"""The CUDA kernels on the card against their plain versions, and the
serving path on the card against the plain path.  Marked ``gpu``: each
test skips without a CUDA device.  The file imports no JAX, so on a
machine with a card but without JAX it runs without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: kernel and plain version both multiply in the src dtype, sum in
f32 and round p to the src dtype before p.V; a summation-order difference
can flip one such rounding, worth up to 2^-8 of a unit-scale output.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 2.0 ** -8

POLICY = {torch.bfloat16: "tp_bf16", torch.float8_e5m2: "tp_bf16_kv8"}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _pools(gen, n_pages, hkv, page, d, dtype):
    mk = lambda: torch.randn((n_pages, hkv, page, d), generator=gen,
                             device="cuda").to(dtype)
    return mk(), mk()


def _table(gen, b, mp, n_pages):
    t = torch.randperm(n_pages, generator=gen, device="cuda")[:b * mp]
    t = t.reshape(b, mp).to(torch.int32)
    t[1, :1] = t[0, :1]                             # an aliased page
    return t


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e5m2])
@pytest.mark.parametrize("d,page,window,softcap", [
    (256, 64, None, 50.0), (64, 16, 20, None), (20, 16, 7, 30.0)])
def test_decode_kernel_matches_plain(gen, dtype, d, page, window, softcap):
    b, hkv, h, mp = 3, 2, 4, 5
    n_pages = b * mp + 1
    k, v = _pools(gen, n_pages, hkv, page, d, dtype)
    q = torch.randn((b, h, 1, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    table = _table(gen, b, mp, n_pages)
    lens = torch.tensor([mp * page - 1, 0, page + 3], device="cuda")
    call = lambda backend: kops.decode_attention(
        q, k, v, kv_len=lens, block_table=table, policy=POLICY[dtype],
        window=window, softcap=softcap, backend=backend)
    before = decode_attention_cuda.launches
    got = call("kernel")
    assert decode_attention_cuda.launches == before + 1
    want = call("plain")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert not got[1].any()                         # the idle row stores 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e5m2])
@pytest.mark.parametrize("d,page,q_offset,window,softcap", [
    (256, 64, 64, None, 50.0), (64, 16, 0, 24, None), (20, 16, 16, 9, 30.0)])
def test_flash_kernel_matches_plain(gen, dtype, d, page, q_offset, window,
                                    softcap):
    b, hkv, h, sq, mp = 2, 2, 4, 40, 8
    n_pages = b * mp + 1
    k, v = _pools(gen, n_pages, hkv, page, d, dtype)
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    table = _table(gen, b, mp, n_pages)
    lens = torch.tensor([q_offset + sq, q_offset + 13], device="cuda")
    call = lambda backend: kops.flash_attention(
        q, k, v, kv_len=lens, block_table=table, policy=POLICY[dtype],
        causal=True, window=window, softcap=softcap, q_offset=q_offset,
        backend=backend)
    before = flash_attention_cuda.launches
    got = call("kernel")
    assert flash_attention_cuda.launches == before + 1
    want = call("plain")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e5m2])
def test_kernels_in_the_softcap_region(gen, dtype):
    """q scaled by 24 puts the scores near +-80, where the softcap 50 bends
    them: the cap changes each kernel's output by far more than ``TOL``,
    and each kernel still matches its plain version.  Prefill runs without
    a window over pages of 32 keys, so the flash kernel's 32-key tiles and
    the plain version's page blocks see the same running max and round p
    alike: what is left of the difference is the cap's own arithmetic."""
    b, hkv, h, d, page, mp, sq, q_offset = 2, 2, 4, 256, 32, 4, 40, 64
    n_pages = b * mp + 1
    k, v = _pools(gen, n_pages, hkv, page, d, dtype)
    table = _table(gen, b, mp, n_pages)
    lens = torch.tensor([q_offset + sq, q_offset + 13], device="cuda")
    for sq_ in (1, sq):
        q = (torch.randn((b, h, sq_, d), generator=gen, device="cuda")
             * 24.0).to(torch.bfloat16)
        if sq_ == 1:
            call = lambda backend, cap: kops.decode_attention(
                q, k, v, kv_len=lens, block_table=table,
                policy=POLICY[dtype], window=48, softcap=cap,
                backend=backend)
        else:
            call = lambda backend, cap: kops.flash_attention(
                q, k, v, kv_len=lens, block_table=table,
                policy=POLICY[dtype], causal=True, window=None, softcap=cap,
                q_offset=q_offset, backend=backend)
        got = call("kernel", 50.0)
        want = call("plain", 50.0)
        uncapped = call("kernel", None)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= TOL
        assert (got - uncapped).abs().max().item() >= 64 * TOL


def test_flash_kernel_contiguous_f32_snap(gen):
    """Emulated storage: f32 containers snapped onto the src grid in the
    kernel, no page table."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    bh, group, sq, d = 4, 2, 48, 32
    q = torch.randn((bh, sq, d), generator=gen, device="cuda")
    k = torch.randn((bh // group, sq, d), generator=gen, device="cuda")
    v = torch.randn((bh // group, sq, d), generator=gen, device="cuda")
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=None,
              softcap=None, src_fmt_name="fp16alt", src_dtype=torch.float32)
    lens = torch.tensor([48, 48, 30, 30], device="cuda")
    got = flash_attention_cuda(q, k, v, lens, **kw)
    want = flash_attention_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL


def test_engine_on_the_card_matches_the_plain_path(gen):
    """Reduced gemma2 served on the card through the kernels and through
    the plain versions: the same greedy streams, and the kernels ran."""
    from repro_torch.launch.engine import ContinuousEngine, synthetic_trace
    from repro_torch.models.registry import build_model
    m = build_model("gemma2-9b", reduced=True, device="cuda", paged_kv=True,
                    page_size=16)
    params = m.init(0)
    reqs = synthetic_trace(8, 3, 32, 16, m.cfg.vocab)
    max_len = max(r.prompt_len + r.max_new for r in reqs)
    runs = {}
    for backend in ("kernel", "plain"):
        mb = m.with_cfg(decode_backend=backend, prefill_backend=backend)
        decode_attention_cuda.launches = flash_attention_cuda.launches = 0
        fin, stats = ContinuousEngine(mb, params, slots=3, max_len=max_len,
                                      chunk=16).run(reqs)
        runs[backend] = ([f.tokens for f in fin], stats,
                         decode_attention_cuda.launches,
                         flash_attention_cuda.launches)
    assert runs["kernel"][0] == runs["plain"][0]
    assert runs["kernel"][2] > 0 and runs["kernel"][3] > 0
    assert runs["plain"][2] == runs["plain"][3] == 0
    assert runs["kernel"][1]["pages_live_end"] == 0
