"""The CUDA kernels on the card against their plain versions, and the
serving path on the card against the plain path.  Marked ``gpu``: each
test skips without a CUDA device.  The file imports no JAX, so on a
machine with a card but without JAX it runs without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: kernel and plain version both multiply in the src dtype, sum in
f32 and round p to the src dtype before p.V; a summation-order difference
can flip one such rounding, worth up to 2^-8 of a unit-scale output.

The op-path kernels: quantize and cast-and-pack must equal their plain
versions BITWISE (NaN-aware, sign of zero included); tp_matmul within
``tp_matmul.agreement_tol`` (f32 sums in another order, plus one output
ulp), with its snapped operands bitwise equal to the plain snap; dotp_ex
within ``1e-5 * sum |a_i b_i|`` of the exact f64 sum of the widened
products, as is the plain version.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.dotp_ex import dotp_ex_cuda, dotp_ex_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.tp_matmul import (  # noqa: E402
    agreement_tol, tp_matmul_cuda, tp_matmul_plain)
from repro_torch.kernels.tp_quant import (  # noqa: E402
    cast_and_pack_cuda, cast_and_pack_plain, tp_quantize_cuda,
    tp_quantize_plain)

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


# ---------------------------------------------------------------------------
# the transprecision op path
# ---------------------------------------------------------------------------
def _bits_equal(got, want):
    """NaN-aware bitwise equality (sign of zero included)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    idt = {4: torch.int32, 2: torch.int16}[got.element_size()]
    nan = torch.isnan(got.float())
    assert torch.equal(nan, torch.isnan(want.float()))
    assert torch.equal(got.view(idt)[~nan], want.view(idt)[~nan])


def _specials(gen, n):
    """``n`` f32 values mixing randn at many scales with the snap's edge
    cases: zeros of both signs, Inf, NaN, f32 subnormals, values at and
    near fp8/fp16 min normal and max normal."""
    x = torch.randn(n, generator=gen, device="cuda")
    x = x * torch.exp2(torch.randint(-30, 30, (n,), generator=gen,
                                     device="cuda").float())
    edge = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                         1e-40, -1e-40, 2.0 ** -14, -(2.0 ** -14),
                         2.0 ** -14 * (1 - 2.0 ** -3), 2.0 ** -15, 57344.0,
                         61440.0, -65504.0, 65520.0, 3e38], device="cuda")
    x[:edge.numel()] = edge
    return x


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (50, 100, 70),
                                   (4, 1000, 300)])
@pytest.mark.parametrize("dtype,out_dtype,quant", [
    (torch.bfloat16, torch.bfloat16, None),
    (torch.float16, torch.float32, None),
    (torch.float32, torch.float32, None),
    (torch.float8_e5m2, torch.bfloat16, None),
    (torch.float32, torch.float32, "fp8"),
    (torch.float32, torch.float16, "fp16alt"),
])
def test_tp_matmul_kernel_matches_plain(gen, m, k, n, dtype, out_dtype,
                                        quant):
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    before = tp_matmul_cuda.launches
    got = tp_matmul_cuda(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
    assert tp_matmul_cuda.launches == before + 1
    want = tp_matmul_plain(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.isfinite(got.float()).all()
    tol = agreement_tol(a, b, got, want, quant)
    assert ((got.float() - want.float()).abs() <= tol).all()
    if quant:
        # the kernel's snapped operands, read back through identity
        # products (x * 1 and zeros: exact), equal the plain snap; an f32
        # sum starting at +0 turns a snapped -0 into +0, so compare values
        snap = lambda x: ref.tp_quantize_ref(x, fmt_name=quant)
        sa = tp_matmul_cuda(a, torch.eye(k, device="cuda"),
                            quant_fmt_name=quant)
        sb = tp_matmul_cuda(torch.eye(k, device="cuda"), b,
                            quant_fmt_name=quant)
        assert torch.equal(sa, snap(a)) and torch.equal(sb, snap(b))


@pytest.mark.parametrize("fmt", ["fp8", "fp16", "fp16alt", "fp8_e4m3",
                                 "tf32"])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
def test_quantize_and_pack_kernels_bitwise(gen, fmt, stochastic, out_dtype):
    for rows, cols, offset in ((256, 128, 0), (100, 60, 0), (3, 7, 1)):
        # ``offset`` 1 puts the data 4 bytes off 16-byte alignment
        n = rows * cols
        flat = _specials(gen, 2 * n + offset)
        x = flat[offset:offset + n].view(rows, cols)
        y = flat[offset + n:offset + 2 * n].view(rows, cols)
        rbits = torch.randint(-(1 << 31), 1 << 31, (rows, cols),
                              dtype=torch.int32, generator=gen,
                              device="cuda") if stochastic else None
        kw = dict(fmt_name=fmt, stochastic=stochastic, out_dtype=out_dtype)
        before = tp_quantize_cuda.launches, cast_and_pack_cuda.launches
        got_q = tp_quantize_cuda(x, rbits, **kw)
        got_p = cast_and_pack_cuda(x, y, rbits, **kw)
        assert (tp_quantize_cuda.launches, cast_and_pack_cuda.launches) == (
            before[0] + 1, before[1] + 1)
        want_q = tp_quantize_plain(x, rbits, **kw)
        want_p = cast_and_pack_plain(x, y, rbits, **kw)
        torch.cuda.synchronize()
        _bits_equal(got_q, want_q)
        _bits_equal(got_p, want_p)


@pytest.mark.parametrize("n", [1, 1000, 1024, 5000, 300001])
@pytest.mark.parametrize("dtype,src", [
    (torch.float16, torch.float16), (torch.float32, torch.float16),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)])
def test_dotp_ex_kernel_close_to_exact(gen, n, dtype, src):
    a = torch.randn(n, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype)
    before = dotp_ex_cuda.launches
    lanes = dotp_ex_cuda(a, b, src_dtype=src)
    assert dotp_ex_cuda.launches == before + 1
    plain = dotp_ex_plain(a, b, src_dtype=src)
    torch.cuda.synchronize()
    assert lanes.shape == (1, 128)
    pa = a.to(src).double()
    pb = b.to(src).double()
    exact, scale = (pa * pb).sum().item(), (pa * pb).abs().sum().item()
    for got in (lanes, plain):
        assert abs(got.double().sum().item() - exact) <= 1e-5 * scale


def test_op_path_entry_points_launch_their_kernels(gen):
    from repro_torch.core import ops as tops
    x = torch.randn((64, 96), generator=gen, device="cuda")
    w = torch.randn((96, 80), generator=gen, device="cuda")
    counts = lambda: (tp_matmul_cuda.launches, tp_quantize_cuda.launches,
                      cast_and_pack_cuda.launches, dotp_ex_cuda.launches)
    before = counts()
    wq = kops.tp_quantize(w, fmt="fp8", stochastic=True, generator=gen)
    y = tops.tp_matmul(x, wq, "em_fp8", use_kernel=True)
    packed = kops.cast_and_pack(y, y, fmt="fp8")
    d = kops.dotp_ex(w.reshape(-1).half(), wq.reshape(-1).half(),
                     policy="tp_fp16")
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    assert y.dtype == torch.float32 and packed.shape == (64, 160)
    assert torch.isfinite(y).all() and torch.isfinite(packed).all()
    assert torch.isfinite(d)
