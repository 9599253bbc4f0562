"""The CUDA kernels on the card against their plain versions, and the
serving path on the card against the plain path.  Marked ``gpu``: each
test skips without a CUDA device.  The file imports no JAX, so on a
machine with a card but without JAX it runs without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: kernel and plain version both multiply in the src dtype, sum in
f32 and round p to the src dtype before p.V; a summation-order difference
can flip one such rounding, worth up to 2^-8 of a unit-scale output.  The
plain flash version walks the kernel's own key tiles
(``flash_attention.kernel_block_k``), so both round p against the same
running max.  Flash attention and tp_matmul each have a tensor-core and an
FMA variant: every case checks which one launched (per-variant counters).
The decode kernel splits each row over a cluster of CTAs and has an mma and
an FMA route; its cases compare with the plain version walking the same
partition (``plan_splits``) and check the per-route counters.

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
from repro_torch.kernels.decode_attention import (  # noqa: E402
    cluster_size, decode_attention_cuda, decode_attention_plain, decode_route,
    plan_splits)
from repro_torch.kernels.dotp_ex import dotp_ex_cuda, dotp_ex_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_fma, flash_attention_plain,
    flash_attention_tc, kernel_block_k)
from repro_torch.kernels.tp_matmul import (  # noqa: E402
    agreement_tol, plan_tc, tc_operand_dtype, tp_matmul_cuda, tp_matmul_fma,
    tp_matmul_plain, tp_matmul_tc)
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


def _decode_counts():
    c = decode_attention_cuda
    return c.launches, c.launches_mma, c.launches_fma


def _decode_flat(gen, *, rows, g, d, page, nk, dtype, q_dtype=torch.bfloat16):
    """Flat decode inputs: q [rows, G, D], pools [n, page, D] with a
    shuffled [rows, nk] table (rows 0 and 1 share their first page)."""
    n = rows * nk + 3
    q = torch.randn((rows, g, d), generator=gen, device="cuda").to(q_dtype)
    k, v = (torch.randn((n, page, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    table = torch.randperm(n, generator=gen, device="cuda")[:rows * nk]
    table = table.reshape(rows, nk).to(torch.int32)
    table[1, 0] = table[0, 0]
    return q, k, v, table


DECODE_CASES = [  # (pool, src, kv grid, q grid, D, G, page, window, softcap)
    (torch.bfloat16, torch.bfloat16, None, None, 256, 2, 64, None, 50.0),
    (torch.bfloat16, torch.bfloat16, None, None, 256, 8, 16, 100, None),
    (torch.bfloat16, torch.bfloat16, None, None, 64, 1, 16, 37, 30.0),
    (torch.bfloat16, torch.bfloat16, None, None, 20, 2, 64, None, 50.0),
    (torch.float8_e5m2, torch.bfloat16, None, None, 256, 2, 16, 41, 50.0),
    (torch.float8_e5m2, torch.bfloat16, None, None, 64, 8, 64, None, None),
    (torch.float8_e5m2, torch.bfloat16, None, None, 20, 1, 16, 9, 30.0),
    (torch.float16, torch.float16, None, None, 64, 2, 16, 50, 50.0),
    (torch.float32, torch.float32, "fp8", "fp16alt", 256, 2, 64, 70, 50.0),
    (torch.float32, torch.float32, "fp8", "fp16alt", 64, 8, 16, None, None),
    (torch.float32, torch.float32, "fp16", "fp16", 20, 2, 16, 33, 30.0),
    (torch.float32, torch.bfloat16, "fp8", None, 64, 2, 64, None, 50.0),
]


@pytest.mark.parametrize("pool,src,kv_fmt,q_fmt,d,g,page,window,softcap",
                         DECODE_CASES)
def test_decode_cluster_kernel_matches_split_plain(gen, pool, src, kv_fmt,
                                                   q_fmt, d, g, page, window,
                                                   softcap):
    """The cluster kernel, called directly, against the plain version over
    the same partition: bf16 / fp8 / fp16 pools and f32 containers snapped
    onto a grid, pages 16 / 64, D 20 / 64 / 256, G 1 / 2 / 8, windows that
    start inside a page, softcaps; an idle row stores 0, a row shorter than
    its cluster leaves ranks idle, and each call adds one launch of the
    route ``decode_route`` names."""
    rows, nk = 5, 12
    q_dt = torch.float32 if src == torch.float32 else torch.bfloat16
    q, k, v, table = _decode_flat(gen, rows=rows, g=g, d=d, page=page, nk=nk,
                                  dtype=pool, q_dtype=q_dt)
    lens = torch.tensor([nk * page, 0, page + 3, 2, nk * page - 5],
                        device="cuda")
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap,
              kv_fmt_name=kv_fmt, q_fmt_name=q_fmt, src_dtype=src)
    before = _decode_counts()
    got = decode_attention_cuda(q, k, v, lens, table, **kw)
    mma = decode_route(src, d) == "mma"
    assert _decode_counts() == (before[0] + 1, before[1] + int(mma),
                                before[2] + int(not mma))
    plan = plan_splits(lens, page, units=nk, window=window)
    assert plan.size == cluster_size(rows, nk, page, window) > 1
    want = decode_attention_plain(q, k, v, lens, table, splits=plan, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert not got[1].any()                         # the idle row stores 0


def test_decode_cluster_kernel_contiguous(gen):
    """Contiguous strips (no table) split on 64-key units."""
    bh, g, smax, d = 6, 2, 300, 64
    q = torch.randn((bh, g, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((bh, smax, d), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    lens = torch.tensor([300, 0, 65, 1, 299, 128], device="cuda")
    kw = dict(scale=d ** -0.5, window=200, softcap=50.0)
    got = decode_attention_cuda(q, k, v, lens, **kw)
    want = decode_attention_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL
    assert not got[1].any()


@pytest.mark.parametrize("rows,size", [(128, 4), (200, 2), (300, 1)])
def test_decode_cluster_kernel_at_larger_batches(gen, rows, size):
    """Batches past the slice's shrink the cluster (``cluster_size``: 4, 2,
    then one CTA a row, a plain launch with no partner): within ``TOL`` of
    the split plain version, idle rows store 0, and the launch counts once
    under the size the rule names."""
    g, d, page, nk = 2, 256, 64, 16
    q, k, v, table = _decode_flat(gen, rows=rows, g=g, d=d, page=page, nk=nk,
                                  dtype=torch.bfloat16)
    lens = torch.randint(0, nk * page + 1, (rows,), generator=gen,
                         device="cuda")
    lens[::7] = 0
    kw = dict(scale=d ** -0.5, window=None, softcap=50.0,
              src_dtype=torch.bfloat16)
    assert cluster_size(rows, nk, page) == size
    by = decode_attention_cuda.launches_by_cluster
    before = by.get(size, 0), sum(by.values())
    got = decode_attention_cuda(q, k, v, lens, table, **kw)
    assert (by.get(size, 0), sum(by.values())) == (before[0] + 1,
                                                    before[1] + 1)
    want = decode_attention_plain(q, k, v, lens, table,
                                  splits=plan_splits(lens, page, units=nk),
                                  **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert not got[::7].any()


def test_decode_cluster_kernel_long_row_is_deterministic(gen):
    """One stream of 8 KV heads at 8191 keys (the 16-CTA cluster): within
    ``TOL`` of the split plain version, and bit for bit the same on a
    second call (rank 0 adds the parts in rank order, no atomics)."""
    rows, g, d, page = 8, 2, 256, 64
    nk = 8192 // page
    q, k, v, table = _decode_flat(gen, rows=rows, g=g, d=d, page=page, nk=nk,
                                  dtype=torch.bfloat16)
    lens = torch.full((rows,), 8191, device="cuda")
    kw = dict(scale=d ** -0.5, window=None, softcap=50.0,
              src_dtype=torch.bfloat16)
    plan = plan_splits(lens, page, units=nk)
    assert plan.size == 16
    got = decode_attention_cuda(q, k, v, lens, table, **kw)
    again = decode_attention_cuda(q, k, v, lens, table, **kw)
    want = decode_attention_plain(q, k, v, lens, table, splits=plan, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= TOL


def test_decode_kernel_traps_on_a_page_outside_the_pool(gen):
    """A page id past the pool stops the kernel on the device (a child
    process: the trap ends the CUDA context)."""
    import os
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from repro_torch.kernels.decode_attention import "
        "decode_attention_cuda\n"
        "q = torch.randn(2, 2, 64, device='cuda').bfloat16()\n"
        "k = torch.randn(4, 16, 64, device='cuda').bfloat16()\n"
        "t = torch.tensor([[0, 1], [2, 4]], device='cuda')\n"
        "o = decode_attention_cuda(q, k, k, torch.tensor([20, 20], "
        "device='cuda'), t)\n"
        "print('LAUNCHED', flush=True)\n"
        "torch.cuda.synchronize()\n"
        "print('NO TRAP')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0 and "LAUNCHED" in r.stdout, (r.stdout, r.stderr)
    assert "NO TRAP" not in r.stdout and "CUDA error" in r.stderr, r.stderr


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
    bk = kernel_block_k(torch.bfloat16, None, d)
    call = lambda backend: kops.flash_attention(
        q, k, v, kv_len=lens, block_table=table, policy=POLICY[dtype],
        causal=True, window=window, softcap=softcap, q_offset=q_offset,
        backend=backend, block_k=bk)
    before = _flash_counts()
    got = call("kernel")
    tc = d in (64, 128, 256)
    assert _flash_counts() == _plus(before, 1, tc)
    want = call("plain")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e5m2])
def test_kernels_in_the_softcap_region(gen, dtype):
    """q scaled by 24 puts the scores near +-80, where the softcap 50 bends
    them: the cap changes each kernel's output by far more than ``TOL``,
    and each kernel still matches its plain version.  Prefill runs without
    a window over pages of 32 keys; the plain version walks the flash
    kernel's own 64-key tiles, so both see the same running max and round p
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
                q_offset=q_offset, backend=backend,
                block_k=kernel_block_k(torch.bfloat16, None, d))
        got = call("kernel", 50.0)
        want = call("plain", 50.0)
        uncapped = call("kernel", None)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= TOL
        assert (got - uncapped).abs().max().item() >= 64 * TOL


def _flash_counts():
    c = flash_attention_cuda
    return c.launches, c.launches_tc, c.launches_fma


def _mm_counts():
    c = tp_matmul_cuda
    return c.launches, c.launches_tc, c.launches_fma


def _plus(before, n, tc):
    return (before[0] + n, before[1] + (n if tc else 0),
            before[2] + (0 if tc else n))


def test_flash_kernel_contiguous_f32_snap(gen):
    """Emulated storage: f32 containers snapped onto the src grid in the
    kernel, no page table (D 32: the FMA variant)."""
    bh, group, sq, d = 4, 2, 48, 32
    q = torch.randn((bh, sq, d), generator=gen, device="cuda")
    k = torch.randn((bh // group, sq, d), generator=gen, device="cuda")
    v = torch.randn((bh // group, sq, d), generator=gen, device="cuda")
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=None,
              softcap=None, src_fmt_name="fp16alt", src_dtype=torch.float32)
    lens = torch.tensor([48, 48, 30, 30], device="cuda")
    before = _flash_counts()
    got = flash_attention_cuda(q, k, v, lens, **kw)
    assert _flash_counts() == _plus(before, 1, False)
    want = flash_attention_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL


def _flash_inputs(gen, *, d, page, group, dtype, src, rows, q_offset, sq):
    """Flattened kernel inputs: q [BH, sq, D] (f32 for an f32 src, else
    bf16), k/v contiguous [BKV, q_offset + sq, D] (``page`` 0) or a
    shuffled flat pool with a [BKV, nk] table, per-row lengths [BH]."""
    bkv = len(rows)
    skv = q_offset + sq
    q = torch.randn((bkv * group, sq, d), generator=gen, device="cuda").to(
        torch.float32 if src == torch.float32 else torch.bfloat16)
    if page:
        nk = -(-skv // page)
        n_rows = bkv * nk + 3
        k, v = (torch.randn((n_rows, page, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        table = torch.randperm(n_rows, generator=gen, device="cuda")[
            :bkv * nk].reshape(bkv, nk).to(torch.int32)
        table[-1, 0] = table[0, 0]                   # an aliased page
    else:
        k, v = (torch.randn((bkv, skv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        table = None
    lens = torch.tensor([q_offset + r for r in rows], device="cuda")
    return q, k, v, lens.repeat_interleave(group), table


@pytest.mark.parametrize("variant", ["tc", "fma"])
@pytest.mark.parametrize("d,page,group,dtype,window,softcap", [
    (256, 64, 2, torch.bfloat16, 100, 50.0),
    (256, 16, 2, torch.float8_e5m2, None, 50.0),
    (256, 0, 2, torch.bfloat16, None, None),
    (128, 16, 1, torch.bfloat16, 40, None),
    (128, 0, 1, torch.float8_e5m2, 70, 30.0),
    (64, 32, 2, torch.bfloat16, None, 30.0),
    (64, 0, 1, torch.bfloat16, 33, None),
])
def test_flash_variants_match_plain(gen, variant, d, page, group, dtype,
                                    window, softcap):
    """Both variants, called directly, against the plain version at their
    own key tiles: paged (pages of 16, 32 and 64) and contiguous, bf16 and
    fp8 pools, GQA group 1 and 2, D 64 / 128 / 256, a ragged row."""
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=page, group=group, dtype=dtype, src=torch.bfloat16,
        rows=[150, 37], q_offset=70, sq=150)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=window,
              softcap=softcap, q_offset=70, src_dtype=torch.bfloat16)
    fn = flash_attention_tc if variant == "tc" else flash_attention_fma
    before = _flash_counts()
    got = fn(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, variant == "tc")
    want = flash_attention_plain(q, k, v, lens, table,
                                 block_k=64 if variant == "tc" else 32, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("group,q_rows", [(1, 128), (2, 128), (4, 64),
                                          (8, 128)])
def test_flash_tc_query_tiles(gen, group, q_rows):
    """The tensor-core variant's query tile over the group's heads: 64 or
    128 rows (one or two consumer warpgroups), groups up to 8."""
    q, k, v, lens, table = _flash_inputs(
        gen, d=128, page=16, group=group, dtype=torch.bfloat16,
        src=torch.bfloat16, rows=[100, 9], q_offset=30, sq=100)
    kw = dict(group=group, scale=128 ** -0.5, causal=True, window=64,
              softcap=50.0, q_offset=30, src_dtype=torch.bfloat16)
    before = _flash_counts()
    got = flash_attention_tc(q, k, v, lens, table, q_rows=q_rows, **kw)
    assert _flash_counts() == _plus(before, 1, True)
    want = flash_attention_plain(q, k, v, lens, table, block_k=64, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("fmt", ["fp16alt", "fp8", "fp16"])
def test_flash_tc_f32_snap(gen, fmt):
    """Emulated storage on the tensor-core variant: f32 q and K/V snapped
    onto a grid that fits bf16 / fp16, converted by the producer."""
    q, k, v, lens, table = _flash_inputs(
        gen, d=256, page=64, group=2, dtype=torch.float32,
        src=torch.float32, rows=[96, 50], q_offset=32, sq=96)
    kw = dict(group=2, scale=256 ** -0.5, causal=True, window=None,
              softcap=50.0, q_offset=32, src_fmt_name=fmt,
              src_dtype=torch.float32)
    before = _flash_counts()
    got = flash_attention_cuda(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, True)
    want = flash_attention_plain(q, k, v, lens, table, block_k=64, **kw)
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
    before = _mm_counts()
    got = tp_matmul_cuda(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
    assert _mm_counts() == _plus(before, 1, tc_operand_dtype(dtype, quant)
                                 is not None)
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


@pytest.mark.parametrize("variant", ["tc", "fma"])
@pytest.mark.parametrize("m,k,n", [
    (4, 3584, 1024),        # the decode batch: TMA pads M = 4 to the tile
    (50, 100, 70),          # ragged M, N and K (unaligned rows)
    (300, 520, 136),        # ragged, rows 16-byte aligned (TMA)
    (256, 14336, 384),      # split K (3 column tiles)
    (256, 1024, 14336),     # unsplit K, BM 256
])
@pytest.mark.parametrize("dtype,out_dtype,quant", [
    (torch.bfloat16, torch.bfloat16, None),
    (torch.float32, torch.float32, "fp8"),
    (torch.float8_e5m2, torch.float16, None),
])
def test_tp_matmul_variants_match_plain(gen, variant, m, k, n, dtype,
                                        out_dtype, quant):
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    fn = tp_matmul_tc if variant == "tc" else tp_matmul_fma
    before = _mm_counts()
    got = fn(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
    assert _mm_counts() == _plus(before, 1, variant == "tc")
    want = tp_matmul_plain(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    tol = agreement_tol(a, b, got, want, quant)
    assert ((got.float() - want.float()).abs() <= tol).all()
    if variant == "tc" and (m, k, n) == (256, 14336, 384):
        assert plan_tc(m, k, n).splits > 1
        # the split's second pass adds the partials in a fixed order
        assert torch.equal(got, fn(a, b, out_dtype=out_dtype,
                                   quant_fmt_name=quant))


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
