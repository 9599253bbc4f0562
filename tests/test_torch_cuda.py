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
running max.  Flash attention and tp_matmul each have a tensor-core
variant, a split route (f32 operands no 16-bit type holds, as sums of bf16
piece products on the tensor cores) and an FMA variant: every case checks
which one launched (per-variant counters).  The split route is held at
the unchanged gates: ``F32_TOL`` = 2^-12 for flash on an f32 pool without
a grid (its dropped piece pairs are worth about 2^-16 of p V, far under
that), ``TOL`` on a grid, ``agreement_tol`` for tp_matmul from K = 1 up.
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
    flash_attention_split, flash_attention_tc, flash_route, kernel_block_k,
    kernel_tiles, plan_q_rows)
from repro_torch.kernels.tp_matmul import (  # noqa: E402
    agreement_tol, matmul_route, plan_split, plan_tc, tp_matmul_cuda,
    tp_matmul_fma, tp_matmul_plain, tp_matmul_split, tp_matmul_tc)
from repro_torch.kernels.tp_quant import (  # noqa: E402
    cast_and_pack_cuda, cast_and_pack_plain, tp_quantize_cuda,
    tp_quantize_plain)

pytestmark = pytest.mark.gpu

TOL = 2.0 ** -8
#: flash on an f32 pool without a grid (chip_smoke's ``F32_TOL``)
F32_TOL = 2.0 ** -12

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
    # qwen3-moe: G 8 (one head tile), D 128, no window, no softcap
    (torch.bfloat16, torch.bfloat16, None, None, 128, 8, 64, None, None),
    (torch.float8_e5m2, torch.bfloat16, None, None, 128, 8, 64, None, None),
    # G > 8: head tiles of 8 over one read of each K/V tile; pass 2 in 4
    # key groups (G 12 at D 128), 2 (G 64 at D 64) or 1 (G 48 at D 128,
    # granite's MQA)
    (torch.bfloat16, torch.bfloat16, None, None, 128, 12, 64, None, None),
    (torch.bfloat16, torch.bfloat16, None, None, 128, 48, 64, None, None),
    (torch.float8_e5m2, torch.bfloat16, None, None, 128, 48, 16, 100, 50.0),
    (torch.bfloat16, torch.bfloat16, None, None, 64, 64, 16, 37, None),
    (torch.float32, torch.float32, "fp8", "fp16alt", 128, 48, 64, None,
     None),
    (torch.float32, torch.float32, None, None, 128, 12, 16, 70, 30.0),
    # internvl2-26b: G 6 (6 live heads of the one-head tile's 8), D 128
    (torch.bfloat16, torch.bfloat16, None, None, 128, 6, 64, None, None),
    (torch.float8_e5m2, torch.bfloat16, None, None, 128, 6, 16, 50, None),
    (torch.bfloat16, torch.bfloat16, None, None, 20, 12, 64, None, 50.0),
]


@pytest.mark.parametrize("pool,src,kv_fmt,q_fmt,d,g,page,window,softcap",
                         DECODE_CASES)
def test_decode_cluster_kernel_matches_split_plain(gen, pool, src, kv_fmt,
                                                   q_fmt, d, g, page, window,
                                                   softcap):
    """The cluster kernel, called directly, against the plain version over
    the same partition: bf16 / fp8 / fp16 pools and f32 containers snapped
    onto a grid, pages 16 / 64, D 20 / 64 / 128 / 256, G 1 / 2 / 8 / 12 /
    48 / 64, windows that
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
    return c.launches, c.launches_tc, c.launches_split, c.launches_fma


def _mm_counts():
    c = tp_matmul_cuda
    return c.launches, c.launches_tc, c.launches_split, c.launches_fma


def _plus(before, n, variant):
    """``before`` (``_flash_counts`` / ``_mm_counts``) after ``n`` launches
    of ``variant``: "tc", "split" or "fma" (True: "tc", False: "fma")."""
    variant = {True: "tc", False: "fma"}.get(variant, variant)
    return (before[0] + n,) + tuple(
        b + (n if v == variant else 0)
        for b, v in zip(before[1:], ("tc", "split", "fma")))


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


def _flash_inputs(gen, *, d, page, group, dtype, src, rows, q_offset, sq,
                  dv=None):
    """Flattened kernel inputs: q [BH, sq, D] (f32 for an f32 src, else
    bf16), k contiguous [BKV, q_offset + sq, D] (``page`` 0) or a shuffled
    flat pool with a [BKV, nk] table, v the same at width ``dv`` (None:
    D), per-row lengths [BH]."""
    bkv = len(rows)
    skv = q_offset + sq
    widths = (d, d if dv is None else dv)
    q = torch.randn((bkv * group, sq, d), generator=gen, device="cuda").to(
        torch.float32 if src == torch.float32 else torch.bfloat16)
    if page:
        nk = -(-skv // page)
        n_rows = bkv * nk + 3
        k, v = (torch.randn((n_rows, page, w), generator=gen,
                            device="cuda").to(dtype) for w in widths)
        table = torch.randperm(n_rows, generator=gen, device="cuda")[
            :bkv * nk].reshape(bkv, nk).to(torch.int32)
        table[-1, 0] = table[0, 0]                   # an aliased page
    else:
        k, v = (torch.randn((bkv, skv, w), generator=gen,
                            device="cuda").to(dtype) for w in widths)
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


@pytest.mark.parametrize("variant,d,dv,page,dtype,fmt", [
    ("tc", 96, 64, 64, torch.bfloat16, None),        # K/V by TMA
    ("tc", 96, 64, 0, torch.bfloat16, None),         # contiguous, TMA
    ("tc", 96, 64, 16, torch.float8_e5m2, None),     # converted by the producer
    ("tc", 96, 64, 64, torch.float32, "fp16alt"),    # f32 containers snapped
    ("tc", 192, 128, 64, torch.bfloat16, None),      # deepseek-v2-lite
    ("tc", 192, 128, 0, torch.bfloat16, None),
    ("tc", 192, 128, 16, torch.float8_e5m2, None),
    ("fma", 96, 64, 16, torch.bfloat16, None),
    ("fma", 192, 128, 0, torch.bfloat16, None),
    ("fma", 24, 16, 16, torch.bfloat16, None),
    ("fma", 24, 16, 0, torch.float8_e5m2, None),
])
def test_flash_variants_with_dv_match_plain(gen, variant, d, dv, page, dtype,
                                            fmt):
    """V's head dim other than QK's (MLA's expanded prefill: 96 / 64, and
    deepseek-v2-lite's 192 / 128):
    each variant against the plain version at its own tiles, paged and
    contiguous, output [BH, Sq, Dv]; then its telemetry instantiation,
    whose output must be bitwise the flags-off output and whose visits and
    flags (V counted at width Dv) must equal the plain version's.  The
    router sends (96, 64) and (192, 128) to ``flash_tc`` and (24, 16) to
    ``flash_fma``."""
    from repro_torch.kernels.flash_attention import (kernel_tiles,
                                                     tc_tile_dtype)
    src = torch.float32 if dtype == torch.float32 else torch.bfloat16
    group, q_offset, sq = 2, 40, 130
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=page, group=group, dtype=dtype, src=src,
        rows=[sq, 61], q_offset=q_offset, sq=sq, dv=dv)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=None,
              softcap=None, q_offset=q_offset, src_fmt_name=fmt,
              src_dtype=src)
    tc_pair = (d, dv) in ((96, 64), (192, 128))
    assert (tc_tile_dtype(src, fmt, d, dv) is not None) == tc_pair
    fn = flash_attention_tc if variant == "tc" else flash_attention_fma
    before = _flash_counts()
    got = fn(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, variant == "tc")
    bq, bk = (kernel_tiles(src, fmt, sq, len(lens) // group, group, d, dv)
              if variant == "tc" else (32, 32))
    want = flash_attention_plain(q, k, v, lens, table, block_k=bk, **kw)
    torch.cuda.synchronize()
    assert got.shape == (q.shape[0], sq, dv) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    on, visits, flags = fn(q, k, v, lens, table, debug_visits=True,
                           debug_flags=True, **kw)
    _, pv, pf = flash_attention_plain(q, k, v, lens, table, block_k=bk,
                                      block_q=bq, debug_visits=True,
                                      debug_flags=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(on.view(torch.int32), got.view(torch.int32))
    assert torch.equal(visits, pv) and torch.equal(flags, pf)
    before = _flash_counts()
    flash_attention_cuda(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, tc_pair)


@pytest.mark.parametrize("group,q_rows", [(1, 128), (2, 128), (4, 64),
                                          (8, 128), (48, 64), (48, 128)])
def test_flash_tc_query_tiles(gen, group, q_rows):
    """The tensor-core variant's query tile over the group's heads: 64 or
    128 rows (one or two consumer warpgroups), groups up to 8 and
    granite's 48 (a 64-row tile holds one query of each head and masks 16
    rows)."""
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


@pytest.mark.parametrize("d,dv,page,group,window,softcap,grid", [
    (64, 64, 16, 2, None, 50.0, None),
    (64, 64, 0, 1, 33, None, None),
    (128, 128, 64, 1, 40, None, None),
    (128, 128, 16, 2, None, 50.0, "tf32"),
    (256, 256, 64, 2, 100, 50.0, None),
    (256, 256, 16, 2, None, 50.0, None),
    (256, 256, 0, 2, None, None, None),
    (96, 64, 16, 1, None, None, None),
    (96, 64, 0, 2, 70, 30.0, None),
    (192, 128, 64, 1, None, 50.0, None),
    (192, 128, 0, 1, 33, 30.0, None),
])
def test_flash_split_route_matches_plain(gen, d, dv, page, group, window,
                                         softcap, grid):
    """The split route on f32 pools (policy fp32, or snapped onto tf32) at
    every (D, Dv) of ``TC_HEAD_PAIRS``: paged (pages of 16 and 64, an
    aliased page) and contiguous, ragged rows, GQA 1 and 2, against the
    plain version at the route's own key tiles within ``F32_TOL`` (``TOL``
    on the tf32 grid, where p is snapped); the telemetry instantiation's
    output bitwise the flags-off one, visits and flags the plain
    version's; the default wrapper routes there."""
    src = torch.float32
    assert flash_route(src, grid, d, dv) == "split"
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=page, group=group, dtype=torch.float32, src=src,
        rows=[150, 37], q_offset=70, sq=150, dv=dv)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=window,
              softcap=softcap, q_offset=70, src_fmt_name=grid, src_dtype=src)
    before = _flash_counts()
    got = flash_attention_split(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, "split")
    bq, bk = kernel_tiles(src, grid, 150, len(lens) // group, group, d, dv)
    want = flash_attention_plain(q, k, v, lens, table, block_k=bk, **kw)
    torch.cuda.synchronize()
    assert got.shape == (q.shape[0], 150, dv) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= (TOL if grid else F32_TOL)
    on, visits, flags = flash_attention_split(
        q, k, v, lens, table, debug_visits=True, debug_flags=True, **kw)
    _, pv, pf = flash_attention_plain(q, k, v, lens, table, block_k=bk,
                                      block_q=bq, debug_visits=True,
                                      debug_flags=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(on.view(torch.int32), got.view(torch.int32))
    assert torch.equal(visits, pv) and torch.equal(flags, pf)
    before = _flash_counts()
    again = flash_attention_cuda(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, "split")
    assert torch.equal(again, got)


def test_flash_split_route_in_the_softcap_region(gen):
    """q scaled by 24 (scores near +-80, where softcap 50 bends them) at
    the slice's chunk shape on an f32 pool: within ``F32_TOL`` of the
    plain version, and the cap changes the output by far more."""
    d, group = 256, 2
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=64, group=group, dtype=torch.float32,
        src=torch.float32, rows=[256, 200], q_offset=768, sq=256)
    q = q * 24.0
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=4096,
              q_offset=768, src_dtype=torch.float32)
    bk = kernel_block_k(torch.float32, None, d)
    got = flash_attention_cuda(q, k, v, lens, table, softcap=50.0, **kw)
    want = flash_attention_plain(q, k, v, lens, table, block_k=bk,
                                 softcap=50.0, **kw)
    uncapped = flash_attention_cuda(q, k, v, lens, table, softcap=None, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= F32_TOL
    assert (got - uncapped).abs().max().item() >= 64 * TOL


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
    assert _mm_counts() == _plus(before, 1, matmul_route(dtype, quant))
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


@pytest.mark.parametrize("k", list(range(1, 17)))
@pytest.mark.parametrize("quant", [None, "tf32"])
def test_tp_matmul_split_route_at_small_k(gen, k, quant):
    """K 1..16 (one k16 step, mostly zero padding): the split route's sum
    of six (or four exact) piece products, with the small pairs added
    first, within the unchanged ``agreement_tol``, whose worst case has
    the least room at small K."""
    m, n = 64, 96
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    before = _mm_counts()
    got = tp_matmul_cuda(a, b, quant_fmt_name=quant)
    assert _mm_counts() == _plus(before, 1, "split")
    want = tp_matmul_plain(a, b, quant_fmt_name=quant)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= agreement_tol(a, b, got, want,
                                                quant)).all()


@pytest.mark.parametrize("m,k,n", [
    (4, 3584, 1024),        # the decode batch: TMA pads M = 4 to the tile
    (50, 100, 70),          # ragged M, N and K (unaligned rows)
    (300, 520, 136),        # ragged, three row tiles
    (256, 14336, 384),      # split K (3 column tiles)
    (256, 1024, 14336),     # unsplit K, two row tiles on one weight tile
])
@pytest.mark.parametrize("out_dtype,quant", [
    (torch.float32, None), (torch.bfloat16, None), (torch.float32, "tf32"),
])
def test_tp_matmul_split_route_matches_plain(gen, m, k, n, out_dtype, quant):
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    plan = plan_split(m, k, n)
    before = _mm_counts()
    got = tp_matmul_split(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
    assert _mm_counts() == _plus(before, 1, "split")
    want = tp_matmul_plain(a, b, out_dtype=out_dtype, quant_fmt_name=quant,
                           plan=plan)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    tol = agreement_tol(a, b, got, want, quant)
    assert ((got.float() - want.float()).abs() <= tol).all()
    if plan.splits > 1:
        # the second pass adds the partials in a fixed order
        assert torch.equal(got, tp_matmul_split(a, b, out_dtype=out_dtype,
                                                quant_fmt_name=quant))
    if quant and k <= 1024:
        # the snapped operands read back through identity products: two
        # pieces hold a tf32 value, so x * 1 summed over its pieces is x
        snap = lambda x: ref.tp_quantize_ref(x, fmt_name=quant)
        eye = torch.eye(k, device="cuda")
        assert torch.equal(tp_matmul_cuda(a, eye, quant_fmt_name=quant),
                           snap(a))


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


# ---------------------------------------------------------------------------
# sampling, penalties, the guard and swap on the card
# ---------------------------------------------------------------------------
VOCAB = 256000


def _logits_card(gen, rows=4):
    lg = 6.0 * torch.randn((rows, VOCAB), generator=gen, device="cuda")
    lg[:, VOCAB - 96:] = -1e30                  # a masked pad tail
    return lg


@pytest.mark.parametrize("top_k,top_p", [(64, None), (None, 0.9),
                                         (64, 0.9)])
def test_sampling_on_the_card_at_full_vocab(gen, top_k, top_p):
    """Draws at [4, 256000]: every token inside the top-k set and the
    nucleus of JAX's rule (exclusive f32 mass < top_p, ties kept), never
    in the pad tail, and a seed repeats its draws."""
    from repro_torch.models.transformer import sample_token
    lg = _logits_card(gen)
    t = 0.7
    z = lg / torch.tensor(t, device="cuda")
    floor = torch.full((4, 1), -torch.inf, device="cuda")
    if top_k:
        floor = torch.maximum(floor, z.topk(top_k, -1).values[:, -1:])
    if top_p:
        srt = z.sort(-1, descending=True).values
        p = srt.softmax(-1)
        excl = p.cumsum(-1) - p
        floor = torch.maximum(floor, torch.where(
            excl < top_p, srt, torch.inf).amin(-1, keepdim=True))
    draws = []
    for seed in (1, 1, 2):
        g = torch.Generator(device="cuda").manual_seed(seed)
        draws.append(torch.stack([sample_token(lg, g, temperature=t,
                                               top_k=top_k, top_p=top_p)
                                  for _ in range(16)]))
    torch.cuda.synchronize()
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    for d in draws:
        assert int(d.max()) < VOCAB - 96
        picked = z.gather(1, d.t().long())
        assert bool((picked >= floor).all())


def test_penalties_and_guard_on_the_card_equal_the_cpu(gen):
    from repro_torch.models.transformer import (
        _bump_counts, apply_penalties, sample_token, sanitize_logits,
        token_counts)
    lg = _logits_card(gen)
    lg[1, 17] = float("nan")
    lg[2, 99], lg[2, 100] = float("inf"), -float("inf")
    lg[3] = float("nan")
    toks = torch.randint(0, VOCAB, (4, 512), generator=gen, device="cuda")
    lens = torch.tensor([512, 100, 7, 300], device="cuda")
    cnt = token_counts(toks, VOCAB, lens)
    cnt = _bump_counts(cnt, toks[:, :1])
    cnt_cpu = _bump_counts(token_counts(toks.cpu(), VOCAB, lens.cpu()),
                           toks[:, :1].cpu())
    assert torch.equal(cnt.cpu(), cnt_cpu)
    clean, bad = sanitize_logits(lg)
    clean_cpu, bad_cpu = sanitize_logits(lg.cpu())
    assert torch.equal(clean.cpu().view(torch.int32),
                       clean_cpu.view(torch.int32))
    assert bad.cpu().tolist() == bad_cpu.tolist() == [False, True, True,
                                                      True]
    for rp, pp in ((1.1, 0.5), (3.0, None), (None, 0.3)):
        got = apply_penalties(clean, cnt, repetition_penalty=rp,
                              presence_penalty=pp)
        want = apply_penalties(clean_cpu, cnt_cpu, repetition_penalty=rp,
                               presence_penalty=pp)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert torch.equal(sample_token(clean).cpu(), sample_token(clean_cpu))
    assert int(sample_token(clean)[3]) == 0


@pytest.mark.parametrize("policy,degrade", [("tp_bf16", None),
                                            ("tp_bf16", "fp8"),
                                            ("tp_bf16_kv8", "fp8")])
def test_swap_round_trip_on_the_card(gen, policy, degrade):
    """Swap-out of three pages of every layer (cast to fp8 on the card
    when degrading) into pinned host memory: the bytes equal the CPU
    cast's of the same pages, the CRC32s equal those of the CPU bytes,
    and swap-in into other pages restores the (widened) values."""
    from repro_torch.launch.engine import ContinuousEngine, _crc_blobs
    from repro_torch.models.registry import build_model
    m = build_model("gemma2-9b", policy=policy, reduced=True, device="cuda",
                    paged_kv=True, page_size=16)
    eng = ContinuousEngine(m, m.init(0), slots=2, max_len=64,
                           degrade_fmt=degrade)
    eng.start([])
    for c in eng.caches:
        for pool in (c.k_pool, c.v_pool):
            pool.copy_(torch.randn(pool.shape, generator=gen,
                                   device="cuda").to(pool.dtype))
    ids, dest = [1, 4, 6], [7, 2, 5]
    blobs, nbytes, sums = eng._swap_out(ids, degrade is not None)
    idx = torch.tensor(ids)
    want = []
    for c in eng.caches:
        pair = []
        for pool in (c.k_pool, c.v_pool):
            x = pool.cpu().index_select(0, idx)
            pair.append(x.to(torch.float8_e5m2) if degrade else x)
        want.append(tuple(pair))
    for (k, v), (wk, wv) in zip(blobs, want):
        assert k.device.type == "cpu" and k.is_pinned()
        assert k.dtype == wk.dtype
        assert torch.equal(k.view(torch.uint8), wk.view(torch.uint8))
        assert torch.equal(v.view(torch.uint8), wv.view(torch.uint8))
    assert sums == _crc_blobs(want)
    assert nbytes == sum(k.numel() * k.element_size() * 2 for k, _ in want)
    eng._swap_in(blobs, dest)
    for c, (wk, wv) in zip(eng.caches, want):
        for pool, w in ((c.k_pool, wk), (c.v_pool, wv)):
            got = pool.index_select(0, torch.tensor(dest, device="cuda"))
            assert torch.equal(got.cpu().view(torch.uint8),
                               w.to(pool.dtype).view(torch.uint8))


# ---------------------------------------------------------------------------
# telemetry instantiations (debug_visits / debug_flags) and escalation
# ---------------------------------------------------------------------------
def _damage(k, v, gen):
    """Magnitudes from 10^-7 to 10^6, and +-Inf / NaN at a few places."""
    mag = lambda x: x * 10.0 ** (13 * torch.rand(x.shape, generator=gen,
                                                 device="cuda") - 7)
    k, v = mag(k.float()), mag(v.float())
    flat_k, flat_v = k.view(-1), v.view(-1)
    flat_k[::977] = float("inf")
    flat_v[5::1301] = float("nan")
    flat_k[7::2003] = float("-inf")
    return k, v


@pytest.mark.parametrize("case", ["mma_bf16_p64", "mma_bf16_strip",
                                  "fma_em_fp8_p16_window", "fma_f32_p16",
                                  "fma_d20_bf16"])
def test_decode_telemetry_matches_plain(gen, case):
    """The telemetry instantiation: output bitwise the flags-off one,
    visits and flags exactly the plain version's, on the route named."""
    route, rest = case.split("_", 1)
    d = 20 if "d20" in case else 64
    page = 64 if "p64" in case else 16
    window = 40 if "window" in case else None
    b, hkv, g, mp = 4, 2, 2, 6
    kv_fmt = q_fmt = None
    src = torch.bfloat16
    k, v = _pools(gen, b * mp + 1, hkv, page, d, torch.float32)
    k, v = _damage(k, v, gen)
    if "em_fp8" in case:
        src, kv_fmt, q_fmt = torch.float32, "fp8", "fp8"
    elif "f32" in case:
        src = torch.float32
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.randn((b * hkv, g, d), generator=gen, device="cuda").to(
        torch.float32 if src == torch.float32 else torch.bfloat16)
    lens = torch.tensor([0, 1, page * mp // 2 + 3, page * mp],
                        dtype=torch.int32, device="cuda").repeat_interleave(
                            hkv)
    table = kops.expand_block_table(_table(gen, b, mp, b * mp + 1), hkv)
    if "strip" in case:
        k = ref.paged_gather(k.reshape(-1, page, d), table)
        v = ref.paged_gather(v.reshape(-1, page, d), table)
        table = None
    else:
        k, v = k.reshape(-1, page, d), v.reshape(-1, page, d)
    kw = dict(scale=d ** -0.5, window=window, softcap=50.0,
              kv_fmt_name=kv_fmt, q_fmt_name=q_fmt, src_dtype=src)
    assert decode_route(src, d) == route
    off = decode_attention_cuda(q, k, v, lens, table, **kw)
    n = decode_attention_cuda.launches_telemetry
    on, visits, flags = decode_attention_cuda(
        q, k, v, lens, table, debug_visits=True, debug_flags=True, **kw)
    _, pv, pf = decode_attention_plain(q, k, v, lens, table,
                                       debug_visits=True, debug_flags=True,
                                       **kw)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches_telemetry == n + 1
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    assert torch.equal(visits, pv) and torch.equal(flags, pf)
    assert int(flags.sum()) > 0


@pytest.mark.parametrize("route,g,pool,page", [
    ("mma", 12, torch.bfloat16, 64), ("mma", 48, torch.bfloat16, 16),
    ("mma", 48, torch.float8_e5m2, 64), ("fma", 48, torch.float32, 64)])
def test_decode_telemetry_at_large_groups(gen, route, g, pool, page):
    """The telemetry instantiation at G 12 and 48 (D 128, one KV head): its
    output bitwise the flags-off one and within ``TOL`` of the plain
    version, visits and flags exactly the plain version's, on the route
    named."""
    rows, d, nk = 4, 128, 8
    src = torch.float32 if pool == torch.float32 else torch.bfloat16
    q, k, v, table = _decode_flat(gen, rows=rows, g=g, d=d, page=page, nk=nk,
                                  dtype=pool, q_dtype=src)
    lens = torch.tensor([0, 1, nk * page // 2 + 3, nk * page],
                        dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, window=None, softcap=None,
              kv_fmt_name="fp8" if pool == torch.float32 else None,
              q_fmt_name=None, src_dtype=src)
    assert decode_route(src, d) == route
    off = decode_attention_cuda(q, k, v, lens, table, **kw)
    before = (decode_attention_cuda.launches_telemetry,
              decode_attention_cuda.launches_mma,
              decode_attention_cuda.launches_fma)
    on, visits, flags = decode_attention_cuda(
        q, k, v, lens, table, debug_visits=True, debug_flags=True, **kw)
    want, pv, pf = decode_attention_plain(
        q, k, v, lens, table, debug_visits=True, debug_flags=True,
        splits=plan_splits(lens, page, units=nk), **kw)
    torch.cuda.synchronize()
    assert (decode_attention_cuda.launches_telemetry - before[0],
            decode_attention_cuda.launches_mma - before[1],
            decode_attention_cuda.launches_fma - before[2]) == \
        (1, int(route == "mma"), int(route == "fma"))
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    assert torch.equal(visits, pv) and torch.equal(flags, pf)
    assert (on - want).abs().max().item() <= TOL
    assert not on[0].any()                          # the idle row stores 0


@pytest.mark.parametrize("case", ["tc_bf16_p64", "tc_em_fp8_p16_window",
                                  "tc_bf16_strip_offset", "fma_f32_p16",
                                  "fma_em_fp16_d96_window", "split_f32_p16",
                                  "split_f32_p64_window", "split_tf32_p16",
                                  "split_f32_strip_offset"])
def test_flash_telemetry_matches_plain(gen, case):
    """The telemetry instantiation of each variant on a damaged f32 pool
    (``flash_fma`` on an f32 pool at D 32, which no tensor-core pair
    takes; the split route at D 128)."""
    variant = case.split("_")[0]
    d = 96 if "d96" in case else 32 if case.startswith("fma_f32") else 128
    page = 64 if "p64" in case else 16
    window = 40 if "window" in case else None
    q_offset = 64 if "offset" in case else 32
    bkv, group, sq, mp = 2, 2, 96, 8
    fmt, src = None, torch.bfloat16
    k, v = _pools(gen, bkv * mp + 1, 1, page, d, torch.float32)
    k, v = _damage(k, v, gen)
    if "em_fp8" in case:
        fmt, src = "fp8", torch.float32
    elif "em_fp16" in case:
        fmt, src = "fp16", torch.float32
    elif "tf32" in case:
        fmt, src = "tf32", torch.float32
    elif "f32" in case:
        src = torch.float32
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.randn((bkv * group, sq, d), generator=gen, device="cuda").to(
        torch.float32 if src == torch.float32 else torch.bfloat16)
    table = _table(gen, bkv, mp, bkv * mp + 1)
    lens = torch.tensor([q_offset + 50] * group + [q_offset + sq] * group,
                        dtype=torch.int32, device="cuda")
    k, v = k.reshape(-1, page, d), v.reshape(-1, page, d)
    if "strip" in case:
        k, v = ref.paged_gather(k, table), ref.paged_gather(v, table)
        table = None
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=window,
              softcap=50.0, q_offset=q_offset, src_fmt_name=fmt,
              src_dtype=src)
    bq, bk = kernel_tiles(src, fmt, sq, bkv, group, d)
    assert flash_route(src, fmt, d) == variant
    off = flash_attention_cuda(q, k, v, lens, table, **kw)
    before = _flash_counts()
    on, visits, flags = flash_attention_cuda(
        q, k, v, lens, table, debug_visits=True, debug_flags=True, **kw)
    _, pv, pf = flash_attention_plain(q, k, v, lens, table, block_k=bk,
                                      block_q=bq, debug_visits=True,
                                      debug_flags=True, **kw)
    torch.cuda.synchronize()
    assert _flash_counts() == _plus(before, 1, variant)
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    assert torch.equal(visits, pv) and torch.equal(flags, pf)
    assert int(flags.sum()) > 0


def test_escalation_engine_on_the_card_equals_the_cpu(gen):
    """The reduced escalation scenario of ``tests/test_torch_escalation.py``
    on the card (decode on the fma route, prefill on ``flash_fma``): the
    same counters, records and fault-plan events as on the CPU."""
    from repro_torch.core.policy import EscalationPolicy
    from repro_torch.launch.engine import ContinuousEngine, Request
    from repro_torch.models.registry import build_model
    from repro_torch.train.fault import ServeFaultPlan
    out = []
    for dev in ("cpu", "cuda"):
        model = build_model("gemma2-9b", policy="fp32", reduced=True,
                            device=dev, paged_kv=True, page_size=16)
        # the card runs the CPU's weights
        params = (model.init(0) if dev == "cpu"
                  else _to_device(out[0][3], "cuda"))
        rng = torch.Generator().manual_seed(0)
        reqs = [Request(rid=i, tokens=torch.randint(
            0, model.cfg.vocab, (12,), generator=rng).tolist(), max_new=16)
            for i in range(2)]
        plan = ServeFaultPlan(overflow_at=(2,), overflow_scale=65536.0)
        eng = ContinuousEngine(model, params, slots=2, max_len=64, chunk=16,
                               n_pages=10, burst_cap=4, fault_plan=plan,
                               escalate=EscalationPolicy(of_threshold=4))
        fin, stats = eng.run(reqs)
        out.append((fin, stats, plan.events, params))
    (cf, cs, ce, _), (gf, gs, ge, _) = out
    assert gs["escalations"] >= 1 and gs["poisoned_rounds"] == 0
    for k in ("escalations", "esc_refused", "esc_deferred", "preemptions",
              "rounds"):
        assert gs[k] == cs[k], k
    assert ge == ce
    assert [(f.rid, f.admit_round, f.finish_round, f.escalated, len(f.tokens))
            for f in gf] == [(f.rid, f.admit_round, f.finish_round,
                              f.escalated, len(f.tokens)) for f in cf]


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# speculative decoding: the verify fold through the decode kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_folded_kernel_read_is_bitwise_the_step_form(gen, paged):
    """4 slots x 4 chunk positions x 8 KV heads (D 256, 65-unit rows, a
    local layer): the fold of 128 rows at the step form's partition (the
    size ``kernels.ops`` picks for the 4 slots; by the static rule 16 CTAs
    a row, and 4 for the fold's own rows) is bitwise the 4 step-form
    kernel calls, and launches at that size."""
    b, s, hkv, g, d, nk, window = 4, 4, 8, 2, 256, 65, 4096
    unit = 64
    pos = torch.tensor([1024, 128, 512, 4080], device="cuda")
    q = torch.randn((b, s, hkv * g, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    if paged:
        k, v = _pools(gen, b * nk + 1, hkv, unit, d, torch.bfloat16)
        table = _table(gen, b, nk, b * nk + 1)
        fold_kv = (k, v, table.repeat_interleave(s, 0))
    else:
        mk = lambda: torch.randn((b, hkv, nk * unit, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
        k, v, table = mk(), mk(), None
        fold_kv = (k.repeat_interleave(s, 0), v.repeat_interleave(s, 0),
                   None)
    step_c = kops.decode_cluster(b, k, table, window, group=g)
    assert step_c == kops.decode_pick(b * hkv, nk, unit, g, d,
                                      torch.bfloat16, "cuda", window)
    assert kops.decode_cluster(b * s, fold_kv[0], fold_kv[2], window,
                               group=g) == kops.decode_pick(
        b * s * hkv, nk, unit, g, d, torch.bfloat16, "cuda", window)
    kvl = pos[:, None] + torch.arange(s, device="cuda") + 1
    kw = dict(policy="tp_bf16", window=window, softcap=50.0,
              backend="kernel")
    steps = torch.stack([kops.decode_attention(
        q[:, i, :, None], k, v, kv_len=kvl[:, i], block_table=table,
        **kw)[:, :, 0] for i in range(s)], 1)
    by = decode_attention_cuda.launches_by_cluster
    before = by.get(step_c, 0)
    fold = kops.decode_attention(
        q.reshape(b * s, hkv * g, 1, d), fold_kv[0], fold_kv[1],
        kv_len=kvl.reshape(-1), block_table=fold_kv[2], cluster=step_c, **kw)
    torch.cuda.synchronize()
    assert by[step_c] == before + 1
    assert torch.equal(fold.reshape(b, s, hkv * g, d).view(torch.int32),
                       steps.view(torch.int32))


def test_verify_chunk_against_decode_steps_on_the_card(gen):
    """Reduced gemma2 on the card, paged: ``verify_chunk`` of 4 tokens
    against 4 ``decode_step`` calls.  The GEMMs run at M = 12 against
    M = 3, which cuBLAS need not round alike, so this reports the largest
    logit difference (printed) and holds it within the model-level
    ``ATOL`` of the CPU parity suites; the attention reads are bitwise
    (above)."""
    from repro_torch.models.registry import build_model
    m = build_model("gemma2-9b", reduced=True, device="cuda", paged_kv=True,
                    page_size=16)
    params = m.init(0)
    toks = torch.randint(0, m.cfg.vocab, (3, 32), generator=gen,
                         device="cuda")
    lens = torch.tensor([32, 17, 9], device="cuda")
    pre = lambda: m.prefill(params, toks, max_len=48, prompt_lens=lens)
    lg0, c_seq = pre()
    _, c_chk = pre()
    chunk, seq = [lg0[:, -1].argmax(-1).to(torch.int32)[:, None]], []
    for i in range(4):
        lg, c_seq = m.decode_step(params, chunk[-1], c_seq, lens + i,
                                  kv_len=lens + i + 1)
        seq.append(lg[:, -1])
        chunk.append(lg[:, -1].argmax(-1).to(torch.int32)[:, None])
    offs = lens[:, None] + torch.arange(4, device="cuda")
    v_lg, _ = m.verify_chunk(params, torch.cat(chunk[:4], 1), c_chk, lens,
                             kv_len=offs + 1)
    diff = (torch.stack(seq, 1) - v_lg).abs().max().item()
    print(f"verify_chunk vs decode_step on the card: max |dlogits| {diff}")
    assert torch.isfinite(v_lg).all() and diff <= 1e-1


# ---------------------------------------------------------------------------
# training on the card: no kernel under autograd, the dense path's grads
# ---------------------------------------------------------------------------
def test_kernel_wrappers_refuse_inputs_that_require_grad(gen):
    """On the card every kernel wrapper refuses an input that requires grad
    under grad mode (the kernels have no backward) and launches nothing;
    under ``no_grad`` the same call launches."""
    x = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q, k = x(1, 4, 8, 64).to(torch.bfloat16), x(1, 2, 64, 64).to(
        torch.bfloat16)
    w = x(64, 64)
    calls = {
        "flash_attention": (flash_attention_cuda, lambda t: kops.flash_attention(
            q * t[0, 0].to(q.dtype), k, k)),
        "decode_attention": (decode_attention_cuda, lambda t: kops.decode_attention(
            q[:, :, :1] * t[0, 0].to(q.dtype), k, k, kv_len=64)),
        "tp_matmul": (tp_matmul_cuda, lambda t: kops.tp_matmul(t, w)),
        "tp_quantize": (tp_quantize_cuda, lambda t: kops.tp_quantize(
            t, fmt="fp8")),
        "cast_and_pack": (cast_and_pack_cuda, lambda t: kops.cast_and_pack(
            t, w, fmt="fp8")),
        "dotp_ex": (dotp_ex_cuda, lambda t: kops.dotp_ex(
            t.reshape(-1), w.reshape(-1))),
    }
    for name, (fn, call) in calls.items():
        t = w.clone().requires_grad_()
        before = fn.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call(t)
        assert fn.launches == before, name
        with torch.no_grad():
            call(t)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name


def _train_case(policy, device, seed=0):
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.models.convert import stack_layers
    from repro_torch.models.registry import build_model
    m = build_model("fpnew-case-study", policy=policy, reduced=True,
                    device=device, prefill_backend="dense")
    cpu = build_model("fpnew-case-study", policy=policy, reduced=True,
                      device="cpu")
    tree = stack_layers(cpu.init(seed), cpu.cfg)
    tree = unflatten(tree, [t.to(device) for t in leaves(tree)])
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, 256, (4, 64), generator=g, dtype=torch.int32)
    labels = torch.randint(0, 256, (4, 64), generator=g, dtype=torch.int32)
    labels[0, :5] = -1
    flat = [t.detach().requires_grad_() for t in leaves(tree)]
    loss = m.forward_train(unflatten(tree, flat), toks.to(device),
                           labels.to(device), loss_chunk=32)
    grads = torch.autograd.grad(loss, flat)
    return m, tree, (toks, labels), loss.detach(), grads


def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("policy,loss_tol,grad_tol", [
    ("fp32", 1e-5, 1e-4), ("tp_bf16", 5e-3, 5e-2)])
def test_train_step_on_the_card_matches_the_cpu(gen, policy, loss_tol,
                                                 grad_tol):
    """Reduced fpnew-case-study: ``forward_train`` loss and every gradient
    on the card against the CPU, then one ``make_train_step`` step.  Under
    ``fp32`` the sums differ only in order (TF32 is off): loss within 1e-5
    relative, gradients within 1e-4 relative L2.  Under ``tp_bf16`` the
    logits and CE run the f32-output bf16 product (``core.ops._WideMM``),
    whose backward rounds the cotangent to bf16 on the card, where the CPU
    path keeps it f32: loss within 5e-3, gradients within 5e-2."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    m, tree, (toks, labels), loss, grads = _train_case(policy, "cuda")
    mc, tc, _, loss_c, grads_c = _train_case(policy, "cpu")
    assert torch.isfinite(loss) and abs(loss.item() - loss_c.item()) <= \
        loss_tol * abs(loss_c.item())
    for a, b in zip(grads, grads_c):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _rel(a, b) < grad_tol, _rel(a, b)
    cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = []
    for model, params in ((m, tree), (mc, tc)):
        state = init_opt_state(params, cfg, model.policy)
        batch = {"tokens": toks.to(model.device),
                 "labels": labels.to(model.device)}
        outs.append(make_train_step(model, cfg)(params, state, batch))
    (p1, s1, met1), (p2, s2, met2) = outs
    assert abs(met1["loss"].item() - met2["loss"].item()) <= \
        loss_tol * abs(met2["loss"].item())
    assert _rel(met1["grad_norm"], met2["grad_norm"]) < grad_tol
    assert int(s1["step"]) == 1 and s1["step"].device.type == "cpu"
    for a, b in zip(leaves(p1), leaves(p2)):
        assert a.device.type == "cuda" and torch.isfinite(a).all()


def test_dp2_train_step_on_the_card_matches_the_cpu(gen):
    """One data-parallel step on a (2, 1) mesh of two gloo ranks on the
    card (``train.mesh_checks.step``: the plain f32 sync of the global
    token mean) against the unsharded step on the CPU, under ``fp32``
    (TF32 off): the loss within 1e-5 relative, the gradient norm and every
    leaf's gradient and master within 1e-4 relative L2; the ranks'
    params bitwise each other."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch import spmd
    from repro_torch.models.convert import stack_layers
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train import mesh_checks as mc
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    m = build_model("fpnew-case-study", policy="fp32", reduced=True,
                    device="cpu", prefill_backend="dense")
    whole = stack_layers(m.init(0), m.cfg)
    state = {"params": whole,
             "opt": init_opt_state(whole, OptConfig(**opt), m.policy)}
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, 256, (4, 32), generator=g, dtype=torch.int32)
    labels = torch.randint(0, 256, (4, 32), generator=g, dtype=torch.int32)
    labels[2, :20] = -1                       # the ranks' counts differ
    batch = {"tokens": toks, "labels": labels}
    ranks = spmd.spawn(mc.rank_main, 2, backend="gloo", args=(
        [("dp", "step", dict(dims=(2, 1), state=state, batch=batch,
                             policy="fp32", opt=opt, device="cuda"))],),
        timeout=600)
    _, grads = loss_and_grads(m, whole, batch)
    _, s2, met = make_train_step(m, OptConfig(**opt))(whole, state["opt"],
                                                      batch)
    for r in (x["dp"] for x in ranks):
        assert abs(r["loss"] - met["loss"].item()) <= \
            1e-5 * abs(met["loss"].item())
        assert abs(r["grad_norm"] - met["grad_norm"].item()) <= \
            1e-4 * met["grad_norm"].item()
        for a, b in zip(r["grads"], grads):
            assert _rel(a, b) < 1e-4
        for a, b in zip(r["master"], leaves(s2["master"])):
            assert _rel(a, b) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["dp"]["params"],
                                                 ranks[1]["dp"]["params"]))


def test_wide_mm_backward_on_the_card(gen):
    """The bf16-operand, f32-output product's backward: both gradients
    within one bf16 rounding of the f64 products of the bf16-rounded
    cotangent with the bf16 operands."""
    from repro_torch.core import ops as tp
    a = torch.randn((96, 256), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    b = torch.randn((256, 160), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    out = tp.tp_matmul(a, b, "tp_bf16", out_fmt="fp32")
    assert out.dtype == torch.float32
    g = torch.randn(out.shape, generator=gen, device="cuda")
    ga, gb = torch.autograd.grad(out, (a, b), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    g16 = g.to(torch.bfloat16).double()
    want_a = g16 @ b.detach().double().t()
    want_b = a.detach().double().t() @ g16
    for got, want in ((ga, want_a), (gb, want_b)):
        err = (got.double() - want).abs()
        assert (err <= 2.0 ** -8 * want.abs() + 1e-6).all(), err.max()


# ---------------------------------------------------------------------------
# the last attention archs: whisper's non-causal reads and group 1,
# internvl2's group 6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["tc", "fma"])
@pytest.mark.parametrize("d,page,group,sq,keys,rows", [
    (64, 0, 1, 150, 300, [300, 170]),     # whisper's encoder: ragged keys
    (64, 0, 1, 20, 1500, [1500, 1500]),   # cross prefill: 20 x 1500 frames
    (128, 16, 6, 100, 130, [130, 61]),    # group 6: 21 queries a 128 tile
])
def test_flash_noncausal_matches_plain(gen, variant, d, page, group, sq,
                                       keys, rows):
    """``causal=False`` (whisper's encoder and cross-attention prefill):
    every query reads every live key, whatever its position, on both
    variants against the plain version at their own key tiles, key counts
    not a multiple of the tile, query counts not a multiple of the query
    tile; each launch counts once as non-causal."""
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=page, group=group, dtype=torch.bfloat16,
        src=torch.bfloat16, rows=[r - (keys - sq) for r in rows],
        q_offset=keys - sq, sq=sq)
    kw = dict(group=group, scale=d ** -0.5, causal=False, window=None,
              softcap=None, q_offset=0, src_dtype=torch.bfloat16)
    fn = flash_attention_tc if variant == "tc" else flash_attention_fma
    before = _flash_counts() + (flash_attention_cuda.launches_noncausal,)
    got = fn(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before[:4], 1, variant == "tc")
    assert flash_attention_cuda.launches_noncausal == before[4] + 1
    want = flash_attention_plain(q, k, v, lens, table,
                                 block_k=64 if variant == "tc" else 32, **kw)
    causal = flash_attention_plain(q, k, v, lens, table,
                                   block_k=64 if variant == "tc" else 32,
                                   **dict(kw, causal=True))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    # the mask matters here: the causal output is far from it
    assert (got - causal).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("g,d,smax", [(1, 64, 1500), (6, 128, 300),
                                      (1, 64, 64)])
def test_decode_contiguous_at_groups_1_and_6(gen, g, d, smax):
    """Contiguous strips as whisper's caches hold them (G 1, D 64: the
    1500-frame cross cache, not a multiple of the 64-key unit, and a
    one-unit self cache) and internvl2's group 6, through
    ``kernels.ops.decode_attention`` (the split the rule names) against
    the plain version over the same partition."""
    b, hkv = 4, 3
    q = torch.randn((b, hkv * g, 1, d), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((b, hkv, smax, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    lens = torch.tensor([smax, smax - 37, 1, 0], device="cuda")
    before = decode_attention_cuda.launches_by_group.get(g, 0)
    got = kops.decode_attention(q, k, v, kv_len=lens, backend="kernel")
    assert decode_attention_cuda.launches_by_group[g] == before + 1
    want = kops.decode_attention(q, k, v, kv_len=lens, backend="plain")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    assert not got[3].any()                         # the idle row stores 0


def test_whisper_generate_on_the_card_matches_the_cpu(gen):
    """Reduced whisper (encoder, cross-attention, learned positions,
    layernorm with drawn gains and shifts) through ``generate`` on the
    card, kernels launched, against the same weights on the CPU (plain
    versions): first-token logits within the model-level 1e-1 (bf16
    activations round at other places on the two devices), the cross
    caches within 5e-2, and greedy tokens equal up to a row's first near
    tie (the CPU's top-2 margin there at most twice the largest logit
    difference)."""
    from repro_torch.models.registry import build_model
    m = build_model("whisper-small", reduced=True, device="cpu")
    params = m.init(0)
    g = torch.Generator().manual_seed(1)

    def lively(t, key=None):
        if isinstance(t, dict):
            return {k2: lively(v, k2) for k2, v in t.items()}
        if isinstance(t, list):
            return [lively(v) for v in t]
        if key in ("g", "b", "b_up", "b_down"):
            n = torch.randn(t.shape, generator=g) * 0.2
            return (n + (1.0 if key == "g" else 0.0)).to(t.dtype)
        return t
    params = lively(params)
    toks = torch.randint(0, m.cfg.vocab, (3, 12), generator=g)
    lens = torch.tensor([12, 7, 3])
    frames = torch.randn((3, m.cfg.encoder.n_frames, m.cfg.d_model),
                         generator=g)
    kw = dict(gen_len=10, prompt_lens=lens, frontend_embeds=frames,
              return_logits=True)
    cpu_gen, cpu_lg = m.generate(params, toks, **kw)
    _, cpu_caches = m.prefill(params, toks, max_len=22, prompt_lens=lens,
                              frontend_embeds=frames)
    mc = build_model("whisper-small", reduced=True, device="cuda")
    pc = _to_cuda(params)
    flash_attention_cuda.launches_noncausal = 0
    d0 = decode_attention_cuda.launches
    card_gen, card_lg = mc.generate(pc, toks.cuda(), **{
        **kw, "prompt_lens": lens.cuda(), "frontend_embeds": frames.cuda()})
    _, card_caches = mc.prefill(pc, toks.cuda(), max_len=22,
                                prompt_lens=lens.cuda(),
                                frontend_embeds=frames.cuda())
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_noncausal == 2 * (
        m.cfg.encoder.n_layers + m.cfg.n_layers)
    assert decode_attention_cuda.launches > d0
    card_lg, card_gen = card_lg.cpu(), card_gen.cpu()
    assert (card_lg[:, 0] - cpu_lg[:, 0]).abs().max().item() <= 1e-1
    for a, b2 in zip(cpu_caches, card_caches):
        assert (a.xkv.k.float() - b2.xkv.k.cpu().float()).abs().max() <= 5e-2
    diff = (card_lg - cpu_lg).abs().amax(-1)
    for r in range(toks.shape[0]):
        bad = (card_gen[r] != cpu_gen[r]).nonzero()
        if len(bad):
            s0 = int(bad[0])
            top2 = cpu_lg[r, s0].topk(2).values
            assert (top2[0] - top2[1]).item() <= 2 * diff[r, s0].item()


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


# ---------------------------------------------------------------------------
# the recurrent archs: zamba2 (Mamba2 + a shared attention block), xlstm
# ---------------------------------------------------------------------------
def _lively_gains(params, seed):
    """Norm gains (rmsnorm ``g``, Mamba2's ``norm``, the xLSTM ``ln``)
    ~ 0.2 N, so every gain matters."""
    g = torch.Generator().manual_seed(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if key in ("g", "norm", "ln"):
            return (torch.randn(t.shape, generator=g) * 0.2).to(t.dtype)
        return t
    return walk(params)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_archs_on_the_card_match_the_cpu(gen, arch):
    """Reduced zamba2 / xlstm under ``fp32``: prefill (a padded last
    chunk), three ``decode_step``s and every recurrent cache field on the
    card against the CPU, within 2e-4 (f32 sums in another order, as the
    CPU suite holds the port to JAX).  zamba2's shared attention layer
    launches the flash kernel once a prefill and the decode kernel once a
    step; xlstm launches no attention kernel."""
    from repro_torch.models import ssm
    from repro_torch.models.registry import build_model
    m = build_model(arch, policy="fp32", reduced=True, device="cpu")
    params = _lively_gains(m.init(0), 1)
    toks = torch.randint(0, m.cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(2))
    mc = build_model(arch, policy="fp32", reduced=True, device="cuda")
    pc = _to_cuda(params)
    n_attn = sum(s.mixer == "shared_attn" for s in m.cfg.layer_list())
    f0, d0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    lg, caches = m.prefill(params, toks, max_len=32)
    lgc, cc = mc.prefill(pc, toks.cuda(), max_len=32)
    for i in range(3):
        assert (lgc.cpu() - lg).abs().max().item() <= 2e-4, i
        tok = lg[:, -1].argmax(-1, keepdim=True)
        lg, caches = m.decode_step(params, tok, caches, 21 + i)
        lgc, cc = mc.decode_step(pc, tok.cuda(), cc, 21 + i)
    torch.cuda.synchronize()
    assert (lgc.cpu() - lg).abs().max().item() <= 2e-4
    for c, k in zip(caches, cc):
        if isinstance(c, (ssm.Mamba2Cache, ssm.MLSTMCache, ssm.SLSTMCache)):
            for field, a, b in zip(c._fields, c, k):
                assert (b.cpu() - a).abs().max().item() <= 2e-4 * max(
                    1.0, a.abs().max().item()), field
    assert flash_attention_cuda.launches - f0 == n_attn
    assert decode_attention_cuda.launches - d0 == 3 * n_attn


def test_zamba2_generate_on_the_card_launches_the_kernels(gen):
    """Reduced zamba2 under ``tp_bf16`` through ``generate`` on the card:
    its shared attention layer launches the flash kernel once (head dim
    16: ``flash_fma``) and the decode kernel once a step; logits
    within the model-level 1e-1 of the CPU's and greedy tokens equal up
    to a row's first near tie."""
    from repro_torch.models.registry import build_model
    m = build_model("zamba2-1.2b", reduced=True, device="cpu")
    params = _lively_gains(m.init(0), 3)
    toks = torch.randint(0, m.cfg.vocab, (3, 19),
                         generator=torch.Generator().manual_seed(4))
    cpu_gen, cpu_lg = m.generate(params, toks, gen_len=8, return_logits=True)
    mc = build_model("zamba2-1.2b", reduced=True, device="cuda")
    f0, d0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    card_gen, card_lg = mc.generate(_to_cuda(params), toks.cuda(),
                                    gen_len=8, return_logits=True)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches - f0 == 1
    assert decode_attention_cuda.launches - d0 == 7
    card_lg, card_gen = card_lg.cpu(), card_gen.cpu()
    assert (card_lg[:, 0] - cpu_lg[:, 0]).abs().max().item() <= 1e-1
    for r in range(3):
        bad = (card_gen[r] != cpu_gen[r]).nonzero()
        if len(bad):
            s = int(bad[0])
            diff = (card_lg[r, :s + 1] - cpu_lg[r, :s + 1]).abs().max()
            top2 = cpu_lg[r, s].topk(2).values
            assert (top2[0] - top2[1]).item() <= 2 * diff.item(), (r, s)


def test_sharded_gloo_ranks_on_the_card(gen):
    """Two ranks on the one card over gloo (``launch.spmd``: every CUDA
    tensor staged through pinned host memory): reduced gemma2 at tp 2.
    Each rank's heads of the kernel reads (decode at the unsharded call's
    split, prefill) are bitwise the card's unsharded reads; its ``fp32``
    prefill logits within 1e-4 of the CPU's unsharded logits, argmax
    equal; the engine serves every request its budget, the ranks' streams
    equal; the collectives ran and staged bytes."""
    from repro_torch.launch import sharded_checks as sc
    from repro_torch.launch import spmd
    from repro_torch.models.registry import build_model
    m = build_model("gemma2-9b", policy="fp32", reduced=True, device="cpu")
    params = m.init(0)
    toks = torch.randint(0, m.cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    dims = dict(heads=m.cfg.n_heads, kv_heads=m.cfg.n_kv_heads,
                head_dim=m.cfg.head_dim)
    plan = [("reads", "reads", (1, 2), dims),
            ("logits", "logits", (1, 2), {"params": params, "tokens": toks}),
            ("engine", "engine", (1, 2), {"params": params,
                                          "policy": "fp32"})]
    cpu = sc.run_plan([("logits", "logits", None, plan[1][3])])
    card = sc.run_plan([("reads", "reads", None, dims)], device="cuda")
    ranks = spmd.spawn(sc.rank_main, 2, backend="gloo", args=(plan, "cuda"),
                       timeout=600)
    for out in ranks:
        r = out["rank"]
        for k in ("decode", "flash"):
            assert torch.equal(out["reads"][k],
                               sc.head_slice(card["reads"][k], r, 2)), k
        assert out["reads"]["cluster"] == card["reads"]["cluster"]
        got, want = out["logits"]["logits"], cpu["logits"]["logits"]
        assert (got - want).abs().max().item() <= 1e-4
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        eng = out["engine"]
        assert all(len(t) > 0 for t in eng["tokens"])
        assert eng["tokens"] == ranks[0]["engine"]["tokens"]
        assert eng["spmd"]["collectives"] > 0
        assert eng["spmd"]["staged_bytes"] > 0


@pytest.mark.parametrize("arch", ("minicpm3-4b", "zamba2-1.2b"))
def test_tp_archs_gloo_ranks_on_the_card(gen, arch):
    """Two ranks on the one card over gloo: reduced minicpm3 (MLA: the
    latents gathered whole, 2 of 4 heads a rank) and zamba2 (Mamba2's
    projections gathered whole, the mixer whole on each rank, its out
    projection row-parallel; the shared block on its head shards) at tp
    2 under ``fp32``.  Each rank's last-position prefill logits within
    2e-4 of the CPU's unsharded logits (f32 sums in another order), the
    ranks' logits and greedy tokens equal each other and the CPU's
    tokens; the collectives ran and staged bytes."""
    from repro_torch.launch import sharded_checks as sc
    from repro_torch.launch import spmd
    from repro_torch.models.registry import build_model
    m = build_model(arch, policy="fp32", reduced=True, device="cpu")
    params = _lively_gains(m.init(0), 5)
    toks = torch.randint(0, m.cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(6))
    kw = {"arch": arch, "params": params, "tokens": toks, "gen_len": 4}
    cpu = sc.run_plan([("a", "logits", None, kw)])["a"]
    ranks = spmd.spawn(sc.rank_main, 2, backend="gloo",
                       args=([("a", "logits", (1, 2), kw)], "cuda"),
                       timeout=600)
    for out in ranks:
        got = out["a"]
        assert (got["logits"] - cpu["logits"]).abs().max().item() <= 2e-4
        assert torch.equal(got["logits"], ranks[0]["a"]["logits"])
        assert torch.equal(got["tokens"], cpu["tokens"])
        assert got["spmd"]["collectives"] > 0
        assert got["spmd"]["staged_bytes"] > 0


def test_ep2_moe_train_step_on_the_card_matches_the_cpu(gen):
    """One expert-parallel step of reduced qwen3-moe on a (1, 2) mesh of
    two gloo ranks on the card (``train.mesh_checks.step``: 4 of its 8
    experts a rank, the M identical slabs' gradient divided by M, the aux
    over the one data shard) against the unsharded step on the CPU,
    under ``fp32`` (TF32 off): the loss and the aux within 1e-5
    relative, the gradient norm and every leaf's gradient and master
    within 1e-4 relative L2; the ranks' params bitwise each other."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch import spmd
    from repro_torch.models.convert import stack_layers
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train import mesh_checks as mc
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    arch = "qwen3-moe-30b-a3b"
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    m = build_model(arch, policy="fp32", reduced=True, device="cpu",
                    prefill_backend="dense")
    whole = stack_layers(m.init(0), m.cfg)
    state = {"params": whole,
             "opt": init_opt_state(whole, OptConfig(**opt), m.policy)}
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, 256, (4, 32), generator=g, dtype=torch.int32)
    labels = torch.randint(0, 256, (4, 32), generator=g, dtype=torch.int32)
    labels[2, :20] = -1
    batch = {"tokens": toks, "labels": labels}
    ranks = spmd.spawn(mc.rank_main, 2, backend="gloo", args=(
        [("ep", "step", dict(dims=(1, 2), arch=arch, state=state,
                             batch=batch, policy="fp32", opt=opt,
                             device="cuda"))],), timeout=600)
    _, grads, aux = loss_and_grads(m, whole, batch, return_aux=True)
    _, s2, met = make_train_step(m, OptConfig(**opt))(whole, state["opt"],
                                                      batch)
    for r in (x["ep"] for x in ranks):
        assert abs(r["loss"] - met["loss"].item()) <= \
            1e-5 * abs(met["loss"].item())
        assert abs(r["aux"] - aux.item()) <= 1e-5 * abs(aux.item())
        assert abs(r["grad_norm"] - met["grad_norm"].item()) <= \
            1e-4 * met["grad_norm"].item()
        for a, b in zip(r["grads"], grads):
            assert _rel(a, b) < 1e-4
        for a, b in zip(r["master"], leaves(s2["master"])):
            assert _rel(a, b) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["ep"]["params"],
                                                 ranks[1]["ep"]["params"]))


# ---------------------------------------------------------------------------
# the autotuner on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card_tuner(gen, tmp_path, monkeypatch):
    """The tuner on a temporary user cache, the shipped file kept."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.reset()
    yield autotune
    autotune.reset()


@pytest.mark.parametrize("op,args", [
    ("decode_attn", (16, 12, 64, 2, 128)),
    ("attn", (256, 4, 2, 128)),
    ("matmul", (128, 2048, 256)),
])
def test_autotune_sweep_on_the_card(card_tuner, op, args):
    """A sweep of one small shape per op: every candidate launches, agrees
    with its plain version at that candidate (the sweep raises otherwise)
    and is timed on the device; the winner is recorded under the card's
    key, and a default ``kernels.ops`` call then counts its launch under
    the winner (cluster, query tile, plan)."""
    at = card_tuner
    fn = {"decode_attn": at.autotune_decode, "attn": at.autotune_attention,
          "matmul": at.autotune_matmul}[op]
    winner, timings = fn(*args, device="cuda", repeats=5)
    shape = args if op != "attn" else args + (args[-1],)
    assert list(timings) == at.candidates(op, shape, torch.bfloat16)
    assert len(timings) > 1 and all(t["ms"] > 0 for t in timings.values())
    assert at.lookup(op, shape, torch.bfloat16, "cuda") == winner
    assert "sm90" in at._key(op, shape, torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    if op == "decode_attn":
        rows, units, page, grp, d = args
        k, v = rnd(rows * units + 1, 1, page, d), rnd(rows * units + 1, 1,
                                                      page, d)
        table = torch.arange(rows * units, dtype=torch.int32,
                             device="cuda").reshape(rows, units)
        by = decode_attention_cuda.launches_by_cluster
        before = dict(by)
        kops.decode_attention(rnd(rows, grp, 1, d), k, v,
                              kv_len=torch.full((rows,), units * page,
                                                device="cuda"),
                              block_table=table)
        key = winner[0]
    elif op == "attn":
        sq, bkv, grp, d = args
        by = flash_attention_cuda.launches_by_q_rows
        before = dict(by)
        kops.flash_attention(rnd(bkv, grp, sq, d), rnd(bkv, 1, sq, d),
                             rnd(bkv, 1, sq, d))
        key = winner[0]
    else:
        m, k, n = args
        by = tp_matmul_cuda.launches_by_plan
        before = dict(by)
        kops.tp_matmul(rnd(m, k), rnd(k, n), policy="tp_bf16")
        key = winner
    torch.cuda.synchronize()
    assert {c: x - before.get(c, 0) for c, x in by.items()
            if x != before.get(c, 0)} == {key: 1}


def test_recorded_winners_drive_the_card_launches(card_tuner):
    """A recorded winner other than the rule: the default calls launch at
    it, bitwise the calls that ask for it, and count under it."""
    at = card_tuner
    g = torch.Generator(device="cuda").manual_seed(6)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    # decode: 8 rows of 16 pages (the rule: 16 CTAs a row) recorded at 2
    b, hkv, grp, d, page, nk = 4, 2, 2, 128, 64, 16
    assert cluster_size(b * hkv, nk, page) == 16
    at.record("decode_attn", (b * hkv, nk, page, grp, d), torch.bfloat16,
              (2,), device="cuda", persist=False)
    k, v = rnd(b * nk + 1, hkv, page, d), rnd(b * nk + 1, hkv, page, d)
    table = torch.randperm(b * nk, generator=g, device="cuda").reshape(
        b, nk).to(torch.int32)
    q = rnd(b, hkv * grp, 1, d)
    lens = torch.tensor([nk * page, 5, 700, 0], device="cuda")
    by = decode_attention_cuda.launches_by_cluster
    before = by.get(2, 0)
    got = kops.decode_attention(q, k, v, kv_len=lens, block_table=table)
    want = kops.decode_attention(q, k, v, kv_len=lens, block_table=table,
                                 cluster=2)
    plain = kops.decode_attention(q, k, v, kv_len=lens, block_table=table,
                                  backend="plain")
    torch.cuda.synchronize()
    assert by[2] == before + 2
    assert torch.equal(got, want)
    assert (got - plain).abs().max().item() <= TOL
    # flash: a 2-row chunk of 8 KV heads at group 2 recorded at 128 rows
    at.record("attn", (128, 8, 2, 128, 128), torch.bfloat16, (128,),
              device="cuda", persist=False)
    assert plan_q_rows(128, 8, 2) == 64
    by = flash_attention_cuda.launches_by_q_rows
    before = by.get(128, 0)
    fq, fk, fv = rnd(2, 8, 128, 128), rnd(2, 4, 128, 128), rnd(2, 4, 128, 128)
    got = kops.flash_attention(fq, fk, fv, block_k=64)
    plain = kops.flash_attention(fq, fk, fv, block_k=64, backend="plain")
    torch.cuda.synchronize()
    assert by[128] == before + 1
    assert (got - plain).abs().max().item() <= TOL
    # tp_matmul: recorded at BM 256 and 4 splits
    at.record("matmul", (64, 4096, 256), torch.bfloat16, (2, 4),
              device="cuda", persist=False)
    assert (plan_tc(64, 4096, 256).wm, plan_tc(64, 4096, 256).splits) != (2, 4)
    by = tp_matmul_cuda.launches_by_plan
    before = by.get((2, 4), 0)
    a, w = rnd(64, 4096), rnd(4096, 256) * 4096 ** -0.5
    got = kops.tp_matmul(a, w, policy="tp_bf16")
    plan = kops.tp_matmul_plan(64, 4096, 256, torch.bfloat16, "cuda")
    want = tp_matmul_plain(a, w, out_dtype=torch.bfloat16, plan=plan)
    torch.cuda.synchronize()
    assert by[(2, 4)] == before + 1 and plan.splits == 4
    assert ((got.float() - want.float()).abs()
            <= agreement_tol(a, w, got, want)).all()


# ---------------------------------------------------------------------------
# the split routes: non-finite operands, wide block tables, the tuner
# ---------------------------------------------------------------------------
def _same_class(got, want, tol):
    """NaN where ``want`` is NaN, the same signed Inf where it is Inf, and
    the finite outputs within ``tol`` (a number or a tensor)."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    tol = tol[fin] if torch.is_tensor(tol) else tol
    assert ((got[fin] - want[fin]).abs() <= tol).all()


@pytest.mark.parametrize("m,k,n,quant", [
    (64, 200, 160, None), (64, 3584, 256, None), (96, 640, 200, "tf32"),
    (50, 100, 70, "tf32")])
def test_tp_matmul_split_route_keeps_non_finite_results(gen, m, k, n, quant):
    """Inf meeting a bf16-exact partner (lower pieces 0), Inf x Inf at one
    index, Inf x 0, Inf - Inf and a NaN, one K split or several: the
    values against the plain version, IEEE's NaN and signed Inf where it
    has them and the finite outputs within ``agreement_tol``."""
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    a[0, 3], b[3, 1] = float("inf"), 0.5
    b[3, 2] = -float("inf")
    a[1, 4], b[4, 9] = -float("inf"), 0.0
    a[2, 5], a[2, 6], b[5, 11], b[6, 11] = (float("inf"), float("inf"),
                                            1.0, -1.0)
    a[3, 0] = float("nan")
    b[k - 1, n - 1] = float("inf")
    plan = plan_split(m, k, n)
    before = _mm_counts()
    got = tp_matmul_cuda(a, b, quant_fmt_name=quant, plan=plan)
    assert _mm_counts() == _plus(before, 1, "split")
    want = tp_matmul_plain(a, b, quant_fmt_name=quant, plan=plan)
    torch.cuda.synchronize()
    assert torch.isinf(want[0, 1]) and torch.isnan(want[1, 9])
    _same_class(got, want, agreement_tol(a, b, got, want, quant))


@pytest.mark.parametrize("d,grid,softcap", [
    (256, None, None), (256, None, 50.0), (128, "tf32", 50.0),
    (128, "tf32", None), (64, None, 30.0)])
def test_flash_split_route_keeps_non_finite_results(gen, d, grid, softcap):
    """Inf in one element of K and of V at live keys of a paged f32 pool
    (GQA 2, so the kernel's query tile is the plain walk's 32 queries):
    the split route's values against the plain version at its key tiles,
    NaN and signed Inf where it has them, the finite outputs within
    ``F32_TOL`` (``TOL`` on the tf32 grid); the telemetry output bitwise
    the flags-off one."""
    src, group = torch.float32, 2
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=16, group=group, dtype=torch.float32, src=src,
        rows=[96, 70], q_offset=32, sq=96)
    for pos, row, pool, col, val in ((70, 0, k, 5, float("inf")),
                                     (40, 0, v, 7, float("inf")),
                                     (90, 1, v, 9, -float("inf")),
                                     (50, 1, k, 2, -float("inf"))):
        pool[int(table[row, pos // 16]), pos % 16, col] = val
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=None,
              softcap=softcap, q_offset=32, src_fmt_name=grid, src_dtype=src)
    before = _flash_counts()
    got = flash_attention_cuda(q, k, v, lens, table, **kw)
    assert _flash_counts() == _plus(before, 1, "split")
    bq, bk = kernel_tiles(src, grid, 96, len(lens) // group, group, d)
    assert bq == 32
    want = flash_attention_plain(q, k, v, lens, table, block_k=bk, **kw)
    on = flash_attention_cuda(q, k, v, lens, table, debug_flags=True, **kw)[0]
    torch.cuda.synchronize()
    assert torch.isinf(want).any()
    _same_class(got, want, TOL if grid else F32_TOL)
    assert torch.equal(on.view(torch.int32), got.view(torch.int32))


def test_flash_split_route_through_a_wide_table(gen):
    """The slice's chunk through 8192-key block tables: the staging pass
    holds only the keys a query sees (``split_staged_keys``), and the
    output equals the one through the chunk's own, narrow tables bitwise
    (the same pages, so the same keys and tiles)."""
    from repro_torch.kernels.flash_attention import split_staged_keys
    d, group, page = 256, 2, 64
    q, k, v, lens, table = _flash_inputs(
        gen, d=d, page=page, group=group, dtype=torch.float32,
        src=torch.float32, rows=[256, 200], q_offset=768, sq=256)
    wide = torch.full((table.shape[0], 128), int(table[0, 0]),
                      dtype=torch.int32, device="cuda")
    wide[:, :table.shape[1]] = table
    assert split_staged_keys(128, page, 256, 768, True) == 1024
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=4096,
              softcap=50.0, q_offset=768, src_dtype=torch.float32)
    got = flash_attention_cuda(q, k, v, lens, wide, **kw)
    narrow = flash_attention_cuda(q, k, v, lens, table, **kw)
    want = flash_attention_plain(q, k, v, lens, wide,
                                 block_k=kernel_block_k(torch.float32, None,
                                                        d), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, narrow)
    assert (got - want).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "float32+tf32"])
def test_autotune_sweeps_the_split_route(card_tuner, dtype):
    """``autotune_matmul`` on the split route's operands (f32 without a
    grid, the tf32 grid): 128-row plans only, ``plan_split`` first, every
    candidate held to its plain version and timed; a default call then
    launches the split route under the winner."""
    at = card_tuner
    m, k, n = 256, 3584, 1024
    winner, timings = at.autotune_matmul(m, k, n, dtype=dtype,
                                         device="cuda", repeats=3)
    assert list(timings) == at.candidates("matmul", (m, k, n), dtype)
    assert list(timings)[0] == (1, plan_split(m, k, n).splits)
    assert len(timings) > 1 and all(wm == 1 for wm, _ in timings)
    a = torch.randn((m, k), device="cuda")
    b = torch.randn((k, n), device="cuda")
    by = tp_matmul_cuda.launches_by_plan
    before, counts = dict(by), _mm_counts()
    kops.tp_matmul(a, b, policy=at._matmul_policy(
        torch.float32, dtype.partition("+")[2] or None))
    torch.cuda.synchronize()
    assert _mm_counts() == _plus(counts, 1, "split")
    assert {p: c - before.get(p, 0) for p, c in by.items()
            if c != before.get(p, 0)} == {winner: 1}
