"""The routing rules of the tensor-core kernel variants, on the CPU.

``tp_matmul.tc_operand_dtype`` and ``flash_attention.tc_tile_dtype`` send a
product to the tensor-core variant only when the operands, as the contract
multiplies them, are exact in the 16-bit tile type: a 16-bit wgmma with an
f32 accumulator then computes the contract's function.  For every format
and operand dtype, values snapped by ``ref.tp_quantize_ref`` (seeded, plus
the grid's edges: min normal, the RNE boundary band, max normal, +-0)
round-trip through the chosen type bit for bit; tf32, unsnapped f32 and
wider grids go to the split route (``matmul_route`` / ``flash_route``:
f32 products as sums of bf16 piece products, two pieces for a grid of up
to 17 significant bits, three without one), and head dims outside
``TC_HEAD_PAIRS`` to ``flash_fma``.  The split-K planners ``plan_tc`` and
``plan_split`` cover K exactly once, in order, for the op path's shapes
and ragged ones.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.formats import REGISTRY  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels._build import NUM_SMS  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FMA_BLOCK_K, SPLIT_Q_ROWS, TC_BLOCK_K, TC_HEAD_PAIRS, flash_route,
    kernel_block_k, kernel_tiles, plan_q_rows, split_block_k, tc_tile_dtype)
from repro_torch.kernels.quant_common import split_pieces  # noqa: E402
from repro_torch.kernels.tp_matmul import (  # noqa: E402
    TC_BK, TC_MIN_STEPS_PER_SPLIT, agreement_tol, matmul_route, plan_split,
    plan_tc, tc_operand_dtype, tp_matmul_plain)

torch.set_num_threads(1)

FORMATS = sorted({f.name: f for f in REGISTRY.values()}.values(),
                 key=lambda f: f.name)
OPERANDS = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e5m2)


def _fits(f):
    return (f.e_bits <= 5 and f.m_bits <= 10) or (f.e_bits <= 8
                                                  and f.m_bits <= 7)


def _values(fmt, dtype, n=4096, seed=0):
    """Seeded f32 values over the grid's whole range plus its edges, as
    ``dtype`` operands (their widened values are what gets snapped)."""
    rs = np.random.RandomState(seed)
    mag = np.exp2(rs.uniform(fmt.emin - 3, fmt.emax + 1, n))
    x = (rs.choice([-1.0, 1.0], n) * mag * rs.uniform(1.0, 2.0, n))
    mn, mx = fmt.min_normal, fmt.max_normal
    band = mn * (1 - 2.0 ** -(fmt.m_bits + 1))
    half_ulp = 2.0 ** -(fmt.m_bits + 2)
    edges = [0.0, -0.0, mn, -mn, band, -band, mn * (1 - half_ulp), mn / 2,
             mx, -mx, mx * (1 + half_ulp), 1.0, -1.0]
    x[:len(edges)] = edges
    x = np.clip(x, -3e38, 3e38).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _bitwise_equal(a, b):
    assert a.dtype == b.dtype == torch.float32
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
@pytest.mark.parametrize("dtype", OPERANDS, ids=str)
def test_snapped_operands_round_trip_through_the_tile(fmt, dtype):
    tile = tc_operand_dtype(dtype, fmt.name)
    flash_tile = tc_tile_dtype(torch.float32, fmt.name, 256)
    if not _fits(fmt):
        # tf32, fp32, fp64: wider than both 16-bit types -> the split
        # route where the in-kernel snap takes the grid (tf32), else FMA
        assert tile is None and flash_tile is None
        split = 1 <= fmt.m_bits < 23 and fmt.e_bits <= 8
        assert matmul_route(dtype, fmt.name) == ("split" if split else "fma")
        assert flash_route(torch.float32, fmt.name, 256) == (
            "split" if split else "fma")
        return
    assert matmul_route(dtype, fmt.name) == "tc"
    assert tile is not None and flash_tile == tile
    snapped = ref.tp_quantize_ref(_values(fmt, dtype), fmt_name=fmt.name)
    assert snapped.dtype == torch.float32
    _bitwise_equal(snapped.to(tile).to(torch.float32), snapped)
    # and the snap lands on the grid's own edges (nothing below min normal)
    live = snapped[snapped != 0].abs()
    assert live.min().item() >= fmt.min_normal


def test_native_operands_route_by_dtype():
    assert tc_operand_dtype(torch.bfloat16) == torch.bfloat16
    assert tc_operand_dtype(torch.float16) == torch.float16
    assert tc_operand_dtype(torch.float8_e5m2) == torch.float16
    assert tc_operand_dtype(torch.float32) is None
    assert tc_operand_dtype(torch.float32, "tf32") is None
    assert matmul_route(torch.float32) == "split"
    assert matmul_route(torch.float32, "tf32") == "split"
    for dt in (torch.bfloat16, torch.float16, torch.float8_e5m2):
        assert matmul_route(dt) == "tc"
    # every e5m2 value is exact in fp16
    e5m2 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e5m2)
    _bitwise_equal(e5m2.to(torch.float16).to(torch.float32),
                   e5m2.to(torch.float32))


@pytest.mark.parametrize("policy,tile", [
    ("tp_bf16", torch.bfloat16), ("tp_bf16_kv8", torch.bfloat16),
    ("tp_fp16", torch.float16), ("em_fp8", torch.float16),
    ("em_fp16", torch.float16), ("fp32", None)])
def test_flash_route_by_policy_and_head_dim(policy, tile):
    src_dt, src_fmt = kops.policy_src(policy)
    for d in (64, 128, 256):
        assert tc_tile_dtype(src_dt, src_fmt, d) == tile
        # policy fp32 (f32 without a grid): the split route's key tile
        assert kernel_block_k(src_dt, src_fmt, d) == (
            TC_BLOCK_K if tile is not None else split_block_k(d))
        assert flash_route(src_dt, src_fmt, d) == (
            "tc" if tile is not None else "split")
    for d in (16, 20, 32, 96, 512):
        assert tc_tile_dtype(src_dt, src_fmt, d) is None
        assert kernel_block_k(src_dt, src_fmt, d) == FMA_BLOCK_K
        assert flash_route(src_dt, src_fmt, d) == "fma"



@pytest.mark.parametrize("policy,tile", [
    ("tp_bf16", torch.bfloat16), ("tp_bf16_kv8", torch.bfloat16),
    ("tp_fp16", torch.float16), ("em_fp8", torch.float16), ("fp32", None)])
def test_flash_route_with_v_head_dim(policy, tile):
    """V's head dim other than QK's: MLA's (96, 64) (minicpm3) and (192,
    128) (deepseek-v2-lite) route to ``flash_tc`` wherever a 16-bit tile
    does, at its (plan_q_rows // group, 64) tiles, and under policy fp32
    to the split route at (64 // group, split_block_k(D)); every other
    pair, (24, 16) among them, to ``flash_fma`` at (32, 32)."""
    src_dt, src_fmt = kops.policy_src(policy)
    for d, dv, bkv in ((96, 64, 160), (192, 128, 64)):
        assert tc_tile_dtype(src_dt, src_fmt, d, dv) == tile
        tiles = kernel_tiles(src_dt, src_fmt, 1024, bkv, 1, d, dv)
        if tile is None:
            assert tiles == (SPLIT_Q_ROWS, split_block_k(d))
            assert flash_route(src_dt, src_fmt, d, dv) == "split"
        else:
            assert tiles == (plan_q_rows(1024, bkv, 1), TC_BLOCK_K)
            assert kernel_block_k(src_dt, src_fmt, d, dv) == TC_BLOCK_K
    for d, dv in ((24, 16), (192, 192), (64, 32), (96, 96), (128, 64),
                  (64, 128)):
        assert tc_tile_dtype(src_dt, src_fmt, d, dv) is None, (d, dv)
        assert kernel_block_k(src_dt, src_fmt, d, dv) == FMA_BLOCK_K
        assert kernel_tiles(src_dt, src_fmt, 64, 4, 2, d, dv) == (32, 32)
        assert flash_route(src_dt, src_fmt, d, dv) == "fma"


@pytest.mark.parametrize("src,grid,route,pieces", [
    (torch.float32, None, "split", 3),          # policy fp32
    (torch.float32, "tf32", "split", 2),        # 11 significant bits
    (torch.float32, (8, 16), "split", 2),       # 17: two pieces still
    (torch.float32, (8, 17), "split", 3),       # 18: three
    (torch.float32, "fp16alt", "tc", None),
    (torch.float32, "fp8", "tc", None),
    (torch.bfloat16, None, "tc", None),
])
def test_split_route_by_src_and_grid(src, grid, route, pieces):
    """The split route takes f32 src that no 16-bit type holds, with the
    fewest pieces that hold its operands exactly, at every (D, Dv) of
    ``TC_HEAD_PAIRS`` (64-row query tiles, ``split_block_k`` keys); the
    same src at other head dims stays on ``flash_fma``, and tp_matmul
    routes by dtype and grid alone."""
    assert split_pieces(src, grid) == pieces
    for d, dv in TC_HEAD_PAIRS:
        assert flash_route(src, grid, d, dv) == route
        if route == "split":
            assert kernel_tiles(src, grid, 256, 8, 2, d, dv) == (
                SPLIT_Q_ROWS // 2, split_block_k(d))
            assert kernel_block_k(src, grid, d, dv) == (32 if d > 128 else 64)
    assert flash_route(src, grid, 32, 32) == "fma"
    assert matmul_route(src, grid) == route

SHAPES = [(256, 3584, 14336), (256, 14336, 3584), (4, 3584, 14336),
          (4, 14336, 3584), (50, 100, 70), (300, 1000, 300), (1, 1, 1),
          (129, 4097, 8), (128, 65, 129), (1000, 64 * 37 + 5, 200)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_k_plan_covers_k_once_in_order(m, k, n):
    plan = plan_tc(m, k, n)
    assert plan.wm == (1 if m <= 128 else 2)
    bm = 128 * plan.wm
    assert plan.m_tiles * bm >= m > (plan.m_tiles - 1) * bm
    assert plan.n_tiles * 128 >= n > (plan.n_tiles - 1) * 128
    assert plan.k_steps == -(-k // TC_BK)
    # the launch's own check: no empty split, none left over
    assert ((plan.splits - 1) * plan.steps_per_split < plan.k_steps
            <= plan.splits * plan.steps_per_split)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(lo < hi and lo % TC_BK == 0 for lo, hi in ranges)
    if plan.splits > 1:
        tiles = plan.m_tiles * plan.n_tiles
        assert tiles * plan.splits <= NUM_SMS
        assert plan.steps_per_split >= TC_MIN_STEPS_PER_SPLIT


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_route_plan_covers_k_once_in_order(m, k, n):
    """``plan_split``: 128-row tiles always, K split by ``plan_tc``'s rule
    at those tiles."""
    plan = plan_split(m, k, n)
    assert plan.wm == 1
    assert plan.m_tiles * 128 >= m > (plan.m_tiles - 1) * 128
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges, ranges[1:]))
    if plan.splits > 1:
        assert plan.m_tiles * plan.n_tiles * plan.splits <= NUM_SMS
        assert plan.steps_per_split >= TC_MIN_STEPS_PER_SPLIT


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float32+tf32"])
def test_split_route_plan_picked_without_a_winner(m, k, n, dtype):
    """With no tuned winner, the tuner's rule and ``kernels.ops``'s pick
    on the split route are ``plan_split`` (128-row tiles), never
    ``plan_tc``'s 256-row plan; every candidate is a 128-row plan."""
    from repro_torch.kernels import autotune
    autotune.reset()
    want = plan_split(m, k, n)
    assert autotune.default_block("matmul", (m, k, n), dtype) == \
        (1, want.splits)
    base, _, grid = dtype.partition("+")
    plan = kops.tp_matmul_plan(m, k, n, torch.float32, "cpu", grid or None)
    assert plan == want
    assert all(wm == 1 for wm, _ in autotune.candidates(
        "matmul", (m, k, n), dtype))


@pytest.mark.parametrize("nk,page,sq,q_offset,causal,want", [
    (128, 64, 256, 768, True, 1024),   # a wide table: the causal horizon
    (17, 64, 256, 768, True, 1024),
    (4, 16, 96, 32, True, 64),         # the table is the smaller
    (2, 16, 40, 0, True, 64),          # at least one 64-key unit
    (3, 100, 50, 0, False, 320),       # not causal: the whole table
    (128, 64, 1, 8000, True, 8064),
])
def test_split_staged_keys(nk, page, sq, q_offset, causal, want):
    """The split route's staging buffers hold the keys a query can see,
    rounded up to 64: never fewer than the kernel's key tiles read (the
    last tile of the last query ends by the horizon rounded up to the
    tile), never the table's width when the causal horizon is nearer."""
    from repro_torch.kernels.flash_attention import split_staged_keys
    got = split_staged_keys(nk, page, sq, q_offset, causal)
    assert got == want and got % 64 == 0
    seen = min(nk * page, q_offset + sq) if causal else nk * page
    for bk in (32, 64):
        assert -(-seen // bk) * bk <= got


def test_split_k_plan_of_the_op_path():
    up, down = plan_tc(256, 3584, 14336), plan_tc(256, 14336, 3584)
    decode = plan_tc(4, 3584, 14336)
    assert (up.wm, up.n_tiles, up.splits) == (2, 112, 1)
    assert (down.wm, down.n_tiles, down.splits) == (2, 28, 4)
    assert (decode.wm, decode.n_tiles, decode.splits) == (1, 112, 1)


def test_split_partials_added_in_order_stay_within_the_bound():
    """The planned split order, summed as the second pass does (f32
    partials, split by split), agrees with the plain version within
    ``agreement_tol``."""
    rs = np.random.RandomState(3)
    m, k, n = 8, 64 * 40 + 17, 24
    a = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rs.randn(k, n).astype(np.float32)).to(torch.bfloat16)
    plan = plan_tc(m, k, n, sms=4)
    assert plan.splits == 4
    parts = [a[:, lo:hi].float() @ b[lo:hi].float()
             for lo, hi in plan.k_ranges(k)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    got = total.to(torch.bfloat16)
    want = tp_matmul_plain(a, b, out_dtype=torch.bfloat16)
    tol = agreement_tol(a, b, got, want)
    assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("sq,bkv,group,rows", [
    (256, 16, 2, 64),      # the slice's 256-token chunk: 128 CTAs of 64 rows
    (1024, 16, 2, 128),    # a 1024-token prompt: 256 CTAs of 128 rows
    (100, 2, 1, 64), (4096, 8, 2, 128), (64, 200, 1, 128), (7, 3, 64, 64),
    (10, 1, 100, 128)])
def test_flash_query_tile_plan(sq, bkv, group, rows):
    """128-row query tiles only while they still give every SM a CTA."""
    from repro_torch.kernels.flash_attention import plan_q_rows
    assert plan_q_rows(sq, bkv, group) == rows
    if rows == 128 and group <= 64:
        assert -(-sq // (128 // group)) * bkv >= NUM_SMS
