"""The split route's arithmetic on the CPU, held against the JAX package.

The split route multiplies f32 operands that no 16-bit type holds on the
tensor cores: each operand is cut into bf16 pieces (``quant_common
.split_bf16``, the plain twin of ``tc::split_bf16``), and a product keeps
the piece pairs of weight 2^-16 and up (``split_pairs``; flash's P V,
2^-8 and up).

  * The split: every normal f32 whose pieces stay inside bf16's range is
    held exactly by three pieces (summed smallest first), every value of
    up to 17 significant bits (the tf32, fp16 and bf16 grids) by two;
    where a piece underflows bf16's subnormals the rest is within half of
    bf16's smallest subnormal, 2^-134; +-0, Inf, NaN, the largest finite
    values (whose RNE bf16 would overflow) and ties.
  * tp_matmul: the split product emulated in torch (``split_matmul_plain``)
    against ``tp_matmul_pallas`` in interpret mode within the unchanged
    ``agreement_tol``, f32 without a grid (three pieces) and on the tf32
    grid (two, every kept pair exact), at K 1, 7, 100 and more.
  * flash: the plain flash with split-emulated QK^T and PV, at the pieces
    and key tiles of the route, against ``flash_attention_pallas`` in
    interpret mode under policy fp32 within ``F32_TOL`` = 2^-12 (the card
    smoke's gate on f32 pools): contiguous and paged, a window, softcap 50
    with q scaled into the cap region.
  * non-finite operands: a non-finite value is its own last piece, P V
    keeps three pairs, and a NaN the pairs still make is recomputed
    whole, so +-Inf and NaN come out where ``tp_matmul_pallas`` and the
    plain versions give them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.tp_matmul import tp_matmul_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, flash_route, kernel_block_k, split_pieces_of)
from repro_torch.kernels.quant_common import (  # noqa: E402
    split_bf16, split_pairs, split_pieces)
from repro_torch.kernels.tp_matmul import (  # noqa: E402
    agreement_tol, matmul_route, split_matmul_plain, tp_matmul_plain)

torch.set_num_threads(1)

F32_TOL = 2.0 ** -12
#: half of bf16's smallest subnormal (2^-133)
BF16_HALF_SUBNORMAL = 2.0 ** -134


def _sum_small_first(pieces):
    total = pieces[-1]
    for p in reversed(pieces[:-1]):
        total = total + p
    return total


def _bits(x):
    return x.contiguous().view(torch.int32)


def _f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _normals(n, lo, hi, seed):
    rs = np.random.RandomState(seed)
    mag = np.exp2(rs.uniform(lo, hi, n)) * rs.uniform(1.0, 2.0, n)
    return _f32(rs.choice([-1.0, 1.0], n) * mag)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------
def test_three_pieces_hold_every_normal_f32():
    """Random 24-bit values from 2^-110 (below it the last piece would
    fall under bf16's subnormals) to 2^127: three pieces, summed smallest
    first, give x back bit for bit; every piece is a bf16 value."""
    x = _normals(20000, -110, 127, seed=0)
    x = (_bits(x) | (torch.arange(x.numel(), dtype=torch.int32) & 0xFF)
         ).view(torch.float32)           # low mantissa bits set
    pieces = split_bf16(x, 3)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    assert torch.equal(_bits(_sum_small_first(pieces)), _bits(x))
    # each piece is at most half an ulp of the one before it, in bf16
    assert (pieces[1].abs() <= pieces[0].abs() * 2.0 ** -8).all()
    assert (pieces[2].abs() <= pieces[1].abs() * 2.0 ** -8).all()


@pytest.mark.parametrize("grid,m", [("tf32", 10), ("fp16", 10),
                                    ("fp16alt", 7), ((8, 16), 16)])
def test_two_pieces_hold_values_of_up_to_17_bits(grid, m):
    """Values on the tf32, fp16 and bf16 grids (11, 11 and 8 significant
    bits) and on an e8m16 grid (17): two pieces hold them exactly, the
    third is 0; the route picks two pieces where no 16-bit tile holds the
    grid (tf32, e8m16)."""
    x = tref.tp_quantize_ref(_normals(8000, -100, 100, seed=1),
                             fmt_name=grid)
    x = x[torch.isfinite(x) & (x != 0)]
    hi, mid, lo = split_bf16(x, 3)
    assert not lo.any()
    assert torch.equal(_bits(mid + hi), _bits(x))
    assert torch.equal(_bits(_sum_small_first(split_bf16(x, 2))), _bits(x))
    want = 2 if m > 7 and grid != "fp16" else None
    assert split_pieces(torch.float32, grid) == want
    if m == 7:                           # bf16's own grid: one piece
        assert not mid.any()


def test_split_edges_zero_inf_nan_largest_and_ties():
    fmax = float(np.finfo(np.float32).max)
    x = _f32([0.0, -0.0, float("inf"), -float("inf"), float("nan"), fmax,
              -fmax, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
              -(1.0 + 2.0 ** -8), 1.0 + 2.0 ** -8 + 2.0 ** -23])
    hi, mid, lo = split_bf16(x, 3)
    # +-0: every piece a zero, the sign kept in the first
    assert torch.equal(_bits(hi[:2]), _bits(x[:2]))
    assert not mid[:2].any() and not lo[:2].any()
    # Inf and NaN go whole into the last piece, the others are 0 (at two
    # pieces too)
    assert torch.equal(lo[2:4], x[2:4]) and torch.isnan(lo[4])
    assert not hi[2:5].any() and not mid[2:5].any()
    hi2, lo2 = split_bf16(x, 2)
    assert torch.equal(lo2[2:4], x[2:4]) and torch.isnan(lo2[4])
    assert not hi2[2:5].any()
    # the largest finite values: RNE would give Inf, so the first piece is
    # the truncation, and the pieces still hold x exactly
    assert torch.isfinite(hi[5:7]).all()
    assert torch.equal(_bits(_sum_small_first([hi, mid, lo])[5:7]),
                       _bits(x[5:7]))
    # ties round to even: 1 + 2^-8 -> 1 (mid 2^-8), 1 + 3 2^-8 -> 1 + 2^-6
    assert hi[7].item() == 1.0 and mid[7].item() == 2.0 ** -8
    assert hi[8].item() == 1.0 + 2.0 ** -6 and mid[8].item() == -2.0 ** -8
    assert hi[9].item() == -1.0
    # just above the tie rounds up, and the remainder is negative
    assert hi[10].item() == 1.0 + 2.0 ** -7 and mid[10].item() < 0
    # every finite x comes back (-0 as +0: the pieces' sum starts at +0)
    fin = torch.isfinite(x)
    assert torch.equal(_sum_small_first([hi, mid, lo])[fin], x[fin])


def test_where_a_piece_underflows():
    """Below 2^-110 the last pieces fall under bf16's subnormals (spacing
    2^-133): the pieces then hold x within 2^-134, half that spacing,
    normal tiny values and f32 subnormals alike (relative to x that is
    no better than 2^-8 at f32's min normal)."""
    x = torch.cat([_normals(4000, -126, -110, seed=2),
                   _normals(4000, -149, -127, seed=3)])
    pieces = split_bf16(x, 3)
    err = (_sum_small_first(pieces).double() - x.double()).abs()
    assert (err <= BF16_HALF_SUBNORMAL).all()
    assert (err <= torch.maximum(x.double().abs() * 2.0 ** -24,
                                 torch.full_like(err, BF16_HALF_SUBNORMAL))
            ).all()
    assert err.max() > 0                 # some bits are lost here


def test_kept_pairs():
    """Weight 2^-16 and up, smallest first: six pairs at three pieces,
    all four at two; flash's P V (weight 2^-8 and up): three at two."""
    assert split_pairs(3, 3) == [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
                                 (0, 0)]
    assert split_pairs(2, 2) == [(1, 1), (1, 0), (0, 1), (0, 0)]
    assert split_pairs(2, 2, top=1) == [(1, 0), (0, 1), (0, 0)]
    # the last piece (where a non-finite value goes) meets the partner's
    # first piece alone at three pieces and in P V
    assert [j for i, j in split_pairs(3, 3) if i == 2] == [0]
    assert [i for i, j in split_pairs(2, 2, top=1) if j == 1] == [0]


# ---------------------------------------------------------------------------
# tp_matmul: the split product against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(16, 1, 16), (16, 7, 24), (32, 100, 48),
                                   (64, 128, 128), (8, 640, 16)])
@pytest.mark.parametrize("quant", [None, "tf32"])
def test_split_matmul_matches_pallas(m, k, n, quant):
    rs = np.random.RandomState(k)
    a = rs.randn(m, k).astype(np.float32)
    b = (rs.randn(k, n) * k ** -0.5).astype(np.float32)
    assert matmul_route(torch.float32, quant) == "split"
    # the Pallas kernel takes whole blocks: pad with zeros (exact)
    bm, bk, bn = 8, 128, 128
    pm, pk, pn = -m % bm, -k % bk, -n % bn
    want = tp_matmul_pallas(jnp.asarray(np.pad(a, ((0, pm), (0, pk)))),
                            jnp.asarray(np.pad(b, ((0, pk), (0, pn)))),
                            block=(bm, bk, bn), quant_fmt_name=quant,
                            interpret=True)
    want = torch.from_numpy(np.array(want)[:m, :n])
    ta, tb = _f32(a), _f32(b)
    got = split_matmul_plain(ta, tb, quant_fmt_name=quant)
    tol = agreement_tol(ta, tb, got, want, quant)
    assert ((got - want).abs() <= tol).all()
    if quant == "tf32":
        # two pieces, all four pairs exact: the f32 sums of the same
        # products, in another order, as the whole-operand plain version
        plain = tp_matmul_plain(ta, tb, quant_fmt_name=quant)
        assert ((got - plain).abs() <= agreement_tol(ta, tb, got, plain,
                                                     quant)).all()


def test_split_matmul_bf16_output_and_planned_k_ranges():
    """A bf16 store (one output ulp more) and a split K: the partial sums
    over the plan's ranges added in order, as the card's second pass."""
    from repro_torch.kernels.tp_matmul import plan_split
    rs = np.random.RandomState(5)
    a = _f32(rs.randn(4, 3584))
    b = _f32(rs.randn(3584, 256) * 3584 ** -0.5)
    plan = plan_split(4, 3584, 256)
    assert plan.splits > 1
    got = split_matmul_plain(a, b, out_dtype=torch.bfloat16, plan=plan)
    want = tp_matmul_plain(a, b, out_dtype=torch.bfloat16)
    tol = agreement_tol(a, b, got, want)
    assert ((got.float() - want.float()).abs() <= tol).all()


# ---------------------------------------------------------------------------
# flash: the plain version with the route's products against Pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,dv,page,window,softcap,q_scale", [
    (64, 64, 0, None, None, 1.0),         # contiguous, no cap
    (64, 64, 16, 40, 50.0, 1.0),          # paged, window, softcap
    (128, 128, 64, None, 50.0, 24.0),     # scores near +-80: the cap bends
    (256, 256, 16, 48, 50.0, 1.0),        # 32-key tiles
    (96, 64, 0, 33, None, 1.0),           # MLA's head dims
])
def test_split_flash_matches_pallas(d, dv, page, window, softcap, q_scale):
    src = torch.float32
    assert flash_route(src, None, d, dv) == "split"
    bk = kernel_block_k(src, None, d, dv)
    bkv, group, q_offset, sq = 2, 2, 64, 64
    skv = q_offset + sq
    rs = np.random.RandomState(d + page)
    q = (rs.randn(bkv * group, sq, d) * q_scale).astype(np.float32)
    kvl = np.repeat(q_offset + np.asarray([sq, 29]), group).astype(np.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=window,
              softcap=softcap, q_offset=q_offset, src_fmt_name=None)
    if page:
        nk = skv // page
        n_pages = bkv * nk + 1
        k = rs.randn(n_pages, page, d).astype(np.float32)
        v = rs.randn(n_pages, page, dv).astype(np.float32)
        table = rs.permutation(n_pages)[:bkv * nk].reshape(bkv, nk)
        table = table.astype(np.int32)
        kg, vg = k[table].reshape(bkv, skv, d), v[table].reshape(bkv, skv, dv)
        tk, tv, tt = _f32(k), _f32(v), torch.from_numpy(table)
    else:
        kg = rs.randn(bkv, skv, d).astype(np.float32)
        vg = rs.randn(bkv, skv, dv).astype(np.float32)
        tk, tv, tt = _f32(kg), _f32(vg), None
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(kg),
                                  jnp.asarray(vg), jnp.asarray(kvl), bq=32,
                                  bk=bk, src_dtype=jnp.float32,
                                  interpret=True, **kw)
    want = torch.from_numpy(np.asarray(want))
    got = flash_attention_plain(_f32(q), tk, tv, torch.from_numpy(kvl), tt,
                                src_dtype=src, block_k=bk,
                                split=split_pieces_of(src, None), **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= F32_TOL
    if q_scale != 1.0:
        # the cap changes the output by far more than the tolerance
        uncapped = flash_attention_plain(
            _f32(q), tk, tv, torch.from_numpy(kvl), tt, src_dtype=src,
            block_k=bk, split=split_pieces_of(src, None),
            **dict(kw, softcap=None))
        assert (got - uncapped).abs().max().item() > 64 * F32_TOL


def test_split_flash_on_the_tf32_grid_matches_pallas():
    """An f32 pool snapped onto tf32 (two pieces of Q and K, all four
    pairs: exact; P V's three pairs drop pm vl, at most 2^-18 p |v|)."""
    src, grid, d = torch.float32, "tf32", 128
    assert split_pieces_of(src, grid) == (2, 2)
    bk = kernel_block_k(src, grid, d)
    bkv, group, sq = 2, 1, 64
    rs = np.random.RandomState(7)
    q = rs.randn(bkv * group, sq, d).astype(np.float32)
    k = rs.randn(bkv, sq, d).astype(np.float32)
    v = rs.randn(bkv, sq, d).astype(np.float32)
    kvl = np.asarray([64, 41], np.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=None,
              softcap=50.0, q_offset=0, src_fmt_name=grid)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(kvl), bq=32,
                                  bk=bk, src_dtype=jnp.float32,
                                  interpret=True, **kw)
    got = flash_attention_plain(_f32(q), _f32(k), _f32(v),
                                torch.from_numpy(kvl), src_dtype=src,
                                block_k=bk, split=split_pieces_of(src, grid),
                                **kw)
    assert (got - torch.from_numpy(np.asarray(want))).abs().max().item() \
        <= F32_TOL


# ---------------------------------------------------------------------------
# non-finite operands: IEEE's +-Inf and NaN, as the plain version and JAX
# ---------------------------------------------------------------------------
def _same_class(got, want, tol):
    """NaN where ``want`` is NaN, the same signed Inf where it is Inf, and
    the finite values within ``tol`` (a number or a tensor)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    tol = tol[fin] if torch.is_tensor(tol) else tol
    assert ((got[fin] - want[fin]).abs() <= tol).all()


@pytest.mark.parametrize("m,k,n", [(16, 7, 24), (32, 100, 48)])
@pytest.mark.parametrize("quant", [None, "tf32"])
def test_split_matmul_keeps_non_finite_results(m, k, n, quant):
    """An Inf meeting a bf16-exact partner (whose lower pieces are 0), Inf
    x Inf at one index, Inf x 0, Inf - Inf and a NaN: the split product
    (with the kernel's repair of NaN sums) gives what ``tp_matmul_pallas``
    and the plain version give."""
    rs = np.random.RandomState(k + n)
    a = rs.randn(m, k).astype(np.float32)
    b = (rs.randn(k, n) * k ** -0.5).astype(np.float32)
    a[0, 3], b[3, 1] = np.inf, 0.5          # Inf x a bf16 value
    b[3, 2] = -np.inf                       # Inf x -Inf at index 3
    a[1, 4], b[4, 9] = -np.inf, 0.0         # Inf x 0: NaN
    a[2, 5], a[2, 6] = np.inf, np.inf       # Inf - Inf where b's signs
    b[5, 11], b[6, 11] = 1.0, -1.0          # differ: NaN
    a[3, 0] = np.nan
    b[k - 1, n - 1] = np.inf                # a column of B
    bm, bk, bn = 8, 128, 128
    pm, pk, pn = -m % bm, -k % bk, -n % bn
    want = tp_matmul_pallas(jnp.asarray(np.pad(a, ((0, pm), (0, pk)))),
                            jnp.asarray(np.pad(b, ((0, pk), (0, pn)))),
                            block=(bm, bk, bn), quant_fmt_name=quant,
                            interpret=True)
    want = torch.from_numpy(np.array(want)[:m, :n])
    ta, tb = _f32(a), _f32(b)
    plain = tp_matmul_plain(ta, tb, quant_fmt_name=quant)
    got = split_matmul_plain(ta, tb, quant_fmt_name=quant)
    assert torch.isinf(want[0, 1]) and torch.isnan(want[1, 9])
    assert torch.isnan(want[2, 11]) and torch.isinf(want[:, n - 1]).any()
    _same_class(plain, want, agreement_tol(ta, tb, plain, want, quant))
    _same_class(got, want, agreement_tol(ta, tb, got, want, quant))
    # without the repair the pairs leave NaN where IEEE gives Inf
    from repro_torch.kernels.quant_common import split_product
    pieces = split_pieces(torch.float32, quant)
    sa = tref.tp_quantize_ref(ta, fmt_name=quant) if quant else ta
    sb = tref.tp_quantize_ref(tb, fmt_name=quant) if quant else tb
    raw = split_product(torch.matmul, sa, sb, pieces, pieces, repair=False)
    assert torch.isnan(raw[0, 1]) or pieces == 3


@pytest.mark.parametrize("grid,softcap", [(None, None), (None, 50.0),
                                          ("tf32", 50.0)])
def test_split_flash_keeps_non_finite_results(grid, softcap):
    """Inf planted in K and V at live keys of a paged f32 pool: the
    split-emulated plain flash (QK^T repaired, P V's three pairs with a
    non-finite v in its last piece) gives the class of every output the
    whole-operand plain version gives, NaN, signed Inf and finite values
    within ``F32_TOL``."""
    src, d, page = torch.float32, 128, 16
    bkv, group, q_offset, sq = 2, 2, 32, 64
    skv = q_offset + sq
    rs = np.random.RandomState(11)
    q = rs.randn(bkv * group, sq, d).astype(np.float32)
    nk = skv // page
    n_pages = bkv * nk + 1
    k = rs.randn(n_pages, page, d).astype(np.float32)
    v = rs.randn(n_pages, page, d).astype(np.float32)
    table = rs.permutation(n_pages)[:bkv * nk].reshape(bkv, nk)
    table = table.astype(np.int32)
    # key 40 of row 0: Inf in V (both signs); key 70 of row 1: Inf in K
    pg, off = table[0, 40 // page], 40 % page
    v[pg, off, 3], v[pg, off, 7] = np.inf, -np.inf
    pg, off = table[1, 70 // page], 70 % page
    k[pg, off, 5] = np.inf
    kvl = torch.tensor(np.repeat(q_offset + np.asarray([sq, 50]), group),
                       dtype=torch.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=None,
              softcap=softcap, q_offset=q_offset, src_fmt_name=grid,
              src_dtype=src, block_k=kernel_block_k(src, grid, d))
    tq, tk, tv, tt = _f32(q), _f32(k), _f32(v), torch.from_numpy(table)
    want = flash_attention_plain(tq, tk, tv, kvl, tt, **kw)
    got = flash_attention_plain(tq, tk, tv, kvl, tt,
                                split=split_pieces_of(src, grid), **kw)
    assert torch.isinf(want).any()
    assert (~torch.isfinite(want)).any(dim=-1).sum() < want.shape[0] * sq
    _same_class(got, want, F32_TOL)
