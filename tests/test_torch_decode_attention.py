"""The decode kernel's plain version (what the CUDA kernel is held against on
the card) against the JAX package's ``decode_attention_pallas`` in
interpret mode and its blocked oracle ``ref.decode_attention_ref(bk=)``.

Inputs are made once with numpy from a seed and handed to both frameworks
in the same storage dtype.  Both sides multiply in the src dtype, sum in
f32 and round p to the src dtype before p.V; they differ only in f32
summation order, so the f32 outputs agree to ``ATOL``/``RTOL`` = 1e-5.
The CUDA kernel itself is compared with this plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).

The kernel splits each row over a cluster of CTAs (``plan_splits``); the
plain version with ``splits=`` walks the same partition and adds the parts'
f32 sums in rank order.  Every part rounds p against the same exact row
max, so a split changes only f32 summation order: it is held to the same
``ATOL``/``RTOL`` against the Pallas kernel, the JAX oracle and the unsplit
plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    GRID_CTAS, STRIP_UNIT, cluster_size, decode_attention_cuda,
    decode_attention_plain, decode_route, plan_splits)
from repro_torch.models.convert import _to_torch  # noqa: E402

torch.set_num_threads(1)

ATOL = RTOL = 1e-5

#: storage dtype -> (numpy/ml_dtypes dtype, JAX src dtype, torch src dtype,
#: kv_fmt_name, q_fmt_name): native narrow storage widens exactly; the f32
#: container case RNE-snaps K/V onto fp8 and q onto bf16 inside the kernel
STORAGE = {
    "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, None, None),
    "fp8": (ml_dtypes.float8_e5m2, jnp.bfloat16, torch.bfloat16, None, None),
    "f32snap": (np.float32, jnp.float32, torch.float32, "fp8", "fp16alt"),
}


def _both(x, dtype):
    """numpy f32 -> (JAX array, torch tensor) of the same bits in ``dtype``."""
    a = np.asarray(x).astype(dtype)
    return jnp.asarray(a), _to_torch(a, "cpu")


def _inputs(q_shape, kv_shape, storage, seed):
    """q in the src dtype's storage, K/V (strips or pools) in ``storage``."""
    rs = np.random.RandomState(seed)
    np_dt, _, _, _, _ = STORAGE[storage]
    q_dt = np.float32 if storage == "f32snap" else ml_dtypes.bfloat16
    q = _both(rs.randn(*q_shape), q_dt)
    k = _both(rs.randn(*kv_shape), np_dt)
    v = _both(rs.randn(*kv_shape), np_dt)
    return q, k, v


CASES = [  # (storage, kv_len per row, window, softcap)
    ("bf16", [128, 0, 37, 100], None, None),
    ("bf16", [128, 70, 1, 0], 24, 50.0),
    ("fp8", [90, 128, 0, 5], 40, 50.0),
    ("f32snap", [64, 3, 128, 0], None, 30.0),
]


@pytest.mark.parametrize("storage,kv_len,window,softcap", CASES)
def test_plain_matches_pallas_and_ref_contiguous(storage, kv_len, window,
                                                 softcap):
    bh, g, smax, d = 4, 2, 128, 32
    (qj, qt), (kj, kt), (vj, vt) = _inputs((bh, g, d), (bh, smax, d),
                                           storage, seed=3)
    _, jsrc, tsrc, kv_fmt, q_fmt = STORAGE[storage]
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap,
              kv_fmt_name=kv_fmt, q_fmt_name=q_fmt)
    kvl = np.asarray(kv_len, np.int32)
    pallas = decode_attention_pallas(qj, kj, vj, jnp.asarray(kvl)[:, None],
                                     bk=64, src_dtype=jsrc, interpret=True,
                                     **kw)
    oracle = jref.decode_attention_ref(qj, kj, vj, kv_len=kvl, bk=64,
                                       src_dtype=jsrc, **kw)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                 src_dtype=tsrc, **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)
    # idle rows (kv_len == 0) store exact zeros
    assert not got[kvl == 0].any()
    # the unblocked (one-block) oracle mode
    dense = tref.decode_attention_ref(qt, kt, vt, kv_len=torch.from_numpy(kvl),
                                      src_dtype=tsrc, **kw)
    want = jref.decode_attention_ref(qj, kj, vj, kv_len=kvl, src_dtype=jsrc,
                                     **kw)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_plain_matches_pallas_in_the_softcap_region(storage):
    """q scaled by 24 puts the scores near +-80, where the softcap 50 bends
    them: the cap changes the output by far more than the tolerance, and
    the plain version still matches the Pallas kernel."""
    bh, g, smax, d = 4, 2, 128, 32
    (qj, qt), (kj, kt), (vj, vt) = _inputs((bh, g, d), (bh, smax, d),
                                           storage, seed=8)
    qj, qt = _both(np.asarray(qt.float()) * 24.0, ml_dtypes.bfloat16)
    _, jsrc, tsrc, _, _ = STORAGE[storage]
    kvl = np.asarray([128, 90, 0, 33], np.int32)
    kw = dict(scale=d ** -0.5, window=48, kv_fmt_name=None, q_fmt_name=None)
    pallas = decode_attention_pallas(qj, kj, vj, jnp.asarray(kvl)[:, None],
                                     bk=64, src_dtype=jsrc, interpret=True,
                                     softcap=50.0, **kw)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                 src_dtype=tsrc, softcap=50.0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL,
                               atol=ATOL)
    uncapped = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                      src_dtype=tsrc, softcap=None, **kw)
    assert (got - uncapped).abs().max().item() > 0.05


def _paged_table(rows, nk, n_pages, seed, alias):
    """A scrambled [rows, nk] table; rows 0 and 1 share their first
    ``alias`` pages (a common prompt prefix)."""
    perm = np.random.RandomState(seed).permutation(n_pages)[:rows * nk]
    table = perm.reshape(rows, nk).astype(np.int32)
    table[1, :alias] = table[0, :alias]
    return table


@pytest.mark.parametrize("storage,kv_len,window,softcap", CASES[1:])
def test_plain_matches_pallas_paged_aliased(storage, kv_len, window,
                                            softcap):
    rows, g, d, page, nk = 4, 2, 32, 16, 8
    n_pages = rows * nk + 3
    (qj, qt), (kj, kt), (vj, vt) = _inputs((rows, g, d), (n_pages, page, d),
                                           storage, seed=5)
    table = _paged_table(rows, nk, n_pages, seed=7, alias=2)
    _, jsrc, tsrc, kv_fmt, q_fmt = STORAGE[storage]
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap,
              kv_fmt_name=kv_fmt, q_fmt_name=q_fmt)
    kvl = np.asarray(kv_len, np.int32)
    pallas = decode_attention_pallas(qj, kj, vj, jnp.asarray(kvl)[:, None],
                                     jnp.asarray(table), bk=page,
                                     src_dtype=jsrc, interpret=True, **kw)
    oracle = jref.decode_attention_paged_ref(qj, kj, vj, jnp.asarray(table),
                                             kv_len=kvl, src_dtype=jsrc, **kw)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                 torch.from_numpy(table), src_dtype=tsrc,
                                 **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)
    # aliased pages: the torch gather equals the JAX one bit for bit
    np.testing.assert_array_equal(
        tref.paged_gather(kt, torch.from_numpy(table)).float().numpy(),
        np.asarray(jref.paged_gather(kj, jnp.asarray(table))
                   ).astype(np.float32))


@pytest.mark.parametrize("policy", ["tp_bf16", "tp_bf16_kv8"])
def test_ops_wrapper_matches_jax_wrapper_paged(policy):
    """``kernels.ops.decode_attention`` (policy plumbing, per-sequence
    length and page-table expansion over the model-level pools
    [n_pages, Hkv, page, D]) against the JAX wrapper."""
    b, h, hkv, d, page, mp = 3, 4, 2, 16, 16, 3
    n_pages = b * mp + 1
    rs = np.random.RandomState(11)
    store = (ml_dtypes.float8_e5m2 if policy == "tp_bf16_kv8"
             else ml_dtypes.bfloat16)
    qj, qt = _both(rs.randn(b, h, 1, d), ml_dtypes.bfloat16)
    kj, kt = _both(rs.randn(n_pages, hkv, page, d), store)
    vj, vt = _both(rs.randn(n_pages, hkv, page, d), store)
    table = _paged_table(b, mp, n_pages, seed=2, alias=1)
    lens = np.asarray([40, 0, 17], np.int32)
    kw = dict(policy=policy, window=16, softcap=50.0)
    want = jkops.decode_attention(qj, kj, vj, kv_len=jnp.asarray(lens),
                                  block_table=jnp.asarray(table),
                                  interpret=True, **kw)
    got = tkops.decode_attention(qt, kt, vt, kv_len=torch.from_numpy(lens),
                                 block_table=torch.from_numpy(table), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert decode_attention_cuda.launches == 0


# ---------------------------------------------------------------------------
# the split-KV partition of the cluster kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [1, 2, 8, 16])
@pytest.mark.parametrize("unit,window", [(16, None), (16, 37), (64, 100),
                                         (64, 4096), (1, 5)])
def test_plan_splits_is_a_page_aligned_partition(size, unit, window):
    """Parts are in order, disjoint, cover the live range ``[start,
    kv_len)`` exactly, and every inner boundary is a multiple of the unit;
    rows shorter than ``size`` units leave parts empty."""
    units = 70
    lens = [0, 1, unit, unit + 1, 3 * unit - 1, 5 * unit + 7, units * unit,
            units * unit + 9, 17]
    plan = plan_splits(lens, unit, units=units, window=window, size=size)
    assert plan.size == size
    assert plan.bounds.shape == (len(lens), size, 2)
    for kvl, parts in zip(lens, plan.bounds.tolist()):
        kvl = min(kvl, units * unit)
        start = 0 if window is None else max(0, kvl - window)
        live = [(lo, hi) for lo, hi in parts if hi > lo]
        assert all(lo == hi for lo, hi in parts if hi <= lo)
        assert sum(hi - lo for lo, hi in live) == max(0, kvl - start)
        if live:
            assert live[0][0] == start and live[-1][1] == kvl
        for (lo0, hi0), (lo1, hi1) in zip(live, live[1:]):
            assert hi0 == lo1 and hi0 % unit == 0
        # a rank with keys holds whole units, except at the range's ends
        n_units = -(-kvl // unit) - start // unit if kvl > start else 0
        assert len(live) == min(size, n_units)


def test_cluster_size():
    # the slice: 4 slots x 8 KV heads, 65 pages -> 16 CTAs a row
    assert cluster_size(32, 65) == 16
    # one stream of 8 KV heads at 8191 keys -> the non-portable 16
    assert cluster_size(8, 128) == 16
    # never more parts than the row's units
    assert cluster_size(2, 5) == 4 and cluster_size(2, 1) == 1
    # the grid stays within two waves of two CTAs per SM
    assert cluster_size(128, 512) == 4 and cluster_size(265, 512) == 1
    for rows in (1, 8, 31, 32, 100, 264, 600):
        c = cluster_size(rows, 1000)
        assert rows * c <= GRID_CTAS or c == 1
        assert c == 16 or rows * 2 * c > GRID_CTAS
    assert plan_splits([100] * 32, 64, units=65).size == 16
    # a window bounds the units a row's live keys span: 64 keys over pages
    # of 16 touch at most 5 pages -> 4 CTAs a row
    assert cluster_size(32, 63, 16, window=64) == 4
    assert plan_splits([300] * 32, 16, units=63, window=64).size == 4
    assert cluster_size(32, 65, 64, window=4096) == 16


def test_decode_route():
    assert decode_route(torch.bfloat16, 256) == "mma"
    assert decode_route(torch.float16, 64) == "mma"
    assert decode_route(torch.bfloat16, 20) == "fma"
    assert decode_route(torch.float32, 256) == "fma"
    # one rule with flash attention's: the same 16-bit operands, but decode
    # keeps p in f32 under an f32 container, so no grid makes it exact
    from repro_torch.kernels.flash_attention import tc_tile_dtype
    from repro_torch.kernels.quant_common import operand_tile_dtype
    for src in (torch.bfloat16, torch.float16, torch.float32):
        assert (decode_route(src, 64) == "mma") == (
            operand_tile_dtype(src) is not None)
        assert (decode_route(src, 64) == "mma") == (
            tc_tile_dtype(src, None, 64) is not None)
    assert tc_tile_dtype(torch.float32, "fp8", 64) == torch.float16


SPLIT_CASES = [  # (storage, kv_len per row, window, softcap)
    ("bf16", [128, 70, 0, 5], None, 50.0),
    ("fp8", [90, 128, 0, 3], 41, 50.0),
    ("f32snap", [127, 17, 128, 0], 50, 30.0),
]


@pytest.mark.parametrize("size", [1, 2, 8, 16])
@pytest.mark.parametrize("storage,kv_len,window,softcap", SPLIT_CASES)
def test_split_plain_matches_pallas_paged(size, storage, kv_len, window,
                                          softcap):
    """The plain version over ``plan_splits``'s partition (pages of 16;
    aliased pages; an idle row; rows of fewer keys than ``size`` pages; a
    window start inside a page) against the Pallas kernel in interpret
    mode, the JAX oracle and the unsplit plain version."""
    rows, g, d, page, nk = 4, 2, 32, 16, 8
    n_pages = rows * nk + 3
    (qj, qt), (kj, kt), (vj, vt) = _inputs((rows, g, d), (n_pages, page, d),
                                           storage, seed=13)
    table = _paged_table(rows, nk, n_pages, seed=17, alias=3)
    _, jsrc, tsrc, kv_fmt, q_fmt = STORAGE[storage]
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap,
              kv_fmt_name=kv_fmt, q_fmt_name=q_fmt)
    kvl = np.asarray(kv_len, np.int32)
    plan = plan_splits(kvl, page, units=nk, window=window, size=size)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                 torch.from_numpy(table), src_dtype=tsrc,
                                 splits=plan, **kw).numpy()
    pallas = decode_attention_pallas(qj, kj, vj, jnp.asarray(kvl)[:, None],
                                     jnp.asarray(table), bk=page,
                                     src_dtype=jsrc, interpret=True, **kw)
    oracle = jref.decode_attention_paged_ref(qj, kj, vj, jnp.asarray(table),
                                             kv_len=kvl, src_dtype=jsrc, **kw)
    unsplit = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                     torch.from_numpy(table), src_dtype=tsrc,
                                     **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, unsplit, rtol=RTOL, atol=ATOL)
    assert not got[kvl == 0].any()
    if size == 1:   # one part is the unsplit walk, bit for bit
        np.testing.assert_array_equal(got, unsplit)


@pytest.mark.parametrize("size", [2, 8])
def test_split_plain_matches_ref_contiguous(size):
    """Contiguous strips split on ``STRIP_UNIT``-key units."""
    bh, g, smax, d = 4, 4, 200, 16
    (qj, qt), (kj, kt), (vj, vt) = _inputs((bh, g, d), (bh, smax, d),
                                           "bf16", seed=21)
    kvl = np.asarray([200, 65, 0, 130], np.int32)
    kw = dict(scale=d ** -0.5, window=150, softcap=50.0)
    plan = plan_splits(kvl, STRIP_UNIT, units=-(-smax // STRIP_UNIT),
                       window=150, size=size)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                 src_dtype=torch.bfloat16, splits=plan, **kw)
    want = jref.decode_attention_ref(qj, kj, vj, kv_len=kvl,
                                     src_dtype=jnp.bfloat16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
