"""The prefill kernel's host-side schedule and plain version against the JAX
package.

``block_schedule`` (the pruned (iq, ik) grid) must equal the JAX one
BITWISE over a grid of shapes, causal/window settings and query offsets.
The plain version (what the CUDA kernel is held against on the card) must
match ``flash_attention_pallas`` in interpret mode, contiguous and paged,
under GQA, ``q_offset`` and ragged per-row ``kv_len``.  The blocking is part
of the contract: p is rounded to the src dtype relative to the running max
of the block walk, so both sides walk the same blocks (the plain version's
32-query blocks, keys in 32-blocks or pages).  They then differ only in f32
summation order, which can still flip one rounding of p onto the src grid
(2^-8 relative), worth up to 2^-8 * (p / l) * |v| of an output: outputs
agree to ``ATOL`` = 1e-4 and ``RTOL`` = 1e-5.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import block_schedule as jschedule  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    PLAIN_BLOCK, block_schedule, flash_attention_cuda, flash_attention_plain)
from repro_torch.models.convert import _to_torch  # noqa: E402

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-5
DENSE_ATOL = 1e-3


def test_block_schedule_bitwise_grid():
    n = 0
    for sq, skv, bq, bk, causal, window, q_off in itertools.product(
            (32, 128), (64, 256), (16, 32), (16, 64), (True, False),
            (None, 1, 17, 64, 300), (0, 5, 64, 200)):
        if sq % bq or skv % bk:
            continue
        got = block_schedule(sq, skv, bq, bk, causal=causal, window=window,
                             q_offset=q_off)
        want = jschedule(sq, skv, bq, bk, causal=causal, window=window,
                         q_offset=q_off)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        n += 1
    assert n == 640


def _both(x, dtype):
    a = np.asarray(x).astype(dtype)
    return jnp.asarray(a), _to_torch(a, "cpu")


#: (storage dtype, JAX src, torch src, src_fmt_name)
STORAGE = {
    "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, None),
    "fp8": (ml_dtypes.float8_e5m2, jnp.bfloat16, torch.bfloat16, None),
    "f32snap": (np.float32, jnp.float32, torch.float32, "fp16alt"),
}


@pytest.mark.parametrize("storage,q_offset,live,window,softcap", [
    ("bf16", 0, [96, 40, 96, 9], None, None),
    ("fp8", 64, [32, 17, 1, 30], 24, 50.0),
    ("f32snap", 32, [64, 64, 20, 5], None, 30.0),
])
def test_plain_matches_pallas_contiguous(storage, q_offset, live, window,
                                         softcap):
    """GQA (group 2) over contiguous K/V [BKV, Skv, D]; row r's kv_len is
    ``q_offset + live[r]`` clipped to Skv."""
    bh, group, d, skv = 4, 2, 32, 96
    sq = skv - q_offset
    np_dt, jsrc, tsrc, sfmt = STORAGE[storage]
    q_dt = np.float32 if storage == "f32snap" else ml_dtypes.bfloat16
    rs = np.random.RandomState(1)
    qj, qt = _both(rs.randn(bh, sq, d), q_dt)
    kj, kt = _both(rs.randn(bh // group, skv, d), np_dt)
    vj, vt = _both(rs.randn(bh // group, skv, d), np_dt)
    kvl = np.minimum(q_offset + np.asarray(live), skv).astype(np.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=window,
              softcap=softcap, q_offset=q_offset, src_fmt_name=sfmt)
    want = flash_attention_pallas(qj, kj, vj, jnp.asarray(kvl),
                                  bq=PLAIN_BLOCK, bk=PLAIN_BLOCK,
                                  src_dtype=jsrc, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                src_dtype=tsrc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the dense (one max, one sum) oracle mode: JAX softcaps it with tanh,
    # the port with the exp form, so a last-bit score difference may flip
    # one src-grid rounding of p at a larger p / l: DENSE_ATOL
    want = jref.flash_attention_ref(qj, kj, vj, kv_len=kvl, src_dtype=jsrc,
                                    **kw)
    got = tref.flash_attention_ref(qt, kt, vt, kv_len=torch.from_numpy(kvl),
                                   src_dtype=tsrc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=DENSE_ATOL)
    # the blocked oracle holds at another blocking too
    want = flash_attention_pallas(qj, kj, vj, jnp.asarray(kvl), bq=16, bk=16,
                                  src_dtype=jsrc, interpret=True, **kw)
    got = tref.flash_attention_ref(qt, kt, vt, kv_len=torch.from_numpy(kvl),
                                   bq=16, bk=16, src_dtype=tsrc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_plain_matches_pallas_in_the_softcap_region(storage):
    """q scaled by 24 puts the scores near +-80, where the softcap 50 bends
    them: the cap changes the output by far more than the tolerance, and
    the plain version still matches the Pallas kernel."""
    bh, group, d, skv, q_offset = 4, 2, 32, 96, 32
    sq = skv - q_offset
    np_dt, jsrc, tsrc, _ = STORAGE[storage]
    rs = np.random.RandomState(12)
    qj, qt = _both(rs.randn(bh, sq, d) * 24.0, ml_dtypes.bfloat16)
    kj, kt = _both(rs.randn(bh // group, skv, d), np_dt)
    vj, vt = _both(rs.randn(bh // group, skv, d), np_dt)
    kvl = np.asarray([96, 96, 70, 70], np.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=40,
              q_offset=q_offset, src_fmt_name=None)
    want = flash_attention_pallas(qj, kj, vj, jnp.asarray(kvl),
                                  bq=PLAIN_BLOCK, bk=PLAIN_BLOCK,
                                  src_dtype=jsrc, interpret=True,
                                  softcap=50.0, **kw)
    got = flash_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                src_dtype=tsrc, softcap=50.0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    uncapped = flash_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                     src_dtype=tsrc, softcap=None, **kw)
    assert (got - uncapped).abs().max().item() > 0.05


@pytest.mark.parametrize("storage", ["bf16", "f32snap"])
def test_plain_matches_pallas_paged_aliased(storage):
    """A continuation chunk (q_offset 32) read through a scrambled page
    table whose rows 0 and 1 share their first two pages."""
    bkv, group, d, page, nk, q_offset, sq = 3, 2, 32, 16, 6, 32, 64
    n_pages = bkv * nk + 2
    np_dt, jsrc, tsrc, sfmt = STORAGE[storage]
    q_dt = np.float32 if storage == "f32snap" else ml_dtypes.bfloat16
    rs = np.random.RandomState(4)
    qj, qt = _both(rs.randn(bkv * group, sq, d), q_dt)
    kj, kt = _both(rs.randn(n_pages, page, d), np_dt)
    vj, vt = _both(rs.randn(n_pages, page, d), np_dt)
    table = rs.permutation(n_pages)[:bkv * nk].reshape(bkv, nk)
    table = table.astype(np.int32)
    table[1, :2] = table[0, :2]
    kvl = np.repeat(q_offset + np.asarray([64, 30, 7]), group).astype(np.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=40,
              softcap=50.0, q_offset=q_offset, src_fmt_name=sfmt)
    want = flash_attention_pallas(qj, kj, vj, jnp.asarray(kvl),
                                  jnp.asarray(table), bq=PLAIN_BLOCK, bk=page,
                                  src_dtype=jsrc, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                torch.from_numpy(table), src_dtype=tsrc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_ops_wrapper_matches_jax_wrapper_paged():
    """``kernels.ops.flash_attention`` over the model-level pools
    [n_pages, Hkv, page, D] with a per-sequence [B, max_pages] table and
    per-sequence lengths, against the JAX wrapper (tp_bf16)."""
    b, h, hkv, d, page, mp, q_offset, sq = 2, 4, 2, 16, 16, 4, 16, 32
    n_pages = b * mp + 1
    rs = np.random.RandomState(9)
    qj, qt = _both(rs.randn(b, h, sq, d), ml_dtypes.bfloat16)
    kj, kt = _both(rs.randn(n_pages, hkv, page, d), ml_dtypes.bfloat16)
    vj, vt = _both(rs.randn(n_pages, hkv, page, d), ml_dtypes.bfloat16)
    table = (rs.permutation(n_pages)[:b * mp].reshape(b, mp)
             .astype(np.int32))
    lens = np.asarray([q_offset + 32, q_offset + 11], np.int32)
    kw = dict(policy="tp_bf16", window=20, softcap=50.0, q_offset=q_offset)
    want = jkops.flash_attention(qj, kj, vj, kv_len=jnp.asarray(lens),
                                 block_table=jnp.asarray(table),
                                 bq=PLAIN_BLOCK,
                                 interpret=True, **kw)
    got = tkops.flash_attention(qt, kt, vt, kv_len=torch.from_numpy(lens),
                                block_table=torch.from_numpy(table), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert flash_attention_cuda.launches == 0


@pytest.mark.parametrize("storage,page,q_offset,window", [
    ("bf16", 16, 64, 50), ("fp8", 16, 32, 20), ("bf16", 64, 64, 50),
    ("f32snap", 64, 96, 70)])
def test_plain_at_the_kernel_tile_matches_pallas(storage, page, q_offset,
                                                 window):
    """The plain version at ``block_k`` = 64 (the tensor-core kernel's key
    tile) over a paged pool, against the Pallas kernel at ``bk`` = 64: a
    page of 64 directly, pages of 16 over the gathered keys (the Pallas
    kernel's paged form is bit-exact to its contiguous form).  The window
    starts off the 64-key grid, so the first key tile is partly masked."""
    bkv, group, d, nk = 2, 2, 32, 128 // page
    sq = 128 - q_offset
    n_pages = bkv * nk + 1
    np_dt, jsrc, tsrc, sfmt = STORAGE[storage]
    q_dt = np.float32 if storage == "f32snap" else ml_dtypes.bfloat16
    rs = np.random.RandomState(21)
    qj, qt = _both(rs.randn(bkv * group, sq, d), q_dt)
    kj, kt = _both(rs.randn(n_pages, page, d), np_dt)
    vj, vt = _both(rs.randn(n_pages, page, d), np_dt)
    table = rs.permutation(n_pages)[:bkv * nk].reshape(bkv, nk)
    table = table.astype(np.int32)
    kvl = np.repeat(q_offset + np.asarray([sq, 29]), group).astype(np.int32)
    assert (q_offset - window + 1) % 64
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=window,
              softcap=50.0, q_offset=q_offset, src_fmt_name=sfmt)
    if page == 64:
        want = flash_attention_pallas(qj, kj, vj, jnp.asarray(kvl),
                                      jnp.asarray(table), bq=PLAIN_BLOCK,
                                      bk=64, src_dtype=jsrc, interpret=True,
                                      **kw)
    else:
        kg = jnp.asarray(np.asarray(kj)[table].reshape(bkv, nk * page, d))
        vg = jnp.asarray(np.asarray(vj)[table].reshape(bkv, nk * page, d))
        want = flash_attention_pallas(qj, kg, vg, jnp.asarray(kvl),
                                      bq=PLAIN_BLOCK, bk=64, src_dtype=jsrc,
                                      interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                torch.from_numpy(table), src_dtype=tsrc,
                                block_k=64, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_plain_block_k_on_contiguous_keys_matches_pallas():
    """Contiguous K/V whose length is not a multiple of the 64-key block:
    the plain version pads the keys (past every ``kv_len``) and walks the
    Pallas kernel's blocks."""
    bh, group, d, skv, q_offset = 4, 2, 32, 160, 32
    sq = skv - q_offset
    rs = np.random.RandomState(22)
    qj, qt = _both(rs.randn(bh, sq, d), ml_dtypes.bfloat16)
    kj, kt = _both(rs.randn(bh // group, skv, d), ml_dtypes.bfloat16)
    vj, vt = _both(rs.randn(bh // group, skv, d), ml_dtypes.bfloat16)
    kvl = np.asarray([160, 160, 100, 100], np.int32)
    kw = dict(group=group, scale=d ** -0.5, causal=True, window=90,
              softcap=None, q_offset=q_offset, src_fmt_name=None)
    pad = ((0, 0), (0, 32), (0, 0))
    want = flash_attention_pallas(
        qj, jnp.pad(kj, pad), jnp.pad(vj, pad), jnp.asarray(kvl),
        bq=PLAIN_BLOCK, bk=64, src_dtype=jnp.bfloat16, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, torch.from_numpy(kvl),
                                src_dtype=torch.bfloat16, block_k=64, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
