"""The decode kernel's plain version (what the CUDA kernel is held against on
the card) against the JAX package's ``decode_attention_pallas`` in
interpret mode and its blocked oracle ``ref.decode_attention_ref(bk=)``.

Inputs are made once with numpy from a seed and handed to both frameworks
in the same storage dtype.  Both sides multiply in the src dtype, sum in
f32 and round p to the src dtype before p.V; they differ only in f32
summation order, so the f32 outputs agree to ``ATOL``/``RTOL`` = 1e-5.
The CUDA kernel itself is compared with this plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
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
    decode_attention_cuda, decode_attention_plain)
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
