"""The port's IEEE flag telemetry against the JAX package's.

  * ``kernels.quant_common.quantize_flag_masks`` / ``widen_with_flags``:
    bit for bit in value and mask, over every f32 reachable from a 16-bit
    pattern, for fp8, fp16 and fp16alt in both overflow modes.
  * The plain decode and flash versions with ``debug_visits`` /
    ``debug_flags`` against ``decode_attention_pallas`` /
    ``flash_attention_pallas`` in interpret mode, at the port's blocking
    (decode: cells of a page, or of 64 keys for a strip; flash: the
    ``flash_tc`` tiles, 64 keys): flag cells EXACTLY equal, visits equal
    with no window and, with one, JAX's map with the cells wholly left of
    the window set to 0.  Ragged ``kv_len`` (0 included), scrambled and
    aliased page tables, Inf / NaN in dead slots, a window and
    ``q_offset > 0``.
  * ``kernels.ops.*(return_flags=True)``: JAX's per-sequence [B, 4] counts,
    and the attention output bitwise the flags-off one.

Inputs carry no f32 subnormals (XLA on the CPU flushes them in float
ops); both sides count in integer space.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.formats import get_format as jget_format  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant_common as jq  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import quant_common as tq  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (STRIP_UNIT,  # noqa: E402
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, kernel_tiles)
from repro_torch.models.convert import _to_torch  # noqa: E402

torch.set_num_threads(1)
F32 = np.float32


def _sweep():
    """Every fp16 bit pattern upcast, plus f32 values at fp8 / fp16 /
    bf16 overflow edges and one far beyond."""
    xs = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(F32)
    extra = F32([57344, 61439, 61440, 65504, 65519, 65520, 3.3895e38,
                 3.4e38, -1e30, 1e-6, -2.0 ** -14 * 0.999])
    return np.concatenate([xs, extra])


@pytest.mark.parametrize("fmt", ["fp8", "fp16", "fp16alt"])
@pytest.mark.parametrize("saturate", [False, True])
def test_quantize_flag_masks_bitwise(fmt, saturate):
    xs = _sweep()
    want = jq.quantize_flag_masks(jnp.asarray(xs), jget_format(fmt),
                                  saturate=saturate)
    got = tq.quantize_flag_masks(torch.from_numpy(xs), fmt,
                                 saturate=saturate)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    for g, w, name in zip(got[1:], want[1:], ("of", "uf", "nx", "nv")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert bool(got[1].any()) and bool(got[3].any())


@pytest.mark.parametrize("dtype,tdtype", [
    (ml_dtypes.bfloat16, torch.bfloat16), (np.float16, torch.float16),
    (ml_dtypes.float8_e5m2, torch.float8_e5m2), (F32, torch.float32)])
def test_widen_with_flags_native_storage(dtype, tdtype):
    """Native storage (and an f32 container with no grid) reports only the
    stored damage: Inf as OF, NaN as NV."""
    x = np.asarray([0.0, 1.5, -np.inf, np.nan, np.inf, -2.0, 1e-3],
                   F32).astype(dtype)
    want = jq.widen_with_flags(jnp.asarray(x), None, jnp.float32)
    got = tq.widen_with_flags(_to_torch(x, "cpu"), None, torch.float32)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tdtype == _to_torch(x, "cpu").dtype


# ---------------------------------------------------------------------------
# plain decode / flash telemetry vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
def _mixed(shape, seed, lo=-4.0, hi=6.0):
    """Log-uniform magnitudes from 10^lo to 10^hi: OF beyond fp8's 61440,
    UF below 2^-14, NX everywhere (never an f32 subnormal)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(F32)
    return (x * (10.0 ** rs.uniform(lo, hi, size=shape))).astype(F32)


def _pages(x, table, page):
    """Scatter per-row strips [rows, nk * page, D] into a pool through
    ``table`` (aliased entries hold the last writer's page)."""
    rows, _, d = x.shape
    pool = np.zeros((int(table.max()) + 1, page, d), x.dtype)
    for h in range(rows):
        for j in range(table.shape[1]):
            pool[table[h, j]] = x[h, j * page:(j + 1) * page]
    return pool


def _cut_window(visits, kv_len, window, unit):
    """JAX's visit map with the cells wholly left of the window zeroed."""
    v = np.array(visits)
    for h, n in enumerate(kv_len):
        start = max(0, int(n) - window)
        v[h, :start // unit] = 0
    return v


DECODE_CASES = {
    # name: (kv dtype, kv_fmt, q_fmt, src, paged page or None, window)
    "strip_em_fp8": (F32, "fp8", "fp16", "f32", None, None),
    "strip_em_fp8_window": (F32, "fp8", None, "f32", None, 70),
    "paged_bf16": (ml_dtypes.bfloat16, None, None, "bf16", 16, None),
    "paged_em_fp8_window": (F32, "fp8", "fp8", "f32", 16, 40),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_telemetry_matches_pallas(case):
    dtype, kv_fmt, q_fmt, src, page, window = DECODE_CASES[case]
    bh, g, d, smax = 4, 2, 16, 192
    kv_len = np.asarray([0, 1, 101, 192], np.int32)
    q = _mixed((bh, g, d), 1)
    k, v = _mixed((bh, smax, d), 2), _mixed((bh, smax, d), 3)
    if dtype != F32:
        q, k, v = (np.clip(x, -1e4, 1e4) for x in (q, k, v))
    k[2, 40, 3], v[3, 7, 0] = np.inf, np.nan          # live damage
    for h, n in enumerate(kv_len):                      # dead slots
        k[h, n:, 1], v[h, n:, 2] = np.inf, np.nan
    q, k, v = (x.astype(dtype) for x in (q, k, v))
    jsrc, tsrc = {"f32": (jnp.float32, torch.float32),
                  "bf16": (jnp.bfloat16, torch.bfloat16)}[src]
    kw = dict(window=window, kv_fmt_name=kv_fmt, q_fmt_name=q_fmt,
              scale=0.25)
    if page is None:
        unit, table = STRIP_UNIT, None
        jk, jv, tk, tv = k, v, k, v
    else:
        unit = page
        nk = smax // page
        table = np.random.RandomState(4).permutation(bh * nk + 3)[
            :bh * nk].reshape(bh, nk).astype(np.int32)
        table[1, 0] = table[0, 0]                    # an aliased page
        k[1, :page], v[1, :page] = k[0, :page], v[0, :page]
        jk = tk = _pages(k, table, page)
        jv = tv = _pages(v, table, page)
    jout = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv),
        jnp.asarray(kv_len), None if table is None else jnp.asarray(table),
        bk=unit, src_dtype=jsrc, interpret=True, debug_visits=True,
        debug_flags=True, **kw)
    tt = lambda x: _to_torch(x, "cpu")
    out, visits, flags = decode_attention_plain(
        tt(q), tt(tk), tt(tv), torch.from_numpy(kv_len),
        None if table is None else torch.from_numpy(table),
        src_dtype=tsrc, debug_visits=True, debug_flags=True, **kw)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jout[2]))
    want_v = np.asarray(jout[1])
    if window is not None:
        want_v = _cut_window(want_v, kv_len, window, unit)
    np.testing.assert_array_equal(visits.numpy(), want_v)
    assert flags[0].sum() == 0 and visits[0].sum() == 0   # kv_len 0
    assert int(flags[2].sum()) > 0
    # the per-row sums equal the JAX package's oracle (ported), which is
    # schedule-free
    oracle = (ref.decode_flag_counts_ref if table is None else
              lambda q_, k_, v_, **kw_: ref.decode_flag_counts_paged_ref(
                  q_, k_, v_, torch.from_numpy(table), **kw_))
    want = oracle(tt(q), tt(tk), tt(tv), kv_len=torch.from_numpy(kv_len),
                  kv_fmt_name=kv_fmt, q_fmt_name=q_fmt)
    np.testing.assert_array_equal(flags.sum(1).numpy(), want.numpy())
    plain = decode_attention_plain(
        tt(q), tt(tk), tt(tv), torch.from_numpy(kv_len),
        None if table is None else torch.from_numpy(table),
        src_dtype=tsrc, **kw)
    assert torch.equal(plain.view(torch.int32), out.view(torch.int32))


FLASH_CASES = {
    # name: (kv dtype, src_fmt, src, page or None, window, q_offset)
    "strip_em_fp8": (F32, "fp8", "f32", None, None, 0),
    "strip_em_fp8_window_offset": (F32, "fp8", "f32", None, 48, 64),
    "paged_bf16_offset": (ml_dtypes.bfloat16, None, "bf16", 16, None, 32),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_telemetry_matches_pallas(case):
    dtype, fmt, src, page, window, q_offset = FLASH_CASES[case]
    bkv, group, sq, d = 2, 2, 64, 16
    skv = 192
    kv_len = np.repeat(np.asarray([q_offset + 50, skv], np.int32), group)
    q = _mixed((bkv * group, sq, d), 5)
    k, v = _mixed((bkv, skv, d), 6), _mixed((bkv, skv, d), 7)
    if dtype != F32:
        q, k, v = (np.clip(x, -1e4, 1e4) for x in (q, k, v))
    k[1, 100, 0] = np.inf
    k[0, q_offset + 50:, 1], v[0, q_offset + 50:, 2] = np.inf, np.nan
    q, k, v = (x.astype(dtype) for x in (q, k, v))
    jsrc, tsrc = {"f32": (jnp.float32, torch.float32),
                  "bf16": (jnp.bfloat16, torch.bfloat16)}[src]
    # the tiles flash_tc walks at D 64: 64 query rows over the group
    bq, bk = kernel_tiles(tsrc if fmt is None else torch.float32, fmt, sq,
                          bkv, group, 64)
    assert (bq, bk) == (32, 64)
    kw = dict(group=group, scale=0.25, causal=True, window=window,
              q_offset=q_offset, src_fmt_name=fmt)
    jq_, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout = flash_attention_pallas(jq_, jk, jv, jnp.asarray(kv_len), bq=bq,
                                  bk=bk, src_dtype=jsrc, interpret=True,
                                  debug_visits=True, debug_flags=True, **kw)
    tt = lambda x: _to_torch(x, "cpu")
    if page is None:
        args = (tt(q), tt(k), tt(v), torch.from_numpy(kv_len), None)
    else:
        table = np.random.RandomState(8).permutation(2 * skv // page + 2)[
            :2 * skv // page].reshape(2, skv // page).astype(np.int32)
        args = (tt(q), tt(_pages(k, table, page)), tt(_pages(v, table, page)),
                torch.from_numpy(kv_len), torch.from_numpy(table))
    out, visits, flags = flash_attention_plain(
        *args, src_dtype=tsrc, block_k=bk, block_q=bq, debug_visits=True,
        debug_flags=True, **kw)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jout[1]))
    assert int(flags.sum()) > 0 and int(visits.sum()) > 0
    plain = flash_attention_plain(*args, src_dtype=tsrc, block_k=bk, **kw)
    assert torch.equal(plain.view(torch.int32), out.view(torch.int32))
    # the per-row sums equal the JAX package's oracle (ported) walking the
    # same blocks; paged, at key blocks of a page
    want = ref.flash_flag_counts_ref(
        tt(q), tt(k), tt(v), group=group, kv_len=torch.from_numpy(kv_len),
        causal=True, window=window, q_offset=q_offset, src_fmt_name=fmt,
        bq=bq, bk=bk)
    np.testing.assert_array_equal(flags.sum(1).numpy(), want.numpy())
    if page is not None:
        _, by_page = flash_attention_plain(*args, src_dtype=tsrc,
                                           block_k=page, block_q=bq,
                                           debug_flags=True, **kw)
        want = ref.flash_flag_counts_paged_ref(
            tt(q), args[1], args[2], args[4], bq=bq, group=group,
            kv_len=torch.from_numpy(kv_len), causal=True, window=window,
            q_offset=q_offset, src_fmt_name=fmt)
        np.testing.assert_array_equal(by_page.sum(1).numpy(), want.numpy())


# ---------------------------------------------------------------------------
# kernels.ops(return_flags=True) against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["em_fp8_kv8", "tp_bf16"])
def test_ops_return_flags_match_jax(policy):
    if policy == "em_fp8_kv8":
        jpol = jget_policy("em_fp8").replace(kv_fmt=jget_format("fp8"))
        tpol = get_policy("em_fp8").replace(kv_fmt=get_format("fp8"))
        dtype = F32
    else:
        jpol, tpol, dtype = jget_policy("tp_bf16"), get_policy("tp_bf16"), \
            ml_dtypes.bfloat16
    b, h, hkv, d = 2, 4, 2, 16
    lens = np.asarray([33, 128], np.int32)
    q1 = _mixed((b, h, 1, d), 9, hi=4.0)
    qs = _mixed((b, h, 64, d), 10, hi=4.0)
    k, v = _mixed((b, hkv, 128, d), 11), _mixed((b, hkv, 128, d), 12)
    k[0, 1, 5, 2], v[1, 0, 100, 3] = np.inf, np.nan
    q1, qs, k, v = (x.astype(dtype) for x in (q1, qs, k, v))
    tt = lambda x: _to_torch(x, "cpu")
    j = [jnp.asarray(x) for x in (q1, qs, k, v)]
    kvl_j, kvl_t = jnp.asarray(lens), torch.from_numpy(lens)

    jo, jf = jops.decode_attention(j[0], j[2], j[3], kv_len=kvl_j,
                                   policy=jpol, bk=64, interpret=True,
                                   return_flags=True)
    to, tf = kops.decode_attention(tt(q1), tt(k), tt(v), kv_len=kvl_t,
                                   policy=tpol, return_flags=True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.dtype == torch.int32 and int(tf.sum()) > 0
    off = kops.decode_attention(tt(q1), tt(k), tt(v), kv_len=kvl_t,
                                policy=tpol)
    assert torch.equal(off.view(torch.int32), to.view(torch.int32))

    jo, jf = jops.flash_attention(j[1], j[2], j[3], kv_len=kvl_j,
                                  policy=jpol, bq=32, bk=64, interpret=True,
                                  return_flags=True)
    to, tf = kops.flash_attention(tt(qs), tt(k), tt(v), kv_len=kvl_t,
                                  policy=tpol, block_q=32, block_k=64,
                                  return_flags=True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    off = kops.flash_attention(tt(qs), tt(k), tt(v), kv_len=kvl_t,
                               policy=tpol, block_k=64)
    assert torch.equal(off.view(torch.int32), to.view(torch.int32))
