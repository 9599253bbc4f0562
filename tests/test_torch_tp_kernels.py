"""The op path's kernels: each plain version against its Pallas twin (JAX,
interpret mode, on the CPU), and the ``kernels.ops`` wrappers against the
JAX wrappers on ragged shapes.

  * ``quantize_bits`` (the integer stage every kernel shares), quantize and
    cast-and-pack: BITWISE, RNE and stochastic (both sides get the same
    32-bit ``rbits``).
  * tp_matmul with matching ``bk``: within ``rtol = atol = 1e-5`` (XLA and
    torch sum a block's products in another order); a bf16 output within
    one bf16 ulp (two f32 sums one ulp apart can round to neighbours).
  * dotp_ex: within ``rtol 1e-4`` of the Pallas kernel, and within
    ``rtol 1e-5`` of the sequential fmacex oracle.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.policy import PRESETS as JPRESETS  # noqa: E402
from repro.core.formats import get_format as jfmt  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import quant_common as jqc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dotp_ex import dotp_ex_pallas  # noqa: E402
from repro.kernels.tp_matmul import tp_matmul_pallas  # noqa: E402
from repro.kernels.tp_quant import (  # noqa: E402
    cast_and_pack_pallas, tp_quantize_pallas)
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import quant_common as tqc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.dotp_ex import dotp_ex_plain  # noqa: E402
from repro_torch.kernels.tp_matmul import tp_matmul_plain  # noqa: E402
from repro_torch.kernels.tp_quant import (  # noqa: E402
    cast_and_pack_plain, tp_quantize_plain)

torch.set_num_threads(1)

F32 = np.float32
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(F32)


def rbits_u32(shape, seed):
    return np.random.RandomState(seed).randint(
        0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


def _bits_equal(got, want):
    """Bitwise on the f32 view, NaN-aware (a NaN only needs to be NaN)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(got)
    np.testing.assert_array_equal(got[m].view(np.uint32),
                                  want[m].view(np.uint32))


def _snap_inputs(seed, n=4096):
    """f32 values across the snap's regimes: the fp16 sweep (subnormals,
    Inf, NaN, both zeros) and seeded values from 2^-40 to 2^40."""
    sweep = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(F32)
    rs = np.random.RandomState(seed)
    scaled = rs.randn(n).astype(F32) * F32(2.0) ** rs.randint(
        -40, 40, n).astype(F32)
    return np.concatenate([sweep, scaled])


# ---------------------------------------------------------------------------
# quantize_bits, tp_quantize, cast_and_pack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("fmt", ["fp8", "fp16", "fp16alt", "fp8_e4m3",
                                 "tf32"])
def test_quantize_bits_bitwise_vs_jax(fmt, stochastic, saturate):
    xs = _snap_inputs(1)
    rb = rbits_u32(xs.shape, 2)
    want = jqc.quantize_bits(jnp.asarray(xs), jnp.asarray(rb), jfmt(fmt),
                             stochastic, saturate=saturate)
    got = tqc.quantize_bits(_t(xs), _t(rb.view(np.int32)), fmt, stochastic,
                            saturate=saturate)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("fmt", ["fp16", "fp16alt", "fp8", "fp8_e4m3",
                                 "tf32"])
def test_tp_quantize_plain_bitwise_vs_pallas(fmt, stochastic):
    x = rnd(256, 128, seed=7, scale=100.0)
    x[0, :8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 6e-5]
    rb = rbits_u32(x.shape, 3)
    want = tp_quantize_pallas(jnp.asarray(x), jnp.asarray(rb), fmt_name=fmt,
                              stochastic=stochastic)
    got = tp_quantize_plain(_t(x), _t(rb.view(np.int32)), fmt_name=fmt,
                            stochastic=stochastic)
    _bits_equal(got, want)
    if not stochastic:   # the softfloat oracle (gradual underflow + FTZ)
        _bits_equal(tref.tp_quantize_ref(_t(x), fmt_name=fmt), got)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
def test_tp_quantize_plain_out_dtypes_vs_pallas(out_dtype):
    x = rnd(512, 256, seed=8, scale=30.0)
    want = tp_quantize_pallas(jnp.asarray(x), fmt_name="fp16alt",
                              out_dtype=JDT[out_dtype])
    got = tp_quantize_plain(_t(x), fmt_name="fp16alt", out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _bits_equal(got, want)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("fmt", ["fp8", "fp16"])
def test_cast_and_pack_plain_bitwise_vs_pallas(fmt, stochastic):
    a = rnd(256, 128, seed=8, scale=20.0)
    b = rnd(256, 128, seed=9, scale=20.0)
    rb = rbits_u32(a.shape, 4)
    want = cast_and_pack_pallas(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(rb), fmt_name=fmt,
                                stochastic=stochastic)
    got = cast_and_pack_plain(_t(a), _t(b), _t(rb.view(np.int32)),
                              fmt_name=fmt, stochastic=stochastic)
    assert got.shape == (256, 256)
    _bits_equal(got, want)
    if not stochastic:
        _bits_equal(tref.cast_and_pack_ref(_t(a), _t(b), fmt_name=fmt), got)


# ---------------------------------------------------------------------------
# tp_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,block", [
    (128, 128, 128, (128, 128, 128)),
    (256, 512, 128, (128, 256, 128)),
    (128, 384, 256, (64, 128, 128)),
])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float16, torch.float32),
])
def test_tp_matmul_plain_vs_pallas(m, k, n, block, in_dtype, out_dtype):
    a, b = rnd(m, k, seed=1), rnd(k, n, seed=2)
    want = tp_matmul_pallas(jnp.asarray(a, JDT[in_dtype]),
                            jnp.asarray(b, JDT[in_dtype]), block=block,
                            out_dtype=JDT[out_dtype])
    got = tp_matmul_plain(_t(a).to(in_dtype), _t(b).to(in_dtype),
                          out_dtype=out_dtype, bk=block[1])
    assert got.dtype == out_dtype
    if out_dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        g, w = _np(got), _np(want)
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
        assert np.all(np.abs(g - w) <= np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("quant_fmt", ["fp16", "fp16alt", "fp8", "fp8_e4m3"])
def test_tp_matmul_fused_snap_vs_pallas(quant_fmt):
    a, b = rnd(128, 256, seed=3), rnd(256, 128, seed=4)
    want = tp_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                            block=(128, 128, 128), quant_fmt_name=quant_fmt)
    got = tp_matmul_plain(_t(a), _t(b), quant_fmt_name=quant_fmt, bk=128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # the snapped operands are bitwise those of the JAX oracle
    for x in (a, b):
        _bits_equal(tref.tp_quantize_ref(_t(x), fmt_name=quant_fmt),
                    jref.tp_quantize_ref(jnp.asarray(x), fmt_name=quant_fmt))


# ---------------------------------------------------------------------------
# dotp_ex
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1024, 4096, 5000])
@pytest.mark.parametrize("src", [torch.float16, torch.bfloat16])
def test_dotp_ex_plain_vs_pallas(n, src):
    a, b = rnd(n, seed=20, scale=0.5), rnd(n, seed=21, scale=0.5)
    rows = -(-n // 128)
    pad = rows * 128 - n
    a2 = np.pad(a, (0, pad)).reshape(rows, 128)
    b2 = np.pad(b, (0, pad)).reshape(rows, 128)
    br = 8 if rows % 8 == 0 else rows
    lanes_j = dotp_ex_pallas(jnp.asarray(a2), jnp.asarray(b2), block_rows=br,
                             src_dtype=JDT[src])
    lanes_t = dotp_ex_plain(_t(a), _t(b), src_dtype=src)
    assert lanes_t.shape == (1, 128)
    scale = float(np.sum(np.abs(_np(_t(a).to(src)) * _np(_t(b).to(src)))))
    np.testing.assert_allclose(_np(lanes_t), _np(lanes_j), rtol=1e-4,
                               atol=1e-6 * scale)
    pol = "tp_fp16" if src == torch.float16 else "tp_bf16"
    got = float(tkops.dotp_ex(_t(a), _t(b), policy=pol))
    want = float(jkops.dotp_ex(jnp.asarray(a), jnp.asarray(b),
                               policy=JPRESETS[pol]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(
        got, float(tref.dotp_ex_ref(_t(a), _t(b), src_dtype=src)), rtol=1e-4)


def test_dotp_ex_close_to_sequential_paper_semantics():
    n = 2048
    a = rnd(n, seed=22, scale=0.3) + 1.0
    b = rnd(n, seed=23, scale=0.3) + 1.0
    got = float(tkops.dotp_ex(_t(a), _t(b), policy="tp_fp16"))
    seq = tref.dotp_sequential_ref(_t(a), _t(b), src_fmt="fp16",
                                   acc_fmt="fp32")
    np.testing.assert_allclose(got, float(seq), rtol=1e-5)
    # the sequential oracle itself is bitwise the JAX one (one f32 rounding
    # per step, in order)
    want = jref.dotp_sequential_ref(a, b, src_fmt="fp16", acc_fmt="fp32")
    _bits_equal(seq.reshape(1), np.asarray(want).reshape(1))
    # an fp16 accumulator (the paper's fmac.h) rounds every step
    seq16 = tref.dotp_sequential_ref(_t(a[:256]), _t(b[:256]),
                                     src_fmt="fp16", acc_fmt="fp16")
    want16 = jref.dotp_sequential_ref(a[:256], b[:256], src_fmt="fp16",
                                      acc_fmt="fp16")
    _bits_equal(seq16.reshape(1), np.asarray(want16).reshape(1))


# ---------------------------------------------------------------------------
# the kernels.ops wrappers on ragged shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["em_fp16", "em_fp8", "tp_bf16",
                                    "tp_fp8"])
def test_tp_matmul_wrapper_ragged_vs_jax(policy):
    a, b = rnd(2, 50, 100, seed=5), rnd(100, 70, seed=6)
    got = tkops.tp_matmul(_t(a), _t(b), policy=policy)
    want = jkops.tp_matmul(jnp.asarray(a), jnp.asarray(b),
                           policy=JPRESETS[policy])
    assert tuple(got.shape) == tuple(want.shape) == (2, 50, 70)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    g, w = _np(got), _np(want)
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
        assert np.all(np.abs(g - w) <= np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("fmt,out_dtype", [("fp16alt", None),
                                           ("fp8", torch.bfloat16),
                                           ("fp16", torch.float16)])
def test_quantize_and_pack_wrappers_ragged_vs_jax(fmt, out_dtype):
    x, y = rnd(100, 60, seed=10, scale=50.0), rnd(100, 60, seed=11)
    got = tkops.tp_quantize(_t(x), fmt=fmt, out_dtype=out_dtype)
    want = jkops.tp_quantize(jnp.asarray(x), fmt=fmt,
                             out_dtype=JDT.get(out_dtype))
    assert got.dtype == (out_dtype or torch.float32)
    _bits_equal(got, want)
    got = tkops.cast_and_pack(_t(x), _t(y), fmt=fmt)
    want = jkops.cast_and_pack(jnp.asarray(x), jnp.asarray(y), fmt=fmt)
    assert got.shape == (100, 120)
    _bits_equal(got, want)


def test_stochastic_wrappers_land_on_neighbours():
    """JAX's threefry bits cannot be matched: the stochastic wrappers are
    held by the properties (each value is one of its two grid neighbours;
    the generator makes the result reproducible)."""
    x, y = rnd(100, 60, seed=12, scale=5.0), rnd(100, 60, seed=13, scale=5.0)
    from repro_torch.core import softfloat as tsf
    q = tkops.tp_quantize(_t(x), fmt="fp8", stochastic=True,
                          generator=torch.Generator().manual_seed(0))
    again = tkops.tp_quantize(_t(x), fmt="fp8", stochastic=True,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, again)
    for v, got in ((x, q), (y, tkops.cast_and_pack(
            _t(x), _t(y), fmt="fp8", stochastic=True,
            generator=torch.Generator().manual_seed(1))[:, 1::2])):
        lo = tsf.quantize(_t(v), "fp8", "rdn")
        hi = tsf.quantize(_t(v), "fp8", "rup")
        assert torch.all((got == lo) | (got == hi))
    with pytest.raises(ValueError, match="Generator"):
        tkops.tp_quantize(_t(x), fmt="fp8", stochastic=True)
