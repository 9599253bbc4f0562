"""The port's transprecision ops (``repro_torch.core.ops``) against the JAX
package's, on the CPU, in both modes.

Bitwise where the result does not depend on an f32 summation order: every
cast (``tp_cast`` in all modes, native casts over the fp16 sweep),
``tp_fma``, ``cast_and_pack`` on each axis, and every operand snap.  The
contractions sum in f32 in another order (XLA against torch), so their raw
sums are held within ``rtol 1e-5``; after an out-format snap two such sums
may round to neighbouring grid points, so snapped results are held within
one ulp of the out format — and bitwise where all sums are exact (small
integer operands).  The elementwise functions (``exp``, ``tanh``...) differ
by a few f32 ulps between the two libraries: ``rtol 1e-5``, or one ulp of
``elem_fmt`` after its snap.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import softfloat as jsf  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import softfloat as tsf  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
MODES = ["rne", "rtz", "rdn", "rup", "rmm"]


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(F32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(y):
    """A torch or JAX result as f32 numpy (narrow dtypes widen exactly)."""
    if isinstance(y, torch.Tensor):
        return y.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


def _bits_equal(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(got)
    np.testing.assert_array_equal(got[m].view(np.uint32),
                                  want[m].view(np.uint32))


def _within_ulp(got, want, fmt):
    """|got - want| <= one ulp of ``fmt`` at the larger magnitude."""
    got, want = _np(got), _np(want)
    m = get_format(fmt).m_bits
    mag = np.maximum(np.abs(got), np.abs(want))
    _, e = np.frexp(mag)
    ulp = np.ldexp(1.0, e - 1 - m)
    assert np.all(np.abs(got - want) <= ulp)


def _custom(name, src, acc, out):
    """The same ad-hoc matmul policy in both packages."""
    jp = jpolicy.PRESETS[name].replace(matmul=jpolicy.MatmulPolicy(
        jpolicy.get_format(src), jpolicy.get_format(acc),
        jpolicy.get_format(out)))
    tp = tpolicy.PRESETS[name].replace(matmul=tpolicy.MatmulPolicy(
        get_format(src), get_format(acc), get_format(out)))
    return jp, tp


# ---------------------------------------------------------------------------
# tp_cast
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", ["fp8", "fp16alt", "fp8_e4m3"])
def test_tp_cast_emulate_vs_jax(fmt, mode):
    xs = np.concatenate([rnd(512, seed=1, scale=30.0),
                         rnd(128, seed=2, scale=1e-4)])
    want = jops.tp_cast(jnp.asarray(xs), fmt, "em_fp8", rounding=mode)
    got = tops.tp_cast(_t(xs), fmt, "em_fp8", rounding=mode)
    _bits_equal(got, want)
    want = jops.tp_cast(jnp.asarray(xs), fmt, "em_fp8", rounding=mode,
                        saturate=True)
    got = tops.tp_cast(_t(xs), fmt, "em_fp8", rounding=mode, saturate=True)
    _bits_equal(got, want)


def _cast_inputs():
    """The fp16 sweep (subnormals, Inf, NaN) and seeded f32 values around
    the fp8 e5m2 grid's edges: its subnormals, its overflow tie 61440 and
    beyond, and exact ties."""
    sweep = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(F32)
    rs = np.random.RandomState(4)
    edges = np.asarray([57344.0, 61439.0, 61440.0, 61441.0, 65504.0, 1e6,
                        2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -17, 2.0 ** -14,
                        1.125, 1.375, 2.0 ** -126, 1e-40], F32)
    return np.concatenate([sweep, rs.randn(4096).astype(F32)
                           * F32(2.0) ** rs.randint(-30, 18, 4096)
                           .astype(F32), edges, -edges])


@pytest.mark.parametrize("fmt", ["fp8", "fp16", "fp16alt"])
def test_native_casts_round_like_jax(fmt):
    """``.to(torch.float8_e5m2)`` / bf16 / fp16 round as the ml_dtypes
    casts of the JAX package do — RNE with subnormals, overflow to Inf —
    which is also the port's softfloat RNE snap."""
    xs = _cast_inputs()
    got = tops.tp_cast(_t(xs), fmt)
    assert got.dtype == get_format(fmt).native_dtype
    _bits_equal(got, jops.tp_cast(jnp.asarray(xs), fmt))
    _bits_equal(got, tsf.quantize(_t(xs), fmt))


def test_native_stochastic_cast_lands_on_neighbours():
    xs = rnd(1024, seed=5, scale=4.0)
    g = torch.Generator().manual_seed(1)
    got = tops.tp_cast(_t(xs), "fp8", rounding="stochastic", generator=g)
    assert got.dtype == torch.float8_e5m2
    lo = tsf.quantize(_t(xs), "fp8", "rdn")
    hi = tsf.quantize(_t(xs), "fp8", "rup")
    f = got.float()
    assert torch.all((f == lo) | (f == hi))
    assert (f == hi).any() and (f == lo).any()


# ---------------------------------------------------------------------------
# tp_fma, tp_einsum / tp_matmul, quantize_ste
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["em_fp16", "em_fp8", "acc_fp16",
                                    "tp_bf16"])
def test_tp_fma_bitwise_vs_jax(policy):
    if policy == "acc_fp16":
        jp, tp = _custom("em_fp8", "fp8", "fp16", "fp16")
    else:
        jp = tp = policy
    a, b, c = (rnd(256, seed=s) for s in (6, 7, 8))
    want = jops.tp_fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jp)
    got = tops.tp_fma(_t(a), _t(b), _t(c), tp)
    _bits_equal(got, want)


@pytest.mark.parametrize("policy", ["em_fp16", "em_fp8", "acc_fp16"])
def test_tp_einsum_emulate_vs_jax(policy):
    if policy == "acc_fp16":
        jp, tp = _custom("em_fp8", "fp8", "fp16", "fp16")
    else:
        jp = tp = policy
    a, b = rnd(2, 9, 48, seed=9), rnd(48, 20, seed=10)
    src = tpolicy.get_policy(tp).matmul.src_fmt
    # the operand snaps are bitwise
    _bits_equal(tops.quantize_ste(_t(a), src), jops.quantize_ste(
        jnp.asarray(a), jpolicy.get_policy(jp).matmul.src_fmt))
    spec = "bsd,de->bse"
    raw_t = tops.tp_einsum(spec, _t(a), _t(b), tp, out_fmt="fp32")
    raw_j = jops.tp_einsum(spec, jnp.asarray(a), jnp.asarray(b), jp,
                           out_fmt="fp32")
    if policy == "acc_fp16":     # the acc snap to fp16 applies here too
        _within_ulp(raw_t, raw_j, "fp16")
    else:
        np.testing.assert_allclose(_np(raw_t), _np(raw_j), rtol=1e-5,
                                   atol=1e-6)
    got = tops.tp_einsum(spec, _t(a), _t(b), tp)
    want = jops.tp_einsum(spec, jnp.asarray(a), jnp.asarray(b), jp)
    _within_ulp(got, want, "fp16")
    got_mm = tops.tp_matmul(_t(a), _t(b), tp)
    _within_ulp(got_mm, jops.tp_matmul(jnp.asarray(a), jnp.asarray(b), jp),
                "fp16")
    # small integers: every sum is exact, so the snapped results are bitwise
    ai = np.random.RandomState(11).randint(-6, 7, (5, 32)).astype(F32)
    bi = np.random.RandomState(12).randint(-6, 7, (32, 7)).astype(F32)
    _bits_equal(tops.tp_matmul(_t(ai), _t(bi), tp),
                jops.tp_matmul(jnp.asarray(ai), jnp.asarray(bi), jp))


def test_tp_matmul_kernel_route_skips_the_out_snap_like_jax():
    """``use_kernel=True`` mirrors JAX's ``use_pallas=True``: f32 result,
    no out-format snap — unlike the einsum route under the same policy."""
    a, b = rnd(2, 50, 100, seed=13), rnd(100, 70, seed=14)
    got = tops.tp_matmul(_t(a), _t(b), "em_fp8", use_kernel=True)
    want = jops.tp_matmul(jnp.asarray(a), jnp.asarray(b), "em_fp8",
                          use_pallas=True)
    assert got.shape == (2, 50, 70) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    einsum = tops.tp_matmul(_t(a), _t(b), "em_fp8")
    snapped = tsf.quantize(got, "fp16")
    assert not torch.equal(got, snapped)             # not on the fp16 grid
    _within_ulp(einsum, snapped, "fp16")


def test_quantize_ste_gradient_matches_jax():
    a, b = rnd(6, 16, seed=15), rnd(16, 5, seed=16)
    w = rnd(6, 5, seed=17)
    x = _t(a).requires_grad_(True)
    y = tops.quantize_ste(x, "fp8")
    _bits_equal(y, jsf.quantize(jnp.asarray(a), "fp8"))
    (y.sum() * 2).backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))   # straight through
    # through an emulate contraction: the same gradient as JAX's
    x = _t(a).requires_grad_(True)
    (tops.tp_einsum("ij,jk->ik", x, _t(b), "em_fp8") * _t(w)).sum().backward()
    gj = jax.grad(lambda t: (jops.tp_einsum("ij,jk->ik", t, jnp.asarray(b),
                                            "em_fp8") * w).sum())(
        jnp.asarray(a))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    # an identity snap (the grid covers f32) still passes the gradient
    x = _t(a).requires_grad_(True)
    tops.quantize_ste(x, "fp32").sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


# ---------------------------------------------------------------------------
# cast_and_pack, tp_elementwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("policy", ["em_fp8", "tp_bf16", None])
def test_cast_and_pack_axes_bitwise_vs_jax(axis, policy):
    a, b = rnd(3, 4, 5, seed=18, scale=8.0), rnd(3, 4, 5, seed=19, scale=8.0)
    fmt = "fp16alt" if policy == "tp_bf16" else "fp8"
    want = jops.cast_and_pack(jnp.asarray(a), jnp.asarray(b), fmt, policy,
                              axis=axis)
    got = tops.cast_and_pack(_t(a), _t(b), fmt, policy, axis=axis)
    assert tuple(got.shape) == tuple(want.shape)
    _bits_equal(got, want)
    # the interleave: a's slices at even indices, b's at odd ones
    ax = axis % 3
    evens = torch.index_select(got, ax, torch.arange(0, got.shape[ax], 2))
    _bits_equal(evens, tops.tp_cast(_t(a), fmt, policy))


ELEM = ["exp", "log", "rsqrt", "sqrt", "div", "recip", "tanh", "silu",
        "gelu", "sigmoid"]


@pytest.mark.parametrize("elem_fmt", ["fp32", "fp16"])
@pytest.mark.parametrize("fn", ELEM)
def test_tp_elementwise_emulate_vs_jax(fn, elem_fmt):
    jp = jpolicy.PRESETS["em_fp16"].replace(
        elem_fmt=jpolicy.get_format(elem_fmt))
    tp = tpolicy.PRESETS["em_fp16"].replace(elem_fmt=get_format(elem_fmt))
    x = np.abs(rnd(300, seed=20, scale=3.0)) + F32(0.05)
    args = (x, x[::-1].copy()) if fn == "div" else (x,)
    want = jops.tp_elementwise(fn, *[jnp.asarray(v) for v in args],
                               policy=jp)
    got = tops.tp_elementwise(fn, *[_t(v) for v in args], policy=tp)
    if elem_fmt == "fp32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=0)
    else:
        _within_ulp(got, want, elem_fmt)
    # with an out snap
    got = tops.tp_elementwise(fn, *[_t(v) for v in args], policy=tp,
                              out_fmt="fp8")
    want = jops.tp_elementwise(fn, *[jnp.asarray(v) for v in args],
                               policy=jp, out_fmt="fp8")
    _within_ulp(got, want, "fp8")


def test_emulate_storage_is_f32():
    for name in ("em_fp16", "em_fp8"):
        t, j = tpolicy.PRESETS[name], jpolicy.PRESETS[name]
        assert tops.storage_dtype(t.param_fmt, t.mode) == torch.float32
        assert jops.storage_dtype(j.param_fmt, j.mode) == jnp.float32
