"""The port's formats, policies, CONV-stage cast and native ops against the
JAX package.

``quantize_rne_bits`` (the grid snap both CUDA kernels carry in
``csrc/quant_common.cuh``) must agree with the JAX one BITWISE over every
upper-16-bit f32 pattern (with the low half at the rounding-relevant
points) plus the fp16 sweep and the specials.  ``FPFormat``/``REGISTRY``
and ``PRESETS`` must match field for field; ``tp_einsum``/``tp_matmul`` in
native mode match the JAX ops on the CPU (both upcast to f32 there).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.kernels import quant_common as jqc  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.kernels import quant_common as tqc  # noqa: E402

torch.set_num_threads(1)

#: low halves around every rounding point of a <= 16-bit-mantissa grid
_LOWS = (0x0000, 0x0001, 0x7FFF, 0x8000, 0x8001, 0xFFFF)


def _sweep_bits() -> np.ndarray:
    """uint32 patterns: every upper 16 bits x the low halves above, the
    fp16 sweep upcast (subnormals, both zeros, Inf, NaN) and specials."""
    hi = np.arange(1 << 16, dtype=np.uint32) << 16
    upper = (hi[:, None] | np.asarray(_LOWS, np.uint32)[None, :]).ravel()
    fp16 = (np.arange(1 << 16, dtype=np.uint16).view(np.float16)
            .astype(np.float32).view(np.uint32))
    specials = np.asarray([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                           0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F7FFFFF,
                           0xFF7FFFFF, 0x00000001, 0x807FFFFF], np.uint32)
    return np.concatenate([upper, fp16, specials])


@pytest.mark.parametrize("fmt", ["fp8", "fp16", "fp16alt", "fp8_e4m3"])
@pytest.mark.parametrize("saturate", [False, True])
def test_quantize_rne_bits_bitwise_vs_jax(fmt, saturate):
    bits = _sweep_bits()
    xs = bits.view(np.float32)
    want = np.asarray(jqc.quantize_rne_bits(jnp.asarray(xs),
                                            jformats.get_format(fmt),
                                            saturate=saturate))
    got = tqc.quantize_rne_bits(torch.from_numpy(xs.copy()), fmt,
                                saturate=saturate).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fmt,src", [("fp8", torch.bfloat16),
                                     ("fp16alt", torch.float32)])
def test_widen_snaps_only_f32_containers(fmt, src):
    xs = np.random.RandomState(0).randn(4096).astype(np.float32)
    snapped = tqc.widen(torch.from_numpy(xs), tformats.get_format(fmt), src)
    want = jqc.widen(jnp.asarray(xs), jformats.get_format(fmt),
                     jnp.bfloat16 if src == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(
        snapped.float().numpy(), np.asarray(want).astype(np.float32))
    # a native narrow tensor widens exactly, no snap
    native = torch.from_numpy(xs).to(torch.bfloat16)
    assert torch.equal(tqc.widen(native, tformats.get_format("fp8"),
                                 torch.float32), native.float())


def test_registry_field_parity():
    assert sorted(tformats.REGISTRY) == sorted(jformats.REGISTRY)
    for name, jf in jformats.REGISTRY.items():
        tf = tformats.REGISTRY[name]
        for attr in ("name", "e_bits", "m_bits", "width", "bias", "emax",
                     "emin", "precision", "max_normal", "min_normal",
                     "min_subnormal", "eps"):
            assert getattr(tf, attr) == getattr(jf, attr), (name, attr)
        assert (tf.native_dtype is None) == (jf.native_dtype is None), name
    natives = {n: f.native_dtype for n, f in tformats.REGISTRY.items()}
    assert natives["fp16"] == torch.float16
    assert natives["fp16alt"] == torch.bfloat16
    assert natives["fp8"] == torch.float8_e5m2
    # IEEE-style e4m3 (Inf, max 240) has no torch twin: float8_e4m3fn is
    # another format and must never stand in for it
    assert natives["fp8_e4m3"] is None
    assert tformats.get_format("fp8_e4m3").max_normal == 240.0


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if hasattr(v, "e_bits"):            # an FPFormat
            v = (v.name, v.e_bits, v.m_bits)
        elif dataclasses.is_dataclass(v):
            v = _fields(v)
        out[f.name] = v
    return out


def test_presets_field_parity():
    assert sorted(tpolicy.PRESETS) == sorted(jpolicy.PRESETS)
    for name, jp in jpolicy.PRESETS.items():
        assert _fields(tpolicy.PRESETS[name]) == _fields(jp), name
    assert ([f.name for f in dataclasses.fields(tpolicy.EscalationPolicy)]
            == [f.name for f in dataclasses.fields(jpolicy.EscalationPolicy)])
    assert (_fields(tpolicy.EscalationPolicy())
            == _fields(jpolicy.EscalationPolicy()))


@pytest.mark.parametrize("policy", ["tp_bf16", "tp_fp16", "fp32"])
def test_native_ops_match_jax_on_cpu(policy):
    rs = np.random.RandomState(1)
    a = rs.randn(3, 5, 64).astype(np.float32)
    b = rs.randn(64, 48).astype(np.float32)
    want = np.asarray(jops.tp_matmul(jnp.asarray(a), jnp.asarray(b), policy)
                      .astype(jnp.float32))
    got = tops.tp_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         policy).float().numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jops.tp_einsum("bsd,de->bse", jnp.asarray(a),
                                     jnp.asarray(b), policy, out_fmt="fp32"))
    got = tops.tp_einsum("bsd,de->bse", torch.from_numpy(a),
                         torch.from_numpy(b), policy, out_fmt="fp32").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    want = np.asarray(jops.tp_elementwise("silu", jnp.asarray(a),
                                          policy=policy))
    got = tops.tp_elementwise("silu", torch.from_numpy(a),
                              policy=policy).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_emulate_mode_is_refused():
    """Emulate mode is ported (``tests/test_torch_tp_ops.py`` holds it
    against JAX); what is still refused is ``narrow_partials``, a sharding
    feature that is not ported."""
    x = torch.ones(2, 2)
    assert torch.equal(tops.tp_matmul(x, x * 1.1, "em_fp16"),
                       torch.full((2, 2), 2.19921875))
    narrow = tpolicy.PRESETS["tp_bf16"].replace(narrow_partials=True)
    with pytest.raises(NotImplementedError, match="narrow_partials"):
        tops.tp_matmul(x, x, narrow)
    with pytest.raises(NotImplementedError, match="narrow_partials"):
        tops.tp_einsum("ij,jk->ik", x, x, narrow)
