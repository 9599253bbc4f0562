"""The port's softfloat (``repro_torch.core.softfloat``) against the JAX
package's, BITWISE in value and in all four IEEE flags.

Inputs: every fp16 bit pattern widened to f32 (normals, subnormals, both
zeros, Inf, NaN) plus seeded f32 values at every binade — container
subnormals, exact ties of each format's grid, and values past max normal.
Every listed format x the five deterministic modes x ``saturate``.  One
f64-container format is held against JAX run in a child process with
``JAX_ENABLE_X64=1``.  Stochastic mode cannot match JAX's threefry bits, so
it is held by properties: on the grid, on one of the two neighbours, and
unbiased.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import softfloat as jsf  # noqa: E402
from repro_torch.core import softfloat as tsf  # noqa: E402
from repro_torch.core.formats import get_format  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
FORMATS = ["fp16", "fp16alt", "fp8", "fp8_e4m3", "tf32", "fp6_e3m2", (3, 4),
           (6, 1)]
MODES = ["rne", "rtz", "rdn", "rup", "rmm"]


def _sweep16():
    """Every f32 value reachable from a 16-bit pattern."""
    return np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(F32)


def _ties(fmt):
    """Exact midpoints between neighbours of ``fmt``'s grid (normal and
    subnormal), both signs, over a few binades at each end of the range."""
    f = get_format(fmt)
    out = []
    for e in list(range(f.emin - 2, f.emin + 3)) + [f.emax - 1, f.emax]:
        step = 2.0 ** (max(e, f.emin) - f.m_bits)
        for k in (1, 2, 3, (1 << f.m_bits) - 1):
            v = 2.0 ** e + (k + 0.5) * step if e >= f.emin \
                else (k + 0.5) * step
            out += [v, -v]
    out += [f.max_normal + 2.0 ** (f.emax - f.m_bits - 1),   # overflow tie
            f.max_normal * 1.5, -f.max_normal * 1.5]
    with np.errstate(over="ignore"):
        return np.asarray(out, np.float64).astype(F32)


def _inputs(fmt):
    rs = np.random.RandomState(0)
    scaled = (rs.randn(4096) * 2.0 ** rs.randint(-150, 129, 4096))
    with np.errstate(over="ignore"):
        scaled = scaled.astype(F32)
    csub = (rs.randint(1, 1 << 23, 256).astype(np.uint32)
            | (rs.randint(0, 2, 256).astype(np.uint32) << 31)).view(F32)
    return np.concatenate([_sweep16(), scaled, csub, _ties(fmt)])


def _bits(y):
    return np.asarray(y).view(np.uint32 if np.asarray(y).dtype == F32
                              else np.uint64)


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_quantize_with_flags_bitwise_vs_jax(fmt, mode, saturate):
    xs = _inputs(fmt)
    want, wfl = jsf.quantize_with_flags(jnp.asarray(xs), fmt, mode,
                                        saturate=saturate)
    got, gfl = tsf.quantize_with_flags(torch.from_numpy(xs.copy()), fmt,
                                       mode, saturate=saturate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for name in tsf.FLAG_NAMES:
        np.testing.assert_array_equal(gfl[name].numpy(),
                                      np.asarray(wfl[name]), err_msg=name)
    # quantize is quantize_with_flags without the flags
    np.testing.assert_array_equal(
        _bits(tsf.quantize(torch.from_numpy(xs.copy()), fmt, mode,
                           saturate=saturate).numpy()), _bits(want))


#: a format whose container is f64 (p = 13 > 11): the port's f64 path
F64_FMT = (4, 12)

_X64_CHILD = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import softfloat
xs = np.load(sys.argv[1])
out = {}
for mode in %(modes)r:
    for sat in (False, True):
        y, fl = softfloat.quantize_with_flags(jnp.asarray(xs), %(fmt)r, mode,
                                              saturate=sat)
        out[f"{mode}-{sat}"] = [np.asarray(y).view(np.uint64).tolist()] + [
            np.asarray(fl[k]).tolist() for k in softfloat.FLAG_NAMES]
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def x64_reference(tmp_path_factory):
    """JAX softfloat under ``JAX_ENABLE_X64=1`` (its own process: x64 is a
    process-wide switch) on the f64-container format."""
    d = tmp_path_factory.mktemp("x64")
    xs = _inputs(F64_FMT)
    np.save(d / "xs.npy", xs)
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu"}
    code = _X64_CHILD % {"modes": MODES, "fmt": F64_FMT}
    r = subprocess.run([sys.executable, "-c", code, str(d / "xs.npy"),
                        str(d / "out.json")], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return xs, json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_f64_container_bitwise_vs_jax_x64(x64_reference, mode, saturate):
    xs, ref = x64_reference
    assert get_format(F64_FMT).container_dtype() == torch.float64
    got, gfl = tsf.quantize_with_flags(torch.from_numpy(xs.copy()), F64_FMT,
                                       mode, saturate=saturate)
    assert got.dtype == torch.float64
    want = ref[f"{mode}-{saturate}"]
    # XLA on the CPU flushes f32 subnormals in the f32 -> f64 convert, so
    # JAX sees 0 for them; the port sees the value.  Those inputs are held
    # to IEEE instead: tiny and inexact (UF and NX), rounded to zero of
    # their sign or, away from zero in a directed mode, to the target's
    # min subnormal.
    csub = (xs != 0) & (np.abs(xs) < np.finfo(F32).tiny)
    assert csub.sum() > 100
    np.testing.assert_array_equal(got.numpy().view(np.uint64)[~csub],
                                  np.asarray(want[0], np.uint64)[~csub])
    for i, name in enumerate(tsf.FLAG_NAMES):
        np.testing.assert_array_equal(gfl[name].numpy()[~csub],
                                      np.asarray(want[1 + i])[~csub],
                                      err_msg=name)
    tiny = xs[csub].astype(np.float64)
    step = get_format(F64_FMT).min_subnormal
    away = {"rup": tiny > 0, "rdn": tiny < 0}.get(mode, np.zeros_like(tiny,
                                                                      bool))
    ieee = np.where(away, np.copysign(step, tiny), np.copysign(0.0, tiny))
    np.testing.assert_array_equal(got.numpy()[csub].view(np.uint64),
                                  ieee.view(np.uint64))
    assert gfl["uf"].numpy()[csub].all() and gfl["nx"].numpy()[csub].all()
    assert not (gfl["of"].numpy()[csub] | gfl["nv"].numpy()[csub]).any()


def test_identity_fast_paths_match_jax():
    xs = np.random.RandomState(3).randn(64).astype(F32)
    # target grid covers the input's: the input comes back as it is
    bf = torch.from_numpy(xs).to(torch.bfloat16)
    assert tsf.quantize(bf, "fp32") is bf
    y, fl = tsf.quantize_with_flags(torch.from_numpy(xs), "fp64")
    assert y.dtype == torch.float32 and not fl["nx"].any()
    # fp16 input onto fp8: through the f32 container, as in JAX
    h = xs.astype(np.float16)
    got = tsf.quantize(torch.from_numpy(h), "fp8")
    want = jsf.quantize(jnp.asarray(h), "fp8")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # integers are floats first
    np.testing.assert_array_equal(
        tsf.quantize(torch.arange(-40, 40), "fp8").numpy(),
        np.asarray(jsf.quantize(jnp.arange(-40, 40), "fp8")))


def test_flags_of_nan_input_on_fast_path():
    x = torch.tensor([float("nan"), 1.0])
    _, fl = tsf.quantize_with_flags(x, "fp32")
    assert fl["nv"].tolist() == [True, False]
    with pytest.raises(ValueError, match="stochastic"):
        tsf.quantize(x, "fp8", "stochastic")
    with pytest.raises(ValueError, match="rounding mode"):
        tsf.quantize(x, "fp8", "nearest")


# ---------------------------------------------------------------------------
# stochastic rounding: properties (the JAX package's own, with a Generator)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["fp16", "fp8", "fp8_e4m3"])
def test_stochastic_lands_on_neighbours(fmt):
    f = get_format(fmt)
    rs = np.random.RandomState(1)
    # uniform values, plus values in the target-subnormal region
    xs = np.concatenate([rs.uniform(-8, 8, 512),
                         rs.uniform(-1, 1, 256) * f.min_normal]).astype(F32)
    x = torch.from_numpy(xs)
    lo = tsf.quantize(x, fmt, "rdn")
    hi = tsf.quantize(x, fmt, "rup")
    got = tsf.quantize(x, fmt, "stochastic",
                       generator=torch.Generator().manual_seed(0))
    assert torch.all((got == lo) | (got == hi))
    assert torch.equal(tsf.quantize(got, fmt, "rne"), got)   # on the grid
    # and the deterministic neighbours agree with JAX
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(jsf.quantize(xs, fmt, "rdn")))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(jsf.quantize(xs, fmt, "rup")))


@pytest.mark.parametrize("x_in_ulps", [0.3, 0.75])
def test_stochastic_unbiased(x_in_ulps):
    fmt = get_format("fp8")
    x = F32(1.0 + x_in_ulps * fmt.eps)  # strictly between two grid points
    n = 4000
    vals = tsf.quantize(torch.full((n,), float(x)), fmt, "stochastic",
                        generator=torch.Generator().manual_seed(42))
    mean = vals.double().mean().item()
    # E[q] = x; tolerance ~4 sigma of Bernoulli(p) * ulp / sqrt(n)
    assert abs(mean - float(x)) < 4 * fmt.eps * 0.5 / math.sqrt(n)


def test_stochastic_unbiased_in_the_subnormal_region():
    fmt = get_format("fp8")
    step = fmt.min_subnormal
    x = F32(5.25 * step)
    n = 4000
    vals = tsf.quantize(torch.full((n,), float(x)), fmt, "stochastic",
                        generator=torch.Generator().manual_seed(7))
    assert set(vals.unique().tolist()) <= {5 * step, 6 * step}
    assert abs(vals.double().mean().item() - float(x)) \
        < 4 * step * 0.5 / math.sqrt(n)
