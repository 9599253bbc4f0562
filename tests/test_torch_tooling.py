"""The port's tooling against the JAX package's, on the CPU:

  * ``ModelConfig.param_counts`` equals JAX's exactly (integers) for every
    config, full and reduced;
  * ``core.energy``'s silicon tables and functions equal JAX's, the H100
    rows are finite and ordered by format width, and ``step_energy_joules``
    refuses link bytes;
  * ``core.hw`` holds the H100's figures under JAX's names;
  * ``windowed_slice`` on reduced gemma2 under ``fp32``: the port's sliced
    prefill and training loss match JAX's sliced path and the port's own
    unsliced path (``rtol 1e-5, atol 1e-5`` on logits, the tolerance of
    JAX's own knob test, and ``rtol 1e-6`` on the loss), with fewer
    counted FLOPs than the unsliced path;
  * ``train.serve_step.serve_shardings`` on a dry ``(1, 2)`` mesh: the
    parameter specs equal JAX's ``param_specs`` leaf for leaf where the
    heads split whole over ``model`` (elsewhere the attention projections
    are replicated), and the cache specs equal JAX's for GQA archs whose
    heads split; MLA's and the recurrent caches, and GQA caches whose heads
    do not split, are whole on the model axis (JAX splits them).
"""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import hw as jhw  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import sharding as jshard  # noqa: E402
from repro.models.transformer import init_caches as jinit_caches  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.attention import _head_shard_size  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.sharding import ATTN_LEAVES  # noqa: E402
from repro_torch.train.serve_step import serve_shardings  # noqa: E402

torch.set_num_threads(1)

FMTS = ("fp64", "fp32", "fp16", "fp16alt", "fp8")


# ---------------------------------------------------------------------------
# param_counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_param_counts_match_jax(arch, reduced):
    want = jreg.get_config(treg.ALIASES.get(arch, arch),
                           reduced=reduced).param_counts()
    got = treg.get_config(arch, reduced=reduced).param_counts()
    assert got == want
    assert all(isinstance(v, int) and v > 0 for v in got.values())


# ---------------------------------------------------------------------------
# energy and hw
# ---------------------------------------------------------------------------
TABLES = ("FMA_PJ_PER_FLOP", "FMA_LANES", "FMA_LATENCY", "NOMINAL_FREQ_HZ",
          "NOMINAL_VDD", "OP_ENERGY_PJ", "CONV_SCALAR_PJ", "CONV_VEC_PJ",
          "CASTPACK_FACTOR", "ARIANE_CORE_OVERHEAD_PJ", "RI5CY_MERGED_PJ",
          "RI5CY_CORE_PJ")


@pytest.mark.parametrize("name", TABLES)
def test_energy_tables_equal_jax(name):
    assert getattr(tenergy, name) == getattr(jenergy, name)


def test_energy_functions_equal_jax():
    for fmt in FMTS:
        for simd in (False, True):
            if (fmt, simd) not in jenergy.FMA_PJ_PER_FLOP:
                continue
            for fn in ("fma_energy_pj", "fma_perf_gflops",
                       "fma_efficiency_gflops_w"):
                assert (getattr(tenergy, fn)(fmt, simd)
                        == getattr(jenergy, fn)(fmt, simd)), (fn, fmt, simd)
        for dst in FMTS:
            if dst != fmt:
                for simd in (False, True):
                    assert (tenergy.conv_energy_pj(fmt, dst, simd)
                            == jenergy.conv_energy_pj(fmt, dst, simd))
    for v in (0.45, 0.6, 0.8, 1.0, 1.2):
        tm, jm = tenergy.DVFSModel(), jenergy.DVFSModel()
        assert tm.f_max(v) == jm.f_max(v)
        assert tm.perf_gflops(v, 4) == jm.perf_gflops(v, 4)
        assert tm.efficiency_gflops_w(v, 8, 0.8) == \
            jm.efficiency_gflops_w(v, 8, 0.8)
    tc, jc = tenergy.CoreModel(), jenergy.CoreModel()
    for kind in ("lh", "fma", "mul", "add", "cmp", "cvt", "castpack"):
        for simd in (False, True):
            assert (tc.instr_energy(kind, "fp16", simd, system=True)
                    == jc.instr_energy(kind, "fp16", simd, system=True))


def test_h100_rows_and_step_energy():
    pj = tenergy.H100_PJ_PER_FLOP
    assert set(pj) == {"fp32", "fp16", "fp16alt", "fp8"}
    assert all(math.isfinite(v) and v > 0 for v in pj.values())
    # energy proportionality on the card: narrower formats cost less
    assert pj["fp8"] < pj["fp16alt"] < pj["fp32"]
    assert pj["fp8"] < pj["fp16"] < pj["fp32"]
    assert tenergy.H100_PJ_PER_HBM_BYTE > 0 and tenergy.H100_IDLE_W > 0
    assert tenergy.H100_CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    j = tenergy.step_energy_joules({"fp8": 1e12, "fp16alt": 2e12}, 3e9)
    assert j == pytest.approx((pj["fp8"] * 1e12 + pj["fp16alt"] * 2e12
                               + tenergy.H100_PJ_PER_HBM_BYTE * 3e9) * 1e-12)
    # the rows are above idle: the board's idle power is charged once,
    # over the step's time
    assert (tenergy.step_energy_joules({"fp8": 1e12}, 0.0, seconds=0.5)
            == pytest.approx(pj["fp8"] + tenergy.H100_IDLE_W * 0.5))
    with pytest.raises(ValueError, match="no link energy"):
        tenergy.step_energy_joules({"fp8": 1.0}, 0.0, link_bytes=1.0)
    assert not hasattr(tenergy, "TPU_PJ_PER_FLOP")


def test_hw_names_hold_the_h100():
    assert set(thw.PEAK_FLOPS_BY_FMT) == set(jhw.PEAK_FLOPS_BY_FMT)
    assert thw.PEAK_FLOPS_BF16 == 989e12 and thw.peak_flops("fp8") == 1979e12
    assert thw.peak_flops("fp32") == thw.peak_flops("fp64") == 67e12
    assert thw.peak_flops("bf16") == thw.peak_flops("fp16") == 989e12
    assert thw.HBM_BW == 3.35e12 and thw.N_SMS == 132
    assert 79 * 2 ** 30 < thw.HBM_PER_CHIP <= 80 * 2 ** 30
    assert not any(n.startswith(("ICI", "DCN")) for n in dir(thw))


# ---------------------------------------------------------------------------
# windowed_slice
# ---------------------------------------------------------------------------
SEQ, CHUNK = 192, 16


@pytest.fixture(scope="module")
def gemma2_fp32():
    jm = jreg.build_model("gemma2-9b", policy="fp32", reduced=True)
    jp = jm.init(jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jm.cfg.vocab, (2, SEQ)).astype(np.int32)
    labels = rng.randint(0, jm.cfg.vocab, (2, SEQ)).astype(np.int32)
    return jm, jp, tp, toks, labels


def test_windowed_slice_matches_jax_and_unsliced(gemma2_fp32):
    jm, jp, tp, toks, labels = gemma2_fp32
    jopt = dataclasses.replace(jm, cfg=dataclasses.replace(
        jm.cfg, attn_chunk=CHUNK, windowed_slice=True))
    want, _ = jax.jit(lambda p, t: jopt.prefill(p, t, max_len=SEQ))(
        jp, toks)
    base = treg.build_model("gemma2-9b", policy="fp32", reduced=True,
                            device="cpu", attn_chunk=CHUNK,
                            prefill_backend="dense")
    sliced = base.with_cfg(windowed_slice=True)
    tt = torch.from_numpy(toks)
    with torch.no_grad(), FlopCounterMode(display=False) as f1:
        got, _ = sliced.prefill(tp, tt, max_len=SEQ)
    with torch.no_grad(), FlopCounterMode(display=False) as f0:
        ref, _ = base.prefill(tp, tt, max_len=SEQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert f1.get_total_flops() < f0.get_total_flops()

    lt = torch.from_numpy(labels)
    l1 = float(sliced.forward_train(tp, tt, lt, remat=False))
    l0 = float(base.forward_train(tp, tt, lt, remat=False))
    lj = float(jax.jit(lambda p, t, l: jopt.forward_train(
        p, t, l, remat=False))(jp, toks, labels))
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    np.testing.assert_allclose(l1, lj, rtol=1e-6)


# ---------------------------------------------------------------------------
# serve_shardings
# ---------------------------------------------------------------------------
SERVE_ARCHS = ("gemma2-9b", "granite-20b", "qwen3-moe-30b-a3b",
               "minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b", "whisper-small",
               "internvl2-26b")
_FAKE = types.SimpleNamespace(shape={"data": 1, "model": 2},
                              axis_names=("data", "model"))


def _stacked_port_specs(specs, cfg) -> dict:
    """The port's per-layer spec tree in JAX's layout, flattened: pattern
    leaves and encoder layers take the stacking lead."""
    def flat(tree, path, lead=False):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, path + (k,), lead))
            return out
        s = tuple(tree)
        return {path: ((None,) + s if lead and s else s)}

    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    out = {}
    for k, v in specs.items():
        if k == "layers":
            for i in range(n_pre):
                out.update(flat(v[i], ("prefix", i)))
            for j in range(n_pat):
                out.update(flat(v[n_pre + j], ("pattern", j), lead=True))
            for i, s in enumerate(v[n_pre + n_pat * cfg.repeats:]):
                out.update(flat(s, ("suffix", i)))
        elif k == "encoder":
            out.update(flat(v["layers"][0], ("encoder", "layers"), True))
            out.update(flat({kk: vv for kk, vv in v.items()
                             if kk != "layers"}, ("encoder",)))
        else:
            out.update(flat(v, (k,)))
    return out


def _jax_flat(tree, path=()):
    if isinstance(tree, P):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_jax_flat(v, path + (i,)))
        return out
    return {}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_shardings_against_jax(arch):
    import warnings
    jm = jreg.build_model(treg.ALIASES[arch], reduced=True)
    tm = treg.build_model(arch, reduced=True, device="cpu")
    cfg = tm.cfg
    mesh = dryrun.dry_mesh(shape=(1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pshape, pspecs, cshape, cspecs, ba = serve_shardings(
            tm, mesh, batch=4, max_len=32)
        jt = jax.eval_shape(jm.init, jax.random.key(0))
        jp = jshard.param_specs(jt, "model", 2)
    assert ba == ("data",)
    assert all(t.device.type == "meta" for t in
               torch.utils._pytree.tree_leaves(pshape))
    split = _head_shard_size(mesh, cfg.n_heads, cfg.n_kv_heads) is not None
    want, got = _jax_flat(jp), _stacked_port_specs(pspecs, cfg)
    assert set(got) == set(want)
    for path, w in want.items():
        if not split and path[-1] in ATTN_LEAVES and "xattn" not in path \
                and "encoder" not in path:
            assert got[path] == (), path        # unsharded attention
        elif not split and path[-1] in ATTN_LEAVES:
            assert got[path] in (w, ()), path
        else:
            assert got[path] == w, path

    jc = jax.eval_shape(lambda: jinit_caches(jm.cfg, 4, 32, jm.policy))
    jcs = jshard.cache_specs(jm.cfg, jc, batch=4, mesh=_FAKE)
    per_layer = list(jcs.prefix)
    for _ in range(cfg.repeats):
        per_layer += [jax.tree.map(lambda s: P(*tuple(s)[1:]), c,
                                   is_leaf=lambda x: isinstance(x, P))
                      for c in jcs.pattern]
    per_layer += list(jcs.suffix)
    whole_heads = 0
    for spec, c, w in zip(cfg.layer_list(), cspecs, per_layer):
        got_l = [tuple(s) for s in torch.utils._pytree.tree_leaves(
            c, is_leaf=lambda x: isinstance(x, tuple) and not hasattr(
                x, "_fields") and all(e is None or isinstance(e, str)
                                      for e in x))]
        want_l = [tuple(s) for s in jax.tree.leaves(
            w, is_leaf=lambda x: isinstance(x, P))]
        assert len(got_l) == len(want_l)
        for g, wl in zip(got_l, want_l):
            if spec.mixer in ("gqa", "shared_attn") and split:
                assert g == wl
            else:
                # whole on the model axis, the batch split as JAX's
                assert "model" not in g and g[0] == wl[0] == "data"
                whole_heads += "model" in wl
    if cfg.name.startswith(("minicpm3", "zamba2", "xlstm", "granite")):
        assert whole_heads > 0          # JAX splits what the port keeps
