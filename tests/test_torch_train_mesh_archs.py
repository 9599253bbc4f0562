"""Training under a mesh for the archs beyond the dense ones: MoE
(qwen3-moe, deepseek-v2-lite: the aux loss by mesh, the expert-parallel
backward), MLA (minicpm3, deepseek), the recurrent mixers (zamba2's
Mamba2, xlstm's mLSTM and sLSTM) and whisper's encoder, in the port
against the JAX package.  Gloo ranks on the CPU (``launch.spmd.spawn``
of ``train.mesh_checks.rank_main``; one module-scoped spawn per world
size, each with a timeout), the reduced configs with JAX's own weights,
under ``fp32``, a global batch of 4 rows of 16 tokens whose rows hold
different counts of masked labels (whisper: seeded frame embeddings).

Every case is one ``make_train_step`` step against JAX's unsharded step
on the whole batch (``make_train_step(mesh=None)``'s math): the loss
within 1e-5, every leaf's gradient, gathered whole, within ``F32_REL`` =
1e-5 relative L2 (xlstm: ``XLSTM_REL``, below), the master after the step
within 1e-4 (relative L2), the ranks' params bitwise each other.  The
MoE aux statistic within 1e-5 of JAX's by mesh:

* ``(2, 1)`` and ``(1, 2)``: JAX's aux over the whole batch (GSPMD routes
  the global batch; one data shard);
* ``(2, 2)``: the mean of JAX's aux over the two half-batches (JAX's
  ``shard_map`` body), and the reference step is JAX's gradient of the
  global mean NLL plus 0.01 times that mean.

MLA (minicpm3, deepseek): JAX's prefill and training rotate every
key's rope part at position 0 (``tests/test_torch_mla.py::
test_jax_prefill_caches_unrotated_rope_keys`` pins that reference
defect), where the port rotates each key at its own position, as JAX's
own decode does.  The JAX references of the MLA archs are therefore
traced with JAX's ``apply_rope`` wrapped (``_keys_at_their_positions``,
in this process only; no JAX file changes) so that the keys take their
positions; everything else is JAX's.

xlstm's gradients: its recurrences amplify rounding, so a leaf's
gradient moves far more than 1e-5 under a change at rounding level: one
ulp up on every weight moves it by up to 1.2e-4 (relative L2,
``pattern[0].attn.b_if``), and the unsharded port sits up to 2e-4 from
JAX on this batch (``tests/test_torch_ssm.py`` reads 1e-5 on its own).
Each xlstm leaf is therefore held to ``SENSITIVITY_X`` = 3 times its own
sensitivity (the one-ulp move, measured here; ``chip_smoke.py`` gates
the recurrent stacks the same way), or ``F32_REL`` where that is larger,
against JAX and against the unsharded port on the same weights and
batch; its master after the step likewise (the one-ulp move of the
master, or 1e-4: the zero-started ``ln`` gain's master is its first
Adam update, ``g / (|g| + eps)``, and reads 2e-4 from JAX unsharded).
A missing sum or an M-fold gradient is off by O(1).

Mutations (``mesh_checks.MUTATIONS``): the expert gradient left M times
over, the recurrent mixers' ``col`` input sum or MLA's head-sharded
latents' sum taken out: some leaf then misses its bound by far.  Also:
qwen3-moe's gradients against JAX's own ``(2, 1)``, ``(1, 2)`` and
``(2, 2)`` mesh gradients (forced host devices in a child process:
GSPMD's global-batch router and its expert-parallel ``shard_map``, whose
expert gradients equal its unsharded ones at ``(1, 2)``); the compressed
sync over ``("pod", "data")`` of a ``(2, 2, 1)`` mesh bitwise JAX's
under RNE (forced host devices in a child process); ZeRO-1 on qwen3-moe
bitwise the whole-state step under AdamW; a qwen3-moe checkpoint from
``(2, 1)`` restored under ``(1, 2)``; ``opt_state_specs`` of the MoE
archs equal to JAX's leaf for leaf; and the card legs' gates
(``chip_smoke.train_mesh_archs_gates``) on the figures of a sound step
and of broken ones.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch.core.tree import leaves, unflatten  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import sharding as tshd  # noqa: E402
from repro_torch.models.convert import (from_jax_state, from_jax_tree,  # noqa: E402
                                       stack_layers)
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import mesh_checks as mc  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

torch.set_num_threads(1)

MOE = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
TP = ("minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b", "whisper-small")
F32_REL = 1e-5
SENSITIVITY_X = 3.0
AUX_TOL = 1e-5
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
SPAWN_S = 400
B, S = 4, 16
LOOP = dict(batch=4, seq=16)
MUTANTS = (("expert_grad_m_times", "qwen3-moe-30b-a3b"),
           ("no_col_input_sum", "zamba2-1.2b"),
           ("no_mla_heads_sum", "minicpm3-4b"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return np.linalg.norm(a - b) / (den if den else 1.0)


def _batch(arch):
    rs = np.random.default_rng(7)
    toks = rs.integers(0, 256, (B, S)).astype(np.int32)
    labels = rs.integers(0, 256, (B, S)).astype(np.int32)
    labels[0, :2] = -1                 # rows 0-1 (data rank 0): 3 masked
    labels[1, :1] = -1
    labels[2, :13] = -1                # rows 2-3 (data rank 1): 20 masked
    labels[3, :7] = -1
    out = {"tokens": toks, "labels": labels}
    enc = treg.get_config(arch, reduced=True).encoder
    if enc is not None:
        out["frontend_embeds"] = rs.standard_normal(
            (B, enc.n_frames, 64)).astype(np.float32)
    return out


def _start(arch):
    jm, jp = cached_model(arch, policy="fp32")
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**OPT),
                                 jget_policy("fp32"))
    return jm, jp, jstate, from_jax_state({"params": _np(jp),
                                           "opt": _np(jstate)}, "cpu")


def _tbatch(arch):
    return {k: torch.from_numpy(v) for k, v in _batch(arch).items()}


@contextlib.contextmanager
def _keys_at_their_positions():
    """JAX's MLA with each rope key rotated at its own position: its
    ``apply_rope`` of the ``[B, S, 1, rope]`` keys against ``[S]``
    positions (which broadcasts and keeps position 0) applied to the
    keys as one head's ``[B, 1, S, rope]`` rows instead."""
    orig = jattention.apply_rope

    def keyed(x, positions, theta=1e4):
        if (x.ndim == 4 and x.shape[2] == 1 and positions.ndim == 1
                and x.shape[1] == positions.shape[0] > 1):
            return orig(x[:, :, 0][:, None], positions, theta)[:, 0][
                :, :, None]
        return orig(x, positions, theta)

    jattention.apply_rope = keyed
    try:
        yield
    finally:
        jattention.apply_rope = orig


def _jax_ref(arch, halves=False):
    mla = bool(treg.get_config(arch, reduced=True).kv_lora)
    with (_keys_at_their_positions() if mla else contextlib.nullcontext()):
        return _jax_ref_traced(arch, halves)


def _jax_ref_traced(arch, halves=False):
    """JAX's step on the whole batch: the loss, every leaf's gradient, the
    master after it and the MoE aux.  ``halves``: the (2, 2) reference,
    the global mean NLL plus 0.01 x the mean of the half-batches' aux."""
    jm, jp, jstate, _ = _start(arch)
    jb = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
    fe = jb.get("frontend_embeds")

    def aux_of(p, sl):
        x = jm.embed(p, jb["tokens"][sl])
        return jm._run_stack(p, x, positions=jnp.arange(S))[2]

    def objective(p):
        if not halves:
            return jm.forward_train(p, jb["tokens"], jb["labels"],
                                    frontend_embeds=fe)
        nll = jm.forward_train(p, jb["tokens"], jb["labels"], aux_coef=0.0)
        return nll + 0.01 * (aux_of(p, slice(0, 2))
                             + aux_of(p, slice(2, 4))) / 2

    loss, grads = jax.jit(jax.value_and_grad(objective))(jp)
    _, s2, _ = jopt.apply_update(jp, grads, jstate, jopt.OptConfig(**OPT),
                                 jget_policy("fp32"))
    out = dict(loss=float(loss),
               grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
               master=[np.asarray(m) for m in jax.tree.leaves(s2["master"])])
    if arch in MOE:
        halves_aux = [float(aux_of(jp, slice(i, i + 2))) for i in (0, 2)]
        out["aux"] = (np.mean(halves_aux) if halves
                      else float(aux_of(jp, slice(0, B))))
    return out


def _step(arch, dims, **kw):
    return (f"{arch}@{dims}", "step",
            dict(dims=dims, arch=arch, state=_start(arch)[3],
                 batch=_tbatch(arch), policy="fp32", opt=OPT, **kw))


def _compress_inputs():
    rs = np.random.default_rng(3)
    g = rs.standard_normal((4, 16, 16)).astype(np.float32)
    g[1] *= 4.0                        # the replicas' scales differ
    g[3] *= 1e-3
    ef = (rs.standard_normal((4, 16, 16)) * 1e-2).astype(np.float32)
    return g, ef


def _moe_state():
    m = treg.build_model(MOE[0], policy="fp32", reduced=True, device="cpu")
    whole = stack_layers(m.init(0), m.cfg)
    return {"params": whole,
            "opt": topt.init_opt_state(whole, topt.OptConfig(**OPT),
                                       m.policy)}


def _plan2(root):
    plan = [_step(a, (1, 2)) for a in MOE + TP]
    plan += [_step(a, (2, 1)) for a in MOE]
    plan += [(f"mutant_{m}", "step", _step(a, (1, 2), mutate=m)[2])
             for m, a in MUTANTS]
    plan += [("zero_moe", "zero",
              dict(dims=(2, 1), state=_moe_state(), policy="fp32", opt=OPT,
                   steps=2, arch=MOE[0], **LOOP)),
             ("elastic_moe", "elastic",
              dict(first=(2, 1), then=(1, 2), root=os.path.join(root, "e"),
                   policy="fp32", opt=OPT, steps=2, more=2, arch=MOE[0],
                   **LOOP))]
    return plan


def _plan4():
    g, ef = _compress_inputs()
    plan = [_step(a, (2, 2)) for a in MOE + TP]
    plan += [(f"compress_{f}", "compress",
              dict(dims=(2, 2, 1), axes=("pod", "data"),
                   grads=torch.from_numpy(g), efs=torch.from_numpy(ef),
                   fmt=f)) for f in ("fp8", "fp16alt")]
    plan.append(("zero_moe", "zero",
                 dict(dims=(2, 2), state=_moe_state(), policy="fp32",
                      opt=OPT, steps=2, arch=MOE[0], **LOOP)))
    return plan


def _spawn(world, plan):
    return spmd.spawn(mc.rank_main, world, backend="gloo", args=(plan,),
                      timeout=SPAWN_S)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds' spawns and JAX's compressed-sync, mesh-gradient and
    xlstm bf16 children, started at once in threads (the JAX references
    are computed meanwhile)."""
    root = str(tmp_path_factory.mktemp("mesh_archs"))
    pool = ThreadPoolExecutor(6)
    futs = dict(w2=pool.submit(_spawn, 2, _plan2(root)),
                w4=pool.submit(_spawn, 4, _plan4()),
                jc=pool.submit(_jax_compress_child,
                               tmp_path_factory.mktemp("gc4")),
                jm=pool.submit(_jax_mesh_child,
                               tmp_path_factory.mktemp("jmesh")),
                xs=pool.submit(_jax_xlstm_child,
                               tmp_path_factory.mktemp("xstrict"), False),
                xe=pool.submit(_jax_xlstm_child,
                               tmp_path_factory.mktemp("xexcess"), True))
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(spawned):
    """JAX's references: the whole-batch step of every arch, the (2, 2)
    one of the MoE archs (computed while the ranks run)."""
    out = {a: _jax_ref(a) for a in MOE + TP}
    out.update({(a, "halves"): _jax_ref(a, halves=True) for a in MOE})
    return out


@pytest.fixture(scope="module")
def world2(spawned):
    return spawned["w2"].result()


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned["w4"].result()


def _ranks(request, dims, name):
    world = request.getfixturevalue("world4" if dims == (2, 2)
                                    else "world2")
    return [r[name] for r in world]


CASES = ([(a, (1, 2)) for a in MOE + TP] + [(a, (2, 1)) for a in MOE]
         + [(a, (2, 2)) for a in MOE + TP])


@pytest.fixture(scope="module")
def xlstm_bounds():
    """Per leaf: ``SENSITIVITY_X`` times the relative move of the
    unsharded port's xlstm gradient when every weight goes one ulp up,
    or ``F32_REL`` where that is larger."""
    m = treg.build_model("xlstm-1.3b", policy="fp32", reduced=True,
                         device="cpu", prefill_backend="dense")
    state = _start("xlstm-1.3b")[3]
    params, batch = state["params"], _tbatch("xlstm-1.3b")
    up = unflatten(params, [torch.nextafter(p, torch.full_like(
        p, float("inf"))) for p in leaves(params)])
    step = tstep.make_train_step(m, topt.OptConfig(**OPT))
    moved = []
    for p in (params, up):
        _, g = tstep.loss_and_grads(m, p, batch)
        st = step(p, state["opt"], batch)[1]
        moved.append((g, leaves(st["master"])))
    (g0, m0), (g1, m1) = moved
    return dict(grads=[max(F32_REL, SENSITIVITY_X * _rel(a, b))
                       for a, b in zip(g1, g0)],
                master=[max(1e-4, SENSITIVITY_X * _rel(a, b))
                        for a, b in zip(m1, m0)])


def _bounds(request, arch, n):
    """``(gradient bounds, master bounds)`` per leaf."""
    if arch == "xlstm-1.3b":
        b = request.getfixturevalue("xlstm_bounds")
        return b["grads"], b["master"]
    return [F32_REL] * n, [1e-4] * n


@pytest.mark.parametrize("arch,dims", CASES)
def test_sharded_step_matches_jax(request, refs, arch, dims):
    ref = refs[(arch, "halves") if arch in MOE and dims == (2, 2)
               else arch]
    bounds, master_bounds = _bounds(request, arch, len(ref["grads"]))
    ranks = _ranks(request, dims, f"{arch}@{dims}")
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) <= 1e-5, (arch, dims)
        assert abs(r["grad_loss"] - ref["loss"]) <= 1e-5
        assert len(r["grads"]) == len(ref["grads"])
        rel = [_rel(got, want) / b for got, want, b in
               zip(r["grads"], ref["grads"], bounds)]
        assert max(rel) < 1.0, (arch, dims, int(np.argmax(rel)), max(rel))
        for got, want, b in zip(r["master"], ref["master"], master_bounds):
            assert _rel(got, want) < b
        if arch in MOE:
            assert abs(r["aux"] - ref["aux"]) <= AUX_TOL, (r["aux"],
                                                           ref["aux"])
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(r["params"], ranks[0]["params"]))


def test_mean_of_shard_aux_is_not_the_global_aux(refs):
    """The (2, 2) aux differs from the whole batch's, so a step taking
    the wrong one fails ``AUX_TOL``."""
    for a in MOE:
        assert abs(refs[(a, "halves")]["aux"] - refs[a]["aux"]) > 10 * AUX_TOL


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
def test_xlstm_sharded_gradients_match_the_unsharded_port(request,
                                                          xlstm_bounds, dims):
    """xlstm against the unsharded port on the same weights and batch:
    the loss within 1e-6, every leaf within its ``xlstm_bounds``."""
    m = treg.build_model("xlstm-1.3b", policy="fp32", reduced=True,
                         device="cpu", prefill_backend="dense")
    loss, grads = tstep.loss_and_grads(m, _start("xlstm-1.3b")[3]["params"],
                                       _tbatch("xlstm-1.3b"))
    for r in _ranks(request, dims, f"xlstm-1.3b@{dims}"):
        assert abs(r["grad_loss"] - float(loss)) <= 1e-6
        for got, want, b in zip(r["grads"], grads, xlstm_bounds["grads"]):
            assert _rel(got, want) < b


def test_xlstm_bf16_gradient_is_jax_without_excess_precision(spawned):
    """Under ``tp_bf16`` the port's xlstm gradient is JAX's jitted one
    with XLA's ``xla_allow_excess_precision`` off (every bf16 intermediate
    rounded, as the port rounds it): within 1e-2 a leaf at chunks 16 and
    8, and its move between the two chunks within a factor 1.5 of JAX's.
    XLA's default keeps fused bf16 intermediates in f32, so JAX's default
    gradient sits nearer the ``fp32`` one: this, not a fault of the port's
    recurrent backward, is the port's larger gap to ``fp32``.  The
    figures are printed (``-s``)."""
    jm, jp = cached_model("xlstm-1.3b", policy="tp_bf16")
    params = from_jax_tree(_np(jp), "cpu")
    port = {}
    for ch in (16, 8):
        m = treg.build_model("xlstm-1.3b", policy="tp_bf16", reduced=True,
                             device="cpu", prefill_backend="dense")
        m = m.with_cfg(mlstm=dataclasses.replace(m.cfg.mlstm, chunk=ch))
        port[ch] = tstep.loss_and_grads(m, params,
                                        _tbatch("xlstm-1.3b"))[1]
    strict, excess = spawned["xs"].result(), spawned["xe"].result()
    n = len(port[16])

    def leaves_of(d, key):
        return [d[f"{key}_{i}"] for i in range(n)]

    def worst(xs, ys):
        return float(max(_rel(x, y) for x, y in zip(xs, ys)))
    fp32 = leaves_of(strict, "fp32_16")
    fig = dict(
        port_vs_strict={ch: worst(port[ch], leaves_of(strict,
                                                       f"tp_bf16_{ch}"))
                        for ch in (16, 8)},
        move_port=worst(port[8], port[16]),
        move_strict=worst(leaves_of(strict, "tp_bf16_8"),
                          leaves_of(strict, "tp_bf16_16")),
        move_excess=worst(leaves_of(excess, "tp_bf16_8"),
                          leaves_of(excess, "tp_bf16_16")),
        to_fp32_port=worst(port[16], fp32),
        to_fp32_strict=worst(leaves_of(strict, "tp_bf16_16"), fp32),
        to_fp32_excess=worst(leaves_of(excess, "tp_bf16_16"), fp32))
    print("xlstm tp_bf16 gradients, worst leaf (relative L2):", fig)
    assert max(fig["port_vs_strict"].values()) < 1e-2, fig
    assert 1 / 1.5 < fig["move_port"] / fig["move_strict"] < 1.5, fig
    assert fig["to_fp32_excess"] < fig["to_fp32_strict"] / 2, fig


@pytest.mark.parametrize("mutant,arch", MUTANTS)
def test_a_mutated_backward_is_caught(world2, refs, mutant, arch):
    """A fault in the backward leaves some leaf's gradient far outside
    its bound, while the loss (a forward quantity) stays."""
    ref = refs[arch]
    for r in (x[f"mutant_{mutant}"] for x in world2):
        assert abs(r["loss"] - ref["loss"]) <= 1e-5
        rel = [_rel(got, want) for got, want in zip(r["grads"],
                                                    ref["grads"])]
        assert max(rel) > 1e-2, (mutant, max(rel))


# ---------------------------------------------------------------------------
# the card's gates
# ---------------------------------------------------------------------------
def _card_ranks(sens=None, **bad):
    """Two ranks' ``card_arch_rank`` returns for one leg at (1, 2), as a
    sound step gives them (``sens``: a recurrent stack's own moves),
    with ``bad``'s figures put in."""
    leaf = dict(grad_rel=[1e-3, 2e-3], update_leaf_rel=[0.05, None],
                update_rel=0.05, loss=2.5, aux=1.25)
    ranks = []
    for r in range(2):
        step = dict(leaf, ms=1.0, setup_s=0.0, compare_s=0.0,
                    spmd=dict(collectives=4, staged_bytes=8,
                              wire_bytes={}),
                    state_bytes=16, param_bytes=4)
        step.update(bad.get(f"rank{r}", {}))
        if r == 0:
            step.update({k: v for k, v in bad.items()
                         if not k.startswith("rank")})
        unsharded = dict(loss=2.5, aux=1.25, ms=1.0, seconds=0.0,
                         parts_s=[0.0])
        if sens is not None:
            unsharded.update(grad_sens=[sens, sens],
                             update_sens=[sens, sens],
                             update_sens_whole=sens)
        ranks.append({"x": dict(unsharded=unsharded, layers=1,
                                policy="tp_bf16", n_params=2,
                                routes_recorded=2, ready_s=0.0, wall_s=0.0,
                                peak_gib=0.0, **{"1x2": step})})
    return ranks


#: (the leg's own moves, what is put in, whether a gate must fail)
CARD_GATE_CASES = [
    (None, {}, False),
    (None, dict(update_rel=1.0, update_leaf_rel=[1.0, None]), True),
    (None, dict(grad_rel=[1e-3, 0.05]), True),
    (None, dict(aux=1.25 + 1e-4), True),
    (None, dict(loss=2.5 + 1e-2), True),
    (None, dict(rank1=dict(loss=2.5 + 1e-6)), True),
    (None, dict(loss=float("nan")), True),
    (0.03, dict(grad_rel=[1e-3, 0.08]), False),
    (0.03, dict(grad_rel=[1e-3, 0.1]), True),
]


@pytest.mark.parametrize("sens,bad,fails", CARD_GATE_CASES)
def test_card_leg_gates(sens, bad, fails):
    """``chip_smoke.train_mesh_archs_gates``, the card legs' gates, on
    figures a rank returns: a sound step passes; an unchanged master, a
    leaf's gradient off by 5e-2, an aux off by 1e-4, a loss off by 1e-2,
    the ranks' losses apart or a NaN loss each fail; a recurrent stack
    whose own move at half its chunk is 3e-2 has its gradient bound
    widened to ``SENSITIVITY_X`` times that, and no further."""
    import chip_smoke
    leg = dict(tag="x", arch="qwen3-moe-30b-a3b", dims=[(1, 2)])
    _, failed = chip_smoke.train_mesh_archs_gates([leg],
                                                  _card_ranks(sens, **bad))
    assert bool(failed) == fails, failed


# ---------------------------------------------------------------------------
# the compressed sync over ("pod", "data")
# ---------------------------------------------------------------------------
_JAX_CHILD = """
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map_compat
from repro.optim.grad_compress import compress_sync_local

g, ef = np.load(sys.argv[1]), np.load(sys.argv[2])
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
dp = ("pod", "data")
out = {}
for fmt in ("fp8", "fp16alt"):
    def body(g, ef, fmt=fmt):
        s, e = compress_sync_local(g[0], ef[0], axes=dp, fmt=fmt,
                                   key=None, n_replicas=4)
        return s[None], e[None]
    f = jax.jit(shard_map_compat(body, mesh=mesh,
                                 in_specs=(P(dp), P(dp)),
                                 out_specs=(P(dp), P(dp)),
                                 axis_names=set(dp), check_vma=False))
    s1, e1 = f(g, ef)
    s2, e2 = f(g, e1)
    for k, v in dict(s1=s1, e1=e1, s2=s2, e2=e2).items():
        out[f"{fmt}_{k}"] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _run_jax_child(script, args, out,
                   xla_flags="--xla_force_host_platform_device_count=4"):
    """``script`` in a child process on the CPU under ``xla_flags``
    (XLA reads them once, at start): the arrays it saved to ``out``."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": xla_flags,
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(os.path.dirname(__file__), "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-c", script, *map(str, args),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=SPAWN_S)
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(np.load(out))


def _jax_compress_child(d):
    g, ef = _compress_inputs()
    np.save(d / "g.npy", g)
    np.save(d / "ef.npy", ef)
    return _run_jax_child(_JAX_CHILD, [d / "g.npy", d / "ef.npy"],
                          d / "out.npz")


_JAX_MESH_CHILD = """
import sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import sharding as shd
from repro.models.layers import set_batch_axes
from repro.models.registry import build_model

arch, toks, labels = sys.argv[1], np.load(sys.argv[2]), np.load(sys.argv[3])
m = build_model(arch, policy="fp32", reduced=True)
p = m.init(jax.random.key(0))
set_batch_axes(("data",))
out = {}
for dims in ((2, 1), (1, 2), (2, 2)):
    mesh = jax.make_mesh(dims, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ps = jax.device_put(p, shd.named(mesh, shd.param_specs(p, "model",
                                                           dims[1])))
    tk, lb = (jax.device_put(v, NamedSharding(mesh, P("data", None)))
              for v in (toks, labels))
    with mesh:
        g = jax.jit(jax.grad(lambda q: m.forward_train(q, tk, lb,
                                                       mesh=mesh)))(ps)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{dims[0]}x{dims[1]}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[4], **out)
"""


def _jax_mesh_child(d, arch=MOE[0]):
    """JAX's own gradient under a ``(2, 1)``, a ``(1, 2)`` and a ``(2, 2)``
    mesh of forced host devices (GSPMD's global-batch router at ``(2, 1)``,
    its expert-parallel ``shard_map`` at the others)."""
    b = _batch(arch)
    np.save(d / "t.npy", b["tokens"])
    np.save(d / "l.npy", b["labels"])
    return _run_jax_child(_JAX_MESH_CHILD, [arch, d / "t.npy", d / "l.npy"],
                          d / "g.npz")


_JAX_XLSTM_CHILD = """
import dataclasses
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.models.registry import build_model

toks, labels = np.load(sys.argv[1]), np.load(sys.argv[2])
p = build_model("xlstm-1.3b", policy="tp_bf16",
                reduced=True).init(jax.random.key(0))
out = {}
for pol, chunks in (("fp32", (16,)), ("tp_bf16", (16, 8))):
    m = build_model("xlstm-1.3b", policy=pol, reduced=True)
    q = p if pol == "tp_bf16" else jax.tree.map(
        lambda a: a.astype(jnp.float32), p)
    for ch in chunks:
        mc = m.with_cfg(mlstm=dataclasses.replace(m.cfg.mlstm, chunk=ch))
        g = jax.jit(jax.grad(lambda w: mc.forward_train(w, toks, labels)))(q)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{pol}_{ch}_{i}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(sys.argv[3], **out)
"""


def _jax_xlstm_child(d, excess: bool):
    """JAX's jitted xlstm gradient (reduced, JAX's bf16 weights) under
    ``fp32`` at chunk 16 and ``tp_bf16`` at chunks 16 and 8, with XLA's
    ``xla_allow_excess_precision`` (its default: fused bf16 intermediates
    kept in f32) on or off."""
    b = _batch("xlstm-1.3b")
    np.save(d / "t.npy", b["tokens"])
    np.save(d / "l.npy", b["labels"])
    flag = "true" if excess else "false"
    return _run_jax_child(_JAX_XLSTM_CHILD, [d / "t.npy", d / "l.npy"],
                          d / "g.npz",
                          xla_flags=f"--xla_allow_excess_precision={flag}")


@pytest.mark.parametrize("dims", [(2, 1), (1, 2), (2, 2)])
def test_moe_gradients_match_jax_own_mesh_step(request, spawned, dims):
    """qwen3-moe's gradient on each rank, gathered whole, against JAX's
    own mesh gradient (GSPMD and the expert-parallel ``shard_map``, not
    a reference built here): within ``F32_REL`` at (2, 1), where the aux
    is the global batch's at weight 1 a rank, at (1, 2), and at (2, 2),
    where the aux is the mean of the data shards'."""
    want = spawned["jm"].result()
    tag = f"{dims[0]}x{dims[1]}"
    for r in _ranks(request, dims, f"{MOE[0]}@{dims}"):
        for i, got in enumerate(r["grads"]):
            assert _rel(got, want[f"{tag}_{i}"]) < F32_REL, (dims, i)


@pytest.mark.parametrize("fmt", ["fp8", "fp16alt"])
def test_compress_sync_over_pod_and_data_bitwise_jax(spawned, world4, fmt):
    """Replica ``i`` of the flattened (pod, data) group, in JAX's
    ``axis_index(("pod", "data"))`` order, holds JAX's slice ``i``."""
    want = spawned["jc"].result()
    for rank, r in enumerate(x[f"compress_{fmt}"] for x in world4):
        for i in (0, 1):
            assert np.array_equal(r["synced"][i].numpy(),
                                  want[f"{fmt}_s{i + 1}"][rank]), (fmt, i)
            assert np.array_equal(r["ef"][i].numpy(),
                                  want[f"{fmt}_e{i + 1}"][rank]), (fmt, i)


# ---------------------------------------------------------------------------
# ZeRO-1, elastic checkpoints and opt_state_specs on an MoE arch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_zero1_adamw_on_moe_is_bitwise_the_whole_state_step(request, world):
    for r in (x["zero_moe"] for x in request.getfixturevalue(world)):
        assert all(r["bitwise"]), r["rel"]
        assert r["state_bytes"] < r["plain_state_bytes"]


def test_moe_checkpoint_restores_from_dp_to_ep(world2):
    """qwen3-moe's (2, 1) checkpoint at step 2 restored under (1, 2)
    (expert leaves split over ``model``): bitwise at the restore, and the
    ranks' continued losses agree."""
    ranks = [x["elastic_moe"] for x in world2]
    for r in ranks:
        assert r["restored_at"] == 2 and all(r["restored_bitwise"])
        assert len(r["then"]) == 2 and all(np.isfinite(r["then"]))
        assert r["then"] == ranks[0]["then"]


class _ShapeOnly:
    def __init__(self, n):
        self.shape = {"data": n}


@pytest.mark.parametrize("arch,msize,dsize", [(MOE[0], 16, 16),
                                              (MOE[1], 2, 2)])
def test_moe_opt_state_specs_match_jax(arch, msize, dsize):
    jm = jreg.build_model(arch)
    jt = jax.eval_shape(jm.init, jax.random.key(0))
    jspecs = jshd.param_specs(jt, "model", msize)
    jshape = jax.eval_shape(lambda p: jopt.init_opt_state(
        p, jopt.OptConfig(), jget_policy("tp_bf16")), jt)
    jo = jopt.opt_state_specs(jspecs, jshape, zero_axis="data",
                              mesh=_ShapeOnly(dsize))
    tm = treg.build_model(arch, device="meta")
    tt = stack_layers(tm.init(torch.Generator()), tm.cfg)
    tspecs = tshd.param_specs(tt, model_size=msize)
    tshape = topt.init_opt_state(tt, topt.OptConfig(), tm.policy)
    to = topt.opt_state_specs(tspecs, tshape, zero_axis="data",
                              mesh=_ShapeOnly(dsize))
    assert set(to) == set(jo)
    for k in jo:
        want = [tuple(p) for p in jax.tree.leaves(
            jo[k], is_leaf=lambda x: isinstance(x, P))]
        assert tshd.spec_leaves(to[k]) == want, k
    # the expert leaves split over the model axis, as JAX's
    assert ("model", None, None) in [tuple(x)[-3:] for x in
                                     tshd.spec_leaves(tspecs)]
