"""Training under a ``(data, model)`` mesh in the port against the JAX
package: gloo ranks on the CPU (``launch.spmd.spawn`` of
``train.mesh_checks.rank_main``; one module-scoped spawn per world size,
each with a timeout), reduced fpnew-case-study (2 layers, d_model 64, 4
heads, vocab 256) from JAX's own weights, a global batch of 4 rows whose
rows hold different counts of masked labels.

Tolerances (relative L2 of a leaf's difference against the JAX leaf):

* dp 2, tp 2 and (2, 2) steps against JAX's unsharded
  ``make_train_step(mesh=None)`` on the whole batch, under ``fp32``: the
  loss within 1e-5, the gradient norm within ``F32_REL`` = 1e-5, every
  leaf's master after the step within 1e-4 (``test_torch_train.py``'s
  bounds); every leaf's gradient at tp 2 (remat ``full`` and ``dots``)
  within ``F32_REL``; the ranks' params bitwise each other;
* gemma3 (qk-norm gains, replicated, inside the head-sharded read) and
  granite (one KV head: attention replicated beside sharded MLPs) at tp
  2 against the unsharded port: loss within 1e-6, every gradient within
  ``F32_REL``;
* ``compress_sync_local`` under RNE bitwise JAX's (values and error
  feedback, two rounds) on a (2, 1) mesh of forced host devices in a
  child process; stochastic rounding by property (on the grid, unbiased,
  JAX's error-feedback convergence bound);
* ZeRO-1 (the ``jit_train_step`` twin) bitwise the mesh step with the
  state whole under AdamW; Adafactor within 1e-6 (its factored means and
  RMS clip sum in another order);
* ``opt_state_specs`` equal to JAX's leaf for leaf;
* checkpoints: a mesh checkpoint read by JAX's ``restore_pytree``, JAX's
  read under a mesh, elastic (2, 1) -> (1, 2) -> none bitwise at the
  restore, the continued losses within 1e-5 of each other; an error
  feedback of another data size refused;
* the archs of ROADMAP Queue 1 item 8b.3 (MoE under any mesh; MLA, the
  recurrent mixers and whisper's encoder under a model axis) build a
  step (their steps: ``tests/test_torch_train_mesh_archs.py``).
"""
import os
import shutil
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

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.core import softfloat  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import sharding as tshd  # noqa: E402
from repro_torch.models.convert import from_jax_state, stack_layers  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import mesh_checks as mc  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402

torch.set_num_threads(1)

ARCH = "fpnew-case-study"
F32_REL = 1e-5
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
SPAWN_S = 300
B, S = 4, 16
LOOP = dict(batch=4, seq=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a = np.asarray(a, np.float64) if not isinstance(a, torch.Tensor) \
        else a.double().numpy()
    b = np.asarray(b, np.float64) if not isinstance(b, torch.Tensor) \
        else b.double().numpy()
    den = np.linalg.norm(b)
    return np.linalg.norm(a - b) / (den if den else 1.0)


def _batch():
    rs = np.random.default_rng(7)
    toks = rs.integers(0, 256, (B, S)).astype(np.int32)
    labels = rs.integers(0, 256, (B, S)).astype(np.int32)
    labels[0, :2] = -1                 # rows 0-1 (rank 0): 3 masked
    labels[1, :1] = -1
    labels[2, :13] = -1                # rows 2-3 (rank 1): 20 masked
    labels[3, :7] = -1
    return toks, labels


def _compress_inputs():
    rs = np.random.default_rng(3)
    g = rs.standard_normal((2, 16, 16)).astype(np.float32)
    g[1] *= 4.0                        # the ranks' scales differ
    ef = (rs.standard_normal((2, 16, 16)) * 1e-2).astype(np.float32)
    return g, ef


def _port_state(arch, policy="fp32"):
    m = treg.build_model(arch, policy=policy, reduced=True, device="cpu",
                         prefill_backend="dense")
    whole = stack_layers(m.init(0), m.cfg)
    return m, {"params": whole,
               "opt": topt.init_opt_state(whole, topt.OptConfig(**OPT),
                                          m.policy)}


@pytest.fixture(scope="module")
def start():
    """JAX's weights and optimizer state, the port's carried from them, and
    the global batch."""
    jm, jp = cached_model(ARCH, policy="fp32")
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**OPT),
                                 jget_policy("fp32"))
    toks, labels = _batch()
    return dict(jm=jm, jp=jp, jstate=jstate,
                state=from_jax_state({"params": _np(jp),
                                      "opt": _np(jstate)}, "cpu"),
                batch={"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})


@pytest.fixture(scope="module")
def ref(start, spawned):
    """JAX's unsharded step and gradients on the whole batch (computed
    while the ranks run)."""
    jm, jp, jstate = start["jm"], start["jp"], start["jstate"]
    jb = {k: jnp.asarray(v.numpy()) for k, v in start["batch"].items()}
    jgrads = jax.grad(lambda p: jm.forward_train(p, jb["tokens"],
                                                 jb["labels"]))(jp)
    jp2, js2, jmet = jax.jit(jmake_step(jm, jopt.OptConfig(**OPT), None))(
        jp, jstate, jb)
    halves = [float(jm.forward_train(jp, jb["tokens"][i:i + 2],
                                     jb["labels"][i:i + 2]))
              for i in (0, 2)]
    return dict(start, loss=float(jmet["loss"]),
                gnorm=float(jmet["grad_norm"]),
                grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)],
                master=[np.asarray(m) for m in
                        jax.tree.leaves(js2["master"])],
                halves=halves)


@pytest.fixture(scope="module")
def jax_ckpt(start, tmp_path_factory):
    """JAX's ``save_pytree`` of its state after the step, as a loop
    checkpoint at step 3."""
    root = tmp_path_factory.mktemp("jaxckpt")
    data = SyntheticLMData(DataConfig(vocab=256, seq_len=S, global_batch=B))
    data.step = 3
    jckpt.save_pytree(str(root / "step_00000003"),
                      {"params": start["jp"], "opt": start["jstate"]},
                      {"step": 3, "data": data.state_dict()})
    return str(root)


def _spawn(world, plan):
    return spmd.spawn(mc.rank_main, world, backend="gloo", args=(plan,),
                      timeout=SPAWN_S)


def _plan2(ref, jax_ckpt, root):
    g, ef = _compress_inputs()
    common = dict(state=ref["state"], batch=ref["batch"], policy="fp32",
                  opt=OPT)
    archs = {a: _port_state(a)[1] for a in ("gemma3-12b", "granite-20b")}
    plan = [("dp", "step", dict(dims=(2, 1), **common)),
            ("tp_full", "step", dict(dims=(1, 2), **common)),
            ("tp_dots", "step", dict(dims=(1, 2), remat_policy="dots",
                                     **common))]
    plan.append(("tp_sr", "step", dict(dims=(1, 2), state=_port_state(
        ARCH, "prod_tp")[1], batch=ref["batch"], policy="prod_tp", opt=OPT,
        sr_seed=3)))
    plan += [(f"tp_{a}", "step", dict(dims=(1, 2), arch=a, state=archs[a],
                                      batch=ref["batch"], policy="fp32",
                                      opt=OPT)) for a in archs]
    plan += [(f"compress_{f}", "compress",
              dict(dims=(2, 1), grads=torch.from_numpy(g),
                   efs=torch.from_numpy(ef), fmt=f))
             for f in ("fp8", "fp16alt")]
    plan += [("cloop", "compressed_loop",
              dict(dims=(2, 1), fmt="fp8", policy="fp32", opt=OPT, steps=3,
                   **LOOP)),
             ("zero_adamw", "zero",
              dict(dims=(2, 1), state=ref["state"], policy="fp32", opt=OPT,
                   steps=2, **LOOP)),
             ("zero_adafactor", "zero",
              dict(dims=(2, 1), state=_adafactor_state(ref), policy="fp32",
                   opt=dict(OPT, name="adafactor"), steps=2, **LOOP)),
             ("elastic", "elastic",
              dict(first=(2, 1), then=(1, 2), root=os.path.join(root, "e"),
                   policy="fp32", opt=OPT, steps=2, more=2, **LOOP)),
             ("ef_refused", "elastic",
              dict(first=(2, 1), then=(1, 2), root=os.path.join(root, "r"),
                   policy="fp32", opt=OPT, steps=1, more=1,
                   compress_grads="fp8", **LOOP)),
             ("from_jax", "restore",
              dict(dims=(1, 2), ckpt_dir=jax_ckpt, policy="fp32", opt=OPT,
                   steps=4, **LOOP))]
    return plan, archs


def _adafactor_state(ref):
    m = treg.build_model(ARCH, policy="fp32", reduced=True, device="cpu")
    return {"params": ref["state"]["params"],
            "opt": topt.init_opt_state(ref["state"]["params"],
                                       topt.OptConfig(name="adafactor"),
                                       m.policy)}


def _plan4(ref):
    ada = dict(state=_adafactor_state(ref), policy="fp32",
               opt=dict(OPT, name="adafactor"))
    return [("dp_tp", "step", dict(dims=(2, 2), state=ref["state"],
                                   batch=ref["batch"], policy="fp32",
                                   opt=OPT)),
            ("dp_tp_adafactor", "step", dict(dims=(2, 2), batch=ref["batch"],
                                             **ada)),
            ("zero_adamw", "zero",
             dict(dims=(2, 2), state=ref["state"], policy="fp32", opt=OPT,
                  steps=2, **LOOP)),
            ("zero_adafactor", "zero", dict(dims=(2, 2), steps=2, **ada,
                                            **LOOP))]


@pytest.fixture(scope="module")
def spawned(start, jax_ckpt, tmp_path_factory):
    """Both worlds' spawns and JAX's compressed-sync child, started at once
    in threads (the JAX references are computed meanwhile)."""
    root = str(tmp_path_factory.mktemp("mesh2"))
    plan2, archs = _plan2(start, jax_ckpt, root)
    pool = ThreadPoolExecutor(3)
    futs = dict(w2=pool.submit(_spawn, 2, plan2),
                w4=pool.submit(_spawn, 4, _plan4(start)),
                jc=pool.submit(_jax_compress_child,
                               tmp_path_factory.mktemp("gc")))
    yield dict(futs, root=root, archs=archs)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world2(spawned):
    return dict(root=spawned["root"], archs=spawned["archs"],
                ranks=spawned["w2"].result())


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned["w4"].result()


def _case(request, world, name):
    ranks = request.getfixturevalue(world)
    ranks = ranks["ranks"] if isinstance(ranks, dict) else ranks
    return [r[name] for r in ranks]


# ---------------------------------------------------------------------------
# steps against JAX's unsharded step
# ---------------------------------------------------------------------------
def test_batch_pins_the_global_token_mean(ref):
    """The ranks' rows hold different counts of live labels, so the mean
    of the ranks' means is not the global mean the steps must give."""
    assert abs(np.mean(ref["halves"]) - ref["loss"]) > 1e-3


@pytest.mark.parametrize("world,name", [("world2", "dp"),
                                        ("world2", "tp_full"),
                                        ("world4", "dp_tp")])
def test_sharded_step_matches_jax(request, ref, world, name):
    ranks = _case(request, world, name)
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) <= 1e-5, name
        assert abs(r["grad_norm"] - ref["gnorm"]) <= F32_REL * ref["gnorm"]
        for got, want in zip(r["master"], ref["master"]):
            assert _rel(got, want) < 1e-4
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(r["params"], ranks[0]["params"]))


@pytest.mark.parametrize("name", ["dp", "tp_full", "tp_dots"])
def test_every_leaf_gradient_matches_jax(world2, ref, name):
    """Every leaf's gradient gathered whole (a missing ``grad_sum`` leaves
    a replicated leaf with one rank's share)."""
    for r in (x[name] for x in world2["ranks"]):
        assert len(r["grads"]) == len(ref["grads"])
        for got, want in zip(r["grads"], ref["grads"]):
            assert _rel(got, want) < F32_REL


@pytest.mark.parametrize("arch", ["gemma3-12b", "granite-20b"])
def test_dense_archs_at_tp2_match_the_unsharded_port(world2, arch):
    m = treg.build_model(arch, policy="fp32", reduced=True, device="cpu",
                         prefill_backend="dense")
    loss, grads = tstep.loss_and_grads(m, world2["archs"][arch]["params"],
                                       _case_batch())
    for r in (x[f"tp_{arch}"] for x in world2["ranks"]):
        assert abs(r["grad_loss"] - float(loss)) <= 1e-6
        for got, want in zip(r["grads"], grads):
            assert _rel(got, want) < F32_REL


def test_split_leaves_requantize_stochastically_and_agree(world2):
    """``prod_tp`` at tp 2: each split leaf draws its block's own stream,
    every whole leaf the unsharded stream on every rank, so the ranks'
    params (gathered whole) are bitwise each other's, bf16 and finite."""
    a, b = (x["tp_sr"] for x in world2["ranks"])
    for x, y in zip(a["params"], b["params"]):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x).all()
        assert torch.equal(x, y)
    assert np.isfinite(a["loss"])


def _case_batch():
    toks, labels = _batch()
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


def test_backward_collectives_are_counted(world2):
    """tp 2: the step's collectives include the backward's ``grad_sum``s
    (2 a layer and the logits' one) beyond the forward's."""
    st = world2["ranks"][0]["tp_full_spmd"]
    fwd_only = world2["ranks"][0]["dp_spmd"]["collectives"]
    assert st["collectives"] > fwd_only > 0


# ---------------------------------------------------------------------------
# the compressed sync
# ---------------------------------------------------------------------------
_JAX_CHILD = """
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map_compat
from repro.optim.grad_compress import compress_sync_local

g, ef = np.load(sys.argv[1]), np.load(sys.argv[2])
mesh = jax.make_mesh((2, 1), ("data", "model"))
out = {}
for fmt in ("fp8", "fp16alt"):
    def body(g, ef, fmt=fmt):
        s, e = compress_sync_local(g[0], ef[0], axes=("data",), fmt=fmt,
                                   key=None, n_replicas=2)
        return s[None], e[None]
    f = jax.jit(shard_map_compat(body, mesh=mesh,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data")),
                                 axis_names={"data"}, check_vma=False))
    s1, e1 = f(g, ef)
    s2, e2 = f(g, e1)
    for k, v in dict(s1=s1, e1=e1, s2=s2, e2=e2).items():
        out[f"{fmt}_{k}"] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _jax_compress_child(d):
    g, ef = _compress_inputs()
    np.save(d / "g.npy", g)
    np.save(d / "ef.npy", ef)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(os.path.dirname(__file__), "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(d / "g.npy"),
                        str(d / "ef.npy"), str(d / "out.npz")], env=env,
                       capture_output=True, text=True, timeout=SPAWN_S)
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def jax_compress(spawned):
    return spawned["jc"].result()


@pytest.mark.parametrize("fmt", ["fp8", "fp16alt"])
def test_compress_sync_rne_bitwise_jax(world2, jax_compress, fmt):
    for rank, r in enumerate(x[f"compress_{fmt}"] for x in world2["ranks"]):
        for i in (0, 1):
            s = jax_compress[f"{fmt}_s{i + 1}"][rank]
            e = jax_compress[f"{fmt}_e{i + 1}"][rank]
            assert np.array_equal(r["synced"][i].numpy(), s), (fmt, i)
            assert np.array_equal(r["ef"][i].numpy(), e), (fmt, i)


def _one_rank():
    return spmd.Group([0], 0, None)


@pytest.mark.parametrize("fmt", ["fp8", "fp16alt"])
def test_compress_sync_stochastic_properties(fmt):
    """On one rank: q on the format's grid, unbiased over draws, and the
    JAX suite's error-feedback convergence bound (a constant gradient's
    cumulative sync within a quarter of max |g| of the true sum)."""
    g = torch.from_numpy(np.random.RandomState(0).randn(16, 16).astype(
        np.float32))
    ef = tstep.init_error_feedback({"g": g})["g"][0]
    assert ef.dtype == torch.float32 and ef.shape == g.shape and not ef.any()
    total = torch.zeros_like(g)
    for i in range(20):
        gen = torch.Generator().manual_seed(i)
        s, ef = tgc.compress_sync_local(g, ef, group=_one_rank(), fmt=fmt,
                                        generator=gen, n_replicas=1)
        total = total + s
    assert float((total - 20 * g).abs().max()) < 0.25 * float(g.abs().max())
    # q: on the grid, and unbiased (its mean over draws is g / scale)
    qs = []
    for i in range(400):
        gf, q, scale = tgc.scale_and_quantize(
            g, torch.zeros_like(g), group=_one_rank(), fmt=fmt,
            generator=torch.Generator().manual_seed(1000 + i))
        assert torch.equal(softfloat.quantize(q, fmt), q)
        qs.append(q.double())
    x = (gf / scale).double()
    ulp = torch.exp2(torch.floor(torch.log2(x.abs()))
                     - softfloat.get_format(fmt).m_bits)
    err = ((torch.stack(qs).mean(0) - x).abs() / ulp).max()
    assert float(err) < 0.15     # 400 draws: sd of the mean <= 0.025 ulp


def test_compressed_loop_carries_error_feedback(world2):
    ranks = [x["cloop"] for x in world2["ranks"]]
    m = treg.build_model(ARCH, policy="fp32", reduced=True, device="cpu")
    n_params = sum(p.numel() for p in leaves(stack_layers(m.init(0), m.cfg)))
    for r in ranks:
        assert all(np.isfinite(r["losses"])) and len(r["losses"]) == 3
        assert r["ef_max_after_1"] > 0
        assert r["ef_shape"][0] == 1
        # bf16 on the wire for fp8: 2 bytes a value a step
        assert r["wire_bytes"] == {"fp8": 2 * n_params * 3}
    assert ranks[0]["losses"] == ranks[1]["losses"]


# ---------------------------------------------------------------------------
# ZeRO-1 and opt_state_specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_zero1_adamw_is_bitwise_the_whole_state_step(request, world):
    for r in _case(request, world, "zero_adamw"):
        assert all(r["bitwise"]), r["rel"]
        assert r["state_bytes"] < r["plain_state_bytes"]


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_zero1_adafactor_within_tolerance(request, world):
    for r in _case(request, world, "zero_adafactor"):
        assert max(r["rel"]) < 1e-6
        assert r["state_bytes"] < r["plain_state_bytes"]


def test_adafactor_at_2x2_matches_the_unsharded_step(world4, ref):
    """Adafactor's factored means and RMS clip reduced over the groups
    that split them: the (2, 2) step's master within 1e-5 of the
    unsharded port step's (the port's Adafactor is held to JAX's in
    ``tests/test_torch_train.py``)."""
    m = treg.build_model(ARCH, policy="fp32", reduced=True, device="cpu",
                         prefill_backend="dense")
    st = _adafactor_state(ref)
    _, s2, met = tstep.make_train_step(
        m, topt.OptConfig(**dict(OPT, name="adafactor")))(
            st["params"], st["opt"], ref["batch"])
    for r in (x["dp_tp_adafactor"] for x in world4):
        assert abs(r["loss"] - float(met["loss"])) <= 1e-5
        for got, want in zip(r["master"], leaves(s2["master"])):
            assert _rel(got, want) < 1e-5


class _ShapeOnly:
    def __init__(self, n):
        self.shape = {"data": n}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch,msize,dsize", [("fpnew-case-study", 2, 2),
                                              ("fpnew-case-study", 16, 16),
                                              ("gemma2-9b", 16, 16)])
def test_opt_state_specs_match_jax(arch, msize, dsize, name):
    jm = jreg.build_model(arch)
    jt = jax.eval_shape(jm.init, jax.random.key(0))
    jspecs = jshd.param_specs(jt, "model", msize)
    jshape = jax.eval_shape(lambda p: jopt.init_opt_state(
        p, jopt.OptConfig(name=name), jget_policy("tp_bf16")), jt)
    jo = jopt.opt_state_specs(jspecs, jshape, zero_axis="data",
                              mesh=_ShapeOnly(dsize))
    tm = treg.build_model(arch, device="meta")
    tt = stack_layers(tm.init(torch.Generator()), tm.cfg)
    tspecs = tshd.param_specs(tt, model_size=msize)
    tshape = topt.init_opt_state(tt, topt.OptConfig(name=name), tm.policy)
    to = topt.opt_state_specs(tspecs, tshape, zero_axis="data",
                              mesh=_ShapeOnly(dsize))
    assert set(to) == set(jo)
    for k in jo:
        want = [tuple(p) for p in jax.tree.leaves(
            jo[k], is_leaf=lambda x: isinstance(x, P))]
        assert tshd.spec_leaves(to[k]) == want, k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _ckpt_dir(world2, tag, step):
    return os.path.join(world2["root"], tag, "a", f"step_{step:08d}")


def test_mesh_checkpoint_is_read_by_jax(world2, ref):
    """The (2, 1) loop's checkpoint holds whole leaves in JAX's format."""
    path = _ckpt_dir(world2, "e", 2)
    like = {"params": ref["jp"], "opt": ref["jstate"]}
    jtree, extra = jckpt.restore_pytree(path, like)
    m = treg.build_model(ARCH, policy="fp32", reduced=True, device="cpu")
    whole = stack_layers(m.init(0), m.cfg)
    ttree, _ = tckpt.restore_pytree(path, {"params": whole, "opt":
                                           topt.init_opt_state(
                                               whole, topt.OptConfig(**OPT),
                                               m.policy)})
    assert extra["step"] == 2
    for j, t in zip(jax.tree.leaves(jtree), leaves(ttree)):
        assert np.array_equal(np.asarray(j, np.float32),
                              t.to(torch.float32).numpy())


def test_jax_checkpoint_is_read_under_a_mesh(world2, ref):
    """JAX's ``save_pytree`` restored on a (1, 2) mesh: each rank's blocks
    are the whole leaves' shards, gathered back bitwise."""
    want = jax.tree.leaves({"params": ref["jp"], "opt": ref["jstate"]})
    for r in (x["from_jax"] for x in world2["ranks"]):
        assert r["restored_at"] == 3
        assert len(r["state"]) == len(want)
        for got, w in zip(r["state"], want):
            assert np.array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(w, np.float32))
        assert all(np.isfinite(r["losses"])) and len(r["losses"]) == 1


def test_elastic_restore_dp_to_tp_to_none(world2, tmp_path):
    """(2, 1) checkpoints at step 2; (1, 2) restores it bitwise and goes on;
    a meshless loop restores it too, and both continuations agree."""
    ranks = [x["elastic"] for x in world2["ranks"]]
    for r in ranks:
        assert r["restored_at"] == 2 and all(r["restored_bitwise"])
        assert r["then"] == ranks[0]["then"] and len(r["then"]) == 2
    shutil.copytree(_ckpt_dir(world2, "e", 2),
                    tmp_path / "step_00000002")
    m = treg.build_model(ARCH, policy="fp32", reduced=True, device="cpu",
                         prefill_backend="dense")
    lp = TrainLoop(m, topt.OptConfig(**OPT),
                   DataConfig(vocab=256, seq_len=LOOP["seq"],
                              global_batch=LOOP["batch"]),
                   LoopConfig(total_steps=4, log_every=0, ckpt_every=0,
                              ckpt_dir=str(tmp_path)))
    assert lp.step == 2
    lp.run()
    got = [x["loss"] for x in lp.metrics_log]
    assert len(got) == 2
    for a, b in zip(got, ranks[0]["then"]):
        assert abs(a - b) <= 1e-5


def test_error_feedback_of_another_data_size_is_refused(world2):
    for r in (x["ef_refused"] for x in world2["ranks"]):
        assert "ef" in r["refused"] and "expects" in r["refused"]


# ---------------------------------------------------------------------------
# the archs of item 8b.3 build a step; the spawn timeout
# ---------------------------------------------------------------------------
def _fake_mesh(dp, tp):
    devices = np.arange(dp * tp).reshape(dp, tp)
    groups = {"data": spmd.Group(list(devices[:, 0]), 0, None),
              "model": spmd.Group(list(devices[0]), 0, None)}
    return Mesh(("data", "model"), devices, 0, groups,
                spmd.Group(list(range(dp * tp)), 0, None))


@pytest.mark.parametrize("arch,dims", [
    ("minicpm3-4b", (1, 2)), ("zamba2-1.2b", (1, 2)), ("xlstm-1.3b", (1, 2)),
    ("whisper-small", (1, 2)), ("qwen3-moe-30b-a3b", (2, 1)),
    ("deepseek-v2-lite-16b", (2, 1))])
def test_unported_mesh_training_names_8b3(arch, dims):
    """The archs that refused a training mesh until ROADMAP Queue 1 item
    8b.3 was done now build a step on it, with the plain and the
    compressed sync (their steps run in
    ``tests/test_torch_train_mesh_archs.py``)."""
    m = treg.build_model(arch, policy="fp32", reduced=True, device="cpu",
                         prefill_backend="dense")
    for fmt in (None, "fp8"):
        assert callable(tstep.make_train_step(m, topt.OptConfig(),
                                              _fake_mesh(*dims),
                                              compress_grads=fmt))


def test_spawn_timeout_kills_the_ranks():
    with pytest.raises(TimeoutError, match="killed"):
        spmd.spawn(mc.sleep, 2, backend="gloo", args=(120.0,), timeout=3.0)
