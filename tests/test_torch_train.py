"""Training in the port against the JAX package, on reduced
fpnew-case-study (2 layers, d_model 64, vocab 256) with JAX's own weights
(``conftest.cached_model``) carried across by ``from_jax_tree`` /
``from_jax_state``.  Inputs come from numpy seeds.

Tolerances (relative L2 of a leaf's difference against the JAX leaf):

* ``forward_train``: under ``fp32`` and ``em_fp8`` (f32 containers) the
  loss within 1e-6 and every gradient within ``F32_REL`` = 1e-5 (f32 sums
  in another order); under ``tp_bf16`` the loss within 2e-3 and each
  gradient within ``BF16_REL`` = 3e-2 (bf16 activations round at other
  places; one bf16 ulp is 2^-8 = 3.9e-3 and several stack up).
* the optimizer (``apply_update``, 3 steps on fixed gradients): master,
  moments and Adafactor factors within 1e-6 (1e-5 under ``prod_tp``,
  whose clip scale comes from a bf16 gradient's norm; its bf16 moments
  within 2^-8), the 16-bit params within 2^-8; ``lr`` within 1e-6, ``grad_norm`` within 1e-5 (an f32 sum
  of 10^5 squares in another order).
* one ``make_train_step`` step and 5 loop steps against JAX's jitted step
  on the same batches: ``fp32`` losses within 1e-5 and the master within
  1e-4 (Adam's normalised update amplifies last-bit gradient differences
  where a gradient is near 0: its first step is sign(g) lr); ``tp_bf16``
  losses within 5e-3, the master after one step within 1e-2, and after 5
  steps each leaf's difference under 0.1 of how far it moved (bf16
  gradients near 0 flip sign between the frameworks; 0.06 seen).

Within the port (bitwise): remat ``full`` / ``dots`` / ``none``.
Checkpoints, data and faults are in ``test_torch_train_ckpt.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.configs import fpnew_case_study as jcfg  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import fpnew_case_study as tcfg  # noqa: E402
from repro_torch.core import softfloat  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import (  # noqa: E402
    flatten_with_paths, leaves, unflatten)
from repro_torch.data.pipeline import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_jax_state, from_jax_tree, layer_views, stack_layers)
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402

torch.set_num_threads(1)

ARCH = "fpnew-case-study"
F32_REL = 1e-5
BF16_REL = 3e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tmodel(policy, arch=ARCH, **cfg):
    return build_model(arch, policy=policy, reduced=True, device="cpu",
                       prefill_backend="dense", **cfg)


def _batch(seed, vocab=256, b=2, s=24):
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rs.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    return toks, labels


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    den = np.linalg.norm(b)
    return np.linalg.norm(a - b) / (den if den else 1.0)


def _same_paths(jtree, ttree):
    """Both trees' leaves by keystr path, asserting the paths agree."""
    jflat = [(jax.tree_util.keystr(p), v) for p, v in
             jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tflat = flatten_with_paths(ttree)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    return [(p, j, t) for (p, j), (_, t) in zip(jflat, tflat)]


def _grads(model, tree, toks, labels, **kw):
    flat = [p.detach().clone().requires_grad_() for p in leaves(tree)]
    loss = model.forward_train(unflatten(tree, flat), torch.from_numpy(toks),
                               torch.from_numpy(labels), **kw)
    return loss, torch.autograd.grad(loss, flat)


# ---------------------------------------------------------------------------
# config, layout
# ---------------------------------------------------------------------------
def test_configs_match_jax():
    skip = {"decode_backend", "prefill_backend"}   # "auto" in the port
    for mine, theirs in ((tcfg.CONFIG, jcfg.CONFIG),
                         (tcfg.reduced(), jcfg.reduced())):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert {k: v for k, v in a.items() if k not in skip} == \
            {k: v for k, v in b.items() if k not in skip}
    full = get_config("fpnew-case-study")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (12, 768, 12, 12, 64,
                                                       2048, 32000)


def test_stack_layers_inverts_layer_views():
    """``Model.init`` stacked into JAX's layout has JAX's paths and shapes;
    ``layer_views`` gives the per-layer dict back, as views."""
    jm, jp = cached_model(ARCH, policy="tp_bf16")
    m = _tmodel("tp_bf16")
    port = m.init(0)
    tree = stack_layers(port, m.cfg)
    for p, j, t in _same_paths(jp, tree):
        assert tuple(j.shape) == tuple(t.shape), p
        assert str(j.dtype) == str(t.dtype).replace("torch.", ""), p
    back = layer_views(tree)
    for a, b in zip(leaves(back), leaves(port)):
        assert torch.equal(a, b)
    wq = tree["pattern"][0]["attn"]["wq"]
    assert back["layers"][1]["attn"]["wq"].data_ptr() == wq[1].data_ptr()


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["fp32", "tp_bf16", "em_fp8"])
def test_forward_train_loss_and_grads_match_jax(policy):
    jm, jp = cached_model(ARCH, policy=policy)
    toks, labels = _batch(0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.forward_train(p, toks, labels, loss_chunk=8)))(jp)
    loss, g = _grads(_tmodel(policy), from_jax_tree(_np(jp), "cpu"), toks,
                     labels, loss_chunk=8)
    tol = BF16_REL if policy == "tp_bf16" else F32_REL
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= (2e-3 if policy == "tp_bf16"
                                            else 1e-6 * float(jl))
    gtree = from_jax_tree(_np(jg), "cpu")
    for (p, want, _), got in zip(_same_paths(jg, gtree), g):
        assert got.dtype == _tmodel(policy).init(0)["embed"].dtype
        assert _rel(got, want) < tol, (p, _rel(got, want))


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-20b",
                                  "qwen3-moe-30b-a3b"])
def test_forward_train_loss_matches_jax_other_archs(arch):
    """fp32 loss parity: gemma2 (windows, softcaps, sandwich norms),
    granite (MQA, gelu MLP with biases) and qwen3-moe (the aux loss)."""
    jm, jp = cached_model(arch, policy="fp32")
    toks, labels = _batch(1, vocab=jm.cfg.vocab, s=20)
    want = jax.jit(lambda p: jm.forward_train(p, toks, labels))(jp)
    m = _tmodel("fp32", arch=arch)
    got = m.forward_train(from_jax_tree(_np(jp), "cpu"),
                          torch.from_numpy(toks), torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), \
        (float(got), float(want))
    if arch.startswith("qwen3"):
        plain = m.forward_train(from_jax_tree(_np(jp), "cpu"),
                                torch.from_numpy(toks),
                                torch.from_numpy(labels), aux_coef=0.0)
        assert float(got) > float(plain)        # the aux term is in


@pytest.mark.parametrize("backend", ["auto", "kernel", "plain"])
def test_forward_train_refuses_kernel_prefill_backends(backend):
    m = build_model(ARCH, reduced=True, device="cpu",
                    prefill_backend=backend)
    toks, labels = _batch(0)
    with pytest.raises(ValueError, match="prefill_backend='dense'"):
        m.forward_train(stack_layers(m.init(0), m.cfg),
                        torch.from_numpy(toks), torch.from_numpy(labels))


@pytest.mark.parametrize("remat_policy", ["full", "dots", "none"])
def test_remat_policies_give_bitwise_equal_grads(remat_policy):
    """Each policy's gradients equal the un-checkpointed ones bit for bit,
    under both a 16-bit and an f32 policy (the recompute replays the same
    kernels)."""
    toks, labels = _batch(2)
    for policy in ("tp_bf16", "fp32"):
        m = _tmodel(policy, remat_policy=remat_policy)
        tree = stack_layers(m.init(3), m.cfg)
        l0, g0 = _grads(m, tree, toks, labels, remat=False)
        l1, g1 = _grads(m, tree, toks, labels, remat=True)
        assert torch.equal(l0, l1)
        for a, b in zip(g0, g1):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1),
    dict(lr=3e-3, warmup_steps=0, total_steps=37, min_lr_frac=0.0)])
def test_lr_at_matches_jax(cfg):
    steps = np.arange(0, cfg["total_steps"] + 5)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(
        jopt.OptConfig(**cfg), s))(jnp.asarray(steps)))
    got = np.array([float(topt.lr_at(topt.OptConfig(**cfg), int(s)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert float(topt.lr_at(topt.OptConfig(**cfg), 0)) == 0.0 or \
        cfg["warmup_steps"] == 0


def _opt_fixture(name, policy):
    """JAX's reduced params with nonzero norm gains, its optimizer state,
    and 3 seeded gradient trees in the params' dtypes."""
    jm, jp = cached_model(ARCH, policy="fp32" if policy == "fp32"
                          else "tp_bf16")
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 1.0).astype(x.dtype)
        if "'g'" in jax.tree_util.keystr(p) else x, jp)
    pol = jget_policy(policy)
    cfg = dict(name=name, lr=1e-2, warmup_steps=1, total_steps=10,
               weight_decay=0.1)
    rs = np.random.default_rng(7)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rs.standard_normal(x.shape).astype(np.float32) * 0.3, x.dtype), jp)
        for _ in range(3)]
    return jp, pol, cfg, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("policy", ["fp32", "prod_tp"])
def test_apply_update_matches_jax(name, policy):
    """3 updates from JAX's state on the stacked tree (pattern norm gains
    [R, d] decayed and, under Adafactor, factored; ``norm_f`` neither),
    bf16 moments under ``prod_tp``; re-quantisation by RNE on both sides."""
    jp, pol, cfg, grads = _opt_fixture(name, policy)
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**cfg), pol)
    tstate = from_jax_state({"params": _np(jp), "opt": _np(jstate)}, "cpu")
    tp, tstate = tstate["params"], tstate["opt"]
    upd = jax.jit(lambda p, g, s: jopt.apply_update(
        p, g, s, jopt.OptConfig(**cfg), pol))
    for g in grads:
        jp, jstate, jm = upd(jp, g, jstate)
        tp, tstate, tm = topt.apply_update(
            tp, from_jax_tree(_np(g), "cpu"), tstate, topt.OptConfig(**cfg),
            get_policy(policy))
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(
            jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for p, want, got in _same_paths(jstate, tstate):
        if "step" in p:
            continue
        assert str(want.dtype) == str(got.dtype).replace("torch.", ""), p
        if got.dtype == torch.bfloat16:     # bf16 moments: an ulp here and there
            assert _rel(got, want) < 2.0 ** -8, (p, _rel(got, want))
        else:   # prod_tp: the clip scale of a bf16 gradient's norm
            tol = 1e-6 if policy == "fp32" else 1e-5
            assert _rel(got, want) < tol, (p, _rel(got, want))
    for p, want, got in _same_paths(jp, tp):
        if policy == "fp32":
            assert _rel(got, want) < 1e-6, p
        else:       # a master 1e-7 apart may round to the next bf16
            assert _rel(got, want) < 2.0 ** -8, p
    if name == "adafactor":     # the stacked [R, d] norm gain is factored
        assert set(tstate["v"]["pattern"][0]["norm1"]["g"]) == {"row",
                                                                "col"}
        assert set(tstate["v"]["norm_f"]["g"]) == {"full"}


def test_weight_decay_follows_the_stacked_rank():
    """Zero gradients: AdamW moves only by decay, so exactly the leaves of
    rank >= 2 move: the pattern's [R, d] norm gains do, ``norm_f`` not."""
    m = _tmodel("fp32")
    tree = stack_layers(m.init(0), m.cfg)
    tree["norm_f"]["g"] = tree["norm_f"]["g"] + 1.0
    tree["pattern"][0]["norm1"]["g"] = tree["pattern"][0]["norm1"]["g"] + 1.0
    cfg = topt.OptConfig(lr=0.1, warmup_steps=0, total_steps=10,
                         weight_decay=0.5)
    pol = get_policy("fp32")
    state = topt.init_opt_state(tree, cfg, pol)
    zero = [torch.zeros_like(x) for x in leaves(tree)]
    new, _, _ = topt.apply_update(tree, unflatten(tree, zero), state, cfg,
                                  pol)
    assert torch.equal(new["norm_f"]["g"], tree["norm_f"]["g"])
    assert (new["pattern"][0]["norm1"]["g"]
            < tree["pattern"][0]["norm1"]["g"]).all()


def test_stochastic_requant_lands_on_the_grid_unbiased_and_seeded():
    """``prod_tp`` re-quantises the master stochastically: the values are
    bf16, unbiased (the mean of 400k draws of a value 0.3 ulp above a grid
    point within 4 sigma of it), a pure function of (seed, step, leaf),
    and different for another step."""
    x = torch.full((400_000,), 1.0 + 0.3 * 2.0 ** -7)
    q = softfloat.quantize(x, "fp16alt", "stochastic",
                           generator=topt.sr_generator(5, 3, 2, "cpu"))
    assert torch.equal(q, q.to(torch.bfloat16).to(torch.float32))
    assert set(q.unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
    sigma = 2.0 ** -7 * (0.3 * 0.7 / x.numel()) ** 0.5
    assert abs(float(q.double().mean()) - float(x[0])) < 4 * sigma
    again = softfloat.quantize(x, "fp16alt", "stochastic",
                               generator=topt.sr_generator(5, 3, 2, "cpu"))
    other = softfloat.quantize(x, "fp16alt", "stochastic",
                               generator=topt.sr_generator(5, 4, 2, "cpu"))
    assert torch.equal(q, again) and not torch.equal(q, other)
    # through apply_update: bf16 params, seeded, differing from RNE
    m = _tmodel("prod_tp")
    tree = stack_layers(m.init(0), m.cfg)
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    pol = get_policy("prod_tp")
    state = topt.init_opt_state(tree, cfg, pol)
    rs = torch.Generator().manual_seed(1)
    g = unflatten(tree, [torch.randn(x.shape, generator=rs)
                         for x in leaves(tree)])
    a = topt.apply_update(tree, g, state, cfg, pol, sr_seed=9)[0]
    b = topt.apply_update(tree, g, state, cfg, pol, sr_seed=9)[0]
    c = topt.apply_update(tree, g, state, cfg, pol)[0]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert all(x.dtype == torch.bfloat16 for x in leaves(a))
    assert not all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(c)))


def test_unported_sharding_pieces_raise():
    """Training under a mesh is ported (``tests/test_torch_train_mesh.py``,
    ``tests/test_torch_train_mesh_archs.py``): ``--mesh pod1`` without 256
    ranks raises JAX's ``_mk_mesh`` message, and the archs of ROADMAP
    Queue 1 item 8b.3 (MLA, MoE) build a step on a model axis."""
    import numpy as np_
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import Mesh
    for flag, n in (("pod1", 256), ("pod2", 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices, have 1"):
            tlaunch.main(["--device", "cpu", "--mesh", flag])
    specs = topt.opt_state_specs({"w": (None, "model")},
                                 {"step": 0, "master": {"w": torch.empty(
                                     (4, 8), device="meta")}})
    assert specs == {"step": (), "master": {"w": ("data", "model")}}
    devices = np_.arange(2).reshape(1, 2)
    mesh = Mesh(("data", "model"), devices, 0,
                {"data": spmd.Group([0], 0, None),
                 "model": spmd.Group([0, 1], 0, None)},
                spmd.Group([0, 1], 0, None))
    for arch in ("minicpm3-4b", "qwen3-moe-30b-a3b"):
        assert callable(tstep.make_train_step(_tmodel("tp_bf16", arch=arch),
                                              topt.OptConfig(), mesh=mesh))


# ---------------------------------------------------------------------------
# the step and the loop against JAX's jitted step
# ---------------------------------------------------------------------------
def _jax_start(policy, cfg):
    jm, jp = cached_model(ARCH, policy=policy)
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**cfg),
                                 jget_policy(policy))
    return jm, jp, jstate


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
def test_train_step_matches_jax(policy):
    """One step from JAX's state on one batch; ``compress_grads`` without a
    mesh changes nothing, as in JAX."""
    cfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jm, jp, jstate = _jax_start(policy, cfg)
    toks, labels = _batch(4)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jp2, js2, jmet = jax.jit(jmake_step(jm, jopt.OptConfig(**cfg), None))(
        jp, jstate, batch)
    m = _tmodel(policy)
    st = from_jax_state({"params": _np(jp), "opt": _np(jstate)}, "cpu")
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    outs = [tstep.make_train_step(m, topt.OptConfig(**cfg), None,
                                  compress_grads=c)(
                                      st["params"], st["opt"], tbatch)
            for c in (None, "fp8")]
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        assert torch.equal(a, b)
    tp2, ts2, tmet = outs[0]
    assert set(tmet) == {"loss", "lr", "grad_norm"}
    tol = 5e-3 if policy == "tp_bf16" else 1e-5
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= tol
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) < (
        BF16_REL if policy == "tp_bf16" else F32_REL)
    for p, want, got in _same_paths(js2["master"], ts2["master"]):
        assert _rel(got, want) < (1e-2 if policy == "tp_bf16" else 1e-4), p


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
def test_five_loop_steps_match_jax(policy, tmp_path):
    """The port's ``TrainLoop`` from JAX's state for 5 steps against JAX's
    jitted step fed the port's batches."""
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jm, jp, jstate = _jax_start(policy, cfg)
    m = _tmodel(policy)
    dcfg = DataConfig(vocab=256, seq_len=32, global_batch=4)
    loop = TrainLoop(m, topt.OptConfig(**cfg), dcfg,
                     LoopConfig(total_steps=5, log_every=0, ckpt_every=0))
    st = from_jax_state({"params": _np(jp), "opt": _np(jstate)}, "cpu")
    loop.params, loop.opt_state = st["params"], st["opt"]
    log = loop.run()
    jstep = jax.jit(jmake_step(jm, jopt.OptConfig(**cfg), None))
    data = SyntheticLMData(dcfg)
    for i in range(5):
        b = {k: jnp.asarray(v.numpy()) for k, v in data.batch_at(i).items()}
        jp, jstate, jmet = jstep(jp, jstate, b)
        tol = 5e-3 if policy == "tp_bf16" else 1e-5
        assert abs(log[i]["loss"] - float(jmet["loss"])) <= tol, i
    assert [r["step"] for r in log] == list(range(5))
    moved = _same_paths(jstate["master"], st["opt"]["master"])
    for (p, want, got), (_, _, start) in zip(
            _same_paths(jstate["master"], loop.opt_state["master"]), moved):
        if policy == "fp32":
            assert _rel(got, want) < 1e-4, p
        else:       # against how far the master moved in 5 steps
            diff = _f32(got) - _f32(want)
            move = _f32(want) - _f32(start)
            assert np.linalg.norm(diff) < 0.1 * np.linalg.norm(move), p
