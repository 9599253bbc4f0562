"""What training under a mesh is checked on: cases run on every rank of
``launch.spmd.spawn(rank_main, ...)`` (the CPU tests) or
``spawn(card_rank, ...)`` (``chip_smoke.train_mesh_phase``), each
returning CPU tensors and numbers for the caller to hold against the
unsharded step.  The rank functions live here, in an importable module:
under ``spawn`` a function of a test module or a ``__main__`` script
cannot be pickled into the child.

``rank_main(rank, world, plan)`` runs ``plan``, a list of ``(name, case,
kwargs)``; a case is ``fn(mesh_of, **kwargs)`` with ``mesh_of((dp,
tp))`` the ``(data, model)`` mesh of those sizes, ``mesh_of((pod, dp,
tp))`` the ``(pod, data, model)`` one (built once, in plan order, on
every rank):

  * ``step``: one step of ``make_train_step(mesh=)`` from given whole
    state on this rank's rows of a global batch: the loss, the MoE aux
    statistic, the gradient norm, every leaf's gradient
    (``loss_and_grads``) and the master and params after the step, all
    gathered whole; ``mutate`` names a deliberate fault of
    ``MUTATIONS`` to run it under (what the tests' bounds must catch);
  * ``compress``: ``compress_sync_local`` on given per-rank gradients and
    error feedback (RNE) over the flattened data ``axes``, twice, the
    second from the first's residual;
  * ``compressed_loop``: a compressed ``TrainLoop``: losses, error
    feedback and wire bytes;
  * ``zero``: the ``jit_train_step`` twin (ZeRO-1) against the plain
    mesh step with the state whole over ``data``, several steps;
  * ``elastic``: a ``TrainLoop`` checkpointing on one mesh and one
    restoring it on another (and the error feedback refused across data
    sizes);
  * ``restore``: a ``TrainLoop`` restoring a given checkpoint directory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time

import numpy as np
import torch

from ..core.tree import leaves, unflatten
from ..data.pipeline import DataConfig, SyntheticLMData
from ..launch import spmd
from ..launch.mesh import _mk_mesh, make_serving_mesh
from ..models import attention, moe, ssm
from ..models.convert import stack_layers
from ..models.registry import build_model
from ..models.sharding import (gather_whole, local_shard, map_specs,
                               shard_params, spec_leaves)
from ..optim.optimizer import OptConfig, apply_update, init_opt_state
from . import train_step as ts
from .loop import LoopConfig, TrainLoop

F32 = torch.float32


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_cpu(v) for v in x]
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _model(arch, policy, device, reduced=True, **cfg):
    return build_model(arch, policy=policy, reduced=reduced, device=device,
                       prefill_backend="dense", **cfg)


def _to(tree, device):
    return map_specs(lambda x, _: x.to(device) if isinstance(
        x, torch.Tensor) and x.dim() else x, tree, tree)


def shard_state(model, state, mesh, opt_specs=None):
    """``(layout, params, opt_state)``: this rank's blocks of the whole
    trainer ``state`` (``{"params", "opt"}``), the state under the params'
    layout or under ZeRO-1 ``opt_specs``."""
    lay = ts.param_layout(model, mesh, opt_specs)
    params = shard_params(state["params"], mesh, model.cfg)
    opt = ts.shard_opt_state(state["opt"], lay.state_specs(state["opt"]),
                             mesh)
    return lay, params, opt


def whole(tree, specs, mesh):
    return map_specs(lambda x, s: gather_whole(x, s, mesh), tree, specs)


# ---------------------------------------------------------------------------
# CPU cases
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _raw_expert_weights(params, m):
    return [params[k] for k in ("w_gate", "w_up", "w_down")]


#: deliberate faults the tests' gradient bounds must catch: the expert
#: weights' gradient left M times over, and one ``grad_sum`` taken out
#: (the recurrent mixers' ``col`` input, MLA's head-sharded latents)
MUTATIONS = {
    "expert_grad_m_times": lambda: _patched(moe, "_expert_weights",
                                            _raw_expert_weights),
    "no_col_input_sum": lambda: _patched(ssm, "col_input",
                                         lambda x, w, width, group: x),
    "no_mla_heads_sum": lambda: _patched(attention, "_into_heads",
                                         lambda t, group: t),
}


def step(mesh_of, *, dims, state, batch, policy, opt, arch="fpnew-case-study",
         remat_policy="full", device="cpu", sr_seed=None,
         mutate=None) -> dict:
    if mutate is not None:
        with MUTATIONS[mutate]():
            return step(mesh_of, dims=dims, state=state, batch=batch,
                        policy=policy, opt=opt, arch=arch,
                        remat_policy=remat_policy, device=device,
                        sr_seed=sr_seed)
    mesh = mesh_of(dims)
    model = _model(arch, policy, device, remat_policy=remat_policy)
    lay, params, ostate = shard_state(model, _to(state, device), mesh)
    rows = {k: v.to(device) for k, v in
            ts.local_rows(batch, mesh).items()}
    loss, grads, aux = ts.loss_and_grads(model, params, rows, mesh,
                                         return_aux=True)
    g = [gather_whole(x, s, mesh) for x, s in zip(grads, lay.p)]
    fn = ts.make_train_step(model, OptConfig(**opt), mesh)
    p2, s2, met = fn(params, ostate, rows, sr_seed=sr_seed)
    specs = lay.state_specs(s2)
    return _cpu(dict(loss=float(met["loss"]), grad_loss=float(loss),
                     aux=float(aux),
                     grad_norm=float(met["grad_norm"]), grads=g,
                     master=leaves(whole(s2["master"], specs["master"],
                                         mesh)),
                     params=leaves(whole(p2, lay.param_specs, mesh))))


def compress(mesh_of, *, dims, grads, efs, fmt, axes=("data",)) -> dict:
    from ..optim.grad_compress import compress_sync_local
    mesh = mesh_of(dims)
    dp = mesh.group(tuple(axes))
    g, ef = grads[dp.index], efs[dp.index]
    out = []
    for _ in range(2):
        s, ef = compress_sync_local(g, ef, group=dp, fmt=fmt,
                                    n_replicas=dp.size)
        out.append((s, ef))
    return _cpu({"synced": [o[0] for o in out], "ef": [o[1] for o in out]})


def _loop(model, mesh, *, steps, batch, seq, opt, seed=0, **lc):
    data = DataConfig(vocab=model.cfg.vocab, seq_len=seq, global_batch=batch)
    return TrainLoop(model, OptConfig(**opt), data,
                     LoopConfig(total_steps=steps, log_every=0, seed=seed,
                                **lc), mesh=mesh)


def compressed_loop(mesh_of, *, dims, fmt, policy, opt, steps, batch, seq,
                    device="cpu") -> dict:
    mesh = mesh_of(dims)
    model = _model("fpnew-case-study", policy, device)
    loop = _loop(model, mesh, steps=1, batch=batch, seq=seq, opt=opt,
                 ckpt_every=0, compress_grads=fmt)
    spmd.reset_stats()
    loop.run()
    ef1 = max(float(e.abs().max()) for e in leaves(loop.ef))
    loop.loop_cfg.total_steps = steps
    loop.run()
    return dict(losses=[r["loss"] for r in loop.metrics_log],
                ef_max_after_1=ef1,
                wire_bytes=spmd.snapshot()["wire_bytes"],
                ef_shape=list(leaves(loop.ef)[0].shape))


def zero(mesh_of, *, dims, state, policy, opt, steps, batch, seq,
         device="cpu", arch="fpnew-case-study") -> dict:
    """The twin (ZeRO-1) and the plain mesh step, ``steps`` steps from
    ``state`` on ``batch_at(k)``: params per leaf (bitwise flags and
    largest relative difference), state bytes a rank and whole."""
    mesh = mesh_of(dims)
    model = _model(arch, policy, device)
    state = _to(state, device)
    cfg = OptConfig(**opt)
    zstep, args, specs = ts.jit_train_step(model, cfg, mesh,
                                           batch_size=batch, seq_len=seq)
    _, pz, sz = shard_state(model, state, mesh, specs["opt"])
    lay, pp, sp = shard_state(model, state, mesh)
    plain = ts.make_train_step(model, cfg, mesh)
    data = SyntheticLMData(DataConfig(vocab=model.cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    for k in range(steps):
        rows = {n: v.to(device) for n, v in
                ts.local_rows(data.batch_at(k), mesh).items()}
        pz, sz, mz = zstep(pz, sz, rows)
        pp, sp, mp = plain(pp, sp, rows)
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in leaves(t)
                           if x.dim())
    rel = [float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))
           for a, b in zip(leaves(pz), leaves(pp))]
    return dict(bitwise=[torch.equal(a, b) for a, b in
                         zip(leaves(pz), leaves(pp))],
                rel=rel, losses=(float(mz["loss"]), float(mp["loss"])),
                state_bytes=nbytes(sz), plain_state_bytes=nbytes(sp),
                whole_state_bytes=nbytes(args[1]),
                arg_shapes=[list(x.shape) for x in leaves(args[0])][:2],
                specs_opt_master_embed=specs["opt"]["master"]["embed"])


def elastic(mesh_of, *, first, then, root, policy, opt, steps, more, batch,
            seq, compress_grads=None, device="cpu",
            arch="fpnew-case-study") -> dict:
    """A loop on mesh ``first`` checkpoints at ``steps``; a loop on
    ``then`` restores it and runs ``more`` steps.  Returns both loops'
    losses, whether the restored blocks equal the local shards of the
    saved whole leaves, or the restore's refusal."""
    model = _model(arch, policy, device)
    kw = dict(batch=batch, seq=seq, opt=opt, compress_grads=compress_grads)
    a = _loop(model, mesh_of(first), steps=steps, ckpt_every=steps,
              ckpt_dir=os.path.join(root, "a"), **kw)
    a.run()
    mesh_b = mesh_of(then)
    try:
        b = _loop(model, mesh_b, steps=steps + more, ckpt_every=0,
                  ckpt_dir=os.path.join(root, "a"), **kw)
    except ValueError as e:
        return dict(first=[r["loss"] for r in a.metrics_log], refused=str(e))
    restored = b.step
    from ..ckpt.checkpoint import restore_pytree
    saved, _ = restore_pytree(a.ckpt.path(steps), b.state_tree())
    same = [torch.equal(local_shard(w, s, mesh_b), x) for w, s, x in zip(
        leaves(saved), _spec_list(b), leaves(b.state_tree()))]
    b.run()
    return dict(first=[r["loss"] for r in a.metrics_log],
                then=[r["loss"] for r in b.metrics_log], restored_at=restored,
                restored_bitwise=same)


def _spec_list(loop):
    return spec_leaves(loop.state_specs())


def restore(mesh_of, *, dims, ckpt_dir, policy, opt, steps, batch, seq,
            device="cpu") -> dict:
    """A loop on ``dims`` restoring ``ckpt_dir``, run to ``steps``: its
    restored step, its whole state at the restore and its losses."""
    mesh = mesh_of(dims)
    model = _model("fpnew-case-study", policy, device)
    loop = _loop(model, mesh, steps=steps, batch=batch, seq=seq, opt=opt,
                 ckpt_every=0, ckpt_dir=ckpt_dir)
    at, state = loop.step, loop.whole_state()
    loop.run()
    return _cpu(dict(restored_at=at, state=leaves(state),
                     losses=[r["loss"] for r in loop.metrics_log]))


def sleep(rank: int, world: int, seconds: float) -> None:
    """A rank that outlives any short ``spawn`` timeout."""
    time.sleep(seconds)


CASES = dict(step=step, compress=compress, compressed_loop=compressed_loop,
             zero=zero, elastic=elastic, restore=restore)


def rank_main(rank: int, world: int, plan) -> dict:
    torch.set_num_threads(1)       # several ranks share the host's cores
    meshes = {}

    def mesh_of(dims):
        if dims not in meshes:
            meshes[dims] = (make_serving_mesh(*dims) if len(dims) == 2 else
                            _mk_mesh(dims, ("pod", "data", "model")))
        return meshes[dims]

    out = {"rank": rank}
    for name, case, kw in plan:
        spmd.reset_stats()
        out[name] = CASES[case](mesh_of, **kw)
        out[name + "_spmd"] = spmd.snapshot()
    return out


# ---------------------------------------------------------------------------
# the card: chip_smoke's training-under-a-mesh phase
# ---------------------------------------------------------------------------
def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


def card_rank(rank: int, world: int, spec: dict) -> dict:
    """One of two ranks on one card (gloo): cases (e)-(i) of
    ``chip_smoke.train_mesh_phase`` on full-width fpnew-case-study
    (``spec``: ``policy``, ``seq``, ``batch``, ``opt``, ``steps`` per
    case, ``root`` a shared directory).  Every number is this rank's."""
    # bitwise gates across runs need the deterministic kernels
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev, pol = "cuda", spec["policy"]
    seq, batch, opt = spec["seq"], spec["batch"], spec["opt"]
    cfg = OptConfig(**opt)
    st = spec["steps"]
    model = _model("fpnew-case-study", pol, dev, reduced=False)
    m21, m12 = make_serving_mesh(world, 1), make_serving_mesh(1, world)
    data = SyntheticLMData(DataConfig(vocab=model.cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    b0 = {k: v.to(dev) for k, v in data.batch_at(0).items()}
    out = {"rank": rank}

    def loop(mesh, steps, **lc):
        lc.setdefault("ckpt_every", 0)
        return _loop(model, mesh, steps=steps, batch=batch, seq=seq, opt=opt,
                     seed=spec["seed"], **lc)

    def timed_run(lp, steps):
        lp.loop_cfg.total_steps = steps
        spmd.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, spmd.snapshot()

    # the unsharded first step on the whole batch (the oracle of (e), (g))
    whole = stack_layers(model.init(spec["seed"]), model.cfg)
    ostate = init_opt_state(whole, cfg, model.policy)
    m0 = [x.clone() for x in leaves(ostate["master"])]
    u_loss, u_grads = ts.loss_and_grads(model, whole, b0)
    _, u_state, u_met = ts.make_train_step(model, cfg)(whole, ostate, b0)
    u_update = [a - b for a, b in zip(leaves(u_state["master"]), m0)]
    u_gnorm = float(u_met["grad_norm"])
    # a leaf whose reference gradient is exactly zero moves by its weight
    # decay alone in both runs: nothing of the sync to compare there
    live = [bool(g.any()) for g in u_grads]
    del u_state, ostate

    # (e) dp (world, 1), plain sync, in legs: the master after step 1,
    # the params at (h)'s step, the one checkpoint at ``ckpt_at`` (the
    # state kept for (i)), then the rest without writes
    e = loop(m21, 1, ckpt_dir=os.path.join(spec["root"], "e"))
    saver, e.ckpt = e.ckpt, None
    t1, _ = timed_run(e, 1)
    # the first step's update (master after it less master before it)
    # against the unsharded step's, over the live leaves: by relative L2
    # of the whole tree and of each leaf.  An unchanged master reads 1.0;
    # a sound sync reads the share of Adam's sign(g) lr steps that flip
    # where a gradient sits within bf16 rounding of 0
    update = [a - b for a, b in zip(
        leaves(e.whole_state()["opt"]["master"]), m0)]
    pairs = [(a, b) for a, b, ok in zip(update, u_update, live) if ok]
    diff = sum(float((a.double() - b.double()).square().sum())
               for a, b in pairs)
    norm = sum(float(b.double().square().sum()) for _, b in pairs)
    leaf_rel = [_rel(a, b) for a, b in pairs]
    update_rel = (diff / norm) ** 0.5
    del update, u_update, m0, pairs
    t_h, _ = timed_run(e, st["h"])
    at_h = [x.clone() for x in leaves(e.params)]
    e.ckpt = saver
    t5, _ = timed_run(e, spec["ckpt_at"])     # its final save, synced
    at_5 = [x.clone() for x in leaves(e.whole_state())]
    e.ckpt = None
    t_e, coll = timed_run(e, st["e"])
    m0 = e.metrics_log[0]
    out["e"] = dict(losses=[r["loss"] for r in e.metrics_log],
                    grad_norms=[r["grad_norm"] for r in e.metrics_log],
                    dts=[r["dt"] for r in e.metrics_log],
                    wall_s=t1 + t_h + t5 + t_e, spmd=coll,
                    spmd_steps=st["e"] - spec["ckpt_at"],
                    first_loss_vs_unsharded=abs(m0["loss"] - float(u_loss)),
                    first_grad_norm=m0["grad_norm"],
                    unsharded_grad_norm=u_gnorm,
                    update_rel_after_1=update_rel,
                    update_leaf_rel_max=max(leaf_rel),
                    update_leaves=len(leaf_rel), leaves=len(live))
    del e

    # (f) the compressed sync
    for fmt in spec["compress"]:
        f = loop(m21, 1, compress_grads=fmt)
        t1, c1 = timed_run(f, 1)
        ef1 = max(float(x.abs().max()) for x in leaves(f.ef))
        t2, c2 = timed_run(f, st["f"])
        wire = {k: c1["wire_bytes"].get(k, 0) + c2["wire_bytes"].get(k, 0)
                for k in set(c1["wire_bytes"]) | set(c2["wire_bytes"])}
        out["f_" + fmt] = dict(losses=[r["loss"] for r in f.metrics_log],
                               dts=[r["dt"] for r in f.metrics_log],
                               wall_s=t1 + t2, ef_max_after_1=ef1,
                               first_grad_norm=f.metrics_log[0]["grad_norm"],
                               wire_bytes_per_step={
                                   k: v / st["f"] for k, v in wire.items()},
                               collectives=c1["collectives"]
                               + c2["collectives"])
        del f

    # (g) tp (1, world): every leaf's gradient, then a short loop
    params = shard_params(whole, m12, model.cfg)
    lay = ts.param_layout(model, m12)
    spmd.reset_stats()
    g_loss, g_grads = ts.loss_and_grads(model, params, b0, m12)
    g_coll = spmd.snapshot()
    rels = [_rel(gather_whole(g, s, m12), u) for g, s, u in
            zip(g_grads, lay.p, u_grads)]
    del params, g_grads, u_grads
    g = loop(m12, st["g"])
    t_g, c_g = timed_run(g, st["g"])
    out["g"] = dict(losses=[r["loss"] for r in g.metrics_log],
                    dts=[r["dt"] for r in g.metrics_log], wall_s=t_g,
                    first_loss_vs_unsharded=abs(float(g_loss) - float(u_loss)),
                    grad_rel=rels, grad_step_spmd=g_coll, spmd=c_g,
                    local_heads=model.cfg.n_heads // world,
                    local_mlp_cols=model.cfg.d_ff // world,
                    local_vocab_rows=int(g.params["embed"].shape[0]))
    del g

    # (h) ZeRO-1 through the jit_train_step twin
    zstep, args, specs = ts.jit_train_step(model, cfg, m21,
                                           batch_size=batch, seq_len=seq)
    state = {"params": whole, "opt": init_opt_state(whole, cfg,
                                                    model.policy)}
    _, pz, sz = shard_state(model, state, m21, specs["opt"])
    del state
    spmd.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dts = []
    for k in range(st["h"]):
        rows = {n: v.to(dev) for n, v in
                ts.local_rows(data.batch_at(k), m21).items()}
        t1 = time.perf_counter()
        pz, sz, mz = zstep(pz, sz, rows)
        float(mz["loss"])
        dts.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in leaves(t)
                           if x.dim())
    out["h"] = dict(bitwise=sum(torch.equal(a, b) for a, b in
                                zip(leaves(pz), at_h)),
                    of=len(at_h), wall_s=time.perf_counter() - t0, dts=dts,
                    state_bytes_rank=nbytes(sz),
                    state_bytes_whole=nbytes(args[1]), spmd=spmd.snapshot())
    del pz, sz, at_h

    # (i) (e)'s step-ckpt_at checkpoint restored under (1, world), held
    # to (e)'s state at that step
    i = loop(m12, spec["ckpt_at"] + st["i"],
             ckpt_dir=os.path.join(spec["root"], "e"))
    same = [torch.equal(local_shard(w, s, m12), x) for w, s, x in zip(
        at_5, _spec_list(i), leaves(i.state_tree()))]
    del at_5
    restored, i.ckpt = i.step, None     # restored: no more writes
    t_i, _ = timed_run(i, spec["ckpt_at"] + st["i"])
    out["i"] = dict(restored_at=restored, bitwise=sum(same), of=len(same),
                    losses=[r["loss"] for r in i.metrics_log], wall_s=t_i)
    out["kernel_launches"] = kernel_launches()
    return out


def kernel_launches() -> dict:
    """This process's launch counts of the hand-written kernels."""
    from ..kernels.decode_attention import decode_attention_cuda
    from ..kernels.dotp_ex import dotp_ex_cuda
    from ..kernels.flash_attention import flash_attention_cuda
    from ..kernels.tp_matmul import tp_matmul_cuda
    from ..kernels.tp_quant import cast_and_pack_cuda, tp_quantize_cuda
    return {fn.__name__: fn.launches for fn in (
        decode_attention_cuda, flash_attention_cuda, tp_matmul_cuda,
        tp_quantize_cuda, cast_and_pack_cuda, dotp_ex_cuda)}


# ---------------------------------------------------------------------------
# the card: chip_smoke's training-under-a-mesh legs of the other archs
# ---------------------------------------------------------------------------
class RouteTape:
    """The MoE router's top-k choices of one unsharded pass (``record``),
    chosen again by the sharded passes (``replay``, in call order,
    cyclically): two bf16 paths flip a near-tied top-k choice of a random
    router, which is not the sharding's doing.  A replayed call takes its
    own router probabilities at the recorded experts, renormalized as
    ``moe.route`` does, so the router's gradient flows as in a free
    pass; a call that routes fewer tokens than were recorded (a data
    shard) takes its ``dp_index``'s contiguous block of them."""

    def __init__(self):
        self.idx = []

    def record(self):
        orig = moe.route

        def rec(x, router, cfg):
            r = orig(x, router, cfg)
            self.idx.append(r[2])
            return r
        return _patched(moe, "route", rec)

    def replay(self, dp_index: int = 0):
        calls = iter(range(1 << 30))

        def pinned(x, router, cfg):
            idx = self.idx[next(calls) % len(self.idx)]
            t = x.shape[0]
            if t != idx.shape[0]:
                idx = idx[dp_index * t:(dp_index + 1) * t]
            probs = torch.softmax(x.to(F32) @ router.to(F32), dim=-1)
            gates = probs.gather(-1, idx)
            if cfg.router_norm_topk:
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                            min=1e-9)
            return probs, gates, idx
        return _patched(moe, "route", pinned)


def lively_norms(tree, seed: int) -> None:
    """Layernorm gains ~ 1 + 0.1 N, shifts and MLP biases ~ 0.1 N, in
    place (the init zeroes a layernorm's gain, so an untrained whisper's
    every state, and its gradient, would be 0)."""
    gen = torch.Generator(device=leaves(tree)[0].device).manual_seed(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif key in ("g", "b", "b_up", "b_down"):
            n = torch.randn(t.shape, generator=gen, device=t.device) * 0.1
            t.copy_(n + 1.0 if key == "g" else n)
    walk(tree)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor) and x.dim())


def _timed_step(fn, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    float(out[2]["loss"])
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _first_step(model, whole, batch, cfg, tape):
    """``(loss, aux, grads, update, ms)`` of the unsharded first step: the
    gradient (routes recorded where ``tape`` is empty, else replayed),
    the update (master after less master before) and the ms of the
    step that made it."""
    with (tape.record() if not tape.idx else tape.replay()):
        loss, grads, aux = ts.loss_and_grads(model, whole, batch,
                                             return_aux=True)
    state = init_opt_state(whole, cfg, model.policy)
    fn = ts.make_train_step(model, cfg)
    with tape.replay():
        (_, state, _), ms = _timed_step(fn, whole, state, batch)
    # the master before the step is the f32 of the params
    update = [a - b.to(F32) for a, b in
              zip(leaves(state["master"]), leaves(whole))]
    return loss, aux, grads, update, ms


def _reference(model, whole, batch, cfg, tape,
               sensitivity: bool = False) -> dict:
    """The unsharded first step on the whole batch (routes recorded):
    loss, aux, every leaf's gradient, the update, which leaves have a
    nonzero gradient, and the step's ms.  ``sensitivity``: also the
    relative move of each leaf's gradient and update, and of the whole
    update, when the recurrent mixers run at half their chunk (another
    order of the same sums: a recurrent stack's own rounding
    sensitivity, as ``chip_smoke``'s serving phases take it)."""
    t0 = time.perf_counter()
    loss, aux, grads, update, ms = _first_step(model, whole, batch, cfg,
                                               tape)
    t1 = time.perf_counter()
    ref = dict(loss=float(loss), aux=float(aux), ms=ms,
               live=[bool(g.any()) for g in grads])
    if sensitivity:
        c = model.cfg
        half = {sub: dataclasses.replace(getattr(c, sub),
                                         chunk=getattr(c, sub).chunk // 2)
                for sub in ("mamba", "mlstm") if getattr(c, sub)}
        _, _, g1, u1, _ = _first_step(model.with_cfg(**half), whole, batch,
                                      cfg, tape)
        ref["grad_sens"] = [_rel(a, b) for a, b in zip(g1, grads)]
        ref["update_sens"] = [_rel(a, b) for a, b in zip(u1, update)]
        pairs = [(a, b) for a, b, ok in zip(u1, update, ref["live"]) if ok]
        ref["update_sens_whole"] = (
            sum(float((a.double() - b.double()).square().sum())
                for a, b in pairs)
            / max(sum(float(b.double().square().sum()) for _, b in pairs),
                  1e-300)) ** 0.5
        del g1, u1, pairs
    t2 = time.perf_counter()
    # held in host memory: the card's is the sharded ranks'
    ref.update(grads=[g.cpu() for g in grads],
               update=[u.cpu() for u in update])
    t3 = time.perf_counter()
    ref.update(seconds=t3 - t0, parts_s=[t1 - t0, t2 - t1, t3 - t2])
    return ref


def _sharded(model, init_whole, mesh, batch, cfg, tape, ref) -> dict:
    """One sharded step from ``init_whole()``'s blocks against ``ref``
    (this rank's numbers; the comparisons on the rank holding ``ref``):
    its loss, aux, ms and collectives, the state's bytes."""
    t_start = time.perf_counter()
    lay = ts.param_layout(model, mesh)
    params = shard_params(init_whole(), mesh, model.cfg)
    state = init_opt_state(params, cfg, model.policy)
    rows = ts.local_rows(batch, mesh)
    dp = mesh.coords["data"]
    torch.cuda.synchronize()
    spmd.reset_stats()
    t0 = time.perf_counter()
    # the step as ``make_train_step``'s: the gradient, then the update
    # under the layout (its gradient compared after)
    with tape.replay(dp):
        loss, grads, aux = ts.loss_and_grads(model, params, rows, mesh,
                                             return_aux=True)
    # the master before the step is the f32 of the params' blocks
    before = leaves(params)
    with torch.no_grad():
        params, state, _ = apply_update(
            params, unflatten(params, grads), state, cfg, model.policy,
            layout=lay)
    float(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    step_spmd = spmd.snapshot()
    t1 = time.perf_counter()
    # every leaf's gradient and update against the whole reference's
    g_sums = _diff_sums(((g, s, b.dtype) for g, s, b in
                         zip(grads, lay.p, before)), mesh,
                        ref and ref["grads"])
    del grads
    specs = spec_leaves(lay.state_specs(state)["master"])
    u_sums = _diff_sums(((a - b.to(F32), s, F32) for a, b, s in
                         zip(leaves(state["master"]), before, specs)),
                        mesh, ref and ref["update"])
    del before
    out = dict(loss=float(loss), aux=float(aux), ms=ms,
               setup_s=t0 - t_start, compare_s=time.perf_counter() - t1,
               spmd=step_spmd, state_bytes=_nbytes(state),
               param_bytes=_nbytes(params))
    if ref is not None:
        rel = lambda d, n: d ** 0.5 / max(n ** 0.5, 1e-30)
        live = [(d, n) for (d, n), ok in zip(u_sums, ref["live"]) if ok]
        out.update(grad_rel=[rel(d, n) for d, n in g_sums],
                   # a leaf with no gradient has nothing to compare
                   update_leaf_rel=[rel(d, n) if ok else None for (d, n), ok
                                    in zip(u_sums, ref["live"])],
                   update_rel=rel(sum(d for d, _ in live),
                                  sum(n for _, n in live)))
    return out


def _diff_sums(blocks, mesh, want):
    """Per leaf, ``(sum (x - ref)^2, sum ref^2)`` over the whole leaf, on
    the rank holding the reference ``want`` (whole leaves in host memory;
    None on the other ranks, which get None back).  ``blocks`` yields
    this rank's ``(block, spec, reference dtype)`` a leaf: a split leaf's
    blocks are compared on their own ranks, each sent its block of the
    reference by the holder (host memory, no whole leaf gathered); a
    replicated leaf, the same on every rank, on the holder alone."""
    holder = want is not None
    everyone = mesh.everyone
    peers = [r for r in everyone.ranks if r != everyone.ranks[0]]
    where = {r: dict(zip(mesh.axis_names, map(int, np.argwhere(
        mesh.devices == r)[0]))) for r in peers}
    sums = []
    for i, (x, s, dtype) in enumerate(blocks):
        split = any(mesh.shape[a] > 1 for ax in s if ax is not None
                    for a in (ax if isinstance(ax, tuple) else (ax,)))
        w = None
        if holder:
            w = local_shard(want[i], s, mesh) if split else want[i]
        if split:
            for r in peers:
                blk = (local_shard(want[i], s, mesh, where[r]) if holder
                       else torch.empty(x.shape, dtype=dtype))
                blk = spmd.broadcast(blk.contiguous(), everyone)
                if mesh.rank == r:
                    w = blk
        if w is None:
            sums.append((0.0, 0.0))
            continue
        w = w.to(x.device, F32)
        sums.append((float(torch.linalg.vector_norm(
            x.to(F32) - w, dtype=torch.float64)) ** 2,
            float(torch.linalg.vector_norm(w, dtype=torch.float64)) ** 2))
    got = spmd.gather_objects(sums, everyone)
    if not holder:
        return None
    return [(sum(r[i][0] for r in got), sum(r[i][1] for r in got))
            for i in range(len(sums))]


def _await(wait: dict, group) -> float:
    """Hold every rank until ``wait["path"]`` exists (the caller's phase
    that shares the card has ended); then the card's free GiB, failing
    below ``wait["need_gib"]``."""
    while not os.path.exists(wait["path"]):
        time.sleep(0.2)
    spmd.barrier(group)
    free = torch.cuda.mem_get_info()[0] / 2 ** 30
    if free < wait["need_gib"]:
        raise RuntimeError(f"{free:.1f} GiB free on the card before leg "
                           f"{wait['before']}, it needs {wait['need_gib']}")
    return free


def card_arch_rank(rank: int, world: int, spec: dict) -> dict:
    """One of two ranks on one card (gloo): the legs of
    ``chip_smoke.train_mesh_archs_phase``, each an arch at full width cut
    in depth (``spec["legs"]``: ``tag``, ``arch``, ``cfg`` overrides, the
    ``dims`` it runs at, ``lively``, ``sensitivity``, a ``policy`` of its
    own), ``spec``'s ``policy``, ``seq``, ``batch``, ``opt`` and
    ``seed``, one step a leg and mesh; ``wait`` (``before`` a leg's tag,
    ``path``, ``need_gib``): the legs from that one on start once the
    path exists and the card has that much free (``_await``).  Rank 0
    also runs the unsharded reference, with the MoE routes recorded for
    the sharded step (``RouteTape``); every comparison is made there,
    every other number is this rank's."""
    torch.set_num_threads(2)
    pol = spec["policy"]
    # the legs' shapes change from one to the next: grow segments, do
    # not fragment fixed ones (set before this process's first CUDA
    # allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

    def release():
        # hand what this rank freed back to the card: the other rank
        # allocates from the same 80 GB
        gc.collect()
        torch.cuda.empty_cache()
    cfg = OptConfig(**spec["opt"])
    meshes = {d: make_serving_mesh(*d) for d in ((1, world), (world, 1))}
    everyone = meshes[(1, world)].everyone
    wait = spec["wait"]
    t_spawn = time.perf_counter()
    out = {"rank": rank}
    for leg in spec["legs"]:
        if leg["tag"] == wait["before"]:
            t0 = time.perf_counter()
            out["waited"] = dict(before=leg["tag"],
                                 free_gib=_await(wait, everyone),
                                 s=time.perf_counter() - t0,
                                 at_s=t0 - t_spawn)
        t_leg = time.perf_counter()
        model = _model(leg["arch"], leg.get("policy", pol), "cuda",
                       reduced=False, **leg["cfg"])
        c = model.cfg
        enc = c.encoder
        data = SyntheticLMData(DataConfig(
            vocab=c.vocab, seq_len=spec["seq"], global_batch=spec["batch"],
            frontend="audio" if enc is not None else None,
            n_frontend_tokens=enc.n_frames if enc is not None else 0,
            d_model=c.d_model))
        batch = {k: v.to("cuda") for k, v in data.batch_at(0).items()}

        def init_whole():
            # the whole trainer tree, made anew where it is needed (a
            # copy kept beside the shards would cost the card its bytes)
            w = stack_layers(model.init(spec["seed"]), c)
            if leg.get("lively"):
                lively_norms(w, spec["seed"])
            return w

        n_params = sum(x.numel() for x in leaves(ts.whole_tree(model)))
        tape, ref = RouteTape(), None
        torch.cuda.reset_peak_memory_stats()
        if rank == 0:
            ref = _reference(model, init_whole(), batch, cfg, tape,
                             sensitivity=leg.get("sensitivity", False))
        release()
        spmd.barrier(everyone)
        # the routes rank 0 recorded, on every rank
        tape.idx = [t.cuda() for t in spmd.gather_objects(
            [t.cpu() for t in tape.idx], everyone)[0]]
        res = dict(arch=leg["arch"], policy=leg.get("policy", pol),
                   layers=c.n_layers, n_params=n_params,
                   routes_recorded=len(tape.idx),
                   ready_s=time.perf_counter() - t_leg)
        if ref is not None:
            res["unsharded"] = {k: ref[k] for k in (
                "loss", "aux", "ms", "grad_sens", "update_sens",
                "update_sens_whole", "seconds", "parts_s") if k in ref}
            res["unsharded"]["live_leaves"] = sum(ref["live"])
        for dims in leg["dims"]:
            res[f"{dims[0]}x{dims[1]}"] = _sharded(
                model, init_whole, meshes[dims], batch, cfg, tape, ref)
            release()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del ref, tape
        release()
        spmd.barrier(everyone)
        res["wall_s"] = time.perf_counter() - t_leg
        out[leg["tag"]] = res
    out["kernel_launches"] = kernel_launches()
    return out
