"""What training under a mesh is checked on: cases run on every rank of
``launch.spmd.spawn(rank_main, ...)`` (the CPU tests) or
``spawn(card_rank, ...)`` (``chip_smoke.train_mesh_phase``), each
returning CPU tensors and numbers for the caller to hold against the
unsharded step.  The rank functions live here, in an importable module:
under ``spawn`` a function of a test module or a ``__main__`` script
cannot be pickled into the child.

``rank_main(rank, world, plan)`` runs ``plan``, a list of ``(name, case,
kwargs)``; a case is ``fn(mesh_of, **kwargs)`` with ``mesh_of((dp,
tp))`` the ``(data, model)`` mesh of those sizes (built once, in plan
order, on every rank):

  * ``step``: one step of ``make_train_step(mesh=)`` from given whole
    state on this rank's rows of a global batch: the loss, the gradient
    norm, every leaf's gradient (``loss_and_grads``) and the master and
    params after the step, all gathered whole;
  * ``compress``: ``compress_sync_local`` on given per-rank gradients and
    error feedback (RNE), twice, the second from the first's residual;
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

import os
import time

import torch

from ..core.tree import leaves
from ..data.pipeline import DataConfig, SyntheticLMData
from ..launch import spmd
from ..launch.mesh import make_serving_mesh
from ..models.convert import stack_layers
from ..models.registry import build_model
from ..models.sharding import gather_whole, local_shard, map_specs, shard_params
from ..optim.optimizer import OptConfig, init_opt_state
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
def step(mesh_of, *, dims, state, batch, policy, opt, arch="fpnew-case-study",
         remat_policy="full", device="cpu", sr_seed=None) -> dict:
    mesh = mesh_of(dims)
    model = _model(arch, policy, device, remat_policy=remat_policy)
    lay, params, ostate = shard_state(model, _to(state, device), mesh)
    rows = {k: v.to(device) for k, v in
            ts.local_rows(batch, mesh).items()}
    loss, grads = ts.loss_and_grads(model, params, rows, mesh)
    g = [gather_whole(x, s, mesh) for x, s in zip(grads, lay.p)]
    fn = ts.make_train_step(model, OptConfig(**opt), mesh)
    p2, s2, met = fn(params, ostate, rows, sr_seed=sr_seed)
    specs = lay.state_specs(s2)
    return _cpu(dict(loss=float(met["loss"]), grad_loss=float(loss),
                     grad_norm=float(met["grad_norm"]), grads=g,
                     master=leaves(whole(s2["master"], specs["master"],
                                         mesh)),
                     params=leaves(whole(p2, lay.param_specs, mesh))))


def compress(mesh_of, *, dims, grads, efs, fmt) -> dict:
    from ..optim.grad_compress import compress_sync_local
    mesh = mesh_of(dims)
    dp = mesh.group("data")
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
         device="cpu") -> dict:
    """The twin (ZeRO-1) and the plain mesh step, ``steps`` steps from
    ``state`` on ``batch_at(k)``: params per leaf (bitwise flags and
    largest relative difference), state bytes a rank and whole."""
    mesh = mesh_of(dims)
    model = _model("fpnew-case-study", policy, device)
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
            seq, compress_grads=None, device="cpu") -> dict:
    """A loop on mesh ``first`` checkpoints at ``steps``; a loop on
    ``then`` restores it and runs ``more`` steps.  Returns both loops'
    losses, whether the restored blocks equal the local shards of the
    saved whole leaves, or the restore's refusal."""
    model = _model("fpnew-case-study", policy, device)
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
    from ..models.sharding import spec_leaves
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
            meshes[dims] = make_serving_mesh(*dims)
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
