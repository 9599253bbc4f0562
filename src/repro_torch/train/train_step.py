"""Train-step factory: model + optimizer + policy -> one step, the JAX
package's ``train/train_step.py``.

    step(params, opt_state, batch, sr_seed=None)
        -> (params, opt_state, metrics)
    step(params, opt_state, batch, ef, sr_seed)          (compressed sync)
        -> (params, opt_state, metrics, ef)

``params`` is the trainer's tree in JAX's own layout (``pattern`` stacked
``[R, ...]``); ``batch`` may hold ``frontend_embeds`` (patch or frame
embeddings), which pass to ``forward_train``; the gradient is
``torch.autograd.grad`` of ``Model.forward_train`` with respect to its
leaves, the update ``optim.optimizer.apply_update``.  ``metrics`` holds
the step's ``loss`` and ``grad_norm`` (0-d device tensors) and ``lr``
(host): reading them is the caller's sync.

Under a ``(data, model)`` mesh (``launch.mesh``; every rank runs the
step, JAX runs one program):

  * ``params`` are this rank's model shards
    (``models.sharding.shard_params``), ``batch`` its rows of the global
    batch (``local_rows``);
  * the plain sync: each rank's gradient of its share of the GLOBAL
    mean NLL (its live labels over the global count, as JAX's step over
    the global batch) is summed over the data axis in f32;
  * ``compress_grads`` (``fp8`` / ``fp16alt``): JAX's ``local_grad_body``
    -- local gradients of the local mean, each leaf through
    ``optim.grad_compress.compress_sync_local`` with stochastic rounding
    decorrelated per replica, the loss the mean of the ranks' means,
    error feedback a ``[1, ...]`` slice of JAX's ``[n_dp, ...]`` buffer
    per rank (``init_error_feedback``);
  * ``jit_train_step`` is the twin of JAX's fully sharded jit: the
    optimizer state held under ZeRO-1 (``opt_state_specs`` over
    ``data``), each rank updating its slice and the new params gathered.

As in JAX, ``compress_grads`` takes effect only under a mesh, and any
arch trains on any mesh.  The MoE aux loss follows JAX's by mesh:

  =========================  ===========================================
  mesh / sync                the aux in the loss
  =========================  ===========================================
  none                       over the whole batch
  ``(data, 1)``, plain       over the GLOBAL batch (JAX's GSPMD routes
                             the global tokens): the ranks' router
                             statistics summed over the data axes, at
                             weight 1 in each rank's gradient
  ``(data, model>1)``,       the mean over the data shards of each
  plain                      shard's own aux (JAX's ``shard_map`` body),
                             at weight ``1 / n_dp`` a rank
  compressed, any mesh       each replica's own, inside its local loss
  =========================  ===========================================

In the plain sync the NLL's weight is the rank's share of the global
live labels; the aux's is not (``loss_and_grads``), and the reported
loss counts it once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.tree import leaves, unflatten
from ..launch import spmd
from ..launch.mesh import check_mesh, model_size
from ..models import sharding as shd
from ..models.convert import stack_layers
from ..models.transformer import Model
from ..optim import grad_compress
from ..optim.optimizer import (Layout, OptConfig, apply_update,
                               init_opt_state, opt_state_specs,
                               sr_generator)

F32 = torch.float32

def train_input_shardings(mesh, batch: int, dp_axes=("data",),
                          with_frontend=False) -> dict:
    """The batch's specs: rows over ``dp_axes`` when they divide."""
    ba = shd.batch_spec_axes(batch, tuple(dp_axes), mesh)
    specs = {"tokens": (ba, None), "labels": (ba, None)}
    if with_frontend:
        specs["frontend_embeds"] = (ba, None, None)
    return specs


def _dp_size(mesh, dp_axes) -> int:
    n = 1
    for a in dp_axes:
        n *= mesh.shape[a]
    return n


def _dp_index(mesh, dp_axes) -> int:
    idx = 0
    for a in dp_axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def local_rows(batch: dict, mesh, dp_axes=("data",)) -> dict:
    """This rank's rows of the global ``batch`` (contiguous blocks in data
    order, as JAX shards the batch dim); the whole batch where the rows do
    not divide (JAX then replicates it)."""
    if mesh is None:
        return batch
    n = _dp_size(mesh, dp_axes)
    b = next(iter(batch.values())).shape[0]
    if n == 1 or b % n:
        return batch
    i, k = _dp_index(mesh, dp_axes), b // n
    return {key: v[i * k:(i + 1) * k] for key, v in batch.items()}


def init_error_feedback(params):
    """This rank's error-feedback buffers: a ``[1, ...]`` slice (f32 zeros)
    of JAX's ``[n_dp, ...]`` per leaf of ``params`` (this rank's
    shards), on any mesh."""
    return unflatten(params, [torch.zeros((1,) + tuple(p.shape), dtype=F32,
                                          device=p.device)
                              for p in leaves(params)])


def whole_tree(model: Model):
    """The trainer's tree of ``model`` at full shape on the meta device."""
    meta = dataclasses.replace(model, device=torch.device("meta"))
    return stack_layers(meta.init(torch.Generator()), model.cfg)


def param_layout(model: Model, mesh, opt_specs=None) -> Layout:
    """The ``Layout`` of the trainer's params on ``mesh`` (their
    ``shard_specs``), with ZeRO-1 ``opt_specs`` when given."""
    return Layout(mesh, shd.shard_specs(whole_tree(model), mesh, model.cfg),
                  opt_specs)


def sync_generator(seed: int, step: int, leaf: int, replica: int,
                   device) -> torch.Generator:
    """The compressed sync's stochastic-rounding stream of one leaf on one
    data replica (JAX folds the replica's index into the key)."""
    return sr_generator(seed, step, leaf, device, salt=-(1 + replica))


def _grads(model, params, batch, mesh, remat, aux_coef, loss_chunk,
           weights=None, aux_groups=()):
    """``(loss, aux, flat grads)`` of ``Model.train_terms`` on this rank's
    batch: the gradient of ``nll + aux_coef * aux``, or with ``weights``
    = ``(w_nll, w_aux, w_report)`` of ``w_nll * nll + w_aux * aux_coef *
    aux``, the loss then ``w_nll * nll + w_report * aux_coef * aux``."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tree = unflatten(params, flat)
    nll, aux = model.train_terms(
        tree, batch["tokens"], batch["labels"],
        frontend_embeds=batch.get("frontend_embeds"), mesh=mesh,
        remat=remat, loss_chunk=loss_chunk, aux_groups=aux_groups)
    if weights is None:
        loss = objective = nll + aux_coef * aux
    else:
        w_nll, w_aux, w_report = weights
        nll = nll * w_nll
        objective = nll + (aux * aux_coef) * w_aux
        loss = nll.detach() + (aux.detach() * aux_coef) * w_report
    grads = torch.autograd.grad(objective, flat, allow_unused=True)
    return loss.detach(), aux.detach(), [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


def loss_and_grads(model: Model, params, batch, mesh=None, *,
                   dp_axes=("data",), remat: bool = True,
                   aux_coef: float = 0.01, loss_chunk: int = 1024,
                   return_aux: bool = False):
    """The plain sync's loss and gradients, as one step takes them: the
    global mean NLL plus the MoE aux by mesh (module docstring) and, per
    leaf, this rank's block of its gradient (f32 under a mesh, summed over
    ``dp_axes``).  ``return_aux``: ``(loss, grads, aux)``, ``aux`` the
    statistic in the loss (the mean of the data shards' under a model
    axis > 1), the same on every rank.

    The weights: each rank's NLL at its live labels over the global count
    (the dp sum then gives the global token mean); the aux at weight 1
    where its statistics are summed over the data axes (each rank's
    gradient then carries its own tokens' share of the global aux, and
    the dp sum the whole), ``1 / n_dp`` where each data shard has its
    own; the reported loss counts the aux once (``1 / n_dp`` a rank)."""
    if mesh is None:
        loss, aux, grads = _grads(model, params, batch, None, remat,
                                  aux_coef, loss_chunk)
        return (loss, grads, aux) if return_aux else (loss, grads)
    groups = [mesh.group(a) for a in dp_axes]
    n_dp = _dp_size(mesh, dp_axes)
    live = (torch.as_tensor(batch["labels"]) >= 0).sum().to(
        F32).to(model.device)
    total = live
    for g in groups:
        total = spmd.all_reduce_sum(total, g)
    global_aux = model.cfg.moe is not None and model_size(mesh) == 1
    weights = (live / torch.clamp(total, min=1),
               1.0 if global_aux else 1.0 / n_dp, 1.0 / n_dp)
    loss, aux, grads = _grads(
        model, params, batch, mesh, remat, aux_coef, loss_chunk,
        weights=weights,
        aux_groups=tuple(g for g in groups if g.size > 1) if global_aux
        else ())
    aux = aux / n_dp
    for grp in groups:
        loss = spmd.all_reduce_sum(loss, grp)
        aux = spmd.all_reduce_sum(aux, grp)
        grads = [spmd.all_reduce_sum(g, grp) for g in grads]
        if grp.size > 1:
            spmd.count_wire("fp32", sum(g.numel() * 4 for g in grads))
    return (loss, grads, aux) if return_aux else (loss, grads)


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None, *,
                    dp_axes: Tuple[str, ...] = ("data",),
                    compress_grads: Optional[str] = None,
                    remat: bool = True, aux_coef: float = 0.01,
                    loss_chunk: int = 1024, opt_specs=None):
    """Returns the step (module docstring).  ``sr_seed`` seeds the
    stochastic re-quantisation of policies with ``stochastic_grad_round``
    (``apply_update``) and, under ``compress_grads``, the sync's
    stochastic rounding.  ``opt_specs``: the state is held under these
    ZeRO-1 specs (``jit_train_step``)."""
    policy = model.policy
    kw = dict(remat=remat, aux_coef=aux_coef, loss_chunk=loss_chunk)
    if mesh is None:
        def step(params, opt_state, batch, sr_seed: Optional[int] = None):
            loss, grads = loss_and_grads(model, params, batch, **kw)
            with torch.no_grad(), \
                    torch.profiler.record_function("train.optimizer"):
                params, opt_state, metrics = apply_update(
                    params, unflatten(params, grads), opt_state, opt_cfg,
                    policy, sr_seed=sr_seed)
            metrics["loss"] = loss
            return params, opt_state, metrics

        return step

    check_mesh(mesh)
    layout = param_layout(model, mesh, opt_specs)

    def update(params, grads, opt_state, sr_seed):
        # the range names the optimizer's kernels in a profile
        with torch.no_grad(), \
                torch.profiler.record_function("train.optimizer"):
            return apply_update(params, unflatten(params, grads), opt_state,
                                opt_cfg, policy, sr_seed=sr_seed,
                                layout=layout)

    if compress_grads is None:
        def step(params, opt_state, batch, sr_seed: Optional[int] = None):
            loss, grads = loss_and_grads(model, params, batch, mesh,
                                         dp_axes=dp_axes, **kw)
            params, opt_state, metrics = update(params, grads, opt_state,
                                                sr_seed)
            metrics["loss"] = loss
            return params, opt_state, metrics

        return step

    # one group over the flattened data axes (JAX's collectives over
    # ``dp_axes``), the replica index JAX's ``axis_index(dp_axes)``
    dp = mesh.group(tuple(dp_axes))
    n_dp, replica = dp.size, dp.index
    model_grp = (mesh.group("model")
                 if mesh.shape.get("model", 1) > 1 else None)
    split = [any(layout.splits(sp, len(sp))) for sp in layout.p]

    def step(params, opt_state, batch, ef, sr_seed: int):
        # each replica's local loss: its mean NLL and its own MoE aux
        loss, _, grads = _grads(model, params, batch, mesh, **kw)
        at = int(opt_state["step"]) + 1
        synced, new_ef = [], []
        for i, (g, e) in enumerate(zip(grads, leaves(ef))):
            s, e2 = grad_compress.compress_sync_local(
                g, e[0], group=dp, fmt=compress_grads,
                generator=sync_generator(sr_seed, at, i, replica, g.device),
                n_replicas=n_dp,
                amax_groups=(model_grp,) if split[i] else ())
            synced.append(s)
            new_ef.append(e2[None])
        if n_dp > 1:
            spmd.count_wire(compress_grads, sum(
                grad_compress.wire_bytes(g.numel(), compress_grads)
                for g in grads))
        loss = spmd.all_reduce_sum(loss, dp) / n_dp
        params, opt_state, metrics = update(params, synced, opt_state,
                                            sr_seed)
        metrics["loss"] = loss
        return params, opt_state, metrics, unflatten(ef, new_ef)

    return step


def shard_opt_state(opt_state, specs, mesh):
    """This rank's block of the whole ``opt_state`` under ``specs``."""
    return shd.map_specs(lambda x, s: shd.local_shard(x, s, mesh),
                         opt_state, specs)


def jit_train_step(model: Model, opt_cfg: OptConfig, mesh, *,
                   batch_size: int, seq_len: int = 4096, dp_axes=("data",),
                   compress_grads=None, **kw):
    """The twin of JAX's fully sharded jit: ``(step, example_args, specs)``
    with ``step`` the mesh step holding the optimizer state under ZeRO-1
    (``opt_state_specs`` over ``dp_axes[-1]``: each rank updates its
    block, the new params are gathered over the data axis),
    ``example_args`` the step's arguments at their whole shapes (meta
    tensors: params, optimizer state, batch, then the ``[n_dp, ...]``
    error feedback under ``compress_grads``) and ``specs`` a dict of the
    ``params`` (``shard_specs``), ``opt`` and ``batch`` spec trees.  A
    rank's state is ``shard_opt_state(init_opt_state(whole params), specs
    ["opt"], mesh)``."""
    cfg = model.cfg
    params_shape = whole_tree(model)
    pspecs = shd.shard_specs(params_shape, mesh, cfg)
    opt_shape = init_opt_state(params_shape, opt_cfg, model.policy)
    ospecs = opt_state_specs(pspecs, opt_shape, zero_axis=dp_axes[-1],
                             mesh=mesh)
    bspecs = train_input_shardings(mesh, batch_size, dp_axes,
                                   with_frontend=cfg.frontend is not None)
    step = make_train_step(model, opt_cfg, mesh, dp_axes=dp_axes,
                           compress_grads=compress_grads, opt_specs=ospecs,
                           **kw)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    args = [params_shape, opt_shape,
            {"tokens": meta((batch_size, seq_len), torch.int32),
             "labels": meta((batch_size, seq_len), torch.int32)}]
    if cfg.frontend is not None:
        n = (cfg.n_frontend_tokens if cfg.frontend == "patch"
             else cfg.encoder.n_frames)
        args[2]["frontend_embeds"] = meta((batch_size, n, cfg.d_model), F32)
    if compress_grads is not None:
        n_dp = _dp_size(mesh, dp_axes)
        args.append(unflatten(params_shape, [
            meta((n_dp,) + tuple(p.shape), F32)
            for p in leaves(params_shape)]))
    return step, tuple(args), {"params": pspecs, "opt": ospecs,
                               "batch": bspecs}
