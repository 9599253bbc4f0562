"""Train-step factory: model + optimizer + policy -> one step, the JAX
package's ``train/train_step.py`` on one device.

    step(params, opt_state, batch, sr_seed=None)
        -> (params, opt_state, metrics)

``params`` is the trainer's tree in JAX's own layout (``pattern`` stacked
``[R, ...]``); ``batch`` may hold ``frontend_embeds`` (patch or frame
embeddings), which pass to ``forward_train``; the gradient is ``torch.autograd.grad`` of
``Model.forward_train`` with respect to its leaves, the update
``optim.optimizer.apply_update``.  ``metrics`` holds the step's ``loss``
and ``grad_norm`` (0-d device tensors) and ``lr`` (host): reading them
is the caller's sync.

As in JAX, ``compress_grads`` (the narrow-format data-parallel gradient
sync) takes effect only under a mesh: without one it is ignored
(``use_compress = compress_grads is not None and mesh is not None``).
Training under a mesh is not ported and raises (ROADMAP Queue 1 item 8b;
serving shards, ``launch.mesh``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.tree import leaves, unflatten
from ..models.transformer import Model
from ..optim.optimizer import OptConfig, apply_update


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None, *,
                    compress_grads: Optional[str] = None,
                    remat: bool = True, aux_coef: float = 0.01,
                    loss_chunk: int = 1024):
    """Returns ``step(params, opt_state, batch, sr_seed=None)``; ``batch``
    holds ``tokens`` and ``labels`` [B, S].  ``sr_seed`` seeds the
    stochastic re-quantisation of policies with ``stochastic_grad_round``
    (``apply_update``)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step under a mesh (data / model parallel training, "
            "compressed gradient sync, ZeRO-1) is not ported: ROADMAP "
            "Queue 1 item 8b (training under a mesh)")
    del compress_grads                   # acts only under a mesh
    policy = model.policy

    def step(params, opt_state, batch, sr_seed: Optional[int] = None):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        tree = unflatten(params, flat)
        loss = model.forward_train(tree, batch["tokens"], batch["labels"],
                                   frontend_embeds=batch.get(
                                       "frontend_embeds"),
                                   remat=remat, aux_coef=aux_coef,
                                   loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        # the range names the optimizer's kernels in a profile
        with torch.no_grad(), \
                torch.profiler.record_function("train.optimizer"):
            params, opt_state, metrics = apply_update(
                unflatten(params, [p.detach() for p in flat]),
                unflatten(params, grads), opt_state, opt_cfg, policy,
                sr_seed=sr_seed)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step
