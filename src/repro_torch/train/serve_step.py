"""Serving-step factories: prefill and decode under a mesh, the JAX
package's ``train/serve_step.py``.

``decode_32k`` / ``long_500k`` run the *decode step* (one new token per
row against a cache of ``max_len``), ``prefill_32k`` the prefill.  The
port has no jit: each factory returns ``(step, args, specs)``, ``step`` a
plain callable, ``args`` its arguments at their WHOLE shapes (meta
tensors: parameters from ``Model.init`` on the meta device, caches from
``init_caches``, the batch) and ``specs`` one spec tree per argument;
``local_args`` cuts a rank's block of them (``models.sharding.local_shard``)
and the step runs on that rank's blocks.

``serve_shardings`` gives the specs the port's step runs under:

  * parameters: ``models.sharding.shard_specs`` (JAX's ``param_specs``
    rules, with the attention projections replicated where the heads do
    not split whole over ``model``: the port then runs that attention
    unsharded);
  * caches: a GQA layer's KV splits its heads over ``model`` when both
    head counts divide, and is otherwise whole on every model rank (JAX
    splits the sequence there); MLA's latent cache and the recurrent
    states stay whole on every model rank (the port gathers MLA's latents
    and runs the recurrent mixers whole); every cache splits its batch
    over the data axes when they divide it, as JAX's;
  * the batch axes (``batch_spec_axes``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models import sharding as shd
from ..models.attention import _head_shard_size
from ..models.transformer import Model, init_caches

F32 = torch.float32
META = torch.device("meta")

#: the mixers whose cache the port keeps whole on every model rank
_WHOLE_CACHE = ("mla", "mamba2", "mlstm", "slstm")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_only(spec, ba) -> tuple:
    """``spec`` with only its batch entry kept (``ba`` at the batch dim)."""
    return tuple(e if e == ba else None for e in spec)


def serve_shardings(model: Model, mesh, *, batch: int, max_len: int,
                    dp_axes=("data",), model_axis="model"):
    """``(params_shape, pspecs, caches_shape, cspecs, ba)``: the whole
    parameters and caches as meta tensors, their spec trees (module
    docstring) and the batch axes (None where they do not divide
    ``batch``)."""
    cfg = model.cfg
    meta = dataclasses.replace(model, device=META)
    params_shape = meta.init(torch.Generator())
    overrides = ({"embed": "rep", "lm_head": "rep"}
                 if cfg.embed_sharding == "replicated" else None)
    pspecs = shd.shard_specs(params_shape, mesh, cfg, overrides)
    caches_shape = init_caches(cfg, batch, max_len, model.policy, META)
    cspecs = shd.cache_specs(cfg, caches_shape, batch=batch, mesh=mesh,
                             batch_axes=dp_axes, model_axis=model_axis)
    ba = shd.batch_spec_axes(batch, tuple(dp_axes), mesh)
    ba_entry = shd._entry(ba)
    split_heads = _head_shard_size(mesh, cfg.n_heads,
                                   cfg.n_kv_heads) is not None
    for i, spec in enumerate(cfg.layer_list()):
        if spec.mixer in _WHOLE_CACHE or not split_heads:
            cspecs[i] = shd.map_specs(lambda _, s: _batch_only(s, ba_entry),
                                      caches_shape[i], cspecs[i])
    return params_shape, pspecs, caches_shape, cspecs, ba


def local_args(args, specs, mesh):
    """This rank's block of every argument (a tensor under its spec, a
    tree of them, or anything else as it is)."""
    def one(a, s):
        if isinstance(a, torch.Tensor):
            return shd.local_shard(a, tuple(s), mesh)
        if isinstance(a, (dict, list, tuple)):
            return shd.map_specs(lambda x, sp: shd.local_shard(x, sp, mesh),
                                 a, s)
        return a
    return tuple(one(a, s) for a, s in zip(args, specs))


def _frontend_shape(cfg, batch: int) -> Tuple[int, int, int]:
    n = (cfg.n_frontend_tokens if cfg.frontend == "patch"
         else cfg.encoder.n_frames)
    return (batch, n, cfg.d_model)


def make_prefill(model: Model, mesh, *, batch: int, seq_len: int,
                 max_len: int, dp_axes=("data",), model_axis="model"):
    """``(prefill, args, specs)``: ``prefill(params, tokens[,
    frontend_embeds])`` -> (last-position logits, caches) under
    ``mesh``."""
    cfg = model.cfg
    params_shape, pspecs, _, _, ba = serve_shardings(
        model, mesh, batch=batch, max_len=max_len, dp_axes=dp_axes,
        model_axis=model_axis)
    ba = shd._entry(ba)

    def prefill(params, tokens, frontend_embeds=None):
        return model.prefill(params, tokens, max_len=max_len,
                             frontend_embeds=frontend_embeds, mesh=mesh)

    args = [params_shape, _meta((batch, seq_len), torch.int32)]
    specs = [pspecs, (ba, None)]
    if cfg.frontend is not None:
        args.append(_meta(_frontend_shape(cfg, batch), F32))
        specs.append((ba, None, None))
    return prefill, tuple(args), tuple(specs)


def make_decode_step(model: Model, mesh, *, batch: int, max_len: int,
                     dp_axes=("data",), model_axis="model"):
    """``(decode, args, specs)``: ``decode(params, token, caches, pos)`` ->
    (logits, caches), one token per row against a ``max_len`` cache (the
    decode_32k / long_500k step), the caches written in place.  ``pos``
    is ``max_len - 1``: the step reads the whole cache."""
    params_shape, pspecs, caches_shape, cspecs, ba = serve_shardings(
        model, mesh, batch=batch, max_len=max_len, dp_axes=dp_axes,
        model_axis=model_axis)
    ba = shd._entry(ba)

    def decode(params, token, caches, pos):
        return model.decode_step(params, token, caches, pos, mesh=mesh)

    args = (params_shape, _meta((batch, 1), torch.int32), caches_shape,
            max_len - 1)
    specs = (pspecs, (ba, None), cspecs, ())
    return decode, args, specs
