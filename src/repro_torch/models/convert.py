"""Weight conversion from the JAX package's ``Model.init`` pytree.

``from_jax_params`` takes that pytree with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)`` on the caller's side) and
returns the port's parameter dict: the stacked ``[R, ...]`` pattern
params are unstacked into one dict per layer, in ``cfg.layer_list()``
order (prefix, then ``R`` repeats of the pattern, then suffix); a MoE
layer's stacked expert leaves ``[R, E, ...]`` come out ``[E, ...]``, its
f32 router stays f32, an untied ``lm_head`` is carried, and a gelu MLP
keeps its ``up`` / ``b_up`` / ``down`` / ``b_down`` leaves, biases
included (granite).  Whisper's leaves come along: the learned positions
``pos_embed``, each decoder layer's ``xattn`` / ``norm_x``, layernorm's
``b``, and the ``encoder`` tree, whose stacked ``[L, ...]`` layers are
unstacked into a list as the pattern's are; zamba2's shared block
(``shared``) is carried as it is.  bf16 and fp8 leaves
(ml_dtypes arrays) are reinterpreted bit for bit.  numpy only: this
module never imports jax.

The trainer keeps JAX's own stacked tree instead (its optimizer decays and
factors leaves by their stacked shapes): ``from_jax_state`` carries a JAX
``TrainLoop`` state across, ``stack_layers`` stacks the port's own init
into that layout, and ``layer_views`` hands ``Model`` per-layer views of
the stacks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.tree import leaves, unflatten

_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _to_torch(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name in _BITCAST:
        raw, dt = _BITCAST[a.dtype.name]
        return torch.from_numpy(a.view(raw).copy()).view(dt).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def from_jax_tree(tree, device: DeviceLike = None):
    """Any JAX pytree with numpy leaves (dicts, lists, tuples) -> the same
    nesting of tensors on ``device``, dtypes and bits kept (lists for
    tuples)."""
    device = resolve_device(device)
    return _tree(tree, lambda a: _to_torch(a, device))


def from_jax_state(state, device: DeviceLike = None) -> dict:
    """A JAX ``TrainLoop`` state ``{"params": ..., "opt": ...}`` (numpy
    leaves) -> the port trainer's: params in JAX's own layout (``embed``,
    ``norm_f``, ``prefix`` / ``suffix``, ``pattern`` stacked ``[R, ...]``),
    the optimizer's ``master``, ``m`` / ``v`` (AdamW) or ``v`` of
    Adafactor ``row`` / ``col`` / ``full`` dicts on ``device``, and
    ``step`` as a 0-d int32 tensor on the host (the optimizer's schedule
    reads it there)."""
    device = resolve_device(device)
    opt = {k: from_jax_tree(v, device) for k, v in state["opt"].items()
           if k != "step"}
    opt["step"] = torch.tensor(int(np.asarray(state["opt"]["step"])),
                               dtype=torch.int32)
    return {"params": from_jax_tree(state["params"], device), "opt": opt}


#: top-level leaves other than the layers, carried as they are (zamba2's
#: shared attention block ``shared`` is one subtree)
_TOP = ("embed", "norm_f", "lm_head", "pos_embed", "shared")


def _unbind(stacked) -> list:
    """A dict of ``[R, ...]`` stacks -> R dicts of views (``unbind``)."""
    views = [t.unbind(0) for t in leaves(stacked)]
    return [unflatten(stacked, [u[r] for u in views])
            for r in range(len(views[0]))]


def _stack(reps: list):
    """R dicts of equal structure -> one dict of ``[R, ...]`` stacks."""
    return unflatten(reps[0], [torch.stack(ts) for ts in
                               zip(*map(leaves, reps))])


def _top(tree, encoder_layers) -> dict:
    """``tree``'s leaves outside the decoder layers, its encoder's layers
    (if any) replaced by ``encoder_layers``."""
    out = {k: tree[k] for k in _TOP if k in tree}
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"], layers=encoder_layers)
    return out


def layer_views(tree) -> dict:
    """The trainer's JAX-layout params -> the port's per-layer dict whose
    pattern (and encoder) layers are views of the stacks (``unbind``
    along ``R``), so autograd delivers one ``[R, ...]`` gradient per
    stacked leaf."""
    per_pos = [_unbind(p) for p in tree["pattern"]]
    layers = list(tree.get("prefix", ()))
    for r in range(len(per_pos[0])):
        layers += [reps[r] for reps in per_pos]
    layers += list(tree.get("suffix", ()))
    enc = (_unbind(tree["encoder"]["layers"]) if "encoder" in tree
           else None)
    return dict(_top(tree, enc), layers=layers)


def stack_layers(params: dict, cfg) -> dict:
    """The port's per-layer params -> JAX's layout (the inverse of
    ``from_jax_params``): ``prefix`` and ``suffix`` lists, and ``pattern``
    one dict per pattern position with each leaf stacked over the
    ``cfg.repeats`` repeats."""
    layers = params["layers"]
    n_pre, n_pat, n_suf = len(cfg.prefix), len(cfg.pattern), len(cfg.suffix)
    enc = (_stack(params["encoder"]["layers"]) if "encoder" in params
           else None)
    return dict(_top(params, enc), prefix=list(layers[:n_pre]),
                suffix=list(layers[len(layers) - n_suf:]) if n_suf else [],
                pattern=[_stack([layers[n_pre + r * n_pat + j]
                                 for r in range(cfg.repeats)])
                         for j in range(n_pat)])


def from_jax_params(tree, device: DeviceLike = None) -> dict:
    """JAX ``Model.init`` pytree (numpy leaves) -> the port's params."""
    device = resolve_device(device)
    conv = lambda t: _tree(t, lambda a: _to_torch(a, device))
    pattern = tree["pattern"]
    reps = len(np.asarray(pattern[0]["norm1"]["g"]))
    layers = [conv(p) for p in tree.get("prefix", ())]
    for r in range(reps):
        for p in pattern:
            layers.append(conv(_tree(p, lambda a: a[r])))
    layers += [conv(p) for p in tree.get("suffix", ())]
    out = {k: conv(tree[k]) for k in _TOP if k in tree}
    out["layers"] = layers
    if "encoder" in tree:                  # whisper: stacked [L, ...] layers
        e = tree["encoder"]
        n = len(np.asarray(e["layers"]["norm1"]["g"]))
        out["encoder"] = {
            "layers": [conv(_tree(e["layers"], lambda a, i=i: a[i]))
                       for i in range(n)],
            "pos": conv(e["pos"]), "norm_f": conv(e["norm_f"])}
    return out


def from_jax_caches(caches, device: DeviceLike = None) -> list:
    """JAX ``init_caches`` / ``prefill`` caches (a ``Caches`` of ``prefix``,
    the ``[R, ...]``-stacked ``pattern`` and ``suffix``, each layer a
    ``{"kv": NamedTuple}`` dict, numpy leaves) -> the port's per-layer
    list in ``cfg.layer_list()`` order: each JAX NamedTuple becomes the
    port's class of the same name (``KVCache``, ``MLACache``,
    ``Mamba2Cache``, ``MLSTMCache``, ``SLSTMCache``), bits kept."""
    from . import attention, ssm
    classes = {c.__name__: c for c in (
        attention.KVCache, attention.MLACache, ssm.Mamba2Cache,
        ssm.MLSTMCache, ssm.SLSTMCache)}
    device = resolve_device(device)

    def one(layer):
        kv = layer["kv"]
        return classes[type(kv).__name__](
            *(_to_torch(a, device) for a in kv))

    pattern = caches.pattern
    reps = len(np.asarray(pattern[0]["kv"][0]))
    out = [one(c) for c in caches.prefix]
    for r in range(reps):
        for c in pattern:
            out.append(one({"kv": type(c["kv"])(*(a[r] for a in c["kv"]))}))
    return out + [one(c) for c in caches.suffix]
