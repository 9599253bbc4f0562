"""Weight conversion from the JAX package's ``Model.init`` pytree.

``from_jax_params`` takes that pytree with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)`` on the caller's side) and
returns the port's parameter dict: the stacked ``[R, ...]`` pattern
params are unstacked into one dict per layer, in ``cfg.layer_list()``
order (prefix, then ``R`` repeats of the pattern, then suffix); a MoE
layer's stacked expert leaves ``[R, E, ...]`` come out ``[E, ...]``, its
f32 router stays f32, an untied ``lm_head`` is carried, and a gelu MLP
keeps its ``up`` / ``b_up`` / ``down`` / ``b_down`` leaves, biases
included (granite).  bf16 and fp8 leaves (ml_dtypes arrays) are
reinterpreted bit for bit.  numpy only: this module never imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

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
    out = {"embed": conv(tree["embed"]), "norm_f": conv(tree["norm_f"]),
           "layers": layers}
    if "lm_head" in tree:                  # untied embeddings
        out["lm_head"] = conv(tree["lm_head"])
    return out
