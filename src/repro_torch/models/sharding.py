"""Sharding rules: parameter / cache / input partition specs for any arch
(the JAX package's ``repro.models.sharding``), and the slicing that gives
a rank its shard.

Megatron-style tensor parallelism over the ``model`` mesh axis, data
parallelism over ``("pod", "data")``, with name-based rules so one table
covers plain, stacked ([R, ...]) and expert ([E, ...]) parameters.  A spec
is a tuple with one entry per leading dim, each an axis name or None (the
entries of JAX's ``PartitionSpec``; ``()`` replicates).

Every rule is divisibility-checked: a dimension that does not divide by
the axis size falls back to replication, with a warning.

``local_shard`` / ``shard_params`` cut full parameters (the port's own, or
JAX's carried across by ``models.convert``) down to this rank's slice:
convert, then shard.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

from ..launch.mesh import model_size
from .attention import _head_shard_size

# parameter-name -> role.  col = shard output (last) dim, row = shard input
# (second-to-last) dim, expert = shard dim -3, vocab = shard dim -2,
# rep = replicate.
_PARAM_RULES = {
    # embeddings
    "embed": "vocab", "lm_head": "col", "pos_embed": "rep", "pos": "rep",
    # attention / mla
    "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    "w_q": "col", "w_dq": "col", "w_uq": "col", "w_dkv": "col",
    "w_kr": "col", "w_uk": "col", "w_uv": "col",
    # dense mlp
    "gate": "col", "up": "col", "down": "row",
    "b_up": "col1", "b_down": "rep",
    # moe (3D expert tensors)
    "router": "rep", "w_gate": "expert", "w_up": "expert", "w_down": "expert",
    # mamba2 / mlstm / slstm
    "in_proj": "col", "out_proj": "row", "conv_w": "col", "conv_b": "col1",
    "up_proj": "col", "down_proj": "row", "w_if": "col",
    # sLSTM: gates and recurrence replicated (a sharded dim in the
    # per-token scan body costs a collective every timestep)
    "w_gates": "rep",
    "r_gates": "rep",
    # mLSTM headwise projections and inner tensors replicated: TP applies
    # only to the up/down projections
    "wq_h": "rep", "wk_h": "rep", "wv_h": "rep",
    "A_log": "rep", "D": "rep", "dt_bias": "rep", "b_if": "rep",
    "b_gates": "rep",
    # norms
    "g": "rep", "b": "rep", "ln": "rep", "norm": "rep",
    "q_norm": "rep", "k_norm": "rep", "kv_norm": "rep",
}

#: the attention projections a head-sharded layer slices by heads (GQA's
#: and MLA's head-major up projections)
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "w_q", "w_uq", "w_uk", "w_uv")


def _spec_for_role(role: str, shape: Tuple[int, ...], model_axis: str,
                   model_size: int) -> tuple:
    rank = len(shape)

    def ok(dim_idx):
        return shape[dim_idx] % model_size == 0 and shape[dim_idx] > 0

    if role == "col" and rank >= 2 and ok(-1):
        return tuple([None] * (rank - 1) + [model_axis])
    if role == "col1" and rank >= 1 and ok(-1):
        return tuple([None] * (rank - 1) + [model_axis])
    if role == "row" and rank >= 2 and ok(-2):
        return tuple([None] * (rank - 2) + [model_axis, None])
    if role == "expert" and rank >= 3 and ok(-3):
        return tuple([None] * (rank - 3) + [model_axis, None, None])
    if role == "vocab" and rank >= 2 and ok(-2):
        return tuple([None] * (rank - 2) + [model_axis, None])
    return ()


def _map_with_name(fn, tree, name=None):
    """``fn(name, leaf)`` over a tree of dicts / lists / tuples, ``name``
    the nearest enclosing dict key (JAX's last ``DictKey`` on the path)."""
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_name(fn, v, name) for v in tree)
    if tree is None:
        return None
    return fn(name, tree)


def param_specs(params, model_axis: str = "model", model_size: int = 16,
                overrides: Optional[dict] = None):
    """A spec tree mirroring ``params`` (anything with ``.shape``: tensors,
    meta tensors, JAX's ShapeDtypeStructs).  ``overrides``: name -> role
    replacements (e.g. {"embed": "rep"})."""
    rules = dict(_PARAM_RULES, **(overrides or {}))

    def visit(name, leaf):
        role = rules.get(name, "rep")
        spec = _spec_for_role(role, tuple(leaf.shape), model_axis,
                              model_size)
        if role != "rep" and spec == ():
            # a 16-way mesh quietly replicating a "sharded" tensor is a
            # memory surprise: say so
            warnings.warn(
                f"sharding: {name!r} {tuple(leaf.shape)} (role {role!r}) "
                f"does not divide the {model_size}-way {model_axis!r} axis "
                f"— replicated instead", stacklevel=3)
        return spec

    return _map_with_name(visit, params)


# ---------------------------------------------------------------------------
# caches and inputs
# ---------------------------------------------------------------------------
def _entry(axes):
    """One spec entry for ``axes`` (a tuple of names or None), as JAX's
    ``PartitionSpec`` stores it: a single name unwrapped."""
    return axes[0] if axes is not None and len(axes) == 1 else axes


def batch_spec_axes(batch: int, batch_axes: Tuple[str, ...],
                    mesh) -> Optional[Tuple[str, ...]]:
    """Batch sharding only when divisible (long_500k has batch 1)."""
    if not batch_axes:
        return None
    size = 1
    for a in batch_axes:
        size *= mesh.shape[a]
    return batch_axes if batch % size == 0 and batch >= size else None


def cache_specs(cfg, caches, *, batch: int, mesh,
                batch_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model"):
    """Specs for a cache tree: the JAX package's ``Caches`` (``prefix`` /
    ``pattern`` stacked [R, ...] / ``suffix``) or the port's per-layer
    list.  Attention KV shards heads over ``model`` when divisible, else
    the sequence dim; paged pools shard heads (no batch dim: each engine
    replica owns its pool), block tables replicate over ``model``; SSM
    states shard heads / features; small normalizer states replicate."""
    msize = mesh.shape[model_axis]
    ba = _entry(batch_spec_axes(batch, batch_axes, mesh))

    def leaf_spec(field: str, shape, lead):
        body = shape[1 + len(lead):]

        def spec(*rest):
            return (*lead, ba, *rest)

        def m(dim):
            return model_axis if body[dim] % msize == 0 else None

        if field in ("k_pool", "v_pool"):
            # [n_pages, Hkv, page, Dh]: heads over model when divisible
            hkv = shape[len(lead) + 1]
            return (*lead, None,
                    model_axis if hkv % msize == 0 else None, None, None)
        if field == "block_table":                   # [B, max_pages]
            return (*lead, ba, None)
        if field in ("k", "v"):                      # KVCache [B,Hkv,S,Dh]
            if body[0] % msize == 0:
                return spec(model_axis, None, None)
            return spec(None, m(1), None)
        if field in ("c_kv", "k_pe"):                # MLA latent [B,S,r]
            return spec(m(0), None)
        if field == "conv":                          # [B,K-1,conv_dim]
            return spec(None, m(1))
        if field == "ssm":                           # [B,H,P,N]
            return spec(m(0), None, None)
        if field == "c" and len(body) == 3:          # mLSTM C [B,H,dk,dv]
            return spec(None, None, m(2))
        return spec(*([None] * len(body)))           # nrm/m/h/slstm

    def walk(node, lead):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, lead) for k, v in node.items()}
        if hasattr(node, "_fields"):                 # cache NamedTuples
            if all(hasattr(getattr(node, f), "shape") for f in node._fields):
                return type(node)(*[leaf_spec(f, tuple(getattr(node, f).shape),
                                              lead)
                                    for f in node._fields])
            return type(node)(*[walk(getattr(node, f), lead)
                                for f in node._fields])
        if isinstance(node, (tuple, list)):
            return tuple(walk(x, lead) for x in node)
        raise TypeError(type(node))

    if hasattr(caches, "prefix") and hasattr(caches, "pattern"):
        return type(caches)(prefix=walk(caches.prefix, ()),
                            pattern=walk(caches.pattern, (None,)),
                            suffix=walk(caches.suffix, ()))
    return [walk(c, ()) for c in caches]


def input_specs_train(batch: int, mesh, batch_axes=("data",)) -> tuple:
    return (_entry(batch_spec_axes(batch, batch_axes, mesh)), None)


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------
def local_shard(t, spec: tuple, mesh, coords: Optional[dict] = None):
    """This rank's block of the full tensor ``t`` under ``spec`` (an entry
    per leading dim: an axis name, a tuple of names, or None), as a tensor
    of its own (the full tensor can be freed); ``coords``: the block of
    the rank at these mesh coordinates instead."""
    coords = mesh.coords if coords is None else coords
    out = t
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(mesh.shape[a] for a in names)
        if n == 1:
            continue
        idx = 0
        for a in names:
            idx = idx * mesh.shape[a] + coords[a]
        step = out.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out.clone() if out is not t else t


def shard_specs(params, mesh, cfg=None, overrides: Optional[dict] = None):
    """The specs ``shard_params`` cuts the full ``params`` by: ``param_specs``
    at the mesh's model size, with, given ``cfg``, the attention
    projections by heads (``ATTN_LEAVES``: GQA's and MLA's) replicated
    where the heads cannot be split whole (the head-sharded path then runs
    unsharded, as the JAX package's does; MLA's latent down projections
    stay ``col``).  Every spec is ``()`` without a model axis > 1."""
    tp = model_size(mesh)
    if tp == 1:
        return map_specs(lambda p, s: (), params, params)
    rules = dict(overrides or {})
    if cfg is not None and _head_shard_size(mesh, cfg.n_heads,
                                            cfg.n_kv_heads) is None:
        rules.update({n: "rep" for n in ATTN_LEAVES})
    return param_specs(params, model_size=tp, overrides=rules)


def shard_params(params, mesh, cfg=None, overrides: Optional[dict] = None):
    """This rank's shards of the full ``params`` under ``shard_specs``.  A
    mesh without a model axis > 1 returns ``params`` as they are."""
    if model_size(mesh) == 1:
        return params
    return map_specs(lambda p, s: local_shard(p, s, mesh), params,
                     shard_specs(params, mesh, cfg, overrides))


# ---------------------------------------------------------------------------
# spec trees: a spec (a tuple) is a leaf, dicts and lists are nodes
# ---------------------------------------------------------------------------
def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves (dicts, lists, tuples and
    NamedTuples of tensors), ``spec`` the entry of ``specs`` at the same
    place."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_specs(fn, v, s) for v, s in zip(tree, specs)]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return fn(tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in JAX's flatten order (sorted dict keys;
    the order of ``core.tree.leaves`` on the tree they describe)."""
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [tuple(specs)]


def split_axes(spec: tuple, ndim: int, mesh) -> list:
    """Per dim of an ``ndim`` leaf, the axes (of size > 1) that ``spec``
    splits it over, outer first."""
    out = []
    for d in range(ndim):
        e = spec[d] if d < len(spec) else None
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(tuple(a for a in names if mesh.shape.get(a, 1) > 1))
    return out


def gather_whole(t, spec: tuple, mesh):
    """The whole tensor from every rank's ``local_shard`` under ``spec``:
    one ``all_gather`` per axis that splits a dim (differentiable)."""
    return relayout(t, spec, (), mesh)


def relayout(t, have: tuple, want: tuple, mesh):
    """``t``, this rank's block under spec ``have``, as its block under
    ``want``: a dim split in ``have`` but not the same in ``want`` is
    gathered whole (inner axis first), then cut by ``want``'s axes."""
    from ..launch import spmd
    hs = split_axes(have, t.dim(), mesh)
    ws = split_axes(want, t.dim(), mesh)
    out = t
    for d, (h, w) in enumerate(zip(hs, ws)):
        if h == w:
            continue
        for a in reversed(h):
            out = spmd.all_gather(out, mesh.group(a), dim=d)
        if w:
            n = math.prod(mesh.shape[a] for a in w)
            idx = 0
            for a in w:
                idx = idx * mesh.shape[a] + mesh.coords[a]
            step = out.shape[d] // n
            out = out.narrow(d, idx * step, step)
    return out
