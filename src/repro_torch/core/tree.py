"""Pytrees of nested dicts / lists / tuples in the JAX package's order.

``jax.tree_util`` flattens a dict by its SORTED keys and a list or tuple
in order, with ``None`` an empty subtree; ``keystr`` names a leaf's path as
``['params']['pattern'][0]['attn']['wq']``.  The trainer's optimizer and
checkpoints walk the same order, so a leaf's index and path are JAX's."""
from __future__ import annotations

from typing import Callable, List, Tuple


def _children(node):
    if isinstance(node, dict):
        return [(f"[{k!r}]", k) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", i) for i in range(len(node))]
    return None


def flatten_with_paths(tree) -> List[Tuple[str, object]]:
    """``[(keystr path, leaf), ...]`` in JAX's flatten order."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for name, key in kids:
            walk(node[key], path + name)

    walk(tree, "")
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> object:
    """``like``'s structure (lists for tuples) with ``new_leaves`` in its
    flatten order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching)`` over ``tree``'s leaves, called in flatten
    order; each tree in
    ``rest`` is indexed along ``tree``'s structure, so where ``tree`` has
    a leaf the others may hold a whole subtree (Adafactor's factored
    ``v``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *[r[k] for r in rest])
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
