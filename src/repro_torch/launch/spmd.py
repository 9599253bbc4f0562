"""Ranks and collectives for the sharded serving path.

The JAX package runs one program over a device mesh and lets XLA's runtime
place the collectives.  Here every rank is a process: ``spawn`` starts
``nprocs`` ranks with ``torch.multiprocessing`` and a ``file://``
rendezvous in a temporary directory, runs ``fn(rank, world, *args)`` in
each, and returns what each rank's ``fn`` returned (pickled through that
directory).

The backend is always the caller's choice, never switched on failure:

  * ``"nccl"``: one rank per card (``cuda:rank``); fewer cards than ranks
    raises;
  * ``"gloo"``: ranks on the CPU, or several ranks on one card.  Gloo
    moves host memory only, so a CUDA tensor is ALWAYS staged through a
    pinned host buffer, there and back; ``STATS`` counts every staged byte
    and the wall time of every collective.

The collective helpers take a ``Group`` (one axis slice of a
``launch.mesh.Mesh``): ``all_reduce_sum`` (an f32 sum, or the rank-order
sum in a narrow dtype), ``all_gather`` (concatenated along a dim),
``all_to_all`` (leading-axis slabs) and ``broadcast``.  A group of one
rank is the identity and needs no process group.  Data-movement
collectives carry the bytes of their tensor (a ``uint8`` view), so a
16-bit or fp8 tensor moves bit for bit whatever dtypes the backend knows;
``all_gather_cat`` gathers several tensors of any shapes in one call.

The rank functions live in importable modules: under ``spawn`` a function
defined in a ``__main__`` script or a test module cannot be pickled into
the child.
"""
from __future__ import annotations

import gc
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

#: what the collectives cost, per process: staged bytes (device -> host ->
#: device under gloo), collective calls and their wall time in ms
STATS = {"staged_bytes": 0, "collectives": 0, "collective_ms": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0 if k != "collective_ms" else 0.0


@dataclass
class Group:
    """One slice of a mesh axis: its global ``ranks`` in axis order, this
    process's ``index`` in it (-1 when not a member) and the process group
    (None for a one-rank slice or without ``torch.distributed``)."""
    ranks: Sequence[int]
    index: int = 0
    pg: object = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)


def backend_of(group: Group) -> Optional[str]:
    return dist.get_backend(group.pg) if group.pg is not None else None


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------
def check_backend(backend: str, nprocs: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        have = torch.cuda.device_count()
        if have < nprocs:
            raise ValueError(
                f"nccl runs one rank per card: {nprocs} ranks need "
                f"{nprocs} cards, {have} visible (several ranks on one "
                f"card: backend='gloo')")


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               root: str, args: tuple) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{root}/rdzv",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(root, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(root, f"rank{rank}.pkl.tmp"),
                   os.path.join(root, f"rank{rank}.pkl"))
    finally:
        # objects in reference cycles (a closure over an engine, over its
        # mesh) hold process groups: free them now, not in the
        # interpreter's teardown, where a gloo group's destructor aborts
        gc.collect()
        dist.destroy_process_group()
        gc.collect()


def spawn(fn: Callable, nprocs: int, *, backend: str,
          args: tuple = ()) -> List:
    """Run ``fn(rank, world, *args)`` on ``nprocs`` fresh processes joined
    by ``backend``; returns the ranks' return values in rank order.  A
    rank that raises makes this raise (the others are terminated)."""
    import torch.multiprocessing as mp
    check_backend(backend, nprocs)
    with tempfile.TemporaryDirectory(prefix="spmd-") as root:
        mp.spawn(_rank_main, args=(fn, nprocs, backend, root, tuple(args)),
                 nprocs=nprocs, join=True)
        out = []
        for r in range(nprocs):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _timed(fn):
    def run(x, group: Group, *a, **kw):
        if group.size == 1:
            return fn(x, group, *a, **kw)
        t0 = time.perf_counter()
        out = fn(x, group, *a, **kw)
        STATS["collectives"] += 1
        STATS["collective_ms"] += (time.perf_counter() - t0) * 1e3
        return out
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


def _to_wire(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The tensor the backend moves: ``x`` itself, or under gloo a pinned
    host copy of a CUDA tensor (counted)."""
    if x.device.type != "cuda" or backend_of(group) != "gloo":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STATS["staged_bytes"] += x.numel() * x.element_size()
    return host


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.device == like.device:
        return y
    STATS["staged_bytes"] += y.numel() * y.element_size()
    return y.to(like.device)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A flat ``uint8`` view of ``x``'s bytes (contiguous)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


@_timed
def all_reduce_sum(x: torch.Tensor, group: Group,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of ``x`` over the group, identical on every rank.  Default:
    an f32 sum (returned in f32).  ``dtype`` narrower than f32 (the
    ``narrow_partials`` reduce): the partials, cast to ``dtype``, are
    gathered and added in rank order in ``dtype``, one rounding an add."""
    if dtype is None or dtype == torch.float32:
        y = x.to(torch.float32).contiguous()
        if group.size == 1:
            return y
        w = _to_wire(y, group)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group.pg)
        return _from_wire(w, y)
    parts = _gather(x.to(dtype), group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``x``, bit for bit, in group order."""
    if group.size == 1:
        return [x]
    b = _bytes(x)
    w = _to_wire(b, group)
    outs = [torch.empty_like(w) for _ in range(group.size)]
    dist.all_gather(outs, w, group=group.pg)
    return [_from_wire(o, b).view(x.dtype).reshape(x.shape) for o in outs]


@_timed
def all_gather(x: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order, bit for
    bit."""
    return x if group.size == 1 else torch.cat(_gather(x, group), dim=dim)


@_timed
def all_gather_cat(parts: Sequence[torch.Tensor],
                   group: Group) -> List[torch.Tensor]:
    """Each of ``parts`` (any shapes and dtypes, on one device) with the
    ranks' blocks concatenated along its LAST dim in group order, bit for
    bit, in one collective over their bytes."""
    if group.size == 1:
        return list(parts)
    flat = torch.cat([_bytes(p) for p in parts])
    ranks = _gather(flat, group)
    out, off = [], 0
    for p in parts:
        n = p.numel() * p.element_size()
        # a copy of each slice: a view at an odd byte offset cannot
        # change dtype
        blocks = [r[off:off + n].clone().view(p.dtype).reshape(p.shape)
                  for r in ranks]
        out.append(torch.cat(blocks, dim=-1))
        off += n
    return out


@_timed
def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` [M, ...] with M the group size: slab ``j`` goes to rank ``j``;
    returns [M, ...] whose slab ``i`` came from rank ``i``."""
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} is not "
                         f"the group size {group.size}")
    if group.size == 1:
        return x
    b = _bytes(x)
    w = _to_wire(b, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group.pg)
    return _from_wire(out, b).view(x.dtype).reshape(x.shape)


@_timed
def broadcast(x: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank, bit for bit."""
    if group.size == 1:
        return x
    b = _bytes(x).clone()
    w = _to_wire(b, group)
    dist.broadcast(w, src=group.ranks[src], group=group.pg)
    return _from_wire(w, b).view(x.dtype).reshape(x.shape)


def barrier(group: Group) -> None:
    """Wait for every rank of ``group``."""
    if group.size > 1:
        dist.barrier(group=group.pg)


@_timed
def gather_objects(obj, group: Group) -> list:
    """Every rank's picklable ``obj``, in group order, on every rank."""
    if group.size == 1:
        return [obj]
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out
