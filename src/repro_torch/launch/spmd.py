"""Ranks and collectives for the sharded serving and training paths.

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
sum in a narrow dtype), ``all_reduce_max``, ``all_gather``
(concatenated along a dim), ``all_to_all`` (leading-axis slabs) and
``broadcast``.  A group of one rank is the identity and needs no process
group.

Training differentiates through them: ``all_reduce_sum`` backprops as
the identity (what follows it is replicated), ``all_gather`` and
``all_gather_cat`` as this rank's block of the cotangent, ``all_to_all``
as the reverse exchange;
``grad_sum`` is the identity forward whose backward sums the cotangent
over the group, for a replicated value entering sharded compute.  A
backward collective is counted in ``STATS`` as a forward one is.

Data-movement collectives carry the bytes of their tensor (a ``uint8``
view), so a 16-bit or fp8 tensor moves bit for bit whatever dtypes the
backend knows; ``all_gather_cat`` gathers several tensors of any shapes
in one call.

``STATS["coll"]`` tables every collective as the JAX package's dry run
keys its HLO's (``op@group_size``: ``all-reduce``, ``all-gather``,
``all-to-all``, ``broadcast``): calls and output bytes.

Dry mode: a group of more than one rank with no process group (a
``launch.mesh`` mesh built with ``dry=True``, rank 0's view of a mesh no
process has) answers every collective on META tensors with a tensor of
the shape the real collective returns, and tables it as a real one is;
``launch.dryrun`` runs the steps so.

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
#: device under gloo), collective calls and their wall time in ms, and
#: the bytes the data-parallel gradient sync put on the wire, by format
#: (``wire_bytes``: "fp32" for the plain sync, the compressed format's
#: name otherwise; counted by the train step), and ``coll``: per
#: ``op@group_size``, the calls and their output bytes
STATS = {"staged_bytes": 0, "collectives": 0, "collective_ms": 0.0,
         "wire_bytes": {}, "coll": {}}


def reset_stats() -> None:
    STATS.update(staged_bytes=0, collectives=0, collective_ms=0.0,
                 wire_bytes={}, coll={})


def snapshot() -> dict:
    """A copy of ``STATS`` that later collectives leave as it is."""
    return dict(STATS, wire_bytes=dict(STATS["wire_bytes"]),
                coll={k: dict(v) for k, v in STATS["coll"].items()})


def count_wire(fmt: str, nbytes: int) -> None:
    """Adds ``nbytes`` sent by this rank's gradient sync in ``fmt``."""
    STATS["wire_bytes"][fmt] = STATS["wire_bytes"].get(fmt, 0) + nbytes


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


def _dry(group: Group, *tensors: torch.Tensor) -> bool:
    """Whether ``group``'s collective is a dry one (module docstring);
    raises for a dry group given a tensor with values."""
    if group.pg is not None or group.size == 1:
        return False
    if any(t.device.type != "meta" for t in tensors):
        raise ValueError(
            f"a group of {group.size} ranks without a process group (a dry "
            f"mesh) carries meta tensors only")
    return True


def _table(op: str, group: Group, outs) -> None:
    """Count one ``op`` collective over ``group`` and its output bytes."""
    rec = STATS["coll"].setdefault(f"{op}@{group.size}",
                                   {"count": 0, "bytes": 0})
    rec["count"] += 1
    rec["bytes"] += sum(o.numel() * o.element_size() for o in outs)


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


def spawn(fn: Callable, nprocs: int, *, backend: str, args: tuple = (),
          timeout: Optional[float] = None) -> List:
    """Run ``fn(rank, world, *args)`` on ``nprocs`` fresh processes joined
    by ``backend``; returns the ranks' return values in rank order.  A
    rank that raises makes this raise (the others are terminated).
    ``timeout`` (seconds): ranks still running then are killed and
    ``TimeoutError`` is raised (a rank waiting in a collective for one
    that failed would otherwise wait for ever)."""
    import torch.multiprocessing as mp
    check_backend(backend, nprocs)
    with tempfile.TemporaryDirectory(prefix="spmd-") as root:
        ctx = mp.spawn(_rank_main,
                       args=(fn, nprocs, backend, root, tuple(args)),
                       nprocs=nprocs, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None else
                               max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn: {nprocs} ranks of {getattr(fn, '__name__', fn)}"
                        f" still running after {timeout} s: killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
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


def _grad_path(x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` must carry a backward."""
    return torch.is_grad_enabled() and x.requires_grad


def _sum(x: torch.Tensor, group: Group,
         dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The sum, never reduced in ``x``'s own storage (the caller's tensor,
    a saved input or an incoming cotangent stays as it was)."""
    if dtype is None or dtype == torch.float32:
        y = x.to(torch.float32).contiguous()
        if group.size > 1 and y is x:
            y = y.clone()
        if group.size == 1:
            return y
        w = _to_wire(y, group)
        if not _dry(group, w):
            dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group.pg)
        _table("all-reduce", group, [w])
        return _from_wire(w, y)
    parts = _gather(x.to(dtype), group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _Sum(torch.autograd.Function):
    """The group sum; its backward is the identity: what follows the sum
    is replicated, so each rank's cotangent is already the whole one."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.dtype = x.dtype
        return _sum(x, group, dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


@_timed
def all_reduce_sum(x: torch.Tensor, group: Group,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of ``x`` over the group, identical on every rank.  Default:
    an f32 sum (returned in f32).  ``dtype`` narrower than f32 (the
    ``narrow_partials`` reduce): the partials, cast to ``dtype``, are
    gathered and added in rank order in ``dtype``, one rounding an add.
    Backward: the identity."""
    if _grad_path(x) and group.size > 1:
        return _Sum.apply(x, group, dtype)
    return _sum(x, group, dtype)


@_timed
def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group (exact, any order),
    identical on every rank; no backward."""
    if group.size == 1:
        return x
    y = x.detach().contiguous().clone()
    w = _to_wire(y, group)
    if not _dry(group, w):
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group.pg)
    _table("all-reduce", group, [w])
    return _from_wire(w, y)


class _GradSum(torch.autograd.Function):
    """Identity forward; backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _grad_total(g, ctx.group), None


@_timed
def _grad_total(g: torch.Tensor, group: Group) -> torch.Tensor:
    """``grad_sum``'s backward: the f32 sum of the ranks' cotangents."""
    return _sum(g, group, None).to(g.dtype)


def grad_sum(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """``x`` itself; its gradient is the sum of the ranks' gradients.  It
    goes where a replicated value (hidden states, a replicated weight)
    enters column-, head- or vocab-sharded compute: each rank's
    cotangent then covers only its shard's share of the whole."""
    if group is None or group.size == 1 or not _grad_path(x):
        return x
    return _GradSum.apply(x, group)


def _gather(x: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's ``x``, bit for bit, in group order."""
    if group.size == 1:
        return [x]
    b = _bytes(x)
    w = _to_wire(b, group)
    outs = [torch.empty_like(w) for _ in range(group.size)]
    if not _dry(group, w):
        dist.all_gather(outs, w, group=group.pg)
    _table("all-gather", group, outs)
    return [_from_wire(o, b).view(x.dtype).reshape(x.shape) for o in outs]


class _Gather(torch.autograd.Function):
    """Concatenation along ``dim``; backward: this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.index, ctx.n, ctx.dim = group.index, x.shape[dim], dim
        return torch.cat(_gather(x.detach(), group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


@_timed
def all_gather(x: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order, bit for
    bit.  Backward: this rank's block of the cotangent."""
    if group.size == 1:
        return x
    if _grad_path(x):
        return _Gather.apply(x, group, dim)
    return torch.cat(_gather(x, group), dim=dim)


def _gather_cat(parts: Sequence[torch.Tensor],
                group: Group) -> List[torch.Tensor]:
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


class _GatherCat(torch.autograd.Function):
    """``all_gather_cat``; backward: this rank's block of each part's
    cotangent (right where the gathered parts feed compute that runs
    whole on every rank, so that each cotangent is already whole)."""

    @staticmethod
    def forward(ctx, group, *parts):
        ctx.index, ctx.widths = group.index, [p.shape[-1] for p in parts]
        return tuple(_gather_cat([p.detach() for p in parts], group))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(
            None if g is None else g.narrow(-1, ctx.index * n, n)
            for g, n in zip(grads, ctx.widths))


@_timed
def all_gather_cat(parts: Sequence[torch.Tensor],
                   group: Group) -> List[torch.Tensor]:
    """Each of ``parts`` (any shapes and dtypes, on one device) with the
    ranks' blocks concatenated along its LAST dim in group order, bit for
    bit, in one collective over their bytes.  Backward: this rank's block
    of each cotangent."""
    if group.size == 1:
        return list(parts)
    if any(_grad_path(p) for p in parts):
        return list(_GatherCat.apply(group, *parts))
    return _gather_cat(parts, group)


def _exchange(x: torch.Tensor, group: Group) -> torch.Tensor:
    b = _bytes(x)
    w = _to_wire(b, group)
    out = torch.empty_like(w)
    if not _dry(group, w):
        dist.all_to_all_single(out, w, group=group.pg)
    _table("all-to-all", group, [out])
    return _from_wire(out, b).view(x.dtype).reshape(x.shape)


class _AllToAll(torch.autograd.Function):
    """The slab exchange; backward: the reverse exchange (slab ``i`` of
    the cotangent goes back to rank ``i``), itself an ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


@_timed
def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` [M, ...] with M the group size: slab ``j`` goes to rank ``j``;
    returns [M, ...] whose slab ``i`` came from rank ``i``."""
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} is not "
                         f"the group size {group.size}")
    if group.size == 1:
        return x
    if _grad_path(x):
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


@_timed
def broadcast(x: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank, bit for bit."""
    if group.size == 1:
        return x
    b = _bytes(x).clone()
    w = _to_wire(b, group)
    if not _dry(group, w):
        dist.broadcast(w, src=group.ranks[src], group=group.pg)
    _table("broadcast", group, [w])
    return _from_wire(w, b).view(x.dtype).reshape(x.shape)


def barrier(group: Group) -> None:
    """Wait for every rank of ``group``."""
    if group.size > 1 and group.pg is not None:
        dist.barrier(group=group.pg)


@_timed
def gather_objects(obj, group: Group) -> list:
    """Every rank's picklable ``obj``, in group order, on every rank."""
    if group.size == 1:
        return [obj]
    if group.pg is None:                # a dry group: every rank is this one
        return [obj] * group.size
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out
