"""Serving meshes over ``torch.distributed`` ranks (the JAX package's
``repro.launch.mesh``).

A ``Mesh`` lays the first ``prod(shape)`` ranks of the default process
group out row-major over named axes, as ``jax.make_mesh`` lays out
devices: ``axis_names``, ``shape`` (a dict, read as JAX's
``mesh.shape[axis]``), ``devices`` (the global ranks in that layout),
this process's ``coords`` and one ``spmd.Group`` per axis, the slice of
that axis through this rank.  Building one is a collective: every rank
of the default group creates every slice's process group, in the same
order.  Without ``torch.distributed`` (one process) only one-rank meshes
exist, and their groups need no process group.

``make_serving_mesh(dp, tp)``: ``("data", "model")``, the model axis
tensor-parallelizes heads and page pools inside each engine replica, the
data axis indexes replicas.  ``replica_meshes`` cuts it into one
``("model",)`` sub-mesh per data row (or the meshless fleet ``[None] *
n``).  ``make_production_mesh`` builds the pod meshes over a world that
large, or (``dry=True``) rank 0's view of them with no ranks at all, whose
collectives ``launch.spmd`` answers on meta tensors.  JAX's ``core/compat.py`` (jax-version shims for ``shard_map`` and
``make_mesh``) has no counterpart: nothing here depends on a JAX version.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .spmd import Group


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Named axes over ranks.  ``group(axis)`` is this rank's slice of
    ``axis``; ``coords[axis]`` its index along it (absent when this rank
    lies outside the mesh); ``everyone`` the group of all its ranks."""

    def __init__(self, axis_names: Sequence[str], devices: np.ndarray,
                 rank: int, groups: Dict[str, Group], everyone: Group,
                 dry: bool = False):
        self.axis_names = tuple(axis_names)
        self.dry = dry
        self.devices = np.asarray(devices)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = rank
        hit = np.argwhere(self.devices == rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, hit[0])}
                       if len(hit) else {})
        self.groups = groups
        self.everyone = everyone

    @property
    def member(self) -> bool:
        return bool(self.coords)

    def group(self, axis) -> Group:
        """This rank's slice of ``axis``; a tuple of axes is the slice of
        their flattened product, row-major in the order given (this
        rank's ``index`` in it is JAX's ``axis_index(axes)``).  The first
        request for a tuple of two or more axes is a collective: every
        rank of the default group makes every slice's process group, so
        every rank asks for it, in one order."""
        if isinstance(axis, str):
            return self.groups[axis]
        axes = tuple(axis)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes not in self.groups:
            self.groups[axes] = _slice_group(self.devices, [
                self.axis_names.index(a) for a in axes], self.rank,
                self.dry)
        return self.groups[axes]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank={self.rank}, "
                f"coords={self.coords})")


def _slice_group(devices: np.ndarray, dims, rank: int,
                 dry: bool = False) -> Group:
    """This rank's group among the slices of ``devices`` over ``dims``
    (flattened row-major in that order), every slice's process group
    made on every rank (none on a ``dry`` mesh)."""
    world = 1 if dry else _world()[0]
    rest = [d for d in range(devices.ndim) if d not in dims]
    moved = np.transpose(devices, rest + list(dims))
    mine = None
    for row in moved.reshape(-1, math.prod(devices.shape[d] for d in dims)):
        ranks = list(map(int, row))
        # new_group is collective over the whole world: every rank makes
        # every slice's group, in one order
        pg = (dist.new_group(ranks) if len(ranks) > 1 and world > 1
              else None)
        if rank in ranks:
            mine = Group(ranks, ranks.index(rank), pg)
    return mine if mine is not None else Group([], -1, None)


def _mk_mesh(shape, axes, dry: bool = False) -> Mesh:
    """A mesh over the first ``prod(shape)`` ranks; raises as the JAX
    package's ``_mk_mesh`` does when the world is too small.  ``dry``:
    rank 0's view of the mesh with no process group at all, whatever the
    world (its collectives are ``spmd``'s dry ones, on meta tensors)."""
    n = math.prod(shape)
    world, rank = (n, 0) if dry else _world()
    if world < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, "
                         f"have {world}")
    devices = np.arange(n).reshape(shape)
    groups = {name: _slice_group(devices, [ax], rank, dry)
              for ax, name in enumerate(axes)}
    ranks = list(range(n))
    pg = (None if n == 1 or dry else dist.group.WORLD if n == world
          else dist.new_group(ranks))
    everyone = Group(ranks, ranks.index(rank) if rank < n else -1, pg)
    return Mesh(axes, devices, rank, groups, everyone, dry)


def make_production_mesh(*, multi_pod: bool = False,
                         dry: bool = False) -> Mesh:
    """Single pod ``(data=16, model=16)``; multi-pod ``(pod=2, data=16,
    model=16)``, the ``pod`` axis a second data-parallel axis.  ``dry``:
    rank 0's view without ranks (``launch.dryrun``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk_mesh(shape, axes, dry)


def make_serving_mesh(dp: int, tp: int) -> Mesh:
    """Serving mesh ``(data=dp, model=tp)`` over the first ``dp * tp``
    ranks."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} tp={tp}")
    return _mk_mesh((dp, tp), ("data", "model"))


def replica_meshes(mesh, n: Optional[int] = None) -> list:
    """One ``("model",)`` sub-mesh per ``data`` row of a serving mesh (each
    replica's tensor parallelism runs over its own row of ranks, so
    replicas share no collective); a ``("model",)`` mesh is its own one
    replica.  A rank outside row ``i`` gets a sub-mesh it is no member of.

    ``mesh=None`` with ``n`` set is the meshless fleet: ``[None] * n``,
    ``n`` unsharded replicas on the default device."""
    if mesh is None:
        if n is None or n < 1:
            raise ValueError("replica_meshes: mesh=None needs an explicit "
                             f"replica count n >= 1, got {n!r}")
        return [None] * n
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a launch.mesh.Mesh (or None), got "
                        f"{type(mesh).__name__}")
    if mesh.axis_names == ("model",):
        return [mesh]
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"expected a (data, model) serving mesh, got "
                         f"axes {mesh.axis_names}")
    model = mesh.group("model")
    subs = []
    for i in range(mesh.devices.shape[0]):
        row = mesh.devices[i]
        mine = mesh.coords.get("data") == i
        grp = model if mine else Group([int(r) for r in row], -1, None)
        subs.append(Mesh(("model",), row, mesh.rank, {"model": grp}, grp,
                         mesh.dry))
    if n is not None and n != len(subs):
        raise ValueError(f"mesh data axis has {len(subs)} replicas but "
                         f"replicas={n} was requested")
    return subs


def dp_axes_of(mesh) -> tuple:
    """The batch-sharding axes of a production mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_size(mesh) -> int:
    """The ``model`` axis size of ``mesh`` (1 without a mesh or axis)."""
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        return 1
    return int(mesh.shape["model"])


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a ``Mesh`` this rank belongs to."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a launch.mesh.Mesh (or None), got "
                        f"{type(mesh).__name__}")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not a member of {mesh!r}")
