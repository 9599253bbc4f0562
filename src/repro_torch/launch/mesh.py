"""Replica topology of the serving fleet (the meshless part of the JAX
package's ``repro.launch.mesh``).

Only the meshless fleet is ported: ``replica_meshes(None, n)`` gives ``n``
unsharded engine replicas time-slicing one device over disjoint page
pools.  A real mesh (tensor-parallel replicas, ``make_serving_mesh``,
``make_production_mesh``, ``dp_axes_of``) waits for sharding (ROADMAP
Queue 1 item 8).
"""
from __future__ import annotations


def replica_meshes(mesh, n: int = None) -> list:
    """One sub-mesh per data-parallel replica.  ``mesh=None`` with ``n``
    set is the meshless fleet: ``[None] * n``, ``n`` unsharded replicas
    on the default device (no collectives: the replica topology minus
    the placement)."""
    if mesh is not None:
        raise NotImplementedError(
            "not ported: serving meshes (tensor-parallel replicas); only "
            "the meshless fleet, replica_meshes(None, n), runs — meshes "
            "wait for sharding, ROADMAP Queue 1 item 8")
    if n is None or n < 1:
        raise ValueError("replica_meshes: mesh=None needs an explicit "
                         f"replica count n >= 1, got {n!r}")
    return [None] * n
