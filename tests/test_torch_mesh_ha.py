"""Replica faults and the request journal on a sharded fleet:
``ReplicatedEngine`` over ``(2, 1)`` and ``(2, 2)`` meshes, each data row
in its own ranks (``torch.distributed`` over gloo on the CPU), held to the
meshless fleet of two replicas on the same queue and fault plan in this
process, which ``tests/test_torch_replica_ha.py`` holds to the JAX
package's.

Every case is journaled; each must give the meshless fleet's streams,
schedule (admit / finish rounds, slots, preemptions), ``heartbeats``,
``ha_*`` counters and journal file, byte for byte:

  * ``unfailed``;
  * ``kill``: replica 0 killed at burst 1, its residents re-ingested by
    replica 1 (before replica 1 steps in that sweep); ``kill_last``:
    replica 1 killed at burst 2, adopted by replica 0 (which stepped
    first);
  * ``hang_swap``: replica 0 hung at burst 2 (patience 1), its residents'
    live pages carried to replica 1 as swap blobs — at (2, 2) each rank's
    blob (its own KV heads) lands on the survivor row's rank with the same
    model coordinate;
  * ``hang_reingest``: the same hang, the residents re-ingested;
  * ``double_loss``: replica 0 killed at burst 1, then replica 1 at burst
    3 with nothing left to adopt its work: every rank raises together,
    and ``run_with_restarts`` replays the journal to the end.

Reduced gemma2 (2 KV heads: whole heads a rank at tp 2) paged at 16
tokens under ``tp_bf16``, with JAX's weights; one spawn per mesh (a
module-scoped fixture) runs every case.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro_torch.launch import sharded_checks as sc  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)

HANG = dict(queue="long", faults=((0, 2, "hang"),), preempt="swap",
            hang_patience=1)
CASES = {
    "unfailed": dict(),
    "kill": dict(faults=((0, 1, "kill"),), migrate="reingest"),
    "kill_last": dict(faults=((1, 2, "kill"),), migrate="reingest"),
    "hang_swap": dict(HANG, migrate="swap"),
    "hang_reingest": dict(HANG, migrate="reingest"),
    "double_loss": dict(faults=((0, 1, "kill"), (1, 3, "kill")),
                        migrate="reingest", restarts=2),
}
MESHES = ((2, 1), (2, 2))


@pytest.fixture(scope="module")
def params():
    _, jp = cached_model("gemma2-9b", paged_kv=True, page_size=16)
    return from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def meshless(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("meshless")
    return sc.run_plan([(n, "fleet_ha", None,
                         dict(kw, params=params,
                              journal=str(d / f"{n}.jsonl")))
                        for n, kw in CASES.items()])


def _sharded(params, tmp_path_factory, dims):
    d = tmp_path_factory.mktemp(f"mesh{dims[0]}x{dims[1]}")
    plan = [(n, "fleet_ha", dims,
             dict(kw, params=params, journal=str(d / f"{n}.jsonl")))
            for n, kw in CASES.items()]
    return spmd.spawn(sc.rank_main, dims[0] * dims[1], backend="gloo",
                      args=(plan,), timeout=300)


@pytest.fixture(scope="module")
def mesh2x1(params, tmp_path_factory):
    return _sharded(params, tmp_path_factory, (2, 1))


@pytest.fixture(scope="module")
def mesh2x2(params, tmp_path_factory):
    return _sharded(params, tmp_path_factory, (2, 2))


def _ranks(request, dims):
    return request.getfixturevalue(f"mesh{dims[0]}x{dims[1]}")


def test_meshless_cases_fail_as_planned(meshless):
    """The oracle itself: each plan fired as its case says."""
    assert meshless["unfailed"]["ha"]["ha_migrations"] == 0
    kill = meshless["kill"]
    assert kill["ha"]["ha_kills"] == 1 and kill["ha"]["ha_migrations"] >= 1
    assert [h["status"] for h in kill["heartbeats"]] == ["dead", "live"]
    last = meshless["kill_last"]
    assert [h["status"] for h in last["heartbeats"]] == ["live", "dead"]
    assert last["ha"]["ha_migrations"] >= 1
    swap = meshless["hang_swap"]["ha"]
    assert swap["ha_hangs"] == 1 and swap["ha_migrated_swap"] >= 1
    re = meshless["hang_reingest"]["ha"]
    assert re["ha_migrated_swap"] == 0 and re["ha_migrated_reingest"] >= 1
    double = meshless["double_loss"]
    assert double["restarts"] == 1
    assert double["tokens"] == meshless["unfailed"]["tokens"]
    assert b'"kind":"replay"' in double["journal"]
    assert double["journal"].count(b'"kind":"replica_lost"') == 2


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_fleet_matches_meshless(request, meshless, dims, case):
    want = meshless[case]
    ranks = _ranks(request, dims)
    for out in ranks:
        got = out[case]
        assert got["tokens"] == want["tokens"], out["rank"]
        assert got["schedule"] == want["schedule"], out["rank"]
        assert got["heartbeats"] == want["heartbeats"], out["rank"]
        assert got["ha"] == want["ha"], out["rank"]
        assert got["restarts"] == want["restarts"]
        assert got["sdc_detected"] == want["sdc_detected"] == 0


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_journal_bytes_match_meshless(request, meshless, dims,
                                              case):
    """One writer, global rank 0: its file is the meshless fleet's."""
    ranks = _ranks(request, dims)
    assert ranks[0][case]["journal"] == meshless[case]["journal"]
    assert all(out[case]["journal"] is None for out in ranks[1:])


def test_swap_blobs_land_on_the_same_model_coordinate(mesh2x2):
    """At (2, 2) the hung row's ranks each evacuate their own KV heads'
    pages; each survivor rank adopts exactly the blobs of the victim rank
    with its model coordinate (rank r of row 1 from rank r of row 0), and
    the two coordinates' blobs differ."""
    moved = [out["hang_swap"]["migration"] for out in mesh2x2]
    # ranks 0, 1: row 0 (the victim) at model 0, 1; ranks 2, 3: row 1
    assert moved[0]["evacuated"] and not moved[0]["adopted"]
    for m in (0, 1):
        victim, survivor = moved[m], moved[2 + m]
        assert survivor["adopted"] == victim["evacuated"]
        assert survivor["migrated_bytes"] > 0
    assert moved[2]["adopted"] != moved[3]["adopted"]


def test_might_lose_predicts_every_loss():
    """``might_lose`` names a replica before each turn that can lose it:
    a kill still due at its burst, a hang whose next missed beat
    exhausts the patience; several plans (``ReplicaFaultPlans``) as any
    of theirs.  It changes no plan's state."""
    from repro_torch.train.fault import ReplicaFaultPlan, ReplicaFaultPlans
    kill = ReplicaFaultPlan(replica=1, at_burst=2, mode="kill")
    assert not kill.might_lose(1, 1, 0, 3)
    assert not kill.might_lose(0, 2, 0, 3)
    assert kill.might_lose(1, 2, 0, 3) and kill.might_lose(1, 5, 0, 3)
    assert kill.take_kill(1, 2) and not kill.might_lose(1, 3, 0, 3)
    hang = ReplicaFaultPlan(replica=0, at_burst=1, mode="hang")
    assert not hang.might_lose(0, 1, 0, 3)          # two beats to spare
    assert hang.might_lose(0, 1, 2, 3) and hang.might_lose(0, 1, 0, 1)
    assert not hang.might_lose(0, 0, 2, 3) and hang.events == []
    both = ReplicaFaultPlans([ReplicaFaultPlan(replica=0, at_burst=1),
                              ReplicaFaultPlan(replica=1, at_burst=3)])
    assert both.might_lose(0, 1, 0, 1) and not both.might_lose(1, 2, 0, 1)
    assert both.take_kill(1, 3) and not both.take_kill(1, 4)
    assert both.events == [("kill", {"replica": 1, "burst": 3})]
