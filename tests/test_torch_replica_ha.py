"""Replica fault tolerance in the port: the meshless ``ReplicatedEngine``
fleet, kill / hang migration, the crash-consistent request journal and
``run_with_restarts``, case for case as in ``tests/test_replica_ha.py``,
and against the JAX package.

Within the port (reduced gemma2 under ``tp_bf16``, paged in 16-token
pages, the weights of ``tests/conftest.py::cached_model`` converted):
kill-reingest, hang-swap and journal replay give tokens bitwise equal to
the unfailed fleet, as the JAX suite asserts for JAX.  Against JAX at the
same queue and plan under ``fp32`` (the two frameworks' greedy streams
are equal there): equal ``Finished`` schedules, ``ha_*`` counters,
heartbeats and byte-equal journal files, each side loading the other's.
Under ``tp_bf16`` the tokens of a kill run are equal to JAX's up to a
row's first near tie (``_near_tie``).  Tolerance: none.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.launch import engine as je  # noqa: E402
from repro.launch import journal as jj  # noqa: E402
from repro.models import paged as jpaged  # noqa: E402
from repro.train import fault as jf  # noqa: E402
from repro_torch.launch import engine as te  # noqa: E402
from repro_torch.launch import journal as tj  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import fault as tf  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("rid", "prompt_len", "tokens", "admit_round", "finish_round",
          "slot", "preemptions", "sheds", "degraded", "deadline",
          "deadline_miss", "escalated")
HA = ("ha_kills", "ha_hangs", "ha_migrations", "ha_migrated_swap",
      "ha_migrated_reingest")

_PAIRS = {}


def _pair(policy="tp_bf16"):
    """``(jax_model, jax_params, port_model, port_params)``: reduced
    gemma2 paged at 16 tokens, the port's weights JAX's converted."""
    if policy not in _PAIRS:
        jm, jp = cached_model("gemma2-9b", policy=policy, paged_kv=True,
                              page_size=16)
        tm = build_model("gemma2-9b", policy=policy, reduced=True,
                         device="cpu", paged_kv=True, page_size=16)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[policy] = (jm, jp, tm, tp)
    return _PAIRS[policy]


@pytest.fixture(scope="module")
def setup():
    _, _, tm, tp = _pair()
    return tm, tp


def _toks(fin):
    return {f.rid: list(f.tokens) for f in fin}


def _queue(mod, vocab):
    """Eight mixed requests over two arrival waves: a burst-1 kill lands
    mid-run with residents in flight."""
    return mod.synthetic_trace(8, 4, 16, 8, vocab)


def _long_queue(mod, vocab, n=4, no_degrade_rid=None):
    """Long-budget residents: every row is mid-decode for several bursts,
    so a hang finds swappable pages."""
    rng = np.random.RandomState(3)
    return [mod.Request(rid=i, tokens=rng.randint(0, vocab, size=6).tolist(),
                        max_new=14, arrival=0,
                        no_degrade=(i == no_degrade_rid))
            for i in range(n)]


def _fleet(setup, **kw):
    model, params = setup
    kw.setdefault("replicas", 2)
    kw.setdefault("slots", 2)
    kw.setdefault("chunk", 8)
    kw.setdefault("burst_cap", 4)
    return te.ReplicatedEngine(model, params, **kw)


@pytest.fixture(scope="module")
def baseline(setup):
    """Unfailed 2-replica fleet over the kill queue: the parity oracle."""
    reqs = _queue(te, setup[0].cfg.vocab)
    ml = max(r.prompt_len + r.max_new for r in reqs)
    fin, stats = _fleet(setup, max_len=ml).run(reqs)
    assert stats["ha_kills"] == stats["ha_migrations"] == 0
    return reqs, ml, _toks(fin)


# ---------------------------------------------------------------------------
# failure injection + migration parity (within the port)
# ---------------------------------------------------------------------------
def test_kill_reingest_migration_parity(setup, baseline):
    reqs, ml, base = baseline
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=1, mode="kill")
    fin, st = _fleet(setup, max_len=ml, migrate="reingest",
                     replica_fault=plan).run(reqs)
    assert _toks(fin) == base
    assert [f.rid for f in fin] == [r.rid for r in reqs]
    assert st["ha_kills"] == 1 and st["ha_hangs"] == 0
    assert st["ha_migrations"] >= 1
    assert st["ha_migrated_reingest"] == st["ha_migrations"]
    assert st["ha_migrated_swap"] == 0
    assert st["heartbeats"][0]["status"] == "dead"
    assert st["heartbeats"][1]["status"] == "live"
    assert any(k == "kill" for k, _ in plan.events)
    assert st["pool"]["n_live"] == len(st["replicas"])     # scratch pages


def test_kill_under_swap_mode_falls_back_to_reingest(setup, baseline):
    """A killed replica's device memory is gone: even with
    ``migrate="swap"`` its requests re-ingest, at token parity."""
    reqs, ml, base = baseline
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=1, mode="kill")
    fin, st = _fleet(setup, max_len=ml, migrate="swap", preempt="swap",
                     replica_fault=plan).run(reqs)
    assert _toks(fin) == base
    assert st["ha_kills"] == 1 and st["ha_migrations"] >= 1
    assert st["ha_migrated_swap"] == 0
    assert st["ha_migrated_reingest"] == st["ha_migrations"]


def test_hang_swap_blob_migration_parity(setup):
    """A hung replica's pages are still readable: residents travel as
    tagged swap blobs into the survivor's pool, bit for bit."""
    reqs = _long_queue(te, setup[0].cfg.vocab)
    ml = 6 + 14
    base, _ = _fleet(setup, max_len=ml, preempt="swap").run(reqs)
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=2, mode="hang")
    fin, st = _fleet(setup, max_len=ml, preempt="swap", migrate="swap",
                     hang_patience=1, replica_fault=plan).run(reqs)
    assert _toks(fin) == _toks(base)
    assert st["ha_hangs"] == 1 and st["ha_kills"] == 0
    assert st["ha_migrated_swap"] >= 1
    assert st["sdc_detected"] == 0
    assert st["heartbeats"][0]["status"] == "dead"
    assert st["heartbeats"][0]["missed"] >= 1


def test_no_degrade_victim_stays_exact_through_migration(setup):
    """A ``no_degrade`` request on the hung replica migrates through a
    degrading (fp8) swap store, yet equals its solo run."""
    model, params = setup
    reqs = _long_queue(te, model.cfg.vocab, no_degrade_rid=0)
    ml = 6 + 14
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=2, mode="hang")
    fin, st = _fleet(setup, max_len=ml, preempt="swap", migrate="swap",
                     degrade_fmt="fp8", hang_patience=1,
                     replica_fault=plan).run(reqs)
    assert st["ha_hangs"] == 1 and st["ha_migrations"] >= 1
    g, _ = model.generate(params, torch.tensor([list(reqs[0].tokens)]),
                          gen_len=14, max_len=ml)
    f0 = next(f for f in fin if f.rid == 0)
    assert f0.tokens == g[0].tolist()
    assert not f0.degraded
    assert all(len(f.tokens) == r.max_new for r, f in zip(reqs, fin))


def _escalating_fleet(mod, model, params, fault):
    return mod.ReplicatedEngine(
        model, params, replicas=2, slots=2, max_len=30, chunk=8,
        burst_cap=4, migrate="reingest", replica_fault=fault,
        escalate=_esc_policy(mod), fault_plan=(
            (jf if mod is je else tf).ServeFaultPlan(
                overflow_at=(2,), overflow_scale=65536.0)))


def _esc_policy(mod):
    if mod is je:
        from repro.core.policy import EscalationPolicy
    else:
        from repro_torch.core.policy import EscalationPolicy
    return EscalationPolicy(of_threshold=4)


def test_mid_escalation_victim_keeps_rung():
    """A request that escalated its KV rung before the failure keeps it on
    the survivor (``_QEntry.esc_level`` rides the migration); tokens equal
    the unfailed escalating fleet's, and JAX's (under ``fp32``)."""
    jm, jp, tm, tp = _pair("fp32")
    rng = np.random.RandomState(5)
    toks = [rng.randint(0, tm.cfg.vocab, size=12).tolist() for _ in range(4)]
    reqs = lambda mod: [mod.Request(rid=i, tokens=t, max_new=16)
                        for i, t in enumerate(toks)]
    base, bst = _escalating_fleet(te, tm, tp, None).run(reqs(te))
    assert bst["escalations"] >= 1
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=3, mode="hang")
    fin, st = _escalating_fleet(te, tm, tp, plan).run(reqs(te))
    assert _toks(fin) == _toks(base)
    assert st["ha_hangs"] == 1 and st["ha_migrations"] >= 1
    assert st["escalations"] >= 1
    assert {f.rid: f.escalated for f in fin} == \
           {f.rid: f.escalated for f in base}
    jfin, jst = _escalating_fleet(
        je, jm, jp, jf.ReplicaFaultPlan(replica=0, at_burst=3,
                                        mode="hang")).run(reqs(je))
    _same_fleet(jfin, jst, fin, st)


# ---------------------------------------------------------------------------
# swap-blob provenance
# ---------------------------------------------------------------------------
def test_blob_tag_unit():
    ok = tpaged.SwapBlobTag(replica=0, dtype="bfloat16", page=16)
    tpaged.check_blob_tag(ok, dtype=torch.bfloat16, page=16)
    tpaged.check_blob_tag(None, dtype=torch.bfloat16, page=16)
    # replica provenance alone is not foreign: migration is the point
    tpaged.check_blob_tag(ok._replace(replica=7), dtype=torch.bfloat16,
                          page=16)
    with pytest.raises(ValueError, match="foreign swap blob"):
        tpaged.check_blob_tag(ok._replace(dtype="float32"),
                              dtype=torch.bfloat16, page=16)
    with pytest.raises(ValueError, match="foreign swap blob"):
        tpaged.check_blob_tag(ok._replace(page=8), dtype=torch.bfloat16,
                              page=16)


def _evacuated_blob(setup):
    reqs = _long_queue(te, setup[0].cfg.vocab)
    fleet = _fleet(setup, max_len=20, preempt="swap")
    e0, e1 = fleet.engines
    for eng, part in zip(fleet.engines, fleet.partition(reqs)):
        eng.start(part)
    for _ in range(3):
        e0.step()
    entries = e0.evacuate(readable=True, mode="swap")
    blob = next(e for e in entries
                if e.resume is not None and e.resume.blobs is not None)
    return e1, blob


def test_adopt_refuses_foreign_blob(setup):
    """An evacuated swap blob whose tag disagrees with the receiving
    pool's layout is refused at ``adopt``; the same blob re-tagged from
    another replica of the same layout is adopted and served."""
    e1, blob = _evacuated_blob(setup)
    good = blob.resume.tag
    assert isinstance(good, tpaged.SwapBlobTag) and good.replica == 0
    blob.resume.tag = good._replace(page=good.page * 2)
    with pytest.raises(ValueError, match="foreign swap blob"):
        e1.adopt([blob])
    blob.resume.tag = good._replace(replica=7)     # same layout: adoptable
    assert e1.adopt([blob]) == 1
    while e1.step():
        pass
    res, st = e1.finalize()
    assert len(res[blob.req.rid].tokens) == blob.req.max_new
    assert st["migrated_in"] == 1 and st["sdc_detected"] == 0


def _damaged_swap_migration(how, mod, fault, journal_mod, model, params,
                            path):
    """A swap-blob migration whose payload has one bit flipped in host
    memory, under framework ``mod``: ``"fleet"``, a hang on replica 0
    whose evacuation swap-out is the plan's first (``corrupt_swap_at``);
    ``"adopt"``, one blob evacuated by hand, flipped, and adopted by the
    other replica.  Returns ``(finished, stats, journal bytes, fault-plan
    events, queue)``."""
    reqs = _long_queue(mod, model.cfg.vocab)
    jr = journal_mod.RequestJournal(str(path))
    if how == "fleet":
        plan = fault.ServeFaultPlan(corrupt_swap_at=(0,))
        fin, st = mod.ReplicatedEngine(
            model, params, replicas=2, slots=2, chunk=8, burst_cap=4,
            max_len=20, preempt="swap", migrate="swap", hang_patience=1,
            replica_fault=fault.ReplicaFaultPlan(replica=0, at_burst=2,
                                                 mode="hang"),
            fault_plan=plan, journal=jr).run(reqs)
        jr.close()
        return fin, st, path.read_bytes(), plan.events, reqs
    fleet = mod.ReplicatedEngine(model, params, replicas=2, slots=2,
                                 chunk=8, burst_cap=4, max_len=20,
                                 preempt="swap")
    e0, e1 = fleet.engines
    for eng, part in zip(fleet.engines, fleet.partition(reqs)):
        eng.start(part)
    for _ in range(3):
        e0.step()
    blob = next(e for e in e0.evacuate(readable=True, mode="swap")
                if e.resume is not None and e.resume.blobs is not None)
    mod.ContinuousEngine._flip_bit(blob.resume.blobs, blob.req.rid)
    e1.journal, e1.fault_plan = jr, fault.ServeFaultPlan()
    assert e1.adopt([blob]) == 1
    while e1.step():
        pass
    res, st = e1.finalize()
    jr.close()
    return (sorted(res.values(), key=lambda f: f.rid), st, path.read_bytes(),
            e1.fault_plan.events, [blob.req])


@pytest.mark.parametrize("how", ["fleet", "adopt"])
def test_damaged_swap_migration_matches_jax(how, tmp_path):
    """A swap blob damaged in host memory between evacuation and adoption
    is journaled as a ``swap`` migration and caught by its CRC32 at
    admission, where the request re-ingests: under ``fp32`` the port's
    journal file is byte for byte JAX's, the fault plans' notes are equal
    (``sdc_detect`` with the slot that admitted it), and every request
    gets its whole budget with JAX's tokens."""
    jm, jp, tm, tp = _pair("fp32")
    runs = {name: _damaged_swap_migration(
                how, mod, fault, jmod, model, params,
                tmp_path / f"{name}.jsonl")
            for name, mod, fault, jmod, model, params in (
                ("jax", je, jf, jj, jm, jp), ("port", te, tf, tj, tm, tp))}
    (jfin, jst, jbytes, jev, reqs), (tfin, tst, tbytes, tev, _) = \
        runs["jax"], runs["port"]
    assert tbytes == jbytes
    migrations = [r for r in tj.RequestJournal.load(
        str(tmp_path / "port.jsonl")).records if r["kind"] == "migrate"]
    assert migrations and {r["mode"] for r in migrations} == {"swap"}
    assert tev == jev
    detects = [kw for kind, kw in tev if kind == "sdc_detect"]
    assert len(detects) == 1 and detects[0]["slot"] >= 0
    assert tst["sdc_detected"] == tst["sdc_reingest"] == 1
    for k in ("sdc_detected", "sdc_reingest", "migrated_in", "resumed"):
        assert tst[k] == jst[k], k
    budgets = {r.rid: r.max_new for r in reqs}
    assert _toks(tfin) == _toks(jfin)
    for f in tfin:
        if f.rid in budgets:
            assert len(f.tokens) == budgets[f.rid]


# ---------------------------------------------------------------------------
# the crash-consistent journal
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def crashed_journal(setup, tmp_path_factory):
    """A one-replica journaled fleet killed mid-run: no survivor, so the
    loss re-raises and the journal file is the only memory.  Returns
    (journal path, queue, max_len, unfailed single-engine oracle)."""
    model, params = setup
    reqs = te.synthetic_trace(6, 2, 16, 8, model.cfg.vocab)
    ml = max(r.prompt_len + r.max_new for r in reqs)
    base, _ = te.ContinuousEngine(model, params, slots=2, max_len=ml,
                                  chunk=8, burst_cap=2).run(reqs)
    path = tmp_path_factory.mktemp("ha") / "journal.jsonl"
    jr = tj.RequestJournal(str(path))
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=2, mode="kill")
    fleet = _fleet(setup, replicas=1, max_len=ml, burst_cap=2,
                   migrate="reingest", replica_fault=plan, journal=jr)
    with pytest.raises(tf.ReplicaLostError, match="replay the journal"):
        fleet.run(reqs)
    jr.close()
    counts = tj.RequestJournal.load(str(path)).counts()
    assert counts["replica_lost"] == 1
    assert counts.get("finish", 0) < len(reqs)      # the crash lost work
    return path, reqs, ml, _toks(base)


def test_restart_replays_journal_to_parity(setup, crashed_journal,
                                           tmp_path):
    """``run_with_restarts`` over the journaled fleet: attempt 1 dies,
    attempt 2 replays the journal and finishes every request with the
    tokens of the run that never crashed."""
    path, reqs, ml, base = crashed_journal
    p = tmp_path / "journal.jsonl"
    shutil.copy(path, p)
    jr = tj.RequestJournal.load(str(p))
    plan = tf.ReplicaFaultPlan(replica=0, at_burst=2, mode="kill")
    fleet = _fleet(setup, replicas=1, max_len=ml, burst_cap=2,
                   migrate="reingest", replica_fault=plan,
                   journal=jr).bind(reqs)
    runner, restarts = tf.run_with_restarts(lambda: fleet, max_restarts=2)
    assert runner is fleet and restarts == 1
    # every request now has a finish record: a further run answers from
    # the journal alone
    fin, st = fleet.run()
    assert _toks(fin) == base
    assert jr.counts()["replay"] >= 1
    assert st["decode_rounds"] == 0
    jr.close()
    assert len(tj.RequestJournal.load(str(p)).records) == len(jr.records)


def test_two_recovery_runs_are_identical(setup, crashed_journal,
                                         tmp_path):
    """Two engines replaying copies of the same crashed journal emit
    identical streams, both the unfailed oracle's."""
    path, reqs, ml, base = crashed_journal
    outs = []
    for tag in ("a", "b"):
        p = tmp_path / f"journal_{tag}.jsonl"
        shutil.copy(path, p)
        jr = tj.RequestJournal.load(str(p))
        fin, st = _fleet(setup, replicas=1, max_len=ml, burst_cap=2,
                         migrate="reingest", journal=jr).run(reqs)
        assert st["journal_replayed"] >= 1
        outs.append(_toks(fin))
        jr.close()
    assert outs[0] == outs[1] == base


def test_recovered_finish_when_stream_is_whole(setup, crashed_journal,
                                               tmp_path):
    """A crash between a request's last ``tokens`` record and its
    ``finish`` record: the restart answers it from the journal with a
    ``finish(recovered=True)``, as the JAX engine does."""
    path, reqs, ml, base = crashed_journal
    p = tmp_path / "journal.jsonl"
    jr = tj.RequestJournal(str(p))
    r = reqs[0]
    jr.append("tokens", rid=r.rid, replica=0, toks=base[r.rid])
    model, params = setup
    eng = te.ContinuousEngine(model, params, slots=2, max_len=ml, chunk=8,
                              burst_cap=2, journal=jr)
    fin, _ = eng.run(reqs)
    assert _toks(fin) == base
    rec = jr.finish_record(r.rid)
    assert rec["recovered"] is True and rec["toks"] == base[r.rid]
    jr.close()


def test_journal_torn_tail_dropped_and_truncated(tmp_path):
    p = tmp_path / "j.jsonl"
    jr = tj.RequestJournal(str(p))
    jr.append("admit", rid=0)
    jr.append("tokens", rid=0, toks=[1, 2])
    jr.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"kind":"tok')                     # crash mid-append
    j2 = tj.RequestJournal.load(str(p))
    assert [r["kind"] for r in j2.records] == ["admit", "tokens"]
    assert j2.emitted(0) == [1, 2]
    # the torn bytes are gone from the file too
    j2.append("tokens", rid=0, toks=[3])
    j2.close()
    assert tj.RequestJournal.load(str(p)).emitted(0) == [1, 2, 3]


def test_journal_whole_record_without_newline_is_torn(tmp_path):
    p = tmp_path / "j.jsonl"
    jr = tj.RequestJournal(str(p))
    jr.append("tokens", rid=0, toks=[1])
    jr.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"kind":"tokens","rid":0,"toks":[9]}')   # no newline
    assert tj.RequestJournal.load(str(p)).emitted(0) == [1]


def test_journal_midfile_corruption_is_hard_error(tmp_path):
    p = tmp_path / "j.jsonl"
    jr = tj.RequestJournal(str(p))
    jr.append("admit", rid=0)
    jr.append("finish", rid=0, toks=[1])
    jr.close()
    lines = p.read_text().splitlines()
    p.write_text(lines[0] + "\n" + "NOT JSON\n" + lines[1] + "\n")
    with pytest.raises(ValueError, match="corrupt at byte"):
        tj.RequestJournal.load(str(p))


RECORDS = [("admit", dict(rid=0, replica=1, round=3, slot=0, resumed=False,
                          emitted=0)),
           ("tokens", dict(rid=0, replica=1, toks=[5, 255, 0])),
           ("finish", dict(rid=0, replica=1, prompt_len=7, toks=[5, 255],
                           admit_round=3, finish_round=9, slot=0,
                           preemptions=1, sheds=0, degraded=True,
                           deadline=None, deadline_miss=False,
                           escalated=2)),
           ("replica_lost", dict(replica=1, why="killed", burst=-1,
                                 evacuated=2)),
           ("note", dict(text="naïve — ünïcode", x=1.5))]


def test_journal_bytes_match_jax_and_cross_load(tmp_path):
    """The same records give the same file bytes on both sides, each
    side loads the other's file, and the digests agree."""
    paths = {}
    for name, mod in (("port", tj), ("jax", jj)):
        paths[name] = tmp_path / f"{name}.jsonl"
        jr = mod.RequestJournal(str(paths[name]))
        for kind, payload in RECORDS:
            jr.append(kind, **payload)
        jr.close()
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    for mod, other in ((tj, "jax"), (jj, "port")):
        jr = mod.RequestJournal.load(str(paths[other]))
        assert jr.records == [{"kind": k, **p} for k, p in RECORDS]
        assert jr.emitted(0) == [5, 255, 0]
        assert jr.finish_record(0)["escalated"] == 2
        assert jr.unfinished([0, 1]) == [1]
        assert jr.counts() == {"admit": 1, "tokens": 1, "finish": 1,
                               "replica_lost": 1, "note": 1}
        jr.close()


# ---------------------------------------------------------------------------
# against the JAX package's fleet
# ---------------------------------------------------------------------------
def _same_fleet(jfin, jst, tfin, tst):
    """Equal ``Finished`` records (tokens included), ``ha_*`` counters,
    heartbeats, the fleet's summed counters and the pool view."""
    assert len(tfin) == len(jfin)
    for j, t in zip(jfin, tfin):
        for f in FIELDS:
            want = getattr(j, f)
            assert getattr(t, f) == (list(want) if f == "tokens" else want), \
                (t.rid, f)
    for k in HA + ("rounds", "decode_rounds", "bursts", "peak_live_pages",
                   "n_pages", "heartbeats", "pool", "replicas_n"):
        assert tst[k] == jst[k], k
    for k in te.COUNTERS:
        if k != "stragglers":
            assert tst[k] == jst[k], k
    assert [s["replica_status"] for s in tst["replicas"]] == \
           [s["replica_status"] for s in jst["replicas"]]


FP32_CASES = {
    "kill": (lambda mod, v: _queue(mod, v),
             dict(migrate="reingest"), dict(replica=1, at_burst=1,
                                            mode="kill")),
    "hang_swap": (lambda mod, v: _long_queue(mod, v),
                  dict(preempt="swap", migrate="swap", hang_patience=1),
                  dict(replica=0, at_burst=2, mode="hang")),
}


@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_fleet_matches_jax_under_fp32(case, tmp_path):
    """The same queue and plan through both fleets with file journals:
    equal schedules, counters and heartbeats, byte-equal journals."""
    jm, jp, tm, tp = _pair("fp32")
    queue, opts, plan = FP32_CASES[case]
    runs = {}
    for name, mod, fault, model, params in (("jax", je, jf, jm, jp),
                                            ("port", te, tf, tm, tp)):
        reqs = queue(mod, tm.cfg.vocab)
        ml = max(r.prompt_len + r.max_new for r in reqs)
        path = tmp_path / f"{name}.jsonl"
        jr = (jj if mod is je else tj).RequestJournal(str(path))
        fin, st = mod.ReplicatedEngine(
            model, params, replicas=2, slots=2, chunk=8, burst_cap=4,
            max_len=ml, replica_fault=fault.ReplicaFaultPlan(**plan),
            journal=jr, **opts).run(reqs)
        jr.close()
        runs[name] = (fin, st, path.read_bytes())
    (jfin, jst, jbytes), (tfin, tst, tbytes) = runs["jax"], runs["port"]
    _same_fleet(jfin, jst, tfin, tst)
    assert tst["ha_migrations"] >= 1
    assert tbytes == jbytes
    assert (tj.RequestJournal.load(str(tmp_path / "jax.jsonl")).records
            == jj.RequestJournal.load(str(tmp_path / "port.jsonl")).records)


def _near_tie(jm, jp, tm, tp, req, want, got):
    """Where ``got`` (the port's stream) first parts from ``want`` (JAX's),
    both frameworks replay the prompt and JAX's tokens before it: JAX's
    logits of the two candidate tokens must lie within twice the largest
    difference between the frameworks' logits there.  Returns the step
    (``len(want)`` when the streams are equal)."""
    s = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             len(want))
    if s < len(want):
        ctx = list(req.tokens) + list(want[:s])
        n = len(ctx) + 1
        jl, _ = jm.with_cfg(paged_kv=False).prefill(
            jp, np.asarray([ctx], np.int32), max_len=n)
        tl, _ = tm.with_cfg(paged_kv=False).prefill(
            tp, torch.tensor([ctx]), max_len=n)
        jl = np.asarray(jl, np.float32)[0, -1]
        tl = tl.float().numpy()[0, -1]
        gap = abs(jl[want[s]] - jl[got[s]])
        assert gap <= 2 * np.abs(jl - tl).max(), (req.rid, s, gap)
    return s


def test_kill_tokens_match_jax_up_to_near_tie(setup, baseline):
    """Under ``tp_bf16`` the two frameworks' kill runs give the same
    schedule and HA story, and tokens equal up to a row's first near
    tie; within the port the run equals its unfailed oracle."""
    jm, jp, tm, tp = _pair()
    reqs, ml, base = baseline
    plan = dict(replica=0, at_burst=1, mode="kill")
    kw = dict(replicas=2, slots=2, chunk=8, burst_cap=4, max_len=ml,
              migrate="reingest")
    jfin, jst = je.ReplicatedEngine(
        jm, jp, replica_fault=jf.ReplicaFaultPlan(**plan), **kw).run(
        _queue(je, jm.cfg.vocab))
    tfin, tst = te.ReplicatedEngine(
        tm, tp, replica_fault=tf.ReplicaFaultPlan(**plan), **kw).run(reqs)
    assert _toks(tfin) == base
    for k in HA + ("heartbeats",):
        assert tst[k] == jst[k], k
    steps = [_near_tie(jm, jp, tm, tp, r, list(j.tokens), t.tokens)
             for r, j, t in zip(reqs, jfin, tfin)]
    assert sum(steps) >= 0.75 * sum(r.max_new for r in reqs), steps


def test_session_trace_matches_jax():
    for args in ((12, 3, 16, 16, 5000), (10, 2, 64, 32, 256000),
                 (7, 1, 8, 4, 100)):
        mine = te.synthetic_trace(*args, flavor="session")
        want = je.synthetic_trace(*args, flavor="session")
        assert [dict(vars(r), tokens=list(r.tokens)) for r in mine] == \
               [dict(vars(r), tokens=list(r.tokens)) for r in want]


def test_aggregate_stats_matches_jax():
    pools = []
    for mod in (tpaged, jpaged):
        allocs = [mod.PageAllocator(n) for n in (5, 9)]
        allocs[0].alloc(3)
        ids = allocs[1].alloc(4)
        allocs[1].free(ids[:2])
        pools.append(mod.aggregate_stats(allocs))
    assert pools[0] == pools[1]
    assert pools[0]["n_live"] == 5 and pools[0]["peak_live"] == 7


# ---------------------------------------------------------------------------
# supervisor + topology (no model needed)
# ---------------------------------------------------------------------------
def test_run_with_restarts_attempt_log_names_replica():
    made = []

    class Fleet:
        def __init__(self):
            self.resets = 0

        def reset_monitors(self):
            self.resets += 1

        def run(self):
            raise tf.ReplicaLostError("replica 1 killed at burst 3",
                                      replica=1, burst=3)

    def mk():
        f = Fleet()
        made.append(f)
        return f

    with pytest.raises(tf.ReplicaLostError) as ei:
        tf.run_with_restarts(mk, max_restarts=1)
    log = ei.value.attempt_log
    assert [(a, t, r) for a, t, r, _ in log] == \
           [(0, "ReplicaLostError", 1), (1, "ReplicaLostError", 1)]
    assert all("burst 3" in msg for _, _, _, msg in log)
    assert [f.resets for f in made] == [1, 1]
    assert issubclass(tf.ReplicaLostError, tf.SimulatedFailure)


def test_replica_fault_plan_primitives():
    kill = tf.ReplicaFaultPlan(replica=1, at_burst=2, mode="kill")
    assert not kill.take_kill(0, 5) and not kill.take_kill(1, 1)
    assert kill.take_kill(1, 3) and not kill.take_kill(1, 4)
    kill.reset()
    assert kill.take_kill(1, 2)
    hang = tf.ReplicaFaultPlan(replica=0, at_burst=1, mode="hang")
    assert not hang.hang_due(0, 0) and not hang.hang_due(1, 4)
    assert hang.hang_due(0, 1) and hang.hang_due(0, 0)      # sticky
    assert [k for k, _ in hang.events] == ["hang"]
    with pytest.raises(ValueError, match="kill|hang"):
        tf.ReplicaFaultPlan(mode="crash")


def test_replica_meshes_meshless():
    assert tmesh.replica_meshes(None, 3) == [None, None, None]
    with pytest.raises(ValueError, match="replica count"):
        tmesh.replica_meshes(None)
    with pytest.raises(ValueError, match="replica count"):
        tmesh.replica_meshes(None, 0)
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.replica_meshes(object(), 2)


def test_replicated_engine_validation(setup):
    with pytest.raises(ValueError, match="swap|reingest"):
        te.ReplicatedEngine(None, None, replicas=1, migrate="teleport")
    model, params = setup
    with pytest.raises(TypeError, match="Mesh"):
        te.ReplicatedEngine(model, params, mesh=object(), slots=1,
                            max_len=16)
    with pytest.raises(TypeError, match="Mesh"):
        te.ContinuousEngine(model, params, slots=1, max_len=16,
                            mesh=object())


def test_engine_knobs_match_jax():
    """``shed_base`` / ``shed_cap`` / ``min_resident``: a 5-page pool
    under a priority arrival, with a short backoff and no anti-thrash
    protection, schedules as the JAX engine does."""
    jm, jp, tm, tp = _pair()
    rng = np.random.RandomState(0)
    spec = [(20, 12, 0, 0), (20, 12, 0, 0), (16, 8, 1, 2), (8, 6, 1, 0)]
    toks = [rng.randint(0, 256, size=p).tolist() for p, _, _, _ in spec]
    kw = dict(slots=2, max_len=48, chunk=16, n_pages=5, shed_base=1,
              shed_cap=4, min_resident=0)
    out = []
    for mod, model, params in ((je, jm, jp), (te, tm, tp)):
        reqs = [mod.Request(rid=i, tokens=t, max_new=b, arrival=a,
                            priority=p)
                for i, (t, (_, b, a, p)) in enumerate(zip(toks, spec))]
        out.append(mod.ContinuousEngine(model, params, **kw).run(reqs))
    (jfin, jst), (tfin, tst) = out
    for j, t in zip(jfin, tfin):
        for f in ("rid", "admit_round", "finish_round", "slot",
                  "preemptions", "sheds"):
            assert getattr(t, f) == getattr(j, f), (t.rid, f)
    for k in ("preemptions", "shed_events", "rounds", "decode_rounds"):
        assert tst[k] == jst[k], k
    assert tst["preemptions"] >= 1


# ---------------------------------------------------------------------------
# the session trace flavor + the HA soak over it
# ---------------------------------------------------------------------------
def test_session_trace_growing_shared_prefix():
    n, slots, plen, gen = 12, 3, 16, 16
    reqs = te.synthetic_trace(n, slots, plen, gen, 5000, flavor="session")
    assert [r.rid for r in reqs] == list(range(n))
    worst = plen + 2 * (gen // 4 + max(1, plen // 4))
    assert max(r.prompt_len for r in reqs) <= worst
    for s in range(n // 3):
        turns = reqs[3 * s:3 * s + 3]
        for a, b in zip(turns, turns[1:]):
            assert list(b.tokens[:a.prompt_len]) == list(a.tokens)
            assert b.prompt_len >= a.prompt_len + a.max_new + 1
            assert b.arrival >= a.arrival + a.max_new
        assert [t.priority for t in turns] == [0, 0, 1]
        assert all(t.no_degrade == (s % 5 == 3) for t in turns)
    assert te.synthetic_trace(n, slots, plen, gen, 5000,
                              flavor="session") == reqs
    with pytest.raises(ValueError, match="chat|soak|session"):
        te.synthetic_trace(4, 2, 8, 8, 100, flavor="bogus")


def test_ha_soak_session_drains_through_kill(setup):
    """A multi-turn session trace on a 2-replica journaled fleet, one
    replica killed mid-run: every request drains to its budget on the
    survivor, everything journaled."""
    reqs = te.synthetic_trace(10, 3, 16, 16, setup[0].cfg.vocab,
                              flavor="session")
    ml = max(r.prompt_len + r.max_new for r in reqs)
    jr = tj.RequestJournal()
    plan = tf.ReplicaFaultPlan(replica=1, at_burst=2, mode="kill")
    fin, st = _fleet(setup, slots=3, max_len=ml, burst_cap=2,
                     migrate="reingest", replica_fault=plan,
                     journal=jr).run(reqs)
    assert [f.rid for f in fin] == [r.rid for r in reqs]
    assert all(len(f.tokens) == r.max_new for r, f in zip(reqs, fin))
    assert st["ha_kills"] == 1 and st["ha_migrations"] >= 1
    assert st["heartbeats"][1]["status"] == "dead"
    assert st["pages_live_end"] == 0
    c = jr.counts()
    assert c["finish"] == len(reqs)
    assert c.get("migrate", 0) == st["ha_migrations"]
    assert c["replica_lost"] == 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_ha_launcher_matches_jax_launcher(capsys, monkeypatch, tmp_path):
    """``--replicas 2 --fault-replica 1:2 --migrate reingest --journal``
    on both launchers, the port's model given JAX's weights (``fp32``):
    the same tokens, ``replica HA`` line and journal bytes."""
    _, jp, _, tp = _pair("fp32")
    monkeypatch.setattr(ttr.Model, "init", lambda self, seed: tp)
    argv = ["--continuous", "--policy", "fp32", "--replicas", "2",
            "--fault-replica", "1:2", "--migrate", "reingest",
            "--requests", "10", "--prompt-len", "16", "--gen", "24"]
    fin, stats = serve.main(argv + ["--device", "cpu", "--journal",
                                    str(tmp_path / "port.jsonl")])
    tout = capsys.readouterr().out
    from repro.launch import serve as jserve
    jserve.main(argv + ["--journal", str(tmp_path / "jax.jsonl")])
    jout = capsys.readouterr().out
    assert stats["ha_kills"] == 1 and stats["ha_migrations"] >= 1
    assert stats["pages_live_end"] == 0
    ha = lambda out: [ln for ln in out.splitlines()
                      if ln.startswith("replica HA:")]
    assert ha(tout) == ha(jout) and len(ha(tout)) == 1
    for f in fin:
        assert (f"req {f.rid:3d}: prompt {f.prompt_len:3d} -> "
                f"{len(f.tokens):3d} tokens  (slot {f.slot}, admitted "
                f"r{f.admit_round}, finished r{f.finish_round})") in jout
    journals = [tj.RequestJournal.load(str(tmp_path / f"{n}.jsonl"))
                for n in ("port", "jax")]
    assert (tmp_path / "port.jsonl").read_bytes() == \
           (tmp_path / "jax.jsonl").read_bytes()
    for f in fin:
        assert journals[1].finish_record(f.rid)["toks"] == f.tokens
    assert "0 restarts" in tout


def test_launcher_restart_replays_journal(capsys, tmp_path):
    """``--replicas 1 --fault-replica 0:2 --journal``: the lone replica's
    loss goes through ``run_with_restarts``, which replays the journal;
    every request gets its budget."""
    p = tmp_path / "j.jsonl"
    fin, stats = serve.main(["--continuous", "--device", "cpu",
                             "--replicas", "1", "--fault-replica", "0:2",
                             "--requests", "6", "--prompt-len", "16",
                             "--gen", "16", "--journal", str(p)])
    out = capsys.readouterr().out
    reqs = te.synthetic_trace(6, 4, 16, 16, 256)
    assert [len(f.tokens) for f in fin] == [r.max_new for r in reqs]
    assert "1 restarts" in out
    assert stats["journal_replayed"] >= 1
    assert tj.RequestJournal.load(str(p)).counts()["finish"] == len(reqs)


@pytest.mark.parametrize("argv,msg", [
    (["--fault-replica", "1:2"], "needs a replicated engine"),
    (["--replicas", "2", "--fault-replica", "1:2:crash"], "kill|hang"),
    (["--replicas", "2", "--fault-replica", "1"], "R:BURST"),
    (["--replicas", "0"], "must be >= 1"),
    (["--mesh", "2"], "DP,TP"),
])
def test_launcher_flag_errors(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--continuous", "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err
