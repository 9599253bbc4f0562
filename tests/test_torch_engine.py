"""The port's continuous-batching engine against the JAX package's on the
house engine model (reduced gemma2, paged in 16-token pages, 3 slots,
``max_len`` 48, chunk 16) and the 8-request queue of
``tests/test_engine.py``: per-request greedy token streams, admit and
finish rounds and ``peak_live_pages`` must be IDENTICAL, and the pool must
drain.  Both engines run with their default ``shed=True`` (the pool is
ample, so no request is ever deferred)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.launch.engine import ContinuousEngine as JaxEngine  # noqa: E402
from repro.launch.engine import Request as JaxRequest  # noqa: E402
from repro.launch.engine import synthetic_trace as jax_trace  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import (ContinuousEngine, Request,  # noqa: E402
                                       synthetic_trace)
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)


def _requests(cls, vocab, seed=0):
    rng = np.random.RandomState(seed)
    lens = (8, 20, 32, 13, 27, 5, 32, 16)
    budgets = (4, 9, 3, 7, 5, 8, 2, 6)
    arrivals = (0, 0, 0, 0, 2, 2, 5, 9)
    return [cls(rid=i, tokens=rng.randint(0, vocab, size=n).tolist(),
                max_new=b, arrival=a)
            for i, (n, b, a) in enumerate(zip(lens, budgets, arrivals))]


@pytest.fixture(scope="module")
def runs():
    jm, jp = cached_model("gemma2-9b", paged_kv=True, page_size=16)
    kw = dict(slots=3, max_len=48, chunk=16)
    jfin, jstats = JaxEngine(jm, jp, **kw).run(
        _requests(JaxRequest, jm.cfg.vocab))
    tm = build_model("gemma2-9b", reduced=True, device="cpu", paged_kv=True,
                     page_size=16)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    eng = ContinuousEngine(tm, tp, **kw)
    tfin, tstats = eng.run(_requests(Request, tm.cfg.vocab))
    return (jfin, jstats), (tfin, tstats), eng


def test_engine_token_streams_identical(runs):
    (jfin, _), (tfin, _), _ = runs
    assert [f.rid for f in tfin] == [f.rid for f in jfin]
    for j, t in zip(jfin, tfin):
        assert t.tokens == list(j.tokens), t.rid
        assert len(t.tokens) == _requests(Request, 256)[t.rid].max_new


def test_engine_rounds_and_pages_identical(runs):
    (jfin, jstats), (tfin, tstats), eng = runs
    for j, t in zip(jfin, tfin):
        assert (t.admit_round, t.finish_round, t.slot) == \
            (j.admit_round, j.finish_round, j.slot), t.rid
    for key in ("rounds", "decode_rounds", "bursts", "peak_live_pages",
                "n_pages", "fixed_equiv_pages"):
        assert tstats[key] == jstats[key], key
    assert tstats["occupancy"] == pytest.approx(jstats["occupancy"])
    # the pool drains back to the scratch page
    assert tstats["pages_live_end"] == 0
    assert eng.alloc.n_live == 1
    assert tstats["peak_live_pages"] <= tstats["fixed_equiv_pages"]


def test_engine_rerun_is_deterministic(runs):
    _, (tfin, tstats), eng = runs
    again, stats2 = eng.run(_requests(Request, 256))
    assert [f.tokens for f in again] == [f.tokens for f in tfin]
    assert stats2["peak_live_pages"] == tstats["peak_live_pages"]


def test_synthetic_trace_matches_jax():
    for args in ((10, 4, 16, 24, 256), (16, 3, 64, 32, 1000)):
        mine, theirs = synthetic_trace(*args), jax_trace(*args)
        assert ([(r.rid, list(r.tokens), r.max_new, r.arrival, r.priority)
                 for r in mine]
                == [(r.rid, list(r.tokens), r.max_new, r.arrival, r.priority)
                    for r in theirs])


def test_engine_refuses_unported_options():
    tm = build_model("gemma2-9b", reduced=True, device="cpu", paged_kv=True,
                     page_size=16)
    params = tm.init(0)
    # meshes are ported (tests/test_torch_tp.py): a foreign object is not
    # one
    with pytest.raises(TypeError, match="Mesh"):
        ContinuousEngine(tm, params, slots=2, max_len=32, mesh=object())
    # replicas and the journal are ported (tests/test_torch_replica_ha.py)
    from repro_torch.launch.journal import RequestJournal
    from repro_torch.train.fault import ReplicaFaultPlan
    eng = ContinuousEngine(tm, params, slots=2, max_len=32, replica_id=1,
                           replica_fault=ReplicaFaultPlan(),
                           journal=RequestJournal(), shed_base=1,
                           shed_cap=8, min_resident=0)
    assert (eng.replica_id, eng.shed_base, eng.shed_cap,
            eng.min_resident) == (1, 1, 8, 0)
    # speculation is ported: greedy only, no penalties
    eng = ContinuousEngine(tm, params, slots=2, max_len=32, spec_k=2,
                           draft_repeats=1, draft_policy="tp_bf16_kv8")
    assert (eng.spec_k, eng.draft_repeats, eng.draft_policy.name) == \
        (2, 1, "tp_bf16_kv8")
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousEngine(tm, params, slots=2, max_len=32, spec_k=2,
                         temperature=0.5)
    with pytest.raises(ValueError, match="penalties"):
        ContinuousEngine(tm, params, slots=2, max_len=32, spec_k=2,
                         presence_penalty=0.5)
    # escalation is ported: a policy object is required, and a narrow pool
    # refuses it (tests/test_torch_escalation.py drives it)
    with pytest.raises(TypeError, match="EscalationPolicy"):
        ContinuousEngine(tm, params, slots=2, max_len=32, escalate=object())
    # the overload and sampling options of this slice are accepted
    ContinuousEngine(tm, params, slots=2, max_len=32, shed=True,
                     temperature=0.5, top_k=8, top_p=0.9, preempt="swap",
                     degrade_fmt="fp8", repetition_penalty=1.1)
    with pytest.raises(ValueError, match="preempt"):
        ContinuousEngine(tm, params, slots=2, max_len=32, preempt="drop")
    with pytest.raises(ValueError, match="paged"):
        ContinuousEngine(tm.with_cfg(paged_kv=False), params, slots=2,
                         max_len=32)


def test_serve_launcher_on_cpu(capsys):
    fin, stats = serve.main(["--continuous", "--device", "cpu", "--slots",
                             "3", "--requests", "6", "--prompt-len", "16",
                             "--gen", "16"])
    out = capsys.readouterr().out
    assert "continuous engine on cpu" in out and "tok/s" in out
    assert len(fin) == 6 and stats["pages_live_end"] == 0
    budgets = [r.max_new for r in synthetic_trace(6, 3, 16, 16, 256)]
    assert [len(f.tokens) for f in fin] == budgets


def test_speculate_launcher_on_cpu(capsys):
    fin, stats = serve.main(["--continuous", "--device", "cpu", "--slots",
                             "3", "--requests", "6", "--prompt-len", "16",
                             "--gen", "16", "--speculate", "3",
                             "--draft-layers", "1"])
    out = capsys.readouterr().out
    assert "speculate k=3 draft_layers=1" in out
    assert "speculative: accept rate" in out and "chunk k+1=4" in out
    assert len(fin) == 6 and stats["pages_live_end"] == 0
    assert 0.0 < stats["spec_accept_rate"] <= 1.0
    plain, _ = serve.main(["--continuous", "--device", "cpu", "--slots",
                           "3", "--requests", "6", "--prompt-len", "16",
                           "--gen", "16"])
    assert [f.tokens for f in fin] == [f.tokens for f in plain]
    for argv in (["--speculate", "3"],
                 ["--continuous", "--speculate", "3", "--temperature", "0.7"],
                 ["--continuous", "--speculate", "3",
                  "--repetition-penalty", "1.2"]):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu"] + argv)
    err = capsys.readouterr().err
    assert "--speculate requires --continuous" in err
    assert err.count("--speculate is greedy-only") == 2
