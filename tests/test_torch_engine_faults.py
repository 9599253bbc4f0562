"""The port's overload-safe ``ContinuousEngine`` against the JAX
package's: preemption (free and swap), degradation, shedding,
priorities and deadlines, the ``ServeFaultPlan`` injections and the
watchdog, case for case as in ``tests/test_engine_faults.py``.

Both engines serve the same queue on reduced gemma2 (the weights of
``tests/conftest.py::cached_model``, converted) with the same pool and
plan.  Tolerance: none.  ``Finished`` records (tokens, admit / finish
rounds, slot, preemptions, sheds, degraded, deadline, deadline_miss) and
every robustness counter must be equal, except the timing-dependent
``stragglers`` and ``straggler_ewma_s``; the one penalized greedy case
holds its tokens to JAX's up to a row's first near tie, and in full to
the port's solo run (a near tie parts the two frameworks' streams there,
see that test).  Inside the port, a preempted
and resumed row emits exactly the tokens of its solo ``generate`` run,
as in the JAX package, and the swap payload's CRC32s equal the JAX
package's ``_crc_blobs`` of the same bytes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402
from test_torch_generate import _agreeing_steps  # noqa: E402

from repro.launch import engine as je  # noqa: E402
from repro.train import fault as jf  # noqa: E402
from repro_torch.launch import engine as te  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.paged import SwapBlobTag, check_blob_tag  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import fault as tf  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("rid", "tokens", "admit_round", "finish_round", "slot",
          "preemptions", "sheds", "degraded", "deadline", "deadline_miss")
STATS = ("rounds", "decode_rounds", "bursts", "peak_live_pages",
         "pages_live_end", "deadline_total", "deadline_misses")
TIMING = ("stragglers",)
ENGINE = dict(slots=2, max_len=48, chunk=16)

_PAIRS = {}


def _pair(policy="tp_bf16"):
    if policy not in _PAIRS:
        jm, jp = cached_model("gemma2-9b", policy=policy, paged_kv=True,
                              page_size=16)
        tm = build_model("gemma2-9b", policy=policy, reduced=True,
                         device="cpu", paged_kv=True, page_size=16)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[policy] = (jm, jp, tm, tp)
    return _PAIRS[policy]


def _pressure_queue(mod, vocab, seed=0, no_degrade=False):
    """Two low-priority residents fill a 5-page pool; a priority-2
    arrival at round 4 cannot fit without preempting one of them."""
    rng = np.random.RandomState(seed)
    mk = lambda n: rng.randint(0, vocab, size=n).tolist()
    return [mod.Request(rid=0, tokens=mk(20), max_new=12, arrival=0,
                        no_degrade=no_degrade),
            mod.Request(rid=1, tokens=mk(20), max_new=12, arrival=0),
            mod.Request(rid=2, tokens=mk(16), max_new=8, arrival=4,
                        priority=2)]


def _plan(mod, **kw):
    return mod.ServeFaultPlan(**kw) if kw else None


def _both(queue, *, policy="tp_bf16", plan=None, **kw):
    """Serve ``queue(module)`` through both engines; a ``plan`` dict
    builds one ``ServeFaultPlan`` per side.  Returns ``(jax_fin,
    jax_stats, port_fin, port_stats, port_engine, port_plan)``."""
    jm, jp, tm, tp = _pair(policy)
    kw = {**ENGINE, **kw}
    jplan, tplan = _plan(jf, **(plan or {})), _plan(tf, **(plan or {}))
    jfin, jst = je.ContinuousEngine(jm, jp, fault_plan=jplan, **kw).run(
        queue(je))
    eng = te.ContinuousEngine(tm, tp, fault_plan=tplan, **kw)
    tfin, tst = eng.run(queue(te))
    if plan is not None:
        assert [k for k, _ in tplan.events] == [k for k, _ in jplan.events]
    return jfin, jst, tfin, tst, eng, tplan


def _same(jfin, jst, tfin, tst):
    assert len(tfin) == len(jfin)
    for j, t in zip(jfin, tfin):
        for f in FIELDS:
            want = getattr(j, f)
            assert getattr(t, f) == (list(want) if f == "tokens" else want), \
                (t.rid, f)
    for k in te.COUNTERS + STATS:
        if k not in TIMING:
            assert tst[k] == jst[k], k
    assert tst["deadline_miss_rate"] == pytest.approx(
        jst["deadline_miss_rate"])


def _solo(tm, tp, req):
    g, _ = tm.generate(tp, torch.tensor([list(req.tokens)]),
                       gen_len=req.max_new, max_len=48)
    return g[0].tolist()


# ---------------------------------------------------------------------------
# preempt-resume parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["free", "swap"])
def test_preempt_resume_bit_parity(mode):
    jm, _, tm, tp = _pair()
    q = lambda m: _pressure_queue(m, jm.cfg.vocab)
    jfin, jst, tfin, tst, _, _ = _both(q, n_pages=5, preempt=mode)
    _same(jfin, jst, tfin, tst)
    assert tst["preemptions"] >= 1 and tst["resumed"] >= 1
    assert tst["preempt_swap" if mode == "swap"
               else "preempt_reingest"] >= 1
    assert any(f.preemptions for f in tfin)
    for r, f in zip(q(te), tfin):
        assert f.tokens == _solo(tm, tp, r), (mode, r.rid)
        assert len(f.tokens) == r.max_new


def test_degraded_swap_is_exact_on_fp8_pool():
    jm, _, tm, tp = _pair("tp_bf16_kv8")
    q = lambda m: _pressure_queue(m, jm.cfg.vocab)
    jfin, jst, tfin, tst, _, _ = _both(q, policy="tp_bf16_kv8", n_pages=5,
                                       preempt="swap", degrade_fmt="fp8")
    _same(jfin, jst, tfin, tst)
    assert tst["degraded"] >= 1 and any(f.degraded for f in tfin)
    for r, f in zip(q(te), tfin):
        assert f.tokens == _solo(tm, tp, r), r.rid


@pytest.mark.parametrize("trace", ["pressure", "soak"])
def test_no_shed_admission_matches_jax(trace):
    """``shed=False``, head-of-line admission, on a pressured pool:
    records and counters equal JAX's ``shed=False`` run."""
    q = {"pressure": lambda m: _pressure_queue(m, 256),
         "soak": lambda m: m.synthetic_trace(10, 2, 16, 16, 256,
                                             flavor="soak")}[trace]
    jfin, jst, tfin, tst, _, _ = _both(q, n_pages=5, shed=False,
                                       preempt="swap")
    _same(jfin, jst, tfin, tst)
    # the pool fills (4 pages beside the scratch page) and requests queue
    assert tst["shed_events"] == 0 and tst["peak_live_pages"] == 4
    assert tst["preemptions"] >= (trace == "pressure")
    assert any(f.admit_round > r.arrival for r, f in zip(q(te), tfin))
    for r, f in zip(q(te), tfin):
        assert len(f.tokens) == r.max_new and f.sheds == 0


@pytest.mark.parametrize("refuse", [False, True])
def test_degrade_tracked_and_refusable(refuse):
    jm, _, tm, tp = _pair()
    q = lambda m: _pressure_queue(m, jm.cfg.vocab, no_degrade=refuse)
    jfin, jst, tfin, tst, _, _ = _both(q, n_pages=5, preempt="swap",
                                       degrade_fmt="fp8")
    _same(jfin, jst, tfin, tst)
    victims = [f for f in tfin if f.preemptions > 0]
    assert victims
    for f in victims:
        assert len(f.tokens) == q(te)[f.rid].max_new
        if refuse and f.rid == 0:
            assert not f.degraded
            assert f.tokens == _solo(tm, tp, q(te)[0])
    if not refuse:
        assert tst["degraded"] >= 1
    # every swap-out came back by one swap-in: both count host bytes
    assert tst["swap_in_bytes"] == tst["swap_out_bytes"] > 0


# ---------------------------------------------------------------------------
# fault-plan replay + injections
# ---------------------------------------------------------------------------
def test_fault_plan_replay_deterministic():
    jm, _, tm, tp = _pair()
    q = lambda m: m.synthetic_trace(8, 2, 16, 16, jm.cfg.vocab,
                                    flavor="soak")
    plan = dict(exhaust_at=(6,), exhaust_for=3, slow_at=(3,), slow_s=0.01,
                poison_at=tuple(range(8, 13)), mask_poison=True)
    jfin, jst, tfin, tst, eng, tplan = _both(q, n_pages=5, plan=plan)
    _same(jfin, jst, tfin, tst)
    ev1 = list(tplan.events)
    fin2, st2 = eng.run(q(te))
    assert [f.tokens for f in fin2] == [f.tokens for f in tfin]
    for k in ("rounds", "preemptions", "shed_events", "poisoned_rounds",
              "faults_exhaust", "faults_slow", "deadline_misses"):
        assert st2[k] == tst[k], k
    assert ev1 == list(tplan.events)
    assert tst["faults_exhaust"] >= 1 and tst["faults_slow"] >= 1
    assert tst["poisoned_rounds"] >= 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_poison_fail_fast_without_masking(side):
    jm, jp, tm, tp = _pair()
    mod, fm, model, params = ((je, jf, jm, jp) if side == "jax"
                              else (te, tf, tm, tp))
    rng = np.random.RandomState(0)
    reqs = [mod.Request(rid=0, tokens=rng.randint(
        0, jm.cfg.vocab, size=8).tolist(), max_new=8)]
    plan = fm.ServeFaultPlan(poison_at=tuple(range(0, 40)),
                             mask_poison=False)
    eng = mod.ContinuousEngine(model, params, fault_plan=plan, **ENGINE)
    with pytest.raises(fm.PoisonedLogitsError):
        eng.run(reqs)


def test_watchdog_aborts_livelock():
    _, _, tm, tp = _pair()
    rng = np.random.RandomState(0)
    reqs = [te.Request(rid=0, tokens=rng.randint(0, 256, size=8).tolist(),
                       max_new=4)]
    plan = tf.ServeFaultPlan(exhaust_at=(0,), exhaust_for=10**6)
    eng = te.ContinuousEngine(tm, tp, n_pages=4, shed=False, fault_plan=plan,
                              watchdog_patience=10, **ENGINE)
    with pytest.raises(tf.EngineStuckError) as ei:
        eng.run(reqs)
    assert ei.value.diag["pool"]["n_free"] == 0
    assert ei.value.diag["pending"]


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_deadline_accounting():
    def q(m):
        rng = np.random.RandomState(0)
        mk = lambda n: rng.randint(0, 256, size=n).tolist()
        return [m.Request(rid=0, tokens=mk(8), max_new=4, deadline=2),
                m.Request(rid=1, tokens=mk(8), max_new=4, deadline=200),
                m.Request(rid=2, tokens=mk(8), max_new=4)]
    jfin, jst, tfin, tst, _, _ = _both(q)
    _same(jfin, jst, tfin, tst)
    assert tfin[0].deadline_miss and tfin[0].deadline == 2
    assert not tfin[1].deadline_miss
    assert tfin[2].deadline is None and not tfin[2].deadline_miss
    assert (tst["deadline_total"], tst["deadline_misses"]) == (2, 1)


# ---------------------------------------------------------------------------
# the overload soak
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,corrupt", [("tp_bf16", ()),
                                            ("tp_bf16_kv8", (0, 1))])
def test_soak_drains_under_faults(policy, corrupt):
    """The soak trace on a 5-page pool with exhaustion, a straggler,
    masked poison (and on the fp8 pool two corrupted swap-outs, each
    caught and re-ingested) drains completely, as in the JAX engine."""
    q = lambda m: m.synthetic_trace(12, 2, 16, 16, 256, flavor="soak")
    plan = dict(exhaust_at=(5, 30), exhaust_for=3, slow_at=(3,),
                slow_s=0.005, poison_at=(7, 8, 9), mask_poison=True,
                corrupt_swap_at=corrupt)
    jfin, jst, tfin, tst, eng, _ = _both(q, policy=policy, n_pages=5,
                                         preempt="swap", degrade_fmt="fp8",
                                         plan=plan)
    _same(jfin, jst, tfin, tst)
    for r, f in zip(q(te), tfin):
        assert f.rid == r.rid and len(f.tokens) == r.max_new
    assert tst["preemptions"] + tst["shed_events"] > 0
    assert tst["faults_exhaust"] >= 1 and tst["deadline_total"] >= 1
    assert eng.alloc.n_live == 1 and tst["pages_live_end"] == 0
    assert tst["sdc_detected"] == tst["sdc_injected"] == min(
        len(corrupt), tst["preempt_swap"])


def test_sampled_engine_with_penalties_repeats_and_schedules_like_jax():
    """Sampling and penalties: the schedule and counters equal JAX's
    (tokens cannot, the generators differ), and a second run with the
    same seed repeats every token."""
    q = lambda m: m.synthetic_trace(10, 2, 16, 16, 256, flavor="soak")
    kw = dict(n_pages=5, preempt="swap", temperature=0.7, top_k=16,
              top_p=0.9, repetition_penalty=1.1, presence_penalty=0.3,
              seed=5)
    jfin, jst, tfin, tst, eng, _ = _both(q, **kw)
    for j, t in zip(jfin, tfin):
        for f in FIELDS[2:]:
            assert getattr(t, f) == getattr(j, f), (t.rid, f)
    for k in te.COUNTERS:
        if k not in TIMING:
            assert tst[k] == jst[k], k
    again, _ = eng.run(q(te))
    assert [f.tokens for f in again] == [f.tokens for f in tfin]


@pytest.mark.parametrize("mode", ["free", "swap"])
def test_greedy_engine_with_penalties(mode):
    """Penalties across a preemption: the histogram is re-seeded on
    resume, so every request's tokens equal its solo penalized
    ``generate`` in the port; the schedule and counters equal JAX's.
    Tokens equal JAX's up to a row's first near tie, by the rule of
    ``test_torch_generate._agreeing_steps`` applied to the two
    frameworks' solo runs (which each engine's tokens equal): request 0
    meets one at step 7 (JAX's penalized top-2 margin 0.005 against a
    0.037 logit difference between the frameworks)."""
    jm, jp, tm, tp = _pair()
    q = lambda m: _pressure_queue(m, 256)
    pen = dict(repetition_penalty=3.0, presence_penalty=0.5)
    jfin, jst, tfin, tst, _, _ = _both(q, n_pages=5, preempt=mode, **pen)
    for j, t in zip(jfin, tfin):
        for f in FIELDS[2:]:
            assert getattr(t, f) == getattr(j, f), (t.rid, f)
    for k in te.COUNTERS:
        assert tst[k] == jst[k], k
    assert tst["preemptions"] >= 1
    for r, f, j in zip(q(te), tfin, jfin):
        toks = np.array([r.tokens], np.int32)
        g, lg = tm.generate(tp, torch.from_numpy(toks), gen_len=r.max_new,
                            max_len=48, return_logits=True, **pen)
        assert f.tokens == g[0].tolist(), r.rid
        jg, jlg = (np.asarray(x) for x in jm.generate(
            jp, jnp.asarray(toks), gen_len=r.max_new, max_len=48,
            return_logits=True, **pen))
        assert list(j.tokens) == jg[0].tolist(), r.rid
        (k,) = _agreeing_steps((jg, jlg), (g.numpy(), lg.numpy()), toks,
                               None, pen)
        assert f.tokens[:k] == list(j.tokens)[:k], r.rid


def test_soak_trace_matches_jax():
    mine = te.synthetic_trace(16, 2, 16, 16, 64, flavor="soak")
    theirs = je.synthetic_trace(16, 2, 16, 16, 64, flavor="soak")
    key = lambda r: (r.rid, list(r.tokens), r.max_new, r.arrival,
                     r.priority, r.deadline, r.no_degrade)
    assert [key(r) for r in mine] == [key(r) for r in theirs]
    assert {r.priority for r in mine} == {0, 1, 2}
    with pytest.raises(ValueError):
        te.synthetic_trace(4, 2, 16, 16, 64, flavor="nope")


def test_soak_launcher_matches_jax_launcher(capsys):
    """The acceptance command: every request drains to its full budget,
    and the per-request rounds and counters equal the JAX launcher's."""
    argv = ["--continuous", "--soak", "--slots", "3", "--requests", "10",
            "--prompt-len", "16", "--gen", "24", "--pool-pages", "5",
            "--preempt", "swap", "--degrade-fmt", "fp8", "--policy",
            "tp_bf16_kv8", "--fault-exhaust", "2", "--fault-poison", "6",
            "--fault-slow", "4"]
    fin, stats = serve.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    from repro.launch import serve as jserve
    jserve.main(argv)
    jout = capsys.readouterr().out
    reqs = te.synthetic_trace(10, 3, 16, 24, 256, flavor="soak")
    assert [len(f.tokens) for f in fin] == [r.max_new for r in reqs]
    assert stats["pages_live_end"] == 0
    for f in fin:
        assert (f"(slot {f.slot}, admitted r{f.admit_round}, finished "
                f"r{f.finish_round})") in jout, f.rid
    assert (f"{stats['preemptions']} preemptions ({stats['preempt_swap']} "
            f"swap / {stats['preempt_reingest']} reingest), "
            f"{stats['shed_events']} sheds, {stats['degraded']} degraded, "
            f"{stats['deadline_misses']}/{stats['deadline_total']} deadline "
            f"misses, {stats['poisoned_rounds']} poisoned rounds masked") \
        in jout


# ---------------------------------------------------------------------------
# swap payload integrity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,np_dtype", [
    (torch.bfloat16, ml_dtypes.bfloat16),
    (torch.float8_e5m2, ml_dtypes.float8_e5m2),
    (torch.float32, np.float32)])
def test_crc_blobs_match_jax(dtype, np_dtype):
    rng = np.random.RandomState(3)
    raw = {1: np.uint8, 2: np.uint16, 4: np.uint32}[
        torch.empty((), dtype=dtype).element_size()]
    blobs_np = [tuple(rng.randint(0, 200, size=(3, 2, 16, 8)).astype(raw)
                      .view(np_dtype) for _ in range(2)) for _ in range(2)]
    int_t = {np.uint8: torch.uint8, np.uint16: torch.int16,
             np.uint32: torch.int32}[raw]
    blobs_t = [tuple(torch.from_numpy(a.view(raw).astype(raw).view(
        {np.uint8: np.uint8, np.uint16: np.int16, np.uint32: np.int32}[raw])
        .copy()).view(int_t).view(dtype) for a in pair)
        for pair in blobs_np]
    assert te._crc_blobs(blobs_t) == je._crc_blobs(blobs_np)
    flipped = [tuple(p) for p in blobs_t]
    te.ContinuousEngine._flip_bit(flipped, 7)
    jflip = [tuple(p) for p in blobs_np]
    je.ContinuousEngine._flip_bit(jflip, 7)
    assert te._crc_blobs(flipped) == je._crc_blobs(jflip)
    assert te._crc_blobs(flipped) != te._crc_blobs(blobs_t)


def test_swap_blob_tags():
    from repro.models.attention import kv_store_dtype as j_store
    from repro.models.attention import kv_swap_dtype as j_swap
    from repro.core.policy import get_policy as j_policy
    from repro_torch.core.policy import get_policy
    from repro_torch.models.attention import kv_store_dtype, kv_swap_dtype
    from repro_torch.models.paged import dtype_name
    for pol in ("tp_bf16", "tp_bf16_kv8", "fp32"):
        assert dtype_name(kv_store_dtype(get_policy(pol))) == str(
            np.dtype(j_store(j_policy(pol))))
    assert kv_swap_dtype("fp8") is torch.float8_e5m2
    assert dtype_name(kv_swap_dtype("fp8")) == str(np.dtype(j_swap("fp8")))
    with pytest.raises(ValueError):
        kv_swap_dtype("fp8_e4m3")
    tag = SwapBlobTag(replica=1, dtype="bfloat16", page=16)
    check_blob_tag(tag, dtype=torch.bfloat16, page=16)
    check_blob_tag(None, dtype=torch.float32, page=8)
    for dt, page in ((torch.float8_e5m2, 16), (torch.bfloat16, 8)):
        with pytest.raises(ValueError, match="foreign swap blob"):
            check_blob_tag(tag, dtype=dt, page=page)
    # an engine's swap blobs carry its replica id
    _, _, tm, tp = _pair()
    eng = te.ContinuousEngine(tm, tp, replica_id=1, preempt="swap",
                              n_pages=5, **ENGINE)
    eng.start(_pressure_queue(te, 256))
    tags = []
    while eng.step():
        tags += [e.resume.tag for e in eng._pending
                 if e.resume is not None and e.resume.blobs is not None]
    assert tags and set(tags) == {tag}


# ---------------------------------------------------------------------------
# fault primitives (no model)
# ---------------------------------------------------------------------------
def test_serve_fault_plan_primitives():
    plan = tf.ServeFaultPlan(exhaust_at=(3, 5), exhaust_for=2,
                             slow_at=(4,), slow_s=0.5, poison_at=(6, 9),
                             corrupt_swap_at=(1,))
    assert plan.take_exhaustion(10) == 2
    assert plan.take_exhaustion(10) is None
    assert plan.take_slow(4) == 0.5
    assert plan.take_slow(4) == 0.0
    assert plan.next_poison(0, 7) == 6
    assert plan.next_poison(7, 20) == 9
    assert plan.next_poison(10, 20) is None
    assert [plan.take_corrupt() for _ in range(3)] == [False, True, False]
    plan.reset()
    assert plan.take_exhaustion(10) == 2
    assert plan.take_corrupt() is False


def test_serve_watchdog_and_straggler_monitor():
    wd = tf.ServeWatchdog(patience=3)
    wd.tick(False), wd.tick(False)
    wd.tick(True)
    wd.tick(False), wd.tick(False)
    with pytest.raises(tf.EngineStuckError):
        wd.tick(False, diag=lambda: {"where": "here"})
    mon = tf.StragglerMonitor(warmup=2)
    assert not any(mon.record(i, 0.01) for i in range(5))
    assert mon.record(5, 0.5)
    assert mon.flagged and mon.flagged[0][0] == 5
