"""The port's flag-driven KV-precision escalation against the JAX
package's.

  * ``models.attention.quantize_kv_rows``: bit for bit in values and OF /
    UF counts, rows at ladder levels 0, 1 and 2, and off the ladder.
  * ``launch.engine.ContinuousEngine(escalate=...)``: the five engine
    scenarios of ``tests/test_numerical_health.py`` at its configuration
    (reduced gemma2-9b under policy ``fp32``, 2 slots, ``max_len`` 64,
    chunk 16, 10 pages of 16 tokens, ``burst_cap`` 4), each served by both
    engines from the same weights: ``escalations`` / ``esc_refused`` /
    ``esc_deferred``, every request's ``Finished`` record (``escalated``
    included) and the fault plan's events are equal, and so are the
    tokens (f32 everywhere: no near tie parts the streams here).
  * The launcher's escalation command on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.core.policy import EscalationPolicy as JaxEscalation  # noqa: E402
from repro.launch import engine as je  # noqa: E402
from repro.models.attention import quantize_kv_rows as jax_rows  # noqa: E402
from repro.train import fault as jf  # noqa: E402
from repro_torch.core.policy import EscalationPolicy  # noqa: E402
from repro_torch.launch import engine as te  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.attention import quantize_kv_rows  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import fault as tf  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("rid", "tokens", "admit_round", "finish_round", "slot",
          "preemptions", "sheds", "degraded", "escalated")
COUNTS = ("escalations", "esc_deferred", "esc_refused", "poisoned_rounds",
          "nonfinite_prefill", "preemptions", "preempt_reingest",
          "preempt_swap", "resumed", "faults_overflow", "rounds",
          "decode_rounds", "bursts", "pages_live_end")

_PAIR = {}


def _pair():
    if not _PAIR:
        jm, jp = cached_model("gemma2-9b", policy="fp32", paged_kv=True,
                              page_size=16)
        tm = build_model("gemma2-9b", policy="fp32", reduced=True,
                         device="cpu", paged_kv=True, page_size=16)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIR.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _PAIR["jm"], _PAIR["jp"], _PAIR["tm"], _PAIR["tp"]


def test_quantize_kv_rows_matches_jax():
    rs = np.random.RandomState(19)
    x = (rs.randn(3, 2, 4, 16) * 10.0 ** rs.uniform(-7, 6, (3, 2, 4, 16))
         ).astype(np.float32)
    fmts_j, fmts_t = JaxEscalation().formats, EscalationPolicy().formats
    levels = np.asarray([0, 1, 2], np.int32)
    yj, cj = jax_rows(jnp.asarray(x), fmts_j, jnp.asarray(levels))
    yt, ct = quantize_kv_rows(torch.from_numpy(x), fmts_t,
                              torch.from_numpy(levels))
    np.testing.assert_array_equal(yt.numpy().view(np.uint32),
                                  np.asarray(yj).view(np.uint32))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.dtype == torch.int32
    assert int(ct[0, 0]) > 0 and int(ct[2, 0]) == 0
    assert torch.isfinite(yt).all()          # saturating: never Inf
    # a level off the ladder takes the widest rung, as in JAX
    odd = np.asarray([3, -1, 1], np.int32)
    yj, cj = jax_rows(jnp.asarray(x), fmts_j, jnp.asarray(odd))
    yt, ct = quantize_kv_rows(torch.from_numpy(x), fmts_t,
                              torch.from_numpy(odd))
    np.testing.assert_array_equal(yt.numpy().view(np.uint32),
                                  np.asarray(yj).view(np.uint32))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def _reqs(mod, vocab, n=2, plen=12, budget=16, seed=0, **kw):
    rng = np.random.RandomState(seed)
    return [mod.Request(rid=i, tokens=rng.randint(0, vocab, size=plen)
                        .tolist(), max_new=budget, arrival=0, **kw)
            for i in range(n)]


def _engine(mod, model, params, plan, policy):
    return mod.ContinuousEngine(model, params, slots=2, max_len=64,
                                chunk=16, n_pages=10, burst_cap=4,
                                escalate=policy, fault_plan=plan)


def _both(policy_kw, **req_kw):
    """One overflow-injected queue through both engines; returns the
    port's (finished, stats, engine, plan) after the parity checks."""
    jm, jp, tm, tp = _pair()
    out = []
    for mod, fmod, esc, model, params in (
            (je, jf, JaxEscalation, jm, jp), (te, tf, EscalationPolicy, tm,
                                              tp)):
        plan = fmod.ServeFaultPlan(overflow_at=(2,), overflow_scale=65536.0)
        eng = _engine(mod, model, params, plan, esc(**policy_kw))
        fin, stats = eng.run(_reqs(mod, jm.cfg.vocab, **req_kw))
        out.append((fin, stats, eng, plan))
    (jfin, jst, _, jplan), (tfin, tst, eng, tplan) = out
    for j, t in zip(jfin, tfin):
        for f in FIELDS:
            want = getattr(j, f)
            assert getattr(t, f) == (list(want) if f == "tokens" else want), \
                (t.rid, f)
    for k in COUNTS:
        assert tst.get(k) == jst.get(k), k
    assert tplan.events == jplan.events
    return tfin, tst, eng, tplan


def test_escalation_finishes_wider_with_no_poison():
    """An overflow-injected queue drains its full budget, ends at a wider
    rung, and never trips the non-finite guard (saturated writes keep the
    logits finite)."""
    fin, stats, _, plan = _both(dict(of_threshold=4))
    assert stats["escalations"] >= 1 and stats["poisoned_rounds"] == 0
    assert any(f.escalated >= 1 for f in fin)
    assert all(len(f.tokens) == 16 for f in fin)
    assert stats["pages_live_end"] == 0
    kinds = [k for k, _ in plan.events]
    assert "overflow" in kinds and "escalate" in kinds


def test_escalation_replay_deterministic():
    fin, stats, eng, plan = _both(dict(of_threshold=4))
    events = list(plan.events)
    jm = _pair()[0]
    again, st2 = eng.run(_reqs(te, jm.cfg.vocab))
    assert [f.tokens for f in again] == [f.tokens for f in fin]
    assert st2["escalations"] == stats["escalations"]
    assert plan.events == events


def test_escalation_refusable():
    fin, stats, _, _ = _both(dict(of_threshold=4), no_escalate=True)
    assert stats["escalations"] == 0 and stats["esc_refused"] >= 1
    assert all(f.escalated == 0 and len(f.tokens) == 16 for f in fin)


def test_escalation_deferred_under_page_pressure():
    fin, stats, _, _ = _both(dict(of_threshold=4, min_free_pages=1000))
    assert stats["escalations"] == 0 and stats["esc_deferred"] >= 1
    assert all(len(f.tokens) == 16 for f in fin)


def test_escalation_requires_wide_pool():
    tm8 = build_model("gemma2-9b", policy="tp_bf16_kv8", reduced=True,
                      device="cpu", paged_kv=True, page_size=16)
    with pytest.raises(ValueError, match="escalat"):
        te.ContinuousEngine(tm8, tm8.init(0), slots=2, max_len=64, chunk=16,
                            escalate=EscalationPolicy())
    jm8, jp8 = cached_model("gemma2-9b", policy="tp_bf16_kv8", paged_kv=True,
                            page_size=16)
    with pytest.raises(ValueError, match="escalat"):
        je.ContinuousEngine(jm8, jp8, slots=2, max_len=64, chunk=16,
                            escalate=JaxEscalation())


def test_escalation_launcher_on_cpu(capsys):
    fin, stats = serve.main(["--continuous", "--policy", "fp32",
                             "--escalate", "fp8,fp16,fp16alt",
                             "--fault-overflow", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert stats["escalations"] >= 1 and stats["poisoned_rounds"] == 0
    assert stats["pages_live_end"] == 0
    assert "escalated L1" in out
    assert (f"numerical health: {stats['escalations']} escalations "
            f"({stats['esc_deferred']} deferred, {stats['esc_refused']} "
            f"refused)") in out
    budgets = [r.max_new for r in te.synthetic_trace(16, 4, 64, 32, 256)]
    assert [len(f.tokens) for f in fin] == budgets
