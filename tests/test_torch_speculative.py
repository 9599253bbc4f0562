"""The port's speculative decoding against the JAX package's, case for
case as ``tests/test_speculative.py`` (its MoE case waits for the MoE
slice), on reduced gemma2 with the weights of
``tests/conftest.py::cached_model`` converted by ``from_jax_params``.

Within the port the bar is bitwise: ``verify_chunk``'s logits and every
cache byte equal k+1 sequential ``decode_step`` calls (the CPU GEMMs give
a row the same bits at M = B and M = B (k+1) for B >= 2; a one-row batch
is a GEMV and differs, see ROADMAP Queue 3), ``speculate_decode`` emits
``generate(temperature=0)``'s tokens whatever the draft, and rejected
rounds leave the live cache as a never-drafted run's.  Against JAX:
``verify_chunk`` logits within the model-level ``RTOL, ATOL = 5e-2,
1e-1`` of ``tests/test_torch_model.py``, tokens equal up to a row's first
near tie (``test_torch_generate._agreeing_steps``), and the engines'
streams and ``spec_rounds`` / ``spec_emitted`` equal.  The verify read's
split partition: a folded ``kernels.ops.decode_attention`` read at the
step form's ``cluster`` is bitwise the step-form reads, and the size the
verify path asks for is ``cluster_size(B * Hkv, ...)``, not the fold's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model, small_batch  # noqa: E402
from test_torch_generate import _agreeing_steps  # noqa: E402

from repro.core.policy import EscalationPolicy as JaxEscalation  # noqa: E402
from repro.launch import engine as je  # noqa: E402
from repro.train import fault as jf  # noqa: E402
from repro_torch.core.policy import EscalationPolicy  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import engine as te  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import fault as tf  # noqa: E402

torch.set_num_threads(1)

POLICIES = ["tp_bf16", "tp_fp16", "tp_bf16_kv8"]
GEN, K, MAX_LEN = 10, 3, 48
RTOL, ATOL = 5e-2, 1e-1

_PAIRS = {}


def _pair(policy="tp_bf16", paged=True):
    key = (policy, paged)
    if key not in _PAIRS:
        cfg = dict(paged_kv=True, page_size=16) if paged else {}
        jm, jp = cached_model("gemma2-9b", policy=policy, **cfg)
        tm = build_model("gemma2-9b", policy=policy, reduced=True,
                         device="cpu", **cfg)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


def _prompts(vocab):
    toks, lens = small_batch(vocab)
    return np.array(toks, np.int32), np.array(lens, np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _greedy(tm, tp, toks, lens, **kw):
    return tm.generate(tp, _t(toks), gen_len=GEN, max_len=MAX_LEN,
                       prompt_lens=_t(lens), **kw)[0].numpy()


def _spec(tm, tp, toks, lens, **kw):
    return tm.speculate_decode(tp, _t(toks), gen_len=GEN, spec_k=K,
                               max_len=MAX_LEN, prompt_lens=_t(lens), **kw)


def _cache_bytes(caches):
    return [x for c in caches for x in c if isinstance(x, torch.Tensor)
            and x.is_floating_point()]


def _steps_then_chunk(tm, tp, toks, lens):
    """4 greedy decode steps from the prefill's token, then ONE
    ``verify_chunk`` of the same 4 tokens into a second prefill's caches:
    ``(step logits [B, 4, V], step caches, chunk logits, chunk caches)``."""
    pre = lambda: tm.prefill(tp, _t(toks), max_len=MAX_LEN,
                             prompt_lens=_t(lens))
    lg0, c_seq = pre()
    _, c_chk = pre()
    tok = lg0[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = _t(lens).long()
    chunk, seq = [tok], []
    for i in range(4):
        lg, c_seq = tm.decode_step(tp, chunk[-1], c_seq, pos + i,
                                   kv_len=pos + i + 1)
        seq.append(lg[:, -1])
        chunk.append(lg[:, -1].argmax(-1).to(torch.int32)[:, None])
    offs = pos[:, None] + torch.arange(4)
    v_lg, c_chk = tm.verify_chunk(tp, torch.cat(chunk[:4], 1), c_chk, pos,
                                  kv_len=offs + 1)
    return torch.stack(seq, 1), c_seq, v_lg, c_chk, torch.cat(chunk[:4], 1)


# ---------------------------------------------------------------------------
# chunk-form verify == step-form decode, bitwise; against JAX by tolerance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_verify_chunk_bitwise_matches_sequential(policy, paged):
    _, _, tm, tp = _pair(policy, paged)
    toks, lens = _prompts(tm.cfg.vocab)
    seq_lg, c_seq, v_lg, c_chk, _ = _steps_then_chunk(tm, tp, toks, lens)
    assert torch.equal(seq_lg, v_lg)
    for a, b in zip(_cache_bytes(c_seq), _cache_bytes(c_chk)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_verify_chunk_matches_jax(paged):
    """The same chunk through JAX's ``verify_chunk``: logits within the
    model-level tolerance, and JAX's own chunk is the port's (its greedy
    steps agree here)."""
    jm, jp, tm, tp = _pair("tp_bf16", paged)
    toks, lens = _prompts(tm.cfg.vocab)
    _, _, v_lg, _, chunk = _steps_then_chunk(tm, tp, toks, lens)
    _, jc = jax.jit(lambda p, t, l: jm.prefill(
        p, t, max_len=MAX_LEN, prompt_lens=l))(jp, toks, lens)
    offs = jnp.asarray(lens)[:, None] + jnp.arange(4, dtype=jnp.int32)
    jl, _ = jax.jit(lambda p, t, c, i, kl: jm.verify_chunk(
        p, t, c, i, kv_len=kl))(jp, jnp.asarray(chunk.numpy()), jc,
                                jnp.asarray(lens), offs + 1)
    np.testing.assert_allclose(v_lg.numpy(), np.asarray(jl, np.float32),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# accepted stream == plain greedy stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("stop", [None, 7])
def test_speculate_decode_matches_generate(paged, stop):
    _, _, tm, tp = _pair("tp_bf16", paged)
    toks, lens = _prompts(tm.cfg.vocab)
    want = _greedy(tm, tp, toks, lens, stop_token=stop)
    got = _spec(tm, tp, toks, lens, stop_token=stop)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dr", [0, 1], ids=["embed-only", "1-repeat"])
def test_layer_skip_and_narrow_draft_parity(dr):
    """A shallow draft (down to zero pattern groups) under a NARROWER
    policy changes only the accept rate, never a token.  The draft is the
    first ``dr`` pattern groups of the flat layer list, in order."""
    _, _, tm, tp = _pair("tp_bf16", True)
    toks, lens = _prompts(tm.cfg.vocab)
    dm, dp, dc = tm.draft_view(tp, list(range(tm.cfg.n_layers)), dr,
                               "tp_bf16_kv8")
    assert dm.cfg.n_layers == dr * len(tm.cfg.pattern) == len(dp["layers"])
    assert dc == list(range(dm.cfg.n_layers))
    assert dm.policy.name == "tp_bf16_kv8"
    want = _greedy(tm, tp, toks, lens)
    got = _spec(tm, tp, toks, lens, draft_repeats=dr,
                draft_policy="tp_bf16_kv8")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_speculate_decode_matches_jax(paged):
    """The port's accepted stream against JAX's ``speculate_decode``: equal
    up to each row's first near tie, judged on the two frameworks' greedy
    ``generate`` logits (each framework's speculative stream is its own
    greedy stream bit for bit, above and in ``tests/test_speculative.py``)."""
    jm, jp, tm, tp = _pair("tp_bf16", paged)
    toks, lens = _prompts(tm.cfg.vocab)
    jspec = np.asarray(jax.jit(lambda p, t, l: jm.speculate_decode(
        p, t, gen_len=GEN, spec_k=K, max_len=MAX_LEN, prompt_lens=l))(
        jp, toks, lens))
    jg, jl = jax.jit(lambda p, t, l: jm.generate(
        p, t, gen_len=GEN, max_len=MAX_LEN, prompt_lens=l,
        return_logits=True))(jp, toks, lens)
    np.testing.assert_array_equal(np.asarray(jg), jspec)
    tg, tl = tm.generate(tp, _t(toks), gen_len=GEN, max_len=MAX_LEN,
                         prompt_lens=_t(lens), return_logits=True)
    tspec = _spec(tm, tp, toks, lens).numpy()
    np.testing.assert_array_equal(tg.numpy(), tspec)
    steps = _agreeing_steps((jspec, np.asarray(jl)), (tspec, tl.numpy()),
                            toks, lens, {})
    assert steps == [GEN] * len(steps)


# ---------------------------------------------------------------------------
# rollback + accounting
# ---------------------------------------------------------------------------
def _never(tm, b):
    return lambda t, p: torch.full((b, K), tm.vocab_out - 1,
                                   dtype=torch.int32)


def _strips(caches):
    """Every layer's K and V as [B, Hkv, Smax, D] (pools gathered through
    their tables)."""
    out = []
    for c in caches:
        if isinstance(c, tpaged.PagedKVCache):
            out += [tpaged.gather_paged_kv(p, c.block_table)
                    for p in (c.k_pool, c.v_pool)]
        else:
            out += [c.k, c.v]
    return out


@pytest.mark.parametrize("draft", ["never", "narrow"])
def test_rollback_leaves_live_cache_bitwise_identical(draft):
    """Rounds with REJECTED drafts leave the live cache region exactly as
    a never-drafted run's: rejected writes land at or past ``lens`` and
    the next chunk overwrites them before they go live.  ``never``: a
    constant never-matching proposal on the contiguous cache, as in the
    JAX package.  ``narrow``: the real draft under ``tp_bf16_kv8`` writing
    into the target's paged bf16 pools, where its writes are cast to the
    pools' dtype and the pools keep it."""
    paged = draft == "narrow"
    _, _, tm, tp = _pair("tp_bf16", paged)
    toks, lens = _prompts(tm.cfg.vocab)
    b = toks.shape[0]
    pre = lambda: tm.prefill(tp, _t(toks), max_len=MAX_LEN,
                             prompt_lens=_t(lens))
    lg0, c_spec = pre()
    _, c_plain = pre()
    dtypes = [x.dtype for x in _strips(c_spec)]
    tok = lg0[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = _t(lens).long()
    done = torch.zeros((b,), dtype=torch.bool)
    kw = (dict(draft_repeats=1, draft_policy="tp_bf16_kv8") if paged
          else dict(_draft_fn=_never(tm, b)))
    s_tok, s_pos, s_lens, spec_out = tok, pos, pos, []
    for _ in range(3):
        g, n, s_tok, s_pos, s_lens, done, c_spec = tm.speculate_step(
            tp, s_tok, c_spec, s_pos, lens=s_lens, done=done,
            limit=pos + 100, spec_k=K, **kw)
        if not paged:
            assert n.tolist() == [1] * b        # 0% accept: the bonus only
        spec_out += [g[r, :n[r]] for r in range(b)]
    emitted = (s_lens - pos).tolist()
    p_tok, plain_out = tok, []
    for i in range(max(emitted)):
        lg, c_plain = tm.decode_step(tp, p_tok, c_plain, pos + i,
                                     kv_len=pos + i + 1)
        p_tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        plain_out.append(p_tok[:, 0])
    plain = torch.stack(plain_out, 1)
    for r in range(b):
        got = torch.cat([x for i, x in enumerate(spec_out) if i % b == r])
        assert torch.equal(got, plain[r, :emitted[r]])
    assert [x.dtype for x in _strips(c_spec)] == dtypes
    for a, c in zip(_strips(c_spec), _strips(c_plain)):
        for r, n_live in enumerate(s_lens.tolist()):
            assert torch.equal(a[r, :, :n_live], c[r, :, :n_live])


def test_forced_zero_accept_terminates_and_matches():
    """A draft that NEVER matches: every round accepts the bonus token
    alone, so the run takes ``gen_len - 1`` rounds and still emits the
    greedy stream."""
    _, _, tm, tp = _pair("tp_bf16", True)
    toks, lens = _prompts(tm.cfg.vocab)
    b = toks.shape[0]
    got, rounds, emitted = _spec(tm, tp, toks, lens, _draft_fn=_never(tm, b),
                                 return_stats=True)
    np.testing.assert_array_equal(got.numpy(), _greedy(tm, tp, toks, lens))
    assert rounds == GEN - 1
    assert emitted == b * (GEN - 1)


def test_full_accept_round_count_and_rate():
    """The full-depth self-draft proposes the verify argmax chain (bitwise,
    on the CPU), so every draft is accepted: ``ceil((gen_len-1)/(k+1))``
    rounds."""
    _, _, tm, tp = _pair("tp_bf16", False)
    toks, lens = _prompts(tm.cfg.vocab)
    got, rounds, emitted = _spec(tm, tp, toks, lens, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), _greedy(tm, tp, toks, lens))
    assert rounds == -(-(GEN - 1) // (K + 1))
    assert emitted == toks.shape[0] * (GEN - 1)


def test_eos_mid_chunk_accounting():
    """A stop token that fires MID-CHUNK clamps acceptance there: the
    stream (stop kept, tail frozen at the pad) is plain EOS decode's, and
    the emitted count stops at each row's stop."""
    _, _, tm, tp = _pair("tp_bf16", True)
    toks, lens = _prompts(tm.cfg.vocab)
    stop = int(_greedy(tm, tp, toks, lens)[0, GEN // 2])
    want = _greedy(tm, tp, toks, lens, stop_token=stop)
    got, rounds, emitted = _spec(tm, tp, toks, lens, stop_token=stop,
                                 return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    live = [(np.where(want[r] == stop)[0][0] if stop in want[r]
             else GEN - 1) for r in range(want.shape[0])]
    assert emitted == sum(live)
    assert 0 < rounds < GEN - 1


def _raises_like(jax_call, torch_call):
    """Both calls raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        torch_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_speculate_headroom_and_gating():
    """No silent cache corruption: missing draft lookahead raises at the
    model and at the engine; sampling and penalty engines refuse
    ``spec_k`` (acceptance is argmax-defined); MLA stacks are refused.
    Each message is the JAX package's."""
    jm, jp, tm, tp = _pair("tp_bf16", True)
    toks, _ = _prompts(tm.cfg.vocab)
    msg = _raises_like(
        lambda: jm.speculate_decode(jp, jnp.asarray(toks), gen_len=8,
                                    spec_k=K, max_len=toks.shape[1] + 8),
        lambda: tm.speculate_decode(tp, _t(toks), gen_len=8, spec_k=K,
                                    max_len=toks.shape[1] + 8))
    assert "headroom" in msg
    for kw, word in ((dict(temperature=0.7), "greedy-only"),
                     (dict(repetition_penalty=1.3), "penalties")):
        msg = _raises_like(
            lambda: je.ContinuousEngine(jm, jp, slots=2, max_len=64,
                                        spec_k=K, **kw),
            lambda: te.ContinuousEngine(tm, tp, slots=2, max_len=64,
                                        spec_k=K, **kw))
        assert word in msg
    msg = _raises_like(
        lambda: je.ContinuousEngine(jm, jp, slots=2, max_len=32,
                                    spec_k=K).run(
            [je.Request(rid=0, tokens=[1] * 24, max_new=8)]),
        lambda: te.ContinuousEngine(tm, tp, slots=2, max_len=32,
                                    spec_k=K).run(
            [te.Request(rid=0, tokens=[1] * 24, max_new=8)]))
    assert "speculative lookahead" in msg
    jmla, _ = cached_model("minicpm3-4b")
    tmla = build_model("minicpm3-4b", reduced=True, device="cpu")
    msg = _raises_like(jmla.speculate_check, tmla.speculate_check)
    assert "mla mixers cannot roll back" in msg


# ---------------------------------------------------------------------------
# the verify read's split partition
# ---------------------------------------------------------------------------
def _rand(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_folded_decode_read_is_bitwise_at_step_partition(paged):
    """4 slots x 4 chunk positions x 8 KV heads over 32-unit rows: a decode
    step of the 4 slots (32 rows) splits each row 16 ways, the fold of
    128 rows would pick 4 on its own.  At the step form's size the folded
    read is bitwise the 4 step-form reads."""
    b, s, hkv, g, d, page, nk = 4, 4, 8, 2, 16, 16, 32
    pos = torch.tensor([300, 17, 120, 500])
    q = _rand((b, s, hkv * g, d), 1)
    if paged:
        n_pages = b * nk + 1
        k, v = _rand((n_pages, hkv, page, d), 2), _rand((n_pages, hkv, page,
                                                         d), 3)
        perm = torch.randperm(n_pages, generator=torch.Generator()
                              .manual_seed(4))
        table = perm[:b * nk].reshape(b, nk).to(torch.int32)
    else:
        smax = nk * dk.STRIP_UNIT
        k, v = _rand((b, hkv, smax, d), 2), _rand((b, hkv, smax, d), 3)
        table = None
    step_c = kops.decode_cluster(b, k, table, window=None, group=g)
    assert step_c == dk.cluster_size(
        b * hkv, nk, page if paged else dk.STRIP_UNIT) == 16
    assert kops.decode_cluster(b * s, k, table, group=g) == 4
    kw = dict(policy="tp_bf16", window=None, softcap=50.0)
    steps = [kops.decode_attention(
        q[:, i, :, None], k, v, kv_len=pos + i + 1, block_table=table, **kw)
        for i in range(s)]
    fold_k, fold_v = ((k, v) if paged else
                      (k.repeat_interleave(s, 0), v.repeat_interleave(s, 0)))
    fold_t = table.repeat_interleave(s, 0) if paged else None
    fold = kops.decode_attention(
        q.reshape(b * s, hkv * g, 1, d), fold_k, fold_v,
        kv_len=(pos[:, None] + torch.arange(s) + 1).reshape(-1),
        block_table=fold_t, cluster=step_c, **kw)
    fold = fold.reshape(b, s, hkv * g, d)
    for i in range(s):
        assert torch.equal(fold[:, i], steps[i][:, :, 0])


def test_verify_read_asks_for_the_step_partition(monkeypatch):
    """With a grid budget small enough that the fold of B x S queries
    would pick a smaller split than a step of B rows, every verify read
    asks for ``cluster_size(B * Hkv, nk, page, window)`` of its layer, and
    the chunk stays bitwise the sequential steps."""
    _, _, tm, tp = _pair("tp_bf16", True)
    monkeypatch.setattr(dk, "GRID_CTAS", 16)
    toks, lens = _prompts(tm.cfg.vocab)
    b, hkv = toks.shape[0], tm.cfg.n_kv_heads
    nk = -(-MAX_LEN // tm.cfg.page_size)
    asked = []
    real = kops.decode_attention

    def spy(q, *a, **kw):
        asked.append((q.shape[0], kw.get("window"), kw.get("cluster")))
        return real(q, *a, **kw)

    monkeypatch.setattr(tattn.kops, "decode_attention", spy)
    seq_lg, c_seq, v_lg, c_chk, _ = _steps_then_chunk(tm, tp, toks, lens)
    folded = [(w, c) for rows, w, c in asked if rows == b * 4]
    assert len(folded) == tm.cfg.n_layers
    for w, c in folded:
        want = dk.cluster_size(b * hkv, nk, tm.cfg.page_size, w)
        assert c == want != dk.cluster_size(b * 4 * hkv, nk,
                                            tm.cfg.page_size, w)
    assert torch.equal(seq_lg, v_lg)
    for a, c in zip(_cache_bytes(c_seq), _cache_bytes(c_chk)):
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))


# ---------------------------------------------------------------------------
# engine composition, port against JAX
# ---------------------------------------------------------------------------
def _trace(mod, vocab, n=10):
    return mod.synthetic_trace(n, 4, 6, 10, vocab, seed=3)


def _engines(reqs_of, *, policy="tp_bf16", plan=None, **kw):
    """Both engines over the same queue and (optional) fault plan:
    ``(jax_fin, jax_stats, port_fin, port_stats)``."""
    jm, jp, tm, tp = _pair(policy, True)
    jplan = jf.ServeFaultPlan(**plan) if plan else None
    tplan = tf.ServeFaultPlan(**plan) if plan else None
    jkw = dict(kw)
    if "escalate" in kw:
        jkw["escalate"] = JaxEscalation(**kw["escalate"])
        kw = dict(kw, escalate=EscalationPolicy(**kw["escalate"]))
    jfin, jst = je.ContinuousEngine(jm, jp, fault_plan=jplan, **jkw).run(
        reqs_of(je, jm.vocab_out))
    tfin, tst = te.ContinuousEngine(tm, tp, fault_plan=tplan, **kw).run(
        reqs_of(te, tm.vocab_out))
    return jfin, jst, tfin, tst


def _same_streams(jfin, jst, tfin, tst):
    """Equal streams, and then equal speculation accounting."""
    assert [f.rid for f in tfin] == [f.rid for f in jfin]
    for j, t in zip(jfin, tfin):
        assert t.tokens == list(j.tokens), t.rid
    for key in ("spec_rounds", "spec_emitted", "spec_k", "decode_rounds",
                "rounds", "pages_live_end"):
        assert tst[key] == jst[key], key
    assert tst["spec_accept_rate"] == pytest.approx(jst["spec_accept_rate"])


SPEC_ENGINE = dict(slots=4, max_len=48, chunk=8, stop_token=7, burst_cap=16)


def test_engine_spec_vs_plain_token_parity():
    """The speculative engine serves the synthetic trace with the plain
    engine's tokens, no more decode rounds, and an accept rate in (0, 1];
    its streams and accounting equal the JAX engine's."""
    _, _, tm, tp = _pair("tp_bf16", True)
    reqs = _trace(te, tm.vocab_out)
    plain, st0 = te.ContinuousEngine(tm, tp, **SPEC_ENGINE).run(reqs)
    jfin, jst, tfin, tst = _engines(_trace, spec_k=K, **SPEC_ENGINE)
    assert [f.tokens for f in tfin] == [f.tokens for f in plain]
    assert 0.0 < tst["spec_accept_rate"] <= 1.0
    assert tst["decode_rounds"] <= st0["decode_rounds"]
    assert tst["spec_emitted"] >= tst["spec_rounds"]
    assert tst["pages_live_end"] == 0
    _same_streams(jfin, jst, tfin, tst)


def test_engine_per_request_caps_and_no_speculate():
    """``no_speculate`` rows (cap 0) and per-request ``spec_k`` caps ride
    the same burst as full-speculation rows, all at parity."""
    def mix(mod, vocab):
        return [dataclasses.replace(r, no_speculate=(i % 3 == 0),
                                    spec_k=(1 if i % 3 == 1 else None))
                for i, r in enumerate(_trace(mod, vocab))]
    _, _, tm, tp = _pair("tp_bf16", True)
    plain, _ = te.ContinuousEngine(tm, tp, **SPEC_ENGINE).run(
        _trace(te, tm.vocab_out))
    jfin, jst, tfin, tst = _engines(mix, spec_k=K, **SPEC_ENGINE)
    assert [f.tokens for f in tfin] == [f.tokens for f in plain]
    assert 0.0 < tst["spec_accept_rate"] <= 1.0
    _same_streams(jfin, jst, tfin, tst)


def test_no_speculate_row_emits_one_token_a_round():
    """A lone ``no_speculate`` request under a full-accept self-draft: one
    verified token a round, so ``gen - 1`` speculative rounds; the same
    request speculating needs ``ceil((gen - 1) / (k + 1))``."""
    _, _, tm, tp = _pair("tp_bf16", True)
    rng = np.random.RandomState(5)
    req = te.Request(rid=0, tokens=rng.randint(0, 256, 12).tolist(),
                     max_new=9)
    for opt_out, rounds in ((True, 8), (False, 2)):
        r = dataclasses.replace(req, no_speculate=opt_out)
        (fin,), st = te.ContinuousEngine(tm, tp, slots=2, max_len=48,
                                         chunk=16, spec_k=K).run([r])
        assert st["spec_rounds"] == st["decode_rounds"] == rounds
        assert st["spec_emitted"] == 8 and len(fin.tokens) == 9


@pytest.mark.parametrize("mode", ["free", "swap"])
def test_engine_spec_composes_with_preemption(mode):
    """A speculating victim preempted under page pressure resumes to its
    exact un-preempted stream on both mechanisms, as in the JAX engine."""
    def queue(mod, vocab):
        rng = np.random.RandomState(0)
        mk = lambda n: rng.randint(0, 256, size=n).tolist()
        return [mod.Request(rid=0, tokens=mk(20), max_new=24, arrival=0),
                mod.Request(rid=1, tokens=mk(20), max_new=24, arrival=0),
                mod.Request(rid=2, tokens=mk(16), max_new=8, arrival=4,
                            priority=2)]
    _, _, tm, tp = _pair("tp_bf16", True)
    jfin, jst, tfin, tst = _engines(queue, slots=2, max_len=48, chunk=16,
                                    n_pages=7, preempt=mode, spec_k=K)
    assert tst["preemptions"] >= 1 and tst["resumed"] >= 1
    for r, f in zip(queue(te, 256), tfin):
        want, _ = tm.generate(tp, torch.tensor([list(r.tokens)]),
                              gen_len=r.max_new, max_len=48)
        assert f.tokens == want[0].tolist(), (mode, r.rid)
    _same_streams(jfin, jst, tfin, tst)
    for key in ("preemptions", "resumed", "preempt_swap", "preempt_reingest"):
        assert tst[key] == jst[key], key


def test_engine_spec_composes_with_escalation():
    """Flag-driven KV escalation under an injected overflow storm: the
    speculating engine drains every budget, escalates a row, keeps every
    logit finite, and does all of it as the JAX engine does."""
    def queue(mod, vocab):
        rng = np.random.RandomState(0)
        return [mod.Request(rid=i, tokens=rng.randint(0, 256,
                                                      size=12).tolist(),
                            max_new=16, arrival=0) for i in range(2)]
    jfin, jst, tfin, tst = _engines(
        queue, policy="fp32", slots=2, max_len=64, chunk=16, n_pages=12,
        burst_cap=4, spec_k=K, escalate=dict(of_threshold=4),
        plan=dict(overflow_at=(2,), overflow_scale=65536.0))
    assert tst["escalations"] >= 1 and tst["poisoned_rounds"] == 0
    assert any(f.escalated >= 1 for f in tfin)
    assert all(len(f.tokens) == 16 for f in tfin)
    assert 0.0 < tst["spec_accept_rate"] <= 1.0
    _same_streams(jfin, jst, tfin, tst)
    assert [f.escalated for f in tfin] == [f.escalated for f in jfin]
    assert tst["escalations"] == jst["escalations"]


def test_engine_spec_replay_deterministic():
    """Same queue, same speculative engine, twice: same tokens, same
    accounting."""
    _, _, tm, tp = _pair("tp_bf16", True)
    eng = te.ContinuousEngine(tm, tp, spec_k=K, **SPEC_ENGINE)
    reqs = _trace(te, tm.vocab_out, n=6)
    fin1, st1 = eng.run(reqs)
    fin2, st2 = eng.run(reqs)
    assert [f.tokens for f in fin1] == [f.tokens for f in fin2]
    assert (st1["spec_rounds"], st1["spec_emitted"]) == \
        (st2["spec_rounds"], st2["spec_emitted"])
