"""MoE serving in the port against the JAX package, on the reduced
configs with the weights of ``tests/conftest.py::cached_model`` converted
by ``models.convert.from_jax_params``: qwen3-moe (GQA with per-head q/k
norm, 8 experts top-2, untied embeddings) through ``ContinuousEngine``
and speculative decoding on the paged pool, and deepseek-v2-lite (MLA,
a dense prefix layer, 8 experts top-2 plus 2 shared) through
``generate``.

Against JAX the models run under policy ``fp32``: greedy tokens equal,
logits within ``F32_ATOL`` = 1e-4 (the same f32 products summed in
another order: 4.5e-6 measured at |logits| <= 3.3).  Under ``tp_bf16``
the two frameworks round bf16 activations at other places, and a router
input one bf16 ulp apart flips a near-tied top-k choice: one expert's
output in place of another's, logits 0.7 to 4.1 apart at the reduced
configs (ROADMAP Queue 3), so no tolerance on the bf16 model holds
without pinning the routing.  Within the port the bar is bitwise under
``tp_bf16``: the engine's streams are ``generate``'s, ``verify_chunk``
equals k+1 ``decode_step`` calls at the MoE capacity of B (k+1) tokens,
and ``speculate_decode`` emits ``generate``'s tokens.  deepseek is held
to JAX's token-by-token ``decode_step`` (``tests/test_torch_mla.py``:
JAX's MLA prefill leaves prompt keys unrotated).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402
from test_torch_speculative import (_cache_bytes,  # noqa: E402
                                    _steps_then_chunk)

from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import ContinuousEngine, Request  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

F32_ATOL = 1e-4
GEN, MAX_LEN, K = 10, 48, 3
QWEN3 = "qwen3-moe-30b-a3b"
DEEPSEEK = "deepseek-v2-lite-16b"


def _pair(arch, policy="tp_bf16", **cfg):
    jm, jp = cached_model(arch, policy=policy, **cfg)
    tm = build_model(arch, policy=policy, reduced=True, device="cpu", **cfg)
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def qwen3():
    return _pair(QWEN3, paged_kv=True, page_size=16)


def _prompts(vocab, seed=11, lens=(12, 27, 32, 20)):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, size=(len(lens), max(lens))).astype(
        np.int32)
    return toks, np.asarray(lens, np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _engine_streams(tm, tp, toks, lens, **kw):
    reqs = [Request(rid=r, tokens=toks[r, :n].tolist(), max_new=GEN,
                    arrival=0) for r, n in enumerate(lens)]
    fin, stats = ContinuousEngine(tm, tp, max_len=MAX_LEN, chunk=16,
                                  **kw).run(reqs)
    assert stats["pages_live_end"] == 0
    return [f.tokens for f in fin], stats


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
def test_qwen3_engine_matches_jax_paged_greedy(policy):
    """The port's engine (3 slots for 4 requests, chunk 16) serves each
    prompt with ``generate``'s greedy tokens, bit for bit.  Under ``fp32``
    both equal JAX's paged greedy ``generate``, logits within
    ``F32_ATOL``."""
    jm, jp, tm, tp = _pair(QWEN3, policy, paged_kv=True, page_size=16)
    toks, lens = _prompts(jm.cfg.vocab)
    tg, tl = tm.generate(tp, _t(toks), gen_len=GEN, max_len=MAX_LEN,
                         prompt_lens=_t(lens), return_logits=True)
    streams, _ = _engine_streams(tm, tp, toks, lens, slots=3)
    assert streams == tg.tolist()
    if policy != "fp32":
        return
    jg, jl = jax.jit(lambda p, t, l: jm.generate(
        p, t, gen_len=GEN, max_len=MAX_LEN, prompt_lens=l,
        return_logits=True))(jp, jnp.asarray(toks), jnp.asarray(lens))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_qwen3_verify_chunk_bitwise_matches_sequential(paged):
    """``verify_chunk`` of 4 positions (MoE capacity at B x 4 tokens)
    against 4 ``decode_step`` calls (capacity at B): logits and every
    cache byte equal."""
    cfg = dict(paged_kv=True, page_size=16) if paged else {}
    _, _, tm, tp = _pair(QWEN3, **cfg)
    toks, lens = _prompts(tm.cfg.vocab)
    seq_lg, c_seq, v_lg, c_chk, _ = _steps_then_chunk(tm, tp, toks, lens)
    assert torch.equal(seq_lg, v_lg)
    for a, b in zip(_cache_bytes(c_seq), _cache_bytes(c_chk)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_speculate_decode_moe_arch_paged(qwen3):
    """The port of ``tests/test_speculative.py::
    test_speculate_decode_moe_arch_paged``: the MoE arch (qk-norm, 8
    experts top-2) through the paged pool, a 1-repeat draft, emits greedy
    ``generate``'s tokens; so does the speculative engine."""
    _, _, tm, tp = qwen3
    toks, lens = _prompts(tm.cfg.vocab)
    want = tm.generate(tp, _t(toks), gen_len=GEN, max_len=MAX_LEN,
                       prompt_lens=_t(lens))[0]
    got = tm.speculate_decode(tp, _t(toks), gen_len=GEN, spec_k=K,
                              max_len=MAX_LEN, prompt_lens=_t(lens),
                              draft_repeats=1)
    assert torch.equal(got, want)
    streams, stats = _engine_streams(tm, tp, toks, lens, slots=4, spec_k=K,
                                     draft_repeats=1)
    assert streams == want.tolist()
    assert 0.0 < stats["spec_accept_rate"] <= 1.0


def _jax_decode_row(jm, jp, jstep, prompt, gen):
    """One row alone through JAX's ``decode_step``: the prompt token by
    token, then ``gen`` greedy tokens.  Returns (tokens [gen], logits
    [gen, V])."""
    from repro.models import transformer as jt
    c = jt.init_caches(jm.cfg, 1, MAX_LEN, jm.policy)
    for i, t in enumerate(prompt):
        lg, c = jstep(jp, jnp.asarray([[t]], jnp.int32), c, jnp.int32(i))
    toks, lgs = [], []
    for s in range(gen):
        lgs.append(np.asarray(lg)[0, -1])
        toks.append(int(lgs[-1].argmax()))
        if s < gen - 1:
            lg, c = jstep(jp, jnp.asarray([[toks[-1]]], jnp.int32), c,
                          jnp.int32(len(prompt) + s))
    return np.asarray(toks), np.stack(lgs)


@pytest.mark.parametrize("loop", ["scan", "while"])
def test_deepseek_generate_matches_jax_decode_loop(loop):
    """deepseek-v2-lite (MLA with q_lora None, dense layer 0, MoE with
    shared experts) under ``fp32`` through ``generate`` on a ragged pack,
    against each row alone through JAX's ``decode_step`` loop: tokens
    equal, logits within ``F32_ATOL``.  Under ``tp_bf16`` the other loop
    form emits the same tokens."""
    jm, jp, tm, tp = _pair(DEEPSEEK, "fp32")
    toks, lens = _prompts(jm.cfg.vocab, seed=12, lens=(8, 20, 32))
    jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))
    rows = [_jax_decode_row(jm, jp, jstep, toks[r, :n], GEN)
            for r, n in enumerate(lens)]
    tg, tl = tm.generate(tp, _t(toks), gen_len=GEN, max_len=MAX_LEN,
                         prompt_lens=_t(lens), return_logits=True,
                         loop=loop)
    np.testing.assert_array_equal(tg.numpy(),
                                  np.stack([w for w, _ in rows]))
    np.testing.assert_allclose(tl.numpy(), np.stack([l for _, l in rows]),
                               rtol=0, atol=F32_ATOL)
    _, _, bm, bp = _pair(DEEPSEEK)
    kw = dict(gen_len=GEN, max_len=MAX_LEN, prompt_lens=_t(lens))
    assert torch.equal(bm.generate(bp, _t(toks), loop=loop, **kw)[0],
                       bm.generate(bp, _t(toks), loop="scan", **kw)[0])


def test_launcher_serves_qwen3_moe_on_cpu(capsys):
    """``serve --arch qwen3-moe-30b-a3b --continuous`` (reduced) serves
    every budget; with ``--speculate 3 --draft-layers 1`` the same tokens."""
    argv = ["--device", "cpu", "--arch", QWEN3, "--continuous", "--slots",
            "3", "--requests", "4", "--prompt-len", "16", "--gen", "8"]
    fin, stats = serve.main(argv)
    spec, sst = serve.main(argv + ["--speculate", "3", "--draft-layers",
                                   "1"])
    out = capsys.readouterr().out
    assert "qwen3-moe-smoke" in out or QWEN3 in out
    assert stats["pages_live_end"] == 0 == sst["pages_live_end"]
    assert [f.tokens for f in spec] == [f.tokens for f in fin]
    assert 0.0 < sst["spec_accept_rate"] <= 1.0


def test_launcher_serves_deepseek_on_cpu(capsys):
    """``serve --arch deepseek-v2-lite-16b`` (reduced) through ``generate``;
    ``--continuous`` is refused (the latent cache has no page axis)."""
    gen = serve.main(["--device", "cpu", "--arch", DEEPSEEK, "--batch", "3",
                      "--prompt-len", "16", "--gen", "6", "--ragged"])
    assert tuple(gen.shape) == (3, 6)
    assert DEEPSEEK in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", DEEPSEEK, "--continuous"])
    assert "paged_kv is unsupported for deepseek-v2-lite-smoke: mla" in (
        capsys.readouterr().err)
