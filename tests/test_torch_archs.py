"""The last attention archs of the port against the JAX package:
gemma3-12b (5:1 local / global, qk-norm, sandwich norms, no softcap),
internvl2-26b (group 6, a patch frontend stub) and whisper-small (an
encoder-decoder with layernorm, learned positions and cross-attention),
each on its ``reduced()`` config with JAX's ``Model.init`` weights
converted by ``from_jax_params`` / ``from_jax_tree``.  JAX's init zeroes
every norm gain and bias, which silences a layernorm model (whisper's
every state and logit is then 0), so the tests draw gains ~ 1 + 0.2 N
and shifts and MLP biases ~ 0.2 N from numpy (``_lively``) and hand the
same tree to both frameworks.  Inputs come from numpy seeds.

Tolerances:

* ``fp32``: prefill logits and two ``decode_step`` logits within
  ``rtol = atol = 2e-4`` of JAX's (as ``tests/test_archs.py``; f32 sums in
  another order); the encoder's states and the cross caches the same;
  greedy ``generate`` tokens equal up to a row's first near tie (JAX's
  top-2 margin there within twice the frameworks' largest logit
  difference); ``forward_train``'s loss within 1e-6 relative and every
  gradient within ``F32_REL`` = 1e-5 relative L2 (``test_torch_train``).
* ``tp_bf16``: the logits within ``rtol, atol = 5e-2, 1e-1`` (the house
  model-level bound, ``test_torch_model``: bf16 activations round at
  other places in the two frameworks).
* embeddings (learned positions at scalar, [B] and [B, S] offsets; the
  patch overwrite) and layernorm under ``fp32``: bitwise and within 1e-6.
* within the port, under ``fp32``: the paged ``ContinuousEngine``'s
  streams equal each prompt's own ``generate`` (text only, as the JAX
  engine takes no frontend).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.configs import gemma3_12b as jg3  # noqa: E402
from repro.configs import internvl2_26b as jiv  # noqa: E402
from repro.configs import whisper_small as jwh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import gemma3_12b as tg3  # noqa: E402
from repro_torch.configs import internvl2_26b as tiv  # noqa: E402
from repro_torch.configs import whisper_small as twh  # noqa: E402
from repro_torch.core.tree import (flatten_with_paths, leaves,  # noqa: E402
                                   unflatten)
from repro_torch.data.pipeline import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.engine import ContinuousEngine, Request  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        from_jax_tree, layer_views,
                                        stack_layers)
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.models.transformer import CrossCache  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("gemma3-12b", "internvl2-26b", "whisper-small")
CONFIGS = {"gemma3-12b": (tg3, jg3), "internvl2-26b": (tiv, jiv),
           "whisper-small": (twh, jwh)}
F32_TOL = 2e-4
BF16_RTOL, BF16_ATOL = 5e-2, 1e-1
F32_REL = 1e-5
B, S, MAX_LEN = 2, 12, 20


def _lively(tree, seed=1):
    """A numpy copy of a JAX param tree with norm gains ~ 1 + 0.2 N and
    norm shifts and gelu-MLP biases ~ 0.2 N (other leaves as they are)."""
    rs = np.random.RandomState(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        a = np.asarray(t)
        if key in ("g", "b", "b_up", "b_down"):
            n = rs.randn(*a.shape) * 0.2 + (1.0 if key == "g" else 0.0)
            return n.astype(np.float32).astype(a.dtype)
        return a
    return walk(tree)


def _pair(arch, policy, **cfg):
    """(JAX model, JAX params, port model, port params): the same lively
    weights on both sides."""
    jm, jp = cached_model(arch, policy=policy, **cfg)
    tree = _lively(jp)
    tm = build_model(arch, policy=policy, reduced=True, device="cpu", **cfg)
    return jm, jax.tree.map(jnp.asarray, tree), tm, from_jax_params(
        tree, device="cpu")


def _frontend(cfg, b=B, seed=2):
    """numpy frontend embeddings of ``cfg`` (patch or frames), or None."""
    rs = np.random.RandomState(seed)
    if cfg.frontend == "patch":
        return rs.randn(b, cfg.n_frontend_tokens, cfg.d_model).astype(
            np.float32)
    if cfg.encoder is not None:
        return rs.randn(b, cfg.encoder.n_frames, cfg.d_model).astype(
            np.float32)
    return None


def _tokens(vocab, b=B, s=S, seed=3):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


def _both(fe):
    return (None, None) if fe is None else (jnp.asarray(fe),
                                            torch.from_numpy(fe))


def _close(got, want, policy):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if policy == "fp32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# configs, registry, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    mine, theirs = CONFIGS[arch]
    skip = {"decode_backend", "prefill_backend"}   # "auto" in the port
    for a, b in ((mine.CONFIG, theirs.CONFIG),
                 (mine.reduced(), theirs.reduced())):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert {k: v for k, v in da.items() if k not in skip} == \
            {k: v for k, v in db.items() if k not in skip}
    assert registry.canonical(arch) in registry.ARCHS
    assert get_config(arch) == mine.CONFIG


def test_full_widths():
    g3, iv, wh = (get_config(a) for a in ARCHS)
    assert (g3.d_model, g3.n_heads, g3.n_kv_heads, g3.head_dim, g3.d_ff,
            g3.vocab) == (3840, 16, 8, 256, 15360, 262144)
    assert [s.window for s in g3.layer_list()[:6]] == [1024] * 5 + [None]
    assert iv.n_heads // iv.n_kv_heads == 6 and iv.n_frontend_tokens == 256
    assert (wh.encoder.n_layers, wh.encoder.n_frames, wh.norm,
            wh.max_seq) == (12, 1500, "layernorm", 65536)


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_jax(arch):
    """``paged_unsupported_reason`` and ``speculate_check`` give JAX's
    answers and messages."""
    jm, _ = cached_model(arch)
    tm = build_model(arch, reduced=True, device="cpu")
    assert tm.cfg.paged_unsupported_reason() == \
        jm.cfg.paged_unsupported_reason()
    try:
        jm.speculate_check()
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        tm.speculate_check()
    else:
        with pytest.raises(ValueError) as got:
            tm.speculate_check()
        assert str(got.value) == want
    if arch == "whisper-small":
        assert want and "cross-attention" in want
        with pytest.raises(ValueError, match="cross-attention caches"):
            tm.with_cfg(paged_kv=True).prefill(
                tm.init(0), torch.zeros((1, 4), dtype=torch.int64),
                max_len=8, frontend_embeds=torch.zeros(
                    (1, tm.cfg.encoder.n_frames, tm.cfg.d_model)))


# ---------------------------------------------------------------------------
# layers, weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layernorm_matches_jax(dtype):
    rs = np.random.RandomState(0)
    x, g, b = (rs.randn(*s).astype(np.float32) * sc for s, sc in
               (((3, 5, 64), 3.0), ((64,), 1.0), ((64,), 0.5)))
    x, g, b = (np.asarray(jnp.asarray(a).astype(dtype)) for a in (x, g, b))
    want = np.asarray(jlayers.layernorm(*map(jnp.asarray, (x, g, b)), 1e-5),
                      np.float32)
    got = tlayers.layernorm(*(from_jax_tree(a, device="cpu")
                              for a in (x, g, b)), 1e-5)
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        # one bf16 rounding of the same f32 value
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=2 ** -8)
    # gamma scales as it is (rmsnorm's is 1 + gamma)
    zero = tlayers.layernorm(torch.ones(2, 8), torch.zeros(8), torch.ones(8))
    assert torch.equal(zero, torch.ones(2, 8))


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_conversion(arch):
    """``from_jax_params`` carries every leaf bit for bit (``pos_embed``,
    the encoder's unstacked layers, ``xattn`` / ``norm_x``, layernorm's
    ``b``), in the layout ``Model.init`` builds."""
    jm, jp = cached_model(arch)
    tree = _lively(jp)
    tp = from_jax_params(tree, device="cpu")
    n_pat = len(jm.cfg.pattern)
    for i, lp in enumerate(tp["layers"]):
        want = jax.tree.map(lambda a: a[i // n_pat],
                            tree["pattern"][i % n_pat])
        for (path, t), w in zip(flatten_with_paths(lp), leaves(want)):
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16))
    if arch == "whisper-small":
        e = tree["encoder"]
        assert len(tp["encoder"]["layers"]) == jm.cfg.encoder.n_layers
        np.testing.assert_array_equal(
            tp["encoder"]["layers"][1]["mlp"]["b_up"].view(torch.int16)
            .numpy(), e["layers"]["mlp"]["b_up"][1].view(np.int16))
        np.testing.assert_array_equal(
            tp["pos_embed"].view(torch.int16).numpy(),
            tree["pos_embed"].view(np.int16))
        assert sorted(tp["layers"][0]) == sorted(tree["pattern"][0])
        assert "b" in tp["norm_f"] and "xattn" in tp["layers"][0]
    mine = build_model(arch, reduced=True, device="cpu").init(0)

    def shapes(t):
        return [(p, tuple(x.shape), x.dtype) for p, x in
                flatten_with_paths(t)]
    assert shapes(mine) == shapes(tp)


def test_stack_layers_inverts_layer_views_with_an_encoder():
    """The trainer's layout of whisper: ``stack_layers`` of the port's init
    has JAX's paths and shapes (the encoder's layers stacked ``[L, ...]``),
    and ``layer_views`` gives the per-layer dict back as views."""
    jm, jp = cached_model("whisper-small")
    m = build_model("whisper-small", reduced=True, device="cpu")
    port = m.init(0)
    tree = stack_layers(port, m.cfg)
    jflat = [(jax.tree_util.keystr(p), v) for p, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    tflat = flatten_with_paths(tree)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (p, j), (_, t) in zip(jflat, tflat):
        assert tuple(j.shape) == tuple(t.shape), p
    back = layer_views(tree)
    assert [p for p, _ in flatten_with_paths(back)] == \
        [p for p, _ in flatten_with_paths(port)]
    for a, b in zip(leaves(back), leaves(port)):
        assert torch.equal(a, b)
    wq = tree["encoder"]["layers"]["attn"]["wq"]
    assert back["encoder"]["layers"][1]["attn"]["wq"].data_ptr() == \
        wq[1].data_ptr()


# ---------------------------------------------------------------------------
# embeddings, encoder, caches
# ---------------------------------------------------------------------------
def test_learned_positions_match_jax():
    """whisper's ``embed`` at a scalar offset, a [B] vector (one token a
    row) and a [B, S] matrix (a verify chunk), bit for bit."""
    jm, jp, tm, tp = _pair("whisper-small", "fp32")
    toks = _tokens(tm.cfg.vocab, s=5)
    for off in (0, 7):
        want = jm.embed(jp, jnp.asarray(toks), pos_offset=off)
        got = tm.embed(tp, torch.from_numpy(toks), pos_offset=off)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vec = np.array([3, 11])
    want = jm.embed(jp, jnp.asarray(toks[:, :1]), pos_offset=jnp.asarray(vec))
    got = tm.embed(tp, torch.from_numpy(toks[:, :1]),
                   pos_offset=torch.from_numpy(vec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mat = vec[:, None] + np.arange(5)
    want = jm.embed(jp, jnp.asarray(toks), pos_offset=jnp.asarray(mat))
    got = tm.embed(tp, torch.from_numpy(toks),
                   pos_offset=torch.from_numpy(mat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_patch_overwrite_matches_jax():
    """internvl2's patch embeddings overwrite the first K embedded
    positions, as JAX's ``dynamic_update_slice``; other patches move the
    prefill logits, so the overwrite is not dropped."""
    jm, jp, tm, tp = _pair("internvl2-26b", "fp32")
    toks = _tokens(tm.cfg.vocab)
    fe = _frontend(tm.cfg)
    jfe, tfe = _both(fe)
    want = np.asarray(jm.embed(jp, jnp.asarray(toks), jfe))
    got = tm.embed(tp, torch.from_numpy(toks), tfe).numpy()
    np.testing.assert_array_equal(got, want)
    k = tm.cfg.n_frontend_tokens
    np.testing.assert_array_equal(got[:, :k], fe)
    np.testing.assert_array_equal(
        got[:, k:], tm.embed(tp, torch.from_numpy(toks)).numpy()[:, k:])
    lg, _ = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                       frontend_embeds=tfe)
    lg2, _ = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                        frontend_embeds=tfe * 2)
    assert (lg - lg2).abs().max().item() > 1e-2


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
def test_encoder_and_cross_caches_match_jax(policy):
    """whisper's ``encode`` and, after ``prefill``, every layer's cross
    cache (the encoder states' K/V, written whole) and self cache."""
    jm, jp, tm, tp = _pair("whisper-small", policy)
    fe = _frontend(tm.cfg)
    jfe, tfe = _both(fe)
    want = jt.encode(jfe, jp["encoder"], jm.cfg, jm.policy)
    _close(tm.encode(tp, tfe), want, policy)
    toks = _tokens(tm.cfg.vocab)
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN,
                       frontend_embeds=jfe)
    _, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                       frontend_embeds=tfe)
    assert all(isinstance(c, CrossCache) for c in tc)
    assert tc[0].xkv.k.shape == (B, tm.cfg.n_kv_heads,
                                 tm.cfg.encoder.n_frames, tm.cfg.head_dim)
    for r, c in enumerate(tc):
        jl = jax.tree.map(lambda a: a[r], jc.pattern[0])
        for mine, theirs in ((c.xkv.k, jl["xkv"].k), (c.xkv.v, jl["xkv"].v),
                             (c.kv.k, jl["kv"].k)):
            _close(mine, theirs, policy)


def test_encoder_needs_frame_embeddings():
    """The audio frontend is a stub: without frame embeddings the port
    raises where JAX's ``encode`` fails on None."""
    tm = build_model("whisper-small", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.prefill(tm.init(0), torch.zeros((1, 4), dtype=torch.int64),
                   max_len=8)


# ---------------------------------------------------------------------------
# prefill, decode, generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, policy):
    """``prefill`` logits and two ``decode_step`` logits (the tokens JAX
    picks fed to both) against JAX's."""
    jm, jp, tm, tp = _pair(arch, policy)
    toks = _tokens(tm.cfg.vocab)
    jfe, tfe = _both(_frontend(tm.cfg))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN,
                        frontend_embeds=jfe)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                        frontend_embeds=tfe)
    _close(tl, jl, policy)
    assert np.abs(np.asarray(jl)).max() > 0.5       # a live model
    for i in range(2):
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, S + i)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, S + i)
        _close(tl, jl, policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    """Greedy ``generate`` on a ragged batch under ``fp32``: the tokens
    equal JAX's up to a row's first near tie."""
    jm, jp, tm, tp = _pair(arch, "fp32")
    toks = _tokens(tm.cfg.vocab, b=3)
    lens = np.array([S, 9, 5] if tm.cfg.frontend != "patch" else [S, 10, 9])
    jfe, tfe = _both(_frontend(tm.cfg, b=3))
    f = jax.jit(lambda p, t, l, e: jm.generate(
        p, t, gen_len=8, prompt_lens=l, frontend_embeds=e,
        return_logits=True))
    jg, jl = (np.asarray(x) for x in f(jp, jnp.asarray(toks),
                                       jnp.asarray(lens), jfe))
    tg, tl = tm.generate(tp, torch.from_numpy(toks), gen_len=8,
                         prompt_lens=torch.from_numpy(lens),
                         frontend_embeds=tfe, return_logits=True)
    tg, tl = tg.numpy(), tl.numpy()
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], rtol=F32_TOL, atol=F32_TOL)
    for r in range(3):
        bad = np.nonzero(tg[r] != jg[r])[0]
        if len(bad):
            s0 = bad[0]        # both saw the same history up to here
            diff = np.abs(tl[r, :s0 + 1] - jl[r, :s0 + 1]).max()
            top2 = np.sort(jl[r, s0])[-2:]
            assert top2[1] - top2[0] <= 2 * diff, (r, s0)


@pytest.mark.parametrize("arch", ["gemma3-12b", "internvl2-26b"])
def test_paged_engine_equals_generate(arch):
    """gemma3 (its window crossed) and internvl2 (text only) through the
    paged ``ContinuousEngine`` under ``fp32``: each request's stream equals
    its prompt's own greedy ``generate``, and the pool drains."""
    _, _, tm, tp = _pair(arch, "fp32")
    paged = tm.with_cfg(paged_kv=True, page_size=8)
    rng = np.random.RandomState(4)
    lens, budgets = (5, 23, 14, 9), (6, 4, 7, 3)
    reqs = [Request(rid=i, tokens=rng.randint(0, tm.cfg.vocab,
                                              size=n).tolist(),
                    max_new=m, arrival=i // 2)
            for i, (n, m) in enumerate(zip(lens, budgets))]
    fin, stats = ContinuousEngine(paged, tp, slots=2, max_len=32,
                                  chunk=8).run(reqs)
    assert stats["pages_live_end"] == 0
    for f, r in zip(fin, reqs):
        want = tm.generate(tp, torch.tensor([r.tokens]), gen_len=r.max_new)
        assert f.tokens == want[0][0].tolist(), r.rid


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    """``forward_train``'s loss and every gradient (the encoder's and the
    learned positions' included) against ``jax.value_and_grad`` under
    ``fp32``, on the trainer's stacked tree."""
    jm, jp, _, _ = _pair(arch, "fp32")
    tm = build_model(arch, policy="fp32", reduced=True, device="cpu",
                     prefill_backend="dense")
    rs = np.random.default_rng(5)
    toks = rs.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32)
    labels = rs.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    fe = _frontend(tm.cfg)
    jfe, tfe = _both(fe)
    jloss, jgrad = jax.value_and_grad(lambda p: jm.forward_train(
        p, jnp.asarray(toks), jnp.asarray(labels), frontend_embeds=jfe))(jp)
    tree = from_jax_tree(jax.tree.map(np.asarray, jp), device="cpu")
    flat = [p.detach().clone().requires_grad_() for p in leaves(tree)]
    loss = tm.forward_train(unflatten(tree, flat), torch.from_numpy(toks),
                            torch.from_numpy(labels), frontend_embeds=tfe)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    jflat = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
             jax.tree_util.tree_flatten_with_path(jgrad)[0]]
    assert [p for p, _ in jflat] == [p for p, _ in flatten_with_paths(tree)]
    for (path, want), got in zip(jflat, grads):
        got = np.zeros_like(want) if got is None else got.numpy()
        den = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= F32_REL * max(den, 1e-30), path


def test_frontend_batches():
    """Patch and audio batches: standard normal f32 [b, K, d] beside the
    tokens, a pure function of the step."""
    for fr, k in (("patch", 8), ("audio", 30)):
        cfg = DataConfig(vocab=256, seq_len=16, global_batch=4,
                         frontend=fr, n_frontend_tokens=k, d_model=64)
        data = SyntheticLMData(cfg, host_index=1, host_count=2)
        b = data.batch_at(3)
        assert b["frontend_embeds"].shape == (2, k, 64)
        assert b["frontend_embeds"].dtype == torch.float32
        assert b["tokens"].shape == (2, 16)
        assert torch.equal(data.batch_at(3)["frontend_embeds"],
                           b["frontend_embeds"])
        assert abs(b["frontend_embeds"].std().item() - 1.0) < 0.1
    plain = SyntheticLMData(DataConfig(vocab=256, seq_len=16,
                                       global_batch=4)).batch_at(0)
    assert "frontend_embeds" not in plain


def test_train_step_takes_frontend_embeds():
    """A whisper train step on a batch with frame embeddings: the loss
    falls over three steps on one batch, and the encoder's weights move."""
    from repro_torch.models.convert import stack_layers as stack
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    tm = build_model("whisper-small", policy="fp32", reduced=True,
                     device="cpu", prefill_backend="dense")
    params = stack(tm.init(0), tm.cfg)
    params = unflatten(params, [t.clone() for t in leaves(params)])
    cfg = DataConfig(vocab=tm.cfg.vocab, seq_len=12, global_batch=2,
                     frontend="audio", n_frontend_tokens=30,
                     d_model=tm.cfg.d_model)
    batch = SyntheticLMData(cfg).batch_at(0)
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    state = init_opt_state(params, opt, tm.policy)
    step = make_train_step(tm, opt)
    enc0 = params["encoder"]["layers"]["attn"]["wq"].clone()
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
    assert not torch.equal(params["encoder"]["layers"]["attn"]["wq"], enc0)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_launchers_take_the_archs(capsys):
    """gemma3 and internvl2 (text only) serve through both launcher forms;
    whisper's fixed batch and train step raise in ``encode`` (the
    launchers feed no frame embeddings, as JAX's do not) and its paged
    forms are refused."""
    tserve.main(["--arch", "gemma3-12b", "--device", "cpu", "--continuous",
                 "--slots", "2", "--requests", "3", "--prompt-len", "12",
                 "--gen", "4"])
    tserve.main(["--arch", "internvl2-26b", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "gemma3-smoke" in out and "internvl2-26b [scan]" in out
    with pytest.raises(ValueError, match="frame embeddings"):
        tserve.main(["--arch", "whisper-small", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "whisper-small", "--device", "cpu",
                     "--continuous"])
    with pytest.raises(ValueError, match="frame embeddings"):
        ttrain.main(["--arch", "whisper-small", "--device", "cpu",
                     "--steps", "2", "--seq-len", "8", "--global-batch",
                     "2"])
    ttrain.main(["--arch", "internvl2-26b", "--device", "cpu", "--steps",
                 "2", "--seq-len", "8", "--global-batch", "2"])
    assert "done: 2 steps" in capsys.readouterr().out
