"""MLA (multi-head latent attention) serving of minicpm3 in the port against
the JAX package, on the reduced config with the weights of
``tests/conftest.py::cached_model`` (converted by
``models.convert.from_jax_params``).

The reference is the JAX package's token-by-token ``decode_step``, not its
prefill: the JAX prefill rotates every prompt key's rope part at position
0 (``src/repro/models/attention.py:767`` broadcasts ``[B, S, 1, rope]``
keys against ``[S]`` positions and keeps index 0), so it attends and
caches unrotated keys; its decode rotates each key at its own position, as
MiniCPM3 and DeepSeek-V2 define it, and so does the port's prefill.
``test_jax_prefill_caches_unrotated_rope_keys`` pins that divergence.

Tolerances: logits at the model-level ``RTOL, ATOL = 5e-2, 1e-1`` of
``tests/test_torch_model.py`` (bf16 activations round at other places in
the two frameworks, and the port's prefill runs the expanded form where
the reference decodes in the absorbed form: measured 0.021 at |logits| <=
6.1).  Layer 0's latent cache is bitwise JAX's (the same products of the
same embeddings); deeper layers within ``CACHE_ATOL`` = 2^-4 (twice the
largest difference measured, 2^-5 on c_kv through the dense path: 4 bf16
ulps at its magnitude, |c_kv| <= 3.3).  One MLA decode step (layer level)
within ``STEP_ATOL`` = 2^-6 of JAX's (one bf16 ulp at 2..4; measured
0).  Greedy tokens equal up to a row's first near tie (the rule of
``tests/test_torch_generate.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model, small_batch  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.layers import apply_rope as japply_rope  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro.core import ops as jtp  # noqa: E402

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import _to_torch, from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 5e-2, 1e-1
CACHE_ATOL = 2.0 ** -4
STEP_ATOL = 2.0 ** -6
S, MAX_LEN, GEN = 16, 48, 12


@pytest.fixture(scope="module")
def pair():
    jm, jp = cached_model("minicpm3-4b")
    tm = build_model("minicpm3-4b", reduced=True, device="cpu")
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def jstep(pair):
    jm = pair[0]
    return jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _sequential(jm, jp, jstep, toks):
    """The JAX package's prompt fed token by token through ``decode_step``:
    the last step's logits [B, 1, V] and the caches."""
    c = jt.init_caches(jm.cfg, toks.shape[0], MAX_LEN, jm.policy)
    for i in range(toks.shape[1]):
        lg, c = jstep(jp, jnp.asarray(toks[:, i:i + 1]), c, jnp.int32(i))
    return np.asarray(lg), c


def _jax_layer_cache(c, layer):
    kv = c.pattern[0]["kv"]
    return _f32(kv.c_kv[layer]), _f32(kv.k_pe[layer])


def _prompts(vocab):
    toks, lens = small_batch(vocab)
    return np.array(toks, np.int32), np.array(lens, np.int32)


def test_config_and_weights_come_across(pair):
    """``CONFIG`` / ``reduced()`` field for field as the JAX package's, and
    every MLA leaf of the converted weights bit for bit."""
    from repro.configs import minicpm3_4b as jcfg
    from repro_torch.configs import minicpm3_4b as tcfg
    for name in ("CONFIG", "reduced"):
        want = getattr(jcfg, name)
        got = getattr(tcfg, name)
        want, got = (want() if callable(want) else want,
                     got() if callable(got) else got)
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "q_lora", "kv_lora",
                  "nope_dim", "rope_dim", "v_head_dim", "emb_scale",
                  "residual_scale", "tie_embeddings", "rope_theta",
                  "norm_eps"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert [(s.mixer, s.ffn) for s in got.pattern] == [("mla", "swiglu")]
        got.validate()
    jm, jp, tm, tp = pair
    leaves = ("w_dq", "q_norm", "w_uq", "w_dkv", "w_kr", "kv_norm", "w_uk",
              "w_uv", "wo")
    for layer in range(jm.cfg.n_layers):
        ja = jp["pattern"][0]["attn"]
        assert sorted(tp["layers"][layer]["attn"]) == sorted(leaves)
        for name in leaves:
            want = np.asarray(ja[name][layer])
            got = tp["layers"][layer]["attn"][name]
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("pos", ["scalar", "rows"])
def test_mla_decode_step_matches_jax(pair, pos):
    """One absorbed-form decode step of ``mla_attention`` against JAX's on
    layer 0's weights, over a latent cache holding 20 random rows: scalar
    or per-row write index (one row of length 0, which must attend to
    nothing), and the written cache rows."""
    jm, jp, tm, tp = pair
    cfg = jm.cfg
    b, smax = 3, 32
    rs = np.random.RandomState(3)
    bf = lambda a: a.astype(jnp.bfloat16)
    x = rs.randn(b, 1, cfg.d_model).astype(np.float32)
    cc = rs.randn(b, smax, cfg.kv_lora).astype(np.float32)
    cp = rs.randn(b, smax, cfg.rope_dim).astype(np.float32)
    if pos == "scalar":
        p_np = 20
        kvl_j, kvl_t = None, None
        positions_j = p_np + jnp.arange(1)
        positions_t = torch.arange(1) + p_np
        pos_j, pos_t = p_np, p_np
    else:
        p_np = np.asarray([20, 7, 30], np.int32)
        kvl = np.asarray([21, 0, 31], np.int32)
        pos_j, pos_t = jnp.asarray(p_np), torch.from_numpy(p_np).long()
        kvl_j, kvl_t = jnp.asarray(kvl), torch.from_numpy(kvl).long()
        positions_j, positions_t = pos_j[:, None, None], pos_t[:, None, None]
    ja = jax.tree.map(lambda a: a[0], jp["pattern"][0]["attn"])
    kw = dict(n_heads=cfg.n_heads, nope_dim=cfg.nope_dim,
              rope_dim=cfg.rope_dim, v_head_dim=cfg.v_head_dim,
              rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    jcache = jattn.MLACache(bf(jnp.asarray(cc)), bf(jnp.asarray(cp)))
    want, wc = jattn.mla_attention(bf(jnp.asarray(x)), ja,
                                   jget_policy("tp_bf16"),
                                   positions=positions_j, cache=jcache,
                                   cache_pos=pos_j, kv_len=kvl_j, **kw)
    tcache = tattn.MLACache(_to_torch(np.asarray(jcache.c_kv), "cpu"),
                            _to_torch(np.asarray(jcache.k_pe), "cpu"))
    got, gc = tattn.mla_attention(
        _to_torch(np.asarray(bf(jnp.asarray(x))), "cpu"),
        tp["layers"][0]["attn"], get_policy("tp_bf16"),
        positions=positions_t, cache=tcache, cache_pos=pos_t, kv_len=kvl_t,
        **kw)
    assert got.shape == (b, 1, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=0,
                               atol=STEP_ATOL)
    if pos == "rows":
        assert not got[1].float().any()         # kv_len 0 attends nothing
    np.testing.assert_array_equal(gc.c_kv.float().numpy(), _f32(wc.c_kv))
    np.testing.assert_array_equal(gc.k_pe.float().numpy(), _f32(wc.k_pe))


def test_latent_write_past_capacity_clamps_like_jax():
    """The latent row write along axis 1: scalar and per-row starts past
    ``Smax - S`` land at the cache's end, as JAX's dynamic_update_slice."""
    buf_j = jnp.zeros((2, 4, 3), jnp.float32)
    buf_t = torch.zeros((2, 4, 3))
    new = np.ones((2, 1, 3), np.float32)
    for pos in (5, np.asarray([1, 7], np.int32), np.asarray([3, 0], np.int32)):
        want = jattn.update_cache_rows(buf_j, jnp.asarray(new) * 2, pos,
                                       axis=1)
        p = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        got = tattn.update_latent_rows(buf_t.clone(),
                                       torch.from_numpy(new) * 2, p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_prefill_matches_jax_sequential_decode(pair, jstep, backend):
    """The port's prefill (expanded form through the flash kernel's plain
    version, or the masked-softmax path) against JAX's prompt fed token by
    token through ``decode_step``: last-position logits and every layer's
    latent cache."""
    jm, jp, tm, tp = pair
    toks = _prompts(jm.cfg.vocab)[0][:, :S]
    want, jc = _sequential(jm, jp, jstep, toks)
    model = tm.with_cfg(prefill_backend=backend)
    got, caches = model.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert flash_attention_cuda.launches == 0
    for layer, c in enumerate(caches):
        assert isinstance(c, tattn.MLACache)
        assert c.c_kv.shape == (3, MAX_LEN, jm.cfg.kv_lora)
        w_ckv, w_kpe = _jax_layer_cache(jc, layer)
        g_ckv, g_kpe = c.c_kv.float().numpy(), c.k_pe.float().numpy()
        if layer == 0:
            np.testing.assert_array_equal(g_ckv[:, :S], w_ckv[:, :S])
            np.testing.assert_array_equal(g_kpe[:, :S], w_kpe[:, :S])
        np.testing.assert_allclose(g_ckv, w_ckv, rtol=0, atol=CACHE_ATOL)
        np.testing.assert_allclose(g_kpe, w_kpe, rtol=0, atol=CACHE_ATOL)


def test_jax_prefill_caches_unrotated_rope_keys(pair, jstep):
    """The reference defect, pinned: JAX's prefill caches layer 0's rope
    keys unrotated (equal to ``x W_kr`` with no rotation, and to the
    decode-written keys only at position 0), so its prefill logits part
    from its own sequential decode by far more than the port's do."""
    jm, jp, tm, tp = pair
    cfg = jm.cfg
    toks = _prompts(cfg.vocab)[0][:, :S]
    seq, jc = _sequential(jm, jp, jstep, toks)
    jlg, pc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=MAX_LEN))(
        jp, jnp.asarray(toks))
    pol = jget_policy("tp_bf16")
    h = jrmsnorm(jm.embed(jp, jnp.asarray(toks)),
                 jp["pattern"][0]["norm1"]["g"][0], cfg.norm_eps)
    raw = jtp.tp_einsum("bsd,dr->bsr", h,
                        jp["pattern"][0]["attn"]["w_kr"][0], pol)
    rotated = japply_rope(raw[:, None], jnp.arange(S), cfg.rope_theta)[:, 0]
    _, j_prefill_kpe = _jax_layer_cache(pc, 0)
    _, j_decode_kpe = _jax_layer_cache(jc, 0)
    np.testing.assert_array_equal(j_prefill_kpe[:, :S], _f32(raw))
    np.testing.assert_array_equal(j_decode_kpe[:, :S], _f32(rotated))
    np.testing.assert_array_equal(j_prefill_kpe[:, 0], j_decode_kpe[:, 0])
    assert np.abs(j_prefill_kpe[:, 1:S] - j_decode_kpe[:, 1:S]).max() > 1.0
    got, caches = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    np.testing.assert_array_equal(caches[0].k_pe.float().numpy()[:, :S],
                                  j_decode_kpe[:, :S])
    port_err = np.abs(got.numpy() - seq).max()
    jax_err = np.abs(np.asarray(jlg) - seq).max()
    assert port_err <= ATOL < jax_err and jax_err > 5 * port_err, (
        port_err, jax_err)


PENALTIES = dict(repetition_penalty=3.0, presence_penalty=0.5)


def _reference_row(jm, jp, jstep, prompt, gen, pen):
    """One row through JAX's ``decode_step`` alone: the prompt token by
    token, then ``gen`` greedy tokens under the penalties ``pen`` (counts
    of the prompt and the emitted tokens).  Returns (tokens [gen], raw
    logits [gen, V], counts [gen, V] each step was penalized with), the
    first token from the last prompt step."""
    c = jt.init_caches(jm.cfg, 1, MAX_LEN, jm.policy)
    for i, t in enumerate(prompt):
        lg, c = jstep(jp, jnp.asarray([[t]], jnp.int32), c, jnp.int32(i))
    cnt = np.bincount(prompt, minlength=jm.vocab_out)
    toks, lgs, cnts = [], [], []
    for s in range(gen):
        lgs.append(np.asarray(lg)[0, -1])
        cnts.append(cnt.copy())
        w = np.asarray(jt.apply_penalties(jnp.asarray(lgs[-1][None]),
                                          jnp.asarray(cnt[None]), **pen))[0]
        toks.append(int(w.argmax()))
        cnt[toks[-1]] += 1
        if s < gen - 1:
            lg, c = jstep(jp, jnp.asarray([[toks[-1]]], jnp.int32), c,
                          jnp.int32(len(prompt) + s))
    return np.asarray(toks), np.stack(lgs), np.stack(cnts)


@pytest.fixture(scope="module")
def reference(pair, jstep):
    """The ragged pack (rows 8 / 20 / 32 right-padded to 32) and each row
    alone through JAX's decode loop, greedy and with ``PENALTIES``."""
    jm, jp, _, _ = pair
    toks, lens = _prompts(jm.cfg.vocab)
    return toks, lens, {
        case: [_reference_row(jm, jp, jstep, toks[r, :lens[r]], GEN, pen)
               for r in range(len(lens))]
        for case, pen in (("greedy", {}), ("penalties", PENALTIES))}


def _agreeing_steps(ref_rows, gen, lgs, pen, stop):
    """Per row, the leading steps on which the port emits JAX's token, up
    to the row's first stop token; the raw logits of those steps within
    ``RTOL, ATOL``.  A row may part only at a near tie: JAX's top-2 margin
    of the penalized logits at most twice the largest difference of the
    two frameworks' penalized logits (the same counts on both sides)."""
    steps = []
    for r, (want, wl, wc) in enumerate(ref_rows):
        end = GEN
        if stop is not None and stop in want:
            end = list(want).index(stop) + 1
        k = end
        for s in range(end):
            if gen[r, s] != want[s]:
                w, g = (np.asarray(jt.apply_penalties(
                    jnp.asarray(x[None]), jnp.asarray(wc[s][None]),
                    **pen))[0] for x in (wl[s], lgs[r, s]))
                top2 = np.sort(w)[-2:]
                assert top2[1] - top2[0] <= 2 * np.abs(w - g).max(), (r, s)
                k = s
                break
            np.testing.assert_allclose(lgs[r, s], wl[s], rtol=RTOL, atol=ATOL)
        if k == end < GEN:                       # stopped: frozen from here
            assert set(gen[r, k - 1:].tolist()) == {stop}, (r, gen[r])
        steps.append(k)
    assert sum(steps) >= 0.75 * sum(
        GEN if stop is None or stop not in w else list(w).index(stop) + 1
        for w, _, _ in ref_rows), steps
    return steps


@pytest.mark.parametrize("loop", ["scan", "while"])
@pytest.mark.parametrize("case", ["greedy", "penalties_stop"])
def test_greedy_generate_matches_jax_decode_loop(pair, reference, loop,
                                                 case):
    """``Model.generate`` on the ragged pack, both loop forms, against each
    row alone through JAX's ``decode_step`` loop.  ``penalties_stop`` adds
    repetition 3.0 / presence 0.5 penalties and a stop token (the one row
    0 emits at step 3 there): a row freezes at its first stop token.  The
    other loop form emits the same tokens."""
    jm, jp, tm, tp = pair
    toks, lens, refs = reference
    kw = dict(loop=loop, prompt_lens=torch.from_numpy(lens))
    pen, stop = {}, None
    ref_rows = refs["greedy"]
    if case == "penalties_stop":
        ref_rows = refs["penalties"]
        pen, stop = PENALTIES, int(ref_rows[0][0][3])
        kw.update(stop_token=stop, **pen)
    gen, lgs, trips = tm.generate(tp, torch.from_numpy(toks), gen_len=GEN,
                                  max_len=MAX_LEN, return_logits=True,
                                  return_trips=True, **kw)
    gen, lgs = gen.numpy(), lgs.numpy()
    steps = _agreeing_steps(ref_rows, gen, lgs, pen, stop)
    if stop is None:
        assert trips == GEN - 1 and min(steps) == GEN
    other = dict(kw, loop="scan" if loop == "while" else "while")
    same = tm.generate(tp, torch.from_numpy(toks), gen_len=GEN,
                       max_len=MAX_LEN, **other)
    np.testing.assert_array_equal(same[0].numpy(), gen)


def test_escalation_path_gives_mla_layers_zero_flags(pair):
    """Under ``esc_fmts`` an MLA layer writes its latent cache as it is and
    contributes zero OF / UF flags, as in the JAX package."""
    from repro_torch.core.formats import get_format
    _, _, tm, tp = pair
    toks = torch.from_numpy(_prompts(256)[0][:, :S])
    lg, caches = tm.prefill(tp, toks, max_len=MAX_LEN)
    tok = lg[:, -1].argmax(-1)[:, None]
    esc = tuple(get_format(f) for f in ("fp8", "fp16"))
    plain_lg, _ = tm.decode_step(tp, tok, [tattn.MLACache(c.c_kv.clone(),
                                                          c.k_pe.clone())
                                           for c in caches], S)
    out = tm.decode_step(tp, tok, caches, S, esc_fmts=esc,
                         kv_levels=torch.zeros(3, dtype=torch.int64),
                         kv_scale=65536.0)
    assert out[2].shape == (3, 2) and not out[2].any()
    assert torch.equal(out[0], plain_lg)


def test_paged_mla_is_refused_with_jax_reason(pair):
    _, _, tm, tp = pair
    paged = tm.with_cfg(paged_kv=True, page_size=16)
    with pytest.raises(ValueError, match="paged_kv is unsupported for "
                                         "minicpm3-smoke: mla"):
        paged.prefill(tp, torch.zeros((1, 8), dtype=torch.int64), max_len=16)


@pytest.mark.parametrize("argv", [
    [],
    ["--ragged", "--stop-token", "13", "--repetition-penalty", "3.0",
     "--presence-penalty", "0.5"],
    ["--loop", "while", "--ragged", "--stop-token", "13"],
    ["--loop", "python"]])
def test_launcher_serves_minicpm3_on_cpu(capsys, argv):
    gen = serve.main(["--device", "cpu", "--arch", "minicpm3-4b", "--batch",
                      "3", "--prompt-len", "16", "--gen", "6"] + argv)
    out = capsys.readouterr().out
    assert "minicpm3-4b" in out and "tok/s" in out
    if gen is not None:
        assert tuple(gen.shape) == (3, 6)


@pytest.mark.parametrize("flag", [["--paged"], ["--continuous"]])
def test_launcher_refuses_paged_minicpm3(capsys, flag):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "minicpm3-4b"] + flag)
    assert "paged_kv is unsupported for minicpm3-smoke: mla" in (
        capsys.readouterr().err)
