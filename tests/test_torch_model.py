"""The port's model on reduced gemma2 against the JAX package's, from the
same weights (``tests/conftest.py::cached_model``, converted with
``models.convert.from_jax_params``).

Prefill logits are compared at the repo's bf16 model-level tolerance
(``rtol 5e-2, atol 1e-1``, as ``tests/test_engine.py`` uses between the
dense and Pallas paths): bf16 activations round at other places in the two
frameworks.  Greedy tokens must agree.  Inside the port, chunked prefill
reproduces full prefill bitwise, as in the JAX package.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from conftest import LENS, cached_model, small_batch  # noqa: E402

from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 5e-2, 1e-1


@pytest.fixture(scope="module")
def weights():
    jm, jp = cached_model("gemma2-9b")
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab):
    toks, lens = small_batch(vocab)
    return (np.asarray(toks), np.asarray(lens),
            torch.from_numpy(np.array(toks)), torch.from_numpy(np.array(lens)))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_prefill_logits_match_jax(weights, paged, backend):
    jp, tp = weights
    cfg = dict(paged_kv=True, page_size=16) if paged else {}
    jm, _ = cached_model("gemma2-9b", **cfg)
    jt, jl, tt, tl = _batch(jm.cfg.vocab)
    want, _ = jax.jit(lambda p, t, l: jm.prefill(p, t, max_len=48,
                                                 prompt_lens=l))(jp, jt, jl)
    tm = build_model("gemma2-9b", reduced=True, device="cpu",
                     prefill_backend=backend, decode_backend=backend, **cfg)
    got, caches = tm.prefill(tp, tt, max_len=48, prompt_lens=tl)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert len(caches) == tm.cfg.n_layers
    assert sorted(LENS) == sorted(int(x) for x in tl)


def _chunked(model, params, toks, lens, chunk):
    caches = model.init_caches(toks.shape[0], 48)
    lg = None
    for off in range(0, toks.shape[1], chunk):
        cl = torch.clamp(lens - off, 0, chunk)
        lc, caches = model.prefill_chunk(params, toks[:, off:off + chunk],
                                         caches, q_offset=off, chunk_lens=cl)
        lg = lc if lg is None else torch.where((cl > 0)[:, None, None], lc,
                                               lg)
    return lg, caches


@pytest.mark.parametrize("chunk", [8, 16])
def test_prefill_chunk_matches_full_prefill_bitwise(weights, chunk):
    """Chunk boundaries are invisible: the same last-live logits bitwise,
    and greedy decode from the chunked caches emits what full prefill's
    caches give."""
    _, tp = weights
    tm = build_model("gemma2-9b", reduced=True, device="cpu", paged_kv=True,
                     page_size=16)
    _, _, tt, tl = _batch(256)
    full, caches_f = tm.prefill(tp, tt, max_len=48, prompt_lens=tl)
    got, caches_c = _chunked(tm, tp, tt, tl, chunk)
    assert torch.equal(full, got)

    def roll(caches, lg):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        outs, pos = [tok], tl.clone()
        for _ in range(4):
            lg, caches = tm.decode_step(tp, outs[-1], caches, pos)
            outs.append(lg[:, -1].argmax(-1).to(torch.int32)[:, None])
            pos = pos + 1
        return torch.cat(outs, 1)

    assert torch.equal(roll(caches_f, full), roll(caches_c, got))


def test_decode_steps_match_jax(weights):
    """Paged prefill then three greedy decode steps: logits within the
    model tolerance and the same tokens as the JAX model."""
    jp, tp = weights
    jm, _ = cached_model("gemma2-9b", paged_kv=True, page_size=16)
    jt, jl, tt, tl = _batch(jm.cfg.vocab)
    tm = build_model("gemma2-9b", reduced=True, device="cpu", paged_kv=True,
                     page_size=16)
    jlg, jc = jax.jit(lambda p, t, l: jm.prefill(p, t, max_len=48,
                                                 prompt_lens=l))(jp, jt, jl)
    tlg, tc = tm.prefill(tp, tt, max_len=48, prompt_lens=tl)
    step = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))
    jpos, tpos = jl, tl.clone()
    for _ in range(3):
        jtok = np.asarray(jlg[:, -1]).argmax(-1).astype(np.int32)[:, None]
        ttok = tlg[:, -1].argmax(-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jlg, jc = step(jp, jtok, jc, jpos)
        tlg, tc = tm.decode_step(tp, ttok, tc, tpos)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=RTOL,
                                   atol=ATOL)
        jpos, tpos = jpos + 1, tpos + 1


def test_init_matches_jax_param_layout(weights):
    """``Model.init`` (torch.Generator) builds the converted JAX pytree's
    structure: same keys, shapes and dtypes per layer."""
    _, tp = weights
    tm = build_model("gemma2-9b", reduced=True, device="cpu")
    mine = tm.init(0)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items()
                    for k2, v in flat(sub, f"{prefix}{k}.").items()}
        if isinstance(tree, list):
            return {k2: v for i, sub in enumerate(tree)
                    for k2, v in flat(sub, f"{prefix}{i}.").items()}
        return {prefix: (tuple(tree.shape), tree.dtype)}

    assert flat(mine) == flat(tp)
    assert len(mine["layers"]) == tm.cfg.n_layers
    again = tm.init(torch.Generator().manual_seed(0))
    assert torch.equal(mine["embed"], again["embed"])


def test_unported_paths_raise():
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):      # ported: they build
        assert build_model(arch, reduced=True, device="cpu").cfg.n_layers == 4
    tm = build_model("gemma2-9b", reduced=True, device="cpu")
    params = tm.init(0)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    # meshes are ported (tests/test_torch_tp.py): a foreign object is not
    # one
    with pytest.raises(TypeError, match="Mesh"):
        tm.generate(params, toks, gen_len=2, mesh=object())
    with pytest.raises(ValueError, match="loop"):
        tm.generate(params, toks, gen_len=2, loop="python")
    # sampling is ported: a draw from a seeded generator
    from repro_torch.models.transformer import sample_token
    tok = sample_token(torch.zeros(1, 8), torch.Generator().manual_seed(0),
                       temperature=0.7)
    assert tok.dtype == torch.int32 and 0 <= int(tok) < 8
