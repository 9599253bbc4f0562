"""The port's sampling ops (``models/transformer.py``: ``sample_token``,
``apply_penalties``, ``token_counts``, ``_bump_counts``,
``sanitize_logits``) against the JAX package's.

Tolerance: none where the ops are deterministic.  Histograms, the guard
(values and ``bad``), the penalties and greedy sampling must equal JAX's
bit for bit.  Penalty inputs stay normal floats: XLA on the CPU flushes
subnormals, torch keeps them (ROADMAP Queue 3).  A draw
(``temperature > 0``) uses a ``torch.Generator``, and JAX's threefry
stream cannot be matched, so draws are held by property: top-k and top-p
membership under JAX's rules (ties with the threshold kept; top-p against
an oracle that computes the same f32 exclusive mass), ``top_k=1`` and a
tiny temperature are greedy, a seed repeats its draws, and a seeded
chi-square test at V = 16 holds the draw frequencies to
``softmax(lg / T)``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import transformer as jt  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _bump_counts, apply_penalties, sample_token, sanitize_logits,
    token_counts)

torch.set_num_threads(1)

V = 64


def _logits(seed, b=8, v=V, scale=4.0):
    return (scale * np.random.RandomState(seed).randn(b, v)).astype(
        np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# bitwise against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ragged", [False, True])
def test_token_counts_and_bump_match_jax(ragged):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, V, size=(4, 24)).astype(np.int32)
    lens = np.asarray([10, 24, 17, 3], np.int32) if ragged else None
    want = jt.token_counts(jnp.asarray(toks), V,
                           None if lens is None else jnp.asarray(lens))
    got = token_counts(torch.from_numpy(toks), V,
                       None if lens is None else torch.from_numpy(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    emitted = rng.randint(0, V, size=(4, 5)).astype(np.int32)
    for i in range(5):
        want = jt._bump_counts(want, jnp.asarray(emitted[:, i:i + 1]))
        got = _bump_counts(got, torch.from_numpy(emitted[:, i:i + 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sanitize_logits_matches_jax():
    lg = _logits(1, b=6)
    lg[1, 3] = np.nan
    lg[2, 5], lg[2, 9] = np.inf, -np.inf
    lg[3, :] = np.nan                       # all-NaN row -> token 0
    lg[4, 0] = -np.inf
    want, wbad = jt.sanitize_logits(jnp.asarray(lg))
    got, bad = sanitize_logits(torch.from_numpy(lg))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(wbad))
    assert bad.tolist() == [False, True, True, True, True, False]
    assert int(sample_token(got)[3]) == 0
    np.testing.assert_array_equal(
        sample_token(got).numpy(),
        np.asarray(jt.sample_token(want, jax.random.key(0))))


@pytest.mark.parametrize("rp,pp", [(3.0, 0.5), (1.1, None), (None, 0.7),
                                   (1.3, 0.7), (1.0, 0.0)])
def test_apply_penalties_match_jax_bitwise(rp, pp):
    """Normal floats only (no subnormal inputs, see the module note)."""
    rng = np.random.RandomState(2)
    lg = _logits(2)
    lg[np.abs(lg) < 1e-3] = 0.5             # keep every value normal
    toks = rng.randint(0, V, size=(8, 16)).astype(np.int32)
    cnt = np.array(jt.token_counts(jnp.asarray(toks), V))
    want = jt.apply_penalties(jnp.asarray(lg), jnp.asarray(cnt),
                              repetition_penalty=rp, presence_penalty=pp)
    got = apply_penalties(torch.from_numpy(lg), torch.from_numpy(cnt),
                          repetition_penalty=rp, presence_penalty=pp)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    seen = cnt > 0
    np.testing.assert_array_equal(got.numpy()[~seen], lg[~seen])


def test_greedy_matches_jax_and_touches_no_generator():
    lg = _logits(3)
    lg[0, 7] = lg[0, 11] = lg[0].max() + 1.0    # a tie: the first wins
    want = np.asarray(jt.sample_token(jnp.asarray(lg), jax.random.key(0)))
    g = _gen(5)
    state = g.get_state()
    for t in (0.0, -1.0, None):
        got = sample_token(torch.from_numpy(lg), g, temperature=t,
                           top_k=3, top_p=0.5)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[0]) == 7
    assert torch.equal(g.get_state(), state)


# ---------------------------------------------------------------------------
# draws, by property
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 13])
def test_top_k_membership_keeps_ties(k):
    for seed in range(4):
        lg = _logits(seed)
        lg[:, 5] = np.sort(lg, axis=1)[:, -k]    # a tie with the k-th
        kth = np.sort(lg, axis=1)[:, -k]
        g = _gen(seed)
        for _ in range(8):
            tok = sample_token(torch.from_numpy(lg), g, temperature=1.5,
                               top_k=k).numpy()
            assert np.all(lg[np.arange(8), tok] >= kth), (k, seed)


def test_top_k_one_is_greedy_at_any_temperature():
    lg = _logits(1)
    want = lg.argmax(-1)
    for t in (0.5, 1.0, 5.0):
        got = sample_token(torch.from_numpy(lg), _gen(2), temperature=t,
                           top_k=1)
        np.testing.assert_array_equal(got.numpy(), want)


def _nucleus_f32(lg, top_p, temperature):
    """JAX's top-p rule computed independently in numpy f32: sort
    descending, f32 softmax, exclusive cumulative mass, keep ``mass <
    top_p`` (the first always), and every token at or above the smallest
    kept logit.  Also returns the smallest distance of an exclusive mass
    from ``top_p`` (rows closer than an f32 ulp's worth are skipped)."""
    lg = np.asarray(lg, np.float32) / np.float32(temperature)
    allowed, margin = [], []
    for row in lg:
        srt = np.sort(row)[::-1]
        e = np.exp(srt - srt[0], dtype=np.float32)
        p = e / e.sum(dtype=np.float32)
        excl = np.cumsum(p, dtype=np.float32) - p
        kth = srt[excl < top_p].min()
        allowed.append(set(np.nonzero(row >= kth)[0].tolist()))
        margin.append(np.abs(excl - top_p).min())
    return allowed, margin


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_membership_under_jax_rule(p):
    checked = 0
    for seed in range(6):
        lg = _logits(seed)
        lg[:, 9] = lg[:, 3]                       # ties everywhere
        allowed, margin = _nucleus_f32(lg, p, 0.8)
        g = _gen(seed)
        for _ in range(8):
            tok = sample_token(torch.from_numpy(lg), g, temperature=0.8,
                               top_p=p).numpy()
            for r in range(8):
                if margin[r] < 1e-6:
                    continue
                assert int(tok[r]) in allowed[r], (p, seed, r)
                checked += 1
    assert checked >= 300


def test_top_p_keeps_tokens_tied_with_the_threshold():
    """Four equal logits and p = 0.3: the exclusive mass of the second
    sorted one is 0.25 < 0.3, so the threshold is that logit and all four
    tied tokens stay drawable (a prefix rule would keep two)."""
    lg = np.full((1, 8), -5.0, np.float32)
    lg[0, [1, 3, 5, 7]] = 2.0
    lg = np.repeat(lg, 400, axis=0)
    tok = sample_token(torch.from_numpy(lg), _gen(0), temperature=1.0,
                       top_p=0.3).numpy()
    assert set(tok.tolist()) == {1, 3, 5, 7}


def test_tiny_temperature_converges_to_greedy():
    lg = _logits(3, scale=8.0)
    for seed in range(6):
        got = sample_token(torch.from_numpy(lg), _gen(seed),
                           temperature=1e-2)
        np.testing.assert_array_equal(got.numpy(), lg.argmax(-1))


def test_same_seed_same_draws():
    lg = torch.from_numpy(_logits(4))
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    a = [sample_token(lg, g, **kw) for g in [_gen(7)] for _ in range(3)]
    b = [sample_token(lg, g, **kw) for g in [_gen(7)] for _ in range(3)]
    c = [sample_token(lg, g, **kw) for g in [_gen(8)] for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    with pytest.raises(ValueError, match="generator"):
        sample_token(lg, temperature=0.9)


def test_pad_floor_is_never_drawn():
    lg = _logits(5)
    lg[:, 40:] = -1e30                       # a masked vocab tail
    tok = sample_token(torch.from_numpy(lg), _gen(1), temperature=3.0)
    assert int(tok.max()) < 40


@pytest.mark.parametrize("temperature", [1.0, 0.6])
def test_draw_frequencies_follow_softmax(temperature):
    """Chi-square goodness of fit of 40000 seeded draws at V = 16 against
    ``softmax(lg / T)`` (df 15; 37.70 is the 0.999 quantile)."""
    n, v = 40000, 16
    row = np.linspace(-2.0, 2.0, v).astype(np.float32)
    lg = torch.from_numpy(np.repeat(row[None], n, axis=0))
    tok = sample_token(lg, _gen(11), temperature=temperature).numpy()
    obs = np.bincount(tok, minlength=v)
    z = row.astype(np.float64) / temperature
    prob = np.exp(z - z.max())
    prob /= prob.sum()
    exp = n * prob
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < 37.70, (chi2, obs.tolist())
