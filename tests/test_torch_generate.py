"""The port's ``Model.generate`` (both loop forms), ``decode_round`` /
``decode_burst`` hooks and the fixed-batch launcher against the JAX
package, on reduced gemma2 with the weights of
``tests/conftest.py::cached_model`` (converted by
``models.convert.from_jax_params``).

Tolerance: greedy tokens, the executed trip count and the guard counts
must equal JAX's exactly; logits within the model-level ``RTOL, ATOL =
5e-2, 1e-1`` of ``tests/test_torch_model.py`` (bf16 activations round at
other places in the two frameworks).  Sampled runs (a ``torch.Generator``
cannot replay JAX's threefry stream) are held inside the port: the scan
and while forms emit the same tokens from the same seed, and a seed
repeats its tokens.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model, small_batch  # noqa: E402

from repro.models import transformer as jt  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.paged import (PageAllocator, build_tables,  # noqa: E402
                                      num_pages)
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 5e-2, 1e-1
GEN = 12
MAX_LEN = 48


def _pair(paged):
    cfg = dict(paged_kv=True, page_size=16) if paged else {}
    jm, jp = cached_model("gemma2-9b", **cfg)
    tm = build_model("gemma2-9b", reduced=True, device="cpu", **cfg)
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def dense():
    return _pair(False)


@pytest.fixture(scope="module")
def paged():
    return _pair(True)


def _jax_generate(jm, jp, toks, **kw):
    f = jax.jit(lambda p, t: jm.generate(p, t, gen_len=GEN, max_len=MAX_LEN,
                                         return_logits=True,
                                         return_trips=True,
                                         guard_nonfinite=True, **kw))
    return [np.asarray(x) for x in f(jp, jnp.asarray(toks))]


def _torch_generate(tm, tp, toks, **kw):
    kw = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
              else v) for k, v in kw.items()}
    gen, lgs, trips, bad = tm.generate(
        tp, torch.from_numpy(np.array(toks)), gen_len=GEN, max_len=MAX_LEN,
        return_logits=True, return_trips=True, guard_nonfinite=True, **kw)
    return gen.numpy(), lgs.numpy(), trips, bad.numpy()


def _agreeing_steps(want, got, toks, lens, pen):
    """Per row, the leading steps on which the two frameworks emit the same
    token.  A row's streams may part only at a near tie: a step where
    JAX's top-2 margin of the penalized logits is at most twice the
    largest difference between the two frameworks' penalized logits (both
    penalized from the same history), which bf16 rounding can flip."""
    (wg, wl), (gg, gl) = want[:2], got[:2]
    b, n, v = wl.shape
    width = toks.shape[1]
    steps = []
    for r in range(b):
        live = width if lens is None else int(lens[r])
        cnt = np.bincount(toks[r, :live], minlength=v)
        k = n
        for s in range(n):
            if gg[r, s] != wg[r, s]:
                w, g = (np.asarray(jt.apply_penalties(
                    jnp.asarray(x[r, s][None]), jnp.asarray(cnt[None]),
                    **pen))[0] for x in (wl, gl))
                top2 = np.sort(w)[-2:]
                assert top2[1] - top2[0] <= 2 * np.abs(w - g).max(), (r, s)
                k = s
                break
            cnt[wg[r, s]] += 1
        steps.append(k)
    return steps


def _check(want, got, loop, toks, lens=None, pen=None):
    """Tokens equal up to each row's first near tie (all of them when no
    row meets one), logits within tolerance up to that step, guard counts
    equal, and trip counts equal when no row parted."""
    (wg, wl, wt, wb), (gg, gl, gt, gb) = want, got
    np.testing.assert_array_equal(gb, wb)
    steps = _agreeing_steps(want, got, toks, lens, pen or {})
    for r, k in enumerate(steps):
        last = min(k, gt) + 1
        np.testing.assert_allclose(gl[r, :last], wl[r, :last], rtol=RTOL,
                                   atol=ATOL)
    assert sum(steps) >= 0.75 * gg.size, steps
    if min(steps) == GEN:
        assert gt == int(wt), (loop, gt, int(wt))
    assert not gl[:, gt + 1:].any()
    return steps


def _prompts(vocab):
    toks, lens = small_batch(vocab)
    return np.array(toks, np.int32), np.array(lens, np.int32)


@pytest.mark.parametrize("loop", ["scan", "while"])
@pytest.mark.parametrize("case", ["uniform", "ragged_stop_penalties"])
def test_greedy_generate_matches_jax(dense, case, loop):
    jm, jp, tm, tp = dense
    toks, lens = _prompts(jm.cfg.vocab)
    kw, pen = dict(loop=loop), {}
    if case != "uniform":
        pen = dict(repetition_penalty=3.0, presence_penalty=0.5)
        base = _jax_generate(jm, jp, toks, prompt_lens=lens, **pen)
        kw.update(prompt_lens=lens, stop_token=int(base[0][0, 3]), **pen)
    _check(_jax_generate(jm, jp, toks, **kw),
           _torch_generate(tm, tp, toks, **kw), loop, toks,
           kw.get("prompt_lens"), pen)


@pytest.mark.parametrize("loop", ["scan", "while"])
def test_greedy_generate_paged_shared_prefix_matches_jax(paged, loop):
    """Paged pools through a table whose first page is shared by every
    row (the rows share their first 16 prompt tokens), with penalties."""
    jm, jp, tm, tp = paged
    toks, _ = _prompts(jm.cfg.vocab)
    toks[1:, :16] = toks[0, :16]
    mp = num_pages(MAX_LEN, 16)
    table = build_tables(PageAllocator(3 * mp), 3, mp, shared_pages=1)
    pen = dict(repetition_penalty=3.0, presence_penalty=0.5)
    kw = dict(loop=loop, page_table=table, n_pages=3 * mp, **pen)
    want = _jax_generate(jm, jp, toks, **kw)
    _check(want, _torch_generate(tm, tp, toks, **kw), loop, toks, None, pen)


def test_while_form_exits_early_on_stop(paged):
    """One row: the stop token is the one it emits at step 3, so the while
    form runs 3 decode steps, its tail frozen to the stop token, and
    returns the scan form's tokens and JAX's trip count."""
    jm, jp, tm, tp = paged
    toks, _ = _prompts(jm.cfg.vocab)
    one = toks[:1]
    stop = int(_jax_generate(jm, jp, one)[0][0, 3])
    runs = {}
    for loop in ("scan", "while"):
        want = _jax_generate(jm, jp, one, stop_token=stop, loop=loop)
        runs[loop] = _torch_generate(tm, tp, one, stop_token=stop, loop=loop)
        assert _check(want, runs[loop], loop, one) == [GEN]
    first = list(runs["scan"][0][0]).index(stop)
    assert runs["while"][2] == first < GEN - 1
    assert runs["scan"][2] == GEN - 1
    np.testing.assert_array_equal(runs["while"][0], runs["scan"][0])
    assert set(runs["while"][0][0, first:].tolist()) == {stop}


def test_guard_counts_a_poisoned_row_like_jax(dense):
    """A NaN embedding row for one token that only row 1's prompt holds.
    The embedding is tied, so that token's logit is NaN in every row at
    every site (each row's guard count is ``GEN``), and row 1's are all
    NaN, so it emits token 0 throughout."""
    jm, jp, tm, tp = dense
    toks, lens = _prompts(jm.cfg.vocab)
    bad_tok = jm.cfg.vocab - 1
    toks[toks == bad_tok] = 0
    toks[1, 4] = bad_tok
    emb = np.array(jp["embed"])
    emb[bad_tok] = np.nan
    jp2 = dict(jp, embed=jnp.asarray(emb))
    tp2 = dict(tp, embed=tp["embed"].clone())
    tp2["embed"][bad_tok] = torch.nan
    for loop in ("scan", "while"):
        want = _jax_generate(jm, jp2, toks, prompt_lens=lens, loop=loop)
        got = _torch_generate(tm, tp2, toks, prompt_lens=lens, loop=loop)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[3], want[3])
        assert got[3].tolist() == [GEN, GEN, GEN]
        assert set(got[0][1].tolist()) == {0}


@pytest.mark.parametrize("stop", [None, 7])
def test_sampled_scan_and_while_identical(paged, stop):
    _, _, tm, tp = paged
    toks, lens = _prompts(256)
    kw = dict(temperature=0.8, top_k=32, top_p=0.9, prompt_lens=lens,
              repetition_penalty=1.3, presence_penalty=0.5, stop_token=stop)
    out = {loop: _torch_generate(tm, tp, toks, loop=loop,
                                 generator=torch.Generator().manual_seed(3),
                                 **kw)
           for loop in ("scan", "while")}
    np.testing.assert_array_equal(out["while"][0], out["scan"][0])
    again = _torch_generate(tm, tp, toks, loop="scan",
                            generator=torch.Generator().manual_seed(3), **kw)
    np.testing.assert_array_equal(again[0], out["scan"][0])
    other = _torch_generate(tm, tp, toks, loop="scan",
                            generator=torch.Generator().manual_seed(4), **kw)
    assert not np.array_equal(other[0], out["scan"][0])


def test_decode_burst_poison_and_guard_match_jax(paged):
    """One burst over three live rows with penalties: the poisoned
    relative round is counted once per live row, and tokens, counts and
    state equal JAX's ``decode_burst``."""
    jm, jp, tm, tp = paged
    toks, lens = _prompts(jm.cfg.vocab)
    j_lg, jc = jax.jit(lambda p, t, l: jm.prefill(
        p, t, max_len=MAX_LEN, prompt_lens=l))(jp, toks, lens)
    t_lg, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN,
                          prompt_lens=torch.from_numpy(lens))
    tok0 = np.asarray(j_lg[:, -1]).argmax(-1).astype(np.int32)[:, None]
    np.testing.assert_array_equal(
        t_lg[:, -1].argmax(-1).numpy(), tok0[:, 0])
    cnt = np.array(jax.jit(lambda t, l: __import__(
        "repro.models.transformer", fromlist=["x"]).token_counts(
        t, jm.vocab_out, l))(toks, lens))
    limit = lens + np.asarray([3, 9, 5], np.int32)
    args = dict(max_len=MAX_LEN, out_width=16, n_max=8, exit_on_finish=0,
                repetition_penalty=3.0, presence_penalty=0.5, guard=True,
                poison_at=2)
    done = np.zeros(3, bool)
    jr = jm.decode_burst(jp, jnp.asarray(tok0), jc, jnp.asarray(lens),
                         jnp.asarray(lens), jnp.asarray(done),
                         jnp.asarray(limit), counts=jnp.asarray(cnt), **args)
    T = lambda a: torch.from_numpy(np.array(a))
    tr = tm.decode_burst(tp, T(tok0), tc, T(lens).long(), T(lens).long(),
                         T(done), T(limit).long(), counts=T(cnt), **args)
    n = int(jr[1])
    assert tr[1] == n == 8
    np.testing.assert_array_equal(tr[0][:, :n].numpy(),
                                  np.asarray(jr[0])[:, :n])
    for i in (2, 4, 5, 6):             # tok, pos, lens, done
        np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr[i]))
    np.testing.assert_array_equal(tr[8].numpy(), np.asarray(jr[8]))
    assert tr[8].tolist() == [1, 1, 1]
    np.testing.assert_array_equal(tr[9].numpy(), np.asarray(jr[9]))


@pytest.mark.parametrize("argv", [
    ["--paged", "--page-size", "8"],
    ["--ragged", "--stop-token", "13", "--repetition-penalty", "3.0",
     "--presence-penalty", "0.5"],
    ["--temperature", "0.7", "--top-k", "20", "--top-p", "0.9"],
    ["--loop", "python", "--temperature", "0.7", "--top-k", "20"]])
def test_fixed_batch_launcher_on_cpu(capsys, argv):
    gen = serve.main(["--device", "cpu", "--batch", "3", "--prompt-len",
                      "16", "--gen", "6"] + argv)
    out = capsys.readouterr().out
    assert "tok/s" in out
    if "--paged" in argv:
        assert "token mismatches = 0" in out and "7/9 pages live" in out
    if gen is not None:
        assert tuple(gen.shape) == (3, 6)
