"""granite-20b in the port against the JAX package: MQA (48 query heads on
one KV head, so group 48) with a non-gated gelu MLP with biases.

* ``layers.gelu_mlp`` against JAX's ``gelu_mlp`` with nonzero biases:
  under ``fp32`` within 1e-5 (f32 sums in another order); under
  ``tp_bf16`` within one bf16 ulp of the output's scale (2^-8 relative,
  bf16 products summed in f32 in another order can flip one rounding).
* the configs field for field, and ``from_jax_params`` on reduced granite:
  every leaf bit for bit, the biases included, in the layout
  ``Model.init`` builds.
* ``decode_attention_plain`` against ``decode_attention_pallas`` in
  interpret mode at G in {1, 8, 12, 48, 64}, contiguous strips and paged
  pools, bf16 and fp8 storage: outputs within ``ATOL`` / ``RTOL`` = 1e-5
  (f32 summation order only, as ``tests/test_torch_decode_attention.py``)
  but in at most 1% of the (row, head) pairs, which may move by up to
  ``P_FLIP`` = 2^-8: with 64 heads a score's last-bit difference can flip
  one bf16 rounding of p (seen once at G 64); the telemetry
  (``debug_visits``, ``debug_flags``) exactly.
* the paged engine on reduced granite at ``n_heads=48`` (G 48), the
  weights JAX's with random nonzero biases: under ``fp32`` the token
  streams, admit and finish rounds equal JAX's engine's; under
  ``tp_bf16`` the tokens equal up to a row's first near tie (JAX's
  logits of the two candidates within twice the frameworks' largest
  logit difference there).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.configs import granite_20b as jcfg  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.launch.engine import ContinuousEngine as JaxEngine  # noqa: E402
from repro.launch.engine import Request as JaxRequest  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import granite_20b as tcfg  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    STRIP_UNIT, decode_attention_plain)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import ContinuousEngine, Request  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import _to_torch, from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402

torch.set_num_threads(1)

ATOL = RTOL = 1e-5
#: one bf16 rounding of p flipped by a last-bit difference of its score
#: (a unit-scale output moves by at most 2^-8, the card tests' TOL)
P_FLIP = 2.0 ** -8
#: the reduced config widened to granite's group: 48 query heads on 1
G48 = dict(n_heads=48)


# ---------------------------------------------------------------------------
# config, MLP, weights
# ---------------------------------------------------------------------------
def test_configs_match_jax():
    skip = {"decode_backend", "prefill_backend"}   # "auto" in the port
    for mine, theirs in ((tcfg.CONFIG, jcfg.CONFIG),
                         (tcfg.reduced(), jcfg.reduced())):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert {k: v for k, v in a.items() if k not in skip} == \
            {k: v for k, v in b.items() if k not in skip}
    full = get_config("granite-20b")
    assert full.n_heads // full.n_kv_heads == 48 and full.head_dim == 128
    assert {s.ffn for s in full.layer_list()} == {"gelu"}


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
def test_gelu_mlp_matches_jax(policy):
    rs = np.random.RandomState(0)
    d, f = 64, 256
    dt = ml_dtypes.bfloat16 if policy == "tp_bf16" else np.float32
    x, w_up, w_down = (rs.randn(*s).astype(np.float32) * sc
                       for s, sc in (((2, 5, d), 1.0), ((d, f), d ** -0.5),
                                     ((f, d), f ** -0.5)))
    b_up, b_down = rs.randn(f) * 0.5, rs.randn(d) * 0.5
    args = [np.asarray(a, np.float32).astype(dt)
            for a in (x, w_up, b_up, w_down, b_down)]
    want = np.asarray(jlayers.gelu_mlp(*map(jnp.asarray, args),
                                       jget_policy(policy)), np.float32)
    got = tlayers.gelu_mlp(*(_to_torch(a, "cpu") for a in args),
                           get_policy(policy))
    assert got.dtype == (torch.bfloat16 if policy == "tp_bf16"
                         else torch.float32)
    got = got.float().numpy()
    if policy == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2.0 ** -8 * scale
    # the biases take part: the MLP without them differs
    zero = [a if i not in (2, 4) else np.zeros_like(a)
            for i, a in enumerate(args)]
    bare = tlayers.gelu_mlp(*(_to_torch(a, "cpu") for a in zero),
                            get_policy(policy)).float().numpy()
    assert np.abs(bare - got).max() > 0.1


def _with_biases(jp, seed=1):
    """JAX params (numpy leaves) with random nonzero gelu-MLP biases."""
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, jp)
    for p in tree["pattern"]:
        for k in ("b_up", "b_down"):
            b = p["mlp"][k]
            p["mlp"][k] = (rs.randn(*b.shape) * 0.5).astype(b.dtype)
    return tree


def test_weight_conversion_of_reduced_granite():
    jm, jp = cached_model("granite-20b")
    tree = _with_biases(jp)
    tp = from_jax_params(tree, device="cpu")
    layer = tp["layers"][1]
    assert sorted(layer["mlp"]) == ["b_down", "b_up", "down", "up"]
    assert len(tp["layers"]) == jm.cfg.n_layers and "lm_head" not in tp
    for r, lp in enumerate(tp["layers"]):
        for k, v in lp["mlp"].items():
            want = tree["pattern"][0]["mlp"][k][r]
            assert v.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                v.view(torch.int16).numpy(), want.view(np.int16))
        assert lp["attn"]["wk"].shape == (64, 16)        # one KV head
    # Model.init builds the converted pytree's layout
    tm = build_model("granite-20b", reduced=True, device="cpu")

    def flat(t, prefix=""):
        if isinstance(t, dict):
            return {k2: v for k, s in t.items()
                    for k2, v in flat(s, f"{prefix}{k}.").items()}
        if isinstance(t, list):
            return {k2: v for i, s in enumerate(t)
                    for k2, v in flat(s, f"{prefix}{i}.").items()}
        return {prefix: (tuple(t.shape), t.dtype)}
    mine = tm.init(0)
    assert flat(mine) == flat(tp)
    assert not mine["layers"][0]["mlp"]["b_up"].any()   # zero, as JAX's


# ---------------------------------------------------------------------------
# the decode read at any group
# ---------------------------------------------------------------------------
STORAGE = {"bf16": ml_dtypes.bfloat16, "fp8": ml_dtypes.float8_e5m2}


def _scatter(strips, ids, page):
    """Strips [rows, nk * page, D] into a pool [max(ids) + 2, page, D]
    through the flat page ids (an aliased id keeps the last writer)."""
    rows, smax, d = strips.shape
    pool = np.zeros((int(ids.max()) + 2, page, d), strips.dtype)
    pool[ids] = strips.reshape(rows * (smax // page), page, d)
    return pool


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("paged", [False, True], ids=["strip", "paged"])
@pytest.mark.parametrize("g", [1, 8, 12, 48, 64])
def test_decode_plain_matches_pallas_at_any_group(g, paged, storage):
    rows, d, smax, page = 3, 32, 128, 16
    rs = np.random.RandomState(g)
    kv_len = np.asarray([smax, 0, 37], np.int32)
    q = rs.randn(rows, g, d).astype(ml_dtypes.bfloat16)
    k, v = (rs.randn(rows, smax, d).astype(STORAGE[storage])
            for _ in range(2))
    table = None
    if paged:                       # the strips scattered into a pool
        nk = smax // page
        table = rs.permutation(rows * nk + 2)[:rows * nk].reshape(
            rows, nk).astype(np.int32)
        table[1, 0] = table[0, 0]                   # an aliased page
        k, v = (_scatter(x, table.reshape(-1), page) for x in (k, v))
    kw = dict(scale=d ** -0.5, window=None, softcap=None, kv_fmt_name=None,
              q_fmt_name=None)
    jout = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_len)[:, None],
        None if table is None else jnp.asarray(table),
        bk=page if paged else STRIP_UNIT, src_dtype=jnp.bfloat16,
        interpret=True, debug_visits=True, debug_flags=True, **kw)
    tt = lambda x: _to_torch(x, "cpu")
    out, visits, flags = decode_attention_plain(
        tt(q), tt(k), tt(v), torch.from_numpy(kv_len),
        None if table is None else torch.from_numpy(table),
        src_dtype=torch.bfloat16, debug_visits=True, debug_flags=True, **kw)
    assert out.shape == (rows, g, d)
    want = np.asarray(jout[0])
    diff = np.abs(out.numpy() - want)
    # f32 summation order alone stays within ATOL / RTOL; where it flips
    # one bf16 rounding of p, that (row, head) moves by at most 2^-8
    off = (diff > ATOL + RTOL * np.abs(want)).any(-1)
    assert diff.max() <= P_FLIP and off.sum() <= max(1, off.size // 100), \
        (diff.max(), np.argwhere(off).tolist())
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jout[2]))
    assert not out[1].any()                          # the idle row stores 0


# ---------------------------------------------------------------------------
# the paged engine at group 48
# ---------------------------------------------------------------------------
def _pair(policy):
    jm, jp = cached_model("granite-20b", policy=policy, paged_kv=True,
                          page_size=16, **G48)
    tree = _with_biases(jp)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model("granite-20b", policy=policy, reduced=True,
                     device="cpu", paged_kv=True, page_size=16, **G48)
    return jm, jp, tm, from_jax_params(tree, device="cpu")


def _requests(cls, vocab, seed=0):
    rng = np.random.RandomState(seed)
    lens, budgets = (8, 20, 32, 13, 27, 5), (4, 9, 3, 7, 5, 8)
    arrivals = (0, 0, 0, 0, 2, 5)
    return [cls(rid=i, tokens=rng.randint(0, vocab, size=n).tolist(),
                max_new=b, arrival=a)
            for i, (n, b, a) in enumerate(zip(lens, budgets, arrivals))]


def _near_tie(jm, jp, tm, tp, req, want, got):
    """Where the port's stream first parts from JAX's, both frameworks
    replay the prompt and JAX's tokens before it: JAX's logits of the two
    candidates must lie within twice the frameworks' largest logit
    difference there.  Returns the step (``len(want)`` if equal)."""
    s = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             len(want))
    if s < len(want):
        ctx = list(req.tokens) + list(want[:s])
        n = len(ctx) + 1
        jl, _ = jm.with_cfg(paged_kv=False).prefill(
            jp, np.asarray([ctx], np.int32), max_len=n)
        tl, _ = tm.with_cfg(paged_kv=False).prefill(
            tp, torch.tensor([ctx]), max_len=n)
        jl = np.asarray(jl, np.float32)[0, -1]
        tl = tl.float().numpy()[0, -1]
        assert abs(jl[want[s]] - jl[got[s]]) <= 2 * np.abs(jl - tl).max(), \
            (req.rid, s)
    return s


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
def test_engine_matches_jax_at_group_48(policy):
    jm, jp, tm, tp = _pair(policy)
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == 48
    kw = dict(slots=3, max_len=48, chunk=16)
    jfin, jst = JaxEngine(jm, jp, **kw).run(_requests(JaxRequest, 256))
    reqs = _requests(Request, 256)
    tfin, tst = ContinuousEngine(tm, tp, **kw).run(reqs)
    assert tst["pages_live_end"] == 0
    assert [len(f.tokens) for f in tfin] == [r.max_new for r in reqs]
    if policy == "fp32":
        for j, t in zip(jfin, tfin):
            assert t.tokens == list(j.tokens), t.rid
            assert (t.admit_round, t.finish_round, t.slot) == \
                (j.admit_round, j.finish_round, j.slot), t.rid
        for key in ("rounds", "decode_rounds", "peak_live_pages"):
            assert tst[key] == jst[key], key
        return
    steps = [_near_tie(jm, jp, tm, tp, r, list(j.tokens), t.tokens)
             for r, j, t in zip(reqs, jfin, tfin)]
    assert sum(steps) >= 0.75 * sum(r.max_new for r in reqs), steps


def test_granite_launcher_on_cpu(capsys):
    fin, stats = serve.main(["--arch", "granite-20b", "--continuous",
                             "--device", "cpu", "--slots", "3",
                             "--requests", "5", "--prompt-len", "16",
                             "--gen", "8"])
    out = capsys.readouterr().out
    assert "continuous engine on cpu" in out and "tok/s" in out
    assert len(fin) == 5 and stats["pages_live_end"] == 0
    assert all(len(f.tokens) >= 1 for f in fin)
