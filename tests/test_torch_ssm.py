"""The recurrent archs of the port against the JAX package: the mixers of
``repro_torch.models.ssm`` (Mamba2's chunked SSD, mLSTM's chunkwise
matrix memory, sLSTM's exponential-gated scan) alone, and zamba2-1.2b
(Mamba2 + a shared attention block) and xlstm-1.3b (mLSTM + sLSTM) on
their ``reduced()`` configs with JAX's ``Model.init`` weights converted
by ``from_jax_params``.  JAX's init zeroes every norm gain, so the tests
draw the gains (``g``, Mamba2's ``norm``, the xLSTM ``ln``) ~ 0.2 N
from numpy for both sides (``_lively``).  Inputs come from numpy seeds.

Tolerances:

* ``fp32``: each mixer's output and every field of its new cache, and
  the models' prefill and decode logits and caches, within ``rtol = atol
  = 2e-4`` (as ``tests/test_archs.py``: f32 sums in another order);
  greedy ``generate`` tokens equal up to a row's first near tie;
  ``forward_train``'s loss within 1e-6 relative, every gradient within
  1e-5 relative L2; within the port, decode equals the prefill of the
  longer prompt within 2e-4.
* ``tp_bf16``: ``rtol, atol = 5e-2, 1e-1``, the house model-level bound
  (bf16 activations round at other places in the two frameworks).
* ``_causal_conv`` and ``_segsum`` within 1e-6; ``softplus`` and
  ``log_sigmoid`` within 1e-6 (JAX's ``logaddexp`` forms, above 20 too).
* The deterministic init leaves: zeros and ones bitwise; ``A_log =
  log(1..H)`` and the ``linspace(3, 6)`` forget biases are the f64 values
  rounded once, within one f32 ulp of JAX's (XLA's CPU code rounds a few
  of its own off by one ulp: ROADMAP Queue 3).
"""
import dataclasses
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.configs import xlstm_1_3b as jxl  # noqa: E402
from repro.configs import zamba2_1_2b as jzb  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.launch.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import xlstm_1_3b as txl  # noqa: E402
from repro_torch.configs import zamba2_1_2b as tzb  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import (flatten_with_paths, leaves,  # noqa: E402
                                   unflatten)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.engine import ContinuousEngine  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import (from_jax_caches,  # noqa: E402
                                        from_jax_params, from_jax_state,
                                        from_jax_tree, stack_layers)
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("zamba2-1.2b", "xlstm-1.3b")
CONFIGS = {"zamba2-1.2b": (tzb, jzb), "xlstm-1.3b": (txl, jxl)}
F32_TOL = 2e-4
BF16_RTOL, BF16_ATOL = 5e-2, 1e-1
F32_REL = 1e-5
B, S, MAX_LEN = 2, 21, 32
#: gains drawn for both sides: rmsnorm's ``g``, Mamba2's gated ``norm``,
#: the xLSTM blocks' ``ln`` (all read as ``1 + gain``)
GAINS = ("g", "norm", "ln")


def _lively(tree, seed=1):
    """A numpy copy of a JAX param tree with every norm gain ~ 0.2 N."""
    rs = np.random.RandomState(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        a = np.asarray(t)
        if key in GAINS:
            return (rs.randn(*a.shape) * 0.2).astype(np.float32).astype(
                a.dtype)
        return a
    return walk(tree)


def _pair(arch, policy):
    """(JAX model, JAX params, port model, port params): the same lively
    weights on both sides."""
    jm, jp = cached_model(arch, policy=policy)
    tree = _lively(jp)
    tm = build_model(arch, policy=policy, reduced=True, device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm, from_jax_params(
        tree, device="cpu")


def _tokens(vocab, b=B, s=S, seed=3):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, policy):
    if policy == "fp32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# configs, registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """``CONFIG`` and ``reduced()`` equal JAX's, the nested sub-configs
    included (``asdict`` recurses into them)."""
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
    zb, xl = (get_config(a) for a in ARCHS)
    assert (zb.n_layers, zb.d_model, zb.n_heads, zb.n_kv_heads, zb.head_dim,
            zb.d_ff, zb.vocab) == (38, 2048, 32, 32, 64, 8192, 32000)
    mixers = [s.mixer for s in zb.layer_list()]
    assert mixers == (["mamba2"] * 5 + ["shared_attn"]) * 6 + ["mamba2"] * 2
    assert (zb.mamba.d_state, zb.mamba.chunk, zb.mamba.n_heads,
            zb.mamba.conv_dim) == (64, 256, 64, 4224)
    assert (xl.n_layers, xl.d_model, xl.vocab) == (48, 2048, 50304)
    assert [s.mixer for s in xl.layer_list()] == \
        (["mlstm"] * 7 + ["slstm"]) * 6
    assert (xl.mlstm.n_heads, xl.mlstm.head_dim, xl.mlstm.chunk,
            xl.slstm.head_dim) == (4, 1024, 256, 512)
    assert all(s.ffn == "none" for s in xl.layer_list())


def test_registry_lists_every_jax_config():
    """Every config module of the JAX package has a counterpart."""
    import repro.configs as jconfigs
    names = {f[:-3] for f in os.listdir(os.path.dirname(jconfigs.__file__))
             if f.endswith(".py") and f not in ("__init__.py", "base.py")}
    assert names == set(registry.ARCHS)
    for a in ARCHS:
        build_model(a, reduced=True, device="cpu")


# ---------------------------------------------------------------------------
# init, conversion
# ---------------------------------------------------------------------------
def test_deterministic_leaves_match_jax():
    """The port's init against JAX's on the leaves that draw no random
    numbers: zeros and ones bitwise; ``A_log`` and the forget-gate
    linspaces the correctly rounded f64 values, within one ulp of JAX's."""
    for arch in ARCHS:
        jm, jp = cached_model(arch, policy="fp32")
        mine = build_model(arch, policy="fp32", reduced=True,
                           device="cpu").init(0)
        theirs = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        for lm, lt in zip(mine["layers"], theirs["layers"]):
            for (path, a), b in zip(flatten_with_paths(lm), leaves(lt)):
                key = path.split("'")[-2]
                if key in ("A_log", "b_if", "b_gates"):
                    np.testing.assert_array_max_ulp(a.numpy(), b.numpy(), 1)
                elif key in ("D", "dt_bias", "conv_b", "norm", "ln", "g"):
                    assert torch.equal(a, b), path
    want = np.log(np.arange(1, 9, dtype=np.float64)).astype(np.float32)
    m = ssm.mamba2_params(torch.Generator().manual_seed(0),
                          ssm.Mamba2Config(d_model=64, head_dim=16),
                          torch.float32, "cpu")
    np.testing.assert_array_equal(m["A_log"].numpy(), want)
    sl = ssm.slstm_params(torch.Generator().manual_seed(0),
                          ssm.SLSTMConfig(d_model=64, n_heads=2),
                          torch.float32, "cpu")
    np.testing.assert_array_equal(
        sl["b_gates"][64:128].numpy(),
        np.linspace(3.0, 6.0, 64).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_conversion(arch):
    """``from_jax_params`` carries every leaf bit for bit, the shared
    block included, and the port's init builds the same leaves (shapes and
    dtypes), the unread ``norm1`` / ``norm2`` / ``mlp`` of every
    ``shared_attn`` layer included; ``stack_layers`` gives JAX's tree
    back."""
    jm, jp = cached_model(arch)
    tree = jax.tree.map(np.asarray, jp)
    tp = from_jax_params(tree, device="cpu")
    n_pre, n_pat = len(jm.cfg.prefix), len(jm.cfg.pattern)
    specs = jm.cfg.layer_list()
    for i, lp in enumerate(tp["layers"]):
        if i < n_pre + jm.cfg.repeats * n_pat:
            j = i - n_pre
            want = jax.tree.map(lambda a: a[j // n_pat],
                                tree["pattern"][j % n_pat])
        else:
            want = tree["suffix"][i - n_pre - jm.cfg.repeats * n_pat]
        for (path, t), w in zip(flatten_with_paths(lp), leaves(want)):
            np.testing.assert_array_equal(_f32(t), np.asarray(w, np.float32))
        if specs[i].mixer == "shared_attn":
            assert sorted(lp) == ["mlp", "norm1", "norm2"]
    if arch == "zamba2-1.2b":
        assert sorted(tp["shared"]) == ["attn", "mlp", "norm1", "norm2"]
    mine = build_model(arch, reduced=True, device="cpu").init(0)

    def shapes(t):
        return [(p, tuple(x.shape), x.dtype) for p, x in
                flatten_with_paths(t)]
    assert shapes(mine) == shapes(tp)
    back = stack_layers(tp, jm.cfg)
    jflat = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    tflat = flatten_with_paths(back)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (p, j), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(_f32(t), np.asarray(j, np.float32),
                                      err_msg=p)


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------
def test_softplus_and_log_sigmoid_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        np.random.RandomState(0).randn(200) * 10]).astype(
                            np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(ssm._softplus(t).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ssm._log_sigmoid(t).numpy(),
                               np.asarray(jax.nn.log_sigmoid(x)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_causal_conv_and_segsum_match_jax(dtype):
    rs = np.random.RandomState(0)
    xbc = rs.randn(2, 9, 12).astype(np.float32)
    w = (rs.randn(4, 12) * 0.5).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    st = np.asarray(jnp.asarray(rs.randn(2, 3, 12)).astype(dtype))
    for state in (None, st):
        jo, js = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                   jnp.asarray(b), None if state is None
                                   else jnp.asarray(state))
        to, ts = ssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                                  torch.from_numpy(b), None if state is None
                                  else from_jax_tree(state, "cpu"))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = (rs.randn(2, 3, 16) * 0.3).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


#: each mixer: (JAX's, the port's, its reduced sub-config, cache class)
MIXERS = {
    "mamba2": (jssm.mamba2_mix, ssm.mamba2_mix, jssm.mamba2_params,
               jssm.Mamba2Config(d_model=64, d_state=16, head_dim=16,
                                 chunk=8), ssm.Mamba2Config),
    "mlstm": (jssm.mlstm_mix, ssm.mlstm_mix, jssm.mlstm_params,
              jssm.MLSTMConfig(d_model=64, n_heads=2, chunk=8),
              ssm.MLSTMConfig),
    "mlstm_narrow": (jssm.mlstm_mix, ssm.mlstm_mix, jssm.mlstm_params,
                     jssm.MLSTMConfig(d_model=64, n_heads=2, chunk=8,
                                      narrow_intra=True), ssm.MLSTMConfig),
    "slstm": (jssm.slstm_mix, ssm.slstm_mix, jssm.slstm_params,
              jssm.SLSTMConfig(d_model=64, n_heads=2), ssm.SLSTMConfig),
}


def _mixer_cache(name, jcfg, kv_dtype, rs, b=B):
    """A live cache (numpy, JAX's NamedTuple): random windows and
    states, a positive sLSTM normaliser, finite stabilisers."""
    n = lambda *s: rs.randn(*s).astype(np.float32)
    kv = lambda a: np.asarray(jnp.asarray(a).astype(kv_dtype))
    if name == "mamba2":
        return jssm.Mamba2Cache(
            kv(n(b, jcfg.d_conv - 1, jcfg.conv_dim)),
            n(b, jcfg.n_heads, jcfg.head_dim, jcfg.d_state) * 0.5)
    if name.startswith("mlstm"):
        h, dk = jcfg.n_heads, jcfg.head_dim
        return jssm.MLSTMCache(kv(n(b, jcfg.d_conv - 1, jcfg.d_inner)),
                               n(b, h, dk, dk) * 0.3, n(b, h, dk),
                               n(b, h))
    d = jcfg.d_model
    return jssm.SLSTMCache(n(b, d), np.abs(n(b, d)) + 0.5, n(b, d),
                           n(b, d) * 0.5)


@functools.lru_cache(maxsize=None)
def _jax_mixer(name, policy):
    fn = MIXERS[name][0]
    cfg = MIXERS[name][3]
    return jax.jit(lambda x, p, c: fn(x, p, cfg, jget_policy(policy),
                                      cache=c))


@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
@pytest.mark.parametrize("s", ["chunks", "padded", "one"])
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_matches_jax(name, s, policy):
    """A mixer without a cache (training) and with a live one (prefill /
    decode), at S a multiple of the chunk (16: two chunks of 8), S with a
    padded last chunk (13) and S = 1: the output and every field of the
    new cache.  mLSTM's ``narrow_intra`` holds its intra-chunk weights in
    bf16 whatever the policy, so it is held to the bf16 bound."""
    _, tfn, jparams, jcfg, tcls = MIXERS[name]
    tcfg = tcls(**dataclasses.asdict(jcfg))
    pol = get_policy(policy)
    dt = jnp.float32 if policy == "fp32" else jnp.bfloat16
    seq = {"chunks": 16, "padded": 13, "one": 1}[s]
    # narrow_intra rounds the intra-chunk weights to bf16 under any policy
    tol = "tp_bf16" if jcfg.__class__ is jssm.MLSTMConfig and \
        jcfg.narrow_intra else policy
    rs = np.random.RandomState(sum(map(ord, name + s)))
    jp = _lively(jax.tree.map(np.asarray, jparams(jax.random.key(5), jcfg,
                                                  dt)))
    tp = from_jax_tree(jp, "cpu")
    x = np.asarray(jnp.asarray(rs.randn(B, seq, 64).astype(np.float32))
                   .astype(dt))
    kv_dtype = jnp.float32 if policy == "fp32" else jnp.bfloat16
    for cache in (None, _mixer_cache(name, jcfg, kv_dtype, rs)):
        jo, jc = _jax_mixer(name, policy)(
            jnp.asarray(x), jax.tree.map(jnp.asarray, jp),
            None if cache is None else jax.tree.map(jnp.asarray, cache))
        tc = (None if cache is None else getattr(
            ssm, type(cache).__name__)(*(from_jax_tree(a, "cpu")
                                         for a in cache)))
        to, tn = tfn(from_jax_tree(x, "cpu"), tp, tcfg, pol, cache=tc)
        assert to.dtype == from_jax_tree(np.asarray(jo), "cpu").dtype
        _close(to, jo, tol)
        if cache is None:
            assert tn is None and jc is None
            continue
        assert type(tn).__name__ == type(jc).__name__
        for field, a, w in zip(tn._fields, tn, jc):
            assert a.dtype == from_jax_tree(np.asarray(w), "cpu").dtype, field
            _close(a, w, tol)


def test_mixer_output_moves_with_the_cache():
    """A cache is read: the same input after another state gives another
    output (each mixer, fp32)."""
    for name in ("mamba2", "mlstm", "slstm"):
        _, tfn, jparams, jcfg, tcls = MIXERS[name]
        tcfg = tcls(**dataclasses.asdict(jcfg))
        rs = np.random.RandomState(7)
        tp = from_jax_tree(_lively(jax.tree.map(
            np.asarray, jparams(jax.random.key(5), jcfg, jnp.float32))),
            "cpu")
        x = torch.from_numpy(rs.randn(B, 3, 64).astype(np.float32))
        outs = [tfn(x, tp, tcfg, get_policy("fp32"), cache=getattr(
            ssm, type(c).__name__)(*(torch.tensor(a) for a in c)))[0]
            for c in (_mixer_cache(name, jcfg, jnp.float32, rs)
                      for _ in range(2))]
        assert (outs[0] - outs[1]).abs().max().item() > 1e-3, name


# ---------------------------------------------------------------------------
# the models: prefill, caches, decode, generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["fp32", "tp_bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, policy):
    """``prefill`` logits, every layer's cache after it (the recurrent
    states and windows, the shared-attention KV), and two
    ``decode_step``s (the tokens JAX picks fed to both)."""
    jm, jp, tm, tp = _pair(arch, policy)
    toks = _tokens(tm.cfg.vocab)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=MAX_LEN))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=MAX_LEN)
    _close(tl, jl, policy)
    assert np.abs(np.asarray(jl)).max() > 0.5       # a live model
    want = from_jax_caches(jax.tree.map(np.asarray, jc), "cpu")
    assert [type(c).__name__ for c in tc] == \
        [type(c).__name__ for c in want]
    for c, w in zip(tc, want):
        for field, a, b in zip(c._fields, c, w):
            assert a.dtype == b.dtype, field
            _close(a, b, policy)
    step = jax.jit(jm.decode_step)
    for i in range(2):
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = step(jp, jnp.asarray(tok), jc, S + i)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, S + i)
        _close(tl, jl, policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_conv_window_dtype_under_kv8_matches_jax(arch):
    """Under ``tp_bf16_kv8`` the conv window is stored as fp8 (the KV
    store dtype) in both frameworks, and the logits stay within the bf16
    bound of JAX's."""
    jm, jp, tm, tp = _pair(arch, "tp_bf16_kv8")
    toks = _tokens(tm.cfg.vocab, s=9)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=16))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=16)
    want = from_jax_caches(jax.tree.map(np.asarray, jc), "cpu")
    rec = [(c, w) for c, w in zip(tc, want)
           if isinstance(c, (ssm.Mamba2Cache, ssm.MLSTMCache))]
    assert rec
    for c, w in rec:
        assert c.conv.dtype == w.conv.dtype == torch.float8_e5m2
    _close(tl, jl, "tp_bf16")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    """Greedy ``generate`` under ``fp32``: the tokens equal JAX's up to a
    row's first near tie (JAX's top-2 margin there within twice the
    frameworks' largest logit difference)."""
    jm, jp, tm, tp = _pair(arch, "fp32")
    toks = _tokens(tm.cfg.vocab, b=3, s=11)
    f = jax.jit(lambda p, t: jm.generate(p, t, gen_len=8,
                                         return_logits=True))
    jg, jl = (np.asarray(x) for x in f(jp, jnp.asarray(toks)))
    tg, tl = tm.generate(tp, torch.from_numpy(toks), gen_len=8,
                         return_logits=True)
    tg, tl = tg.numpy(), tl.numpy()
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], rtol=F32_TOL, atol=F32_TOL)
    for r in range(3):
        bad = np.nonzero(tg[r] != jg[r])[0]
        if len(bad):
            s0 = bad[0]        # both saw the same history up to here
            diff = np.abs(tl[r, :s0 + 1] - jl[r, :s0 + 1]).max()
            top2 = np.sort(jl[r, s0])[-2:]
            assert top2[1] - top2[0] <= 2 * diff, (r, s0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_prefill_of_the_longer_prompt(arch):
    """Within the port (JAX's ``test_decode_matches_prefill_continuation``
    invariant): a prefill of 13 tokens (a padded last chunk) then 5
    ``decode_step``s equals a prefill of all 18, under ``fp32``; the scan
    form of ``generate`` agrees with its while form."""
    _, _, tm, tp = _pair(arch, "fp32")
    toks = torch.from_numpy(_tokens(tm.cfg.vocab, b=1, s=18, seed=8))
    lg_a, caches = tm.prefill(tp, toks[:, :13], max_len=24)
    for i in range(5):
        lg_a, caches = tm.decode_step(tp, toks[:, 13 + i:14 + i], caches,
                                      13 + i)
    lg_b, _ = tm.prefill(tp, toks, max_len=24)
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    g_scan, _ = tm.generate(tp, toks, gen_len=6)
    g_while, _ = tm.generate(tp, toks, gen_len=6, loop="while",
                             stop_token=int(g_scan[0, 2]))
    assert torch.equal(g_while[0, :3], g_scan[0, :3])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_jax(arch):
    """``paged_kv`` (cannot page), ``prompt_lens`` (ragged),
    ``speculate_check`` and ``ContinuousEngine``, each with JAX's
    message."""
    jm, jp, tm, tp = _pair(arch, "fp32")
    assert tm.cfg.paged_unsupported_reason() == \
        jm.cfg.paged_unsupported_reason()
    toks = _tokens(tm.cfg.vocab, s=6)

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    pairs = [
        (lambda: jm.with_cfg(paged_kv=True).prefill(
            jp, jnp.asarray(toks), max_len=8),
         lambda: tm.with_cfg(paged_kv=True).prefill(
            tp, torch.from_numpy(toks), max_len=8)),
        (lambda: jm.prefill(jp, jnp.asarray(toks), max_len=8,
                            prompt_lens=jnp.asarray([6, 3])),
         lambda: tm.prefill(tp, torch.from_numpy(toks), max_len=8,
                            prompt_lens=torch.tensor([6, 3]))),
        (jm.speculate_check, tm.speculate_check),
        (lambda: JEngine(jm.with_cfg(paged_kv=True), jp, slots=2,
                         max_len=16),
         lambda: ContinuousEngine(tm.with_cfg(paged_kv=True), tp, slots=2,
                                  max_len=16)),
    ]
    got = [(message(j), message(t)) for j, t in pairs]
    for want, mine in got:
        assert mine == want
    assert "cannot page" in got[0][1] and "ragged" in got[1][1]
    assert "roll back" in got[2][1] and "continuous batching" in got[3][1]
    with pytest.raises(ValueError, match="ragged"):
        tm.generate(tp, torch.from_numpy(toks), gen_len=2,
                    prompt_lens=torch.tensor([6, 3]))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    """``forward_train``'s loss and every gradient against
    ``jax.value_and_grad`` under ``fp32`` on the trainer's stacked tree:
    the chunked paths without a cache (S = 24: whole and padded chunks),
    and zero gradients for the unread leaves of the ``shared_attn``
    layers."""
    jm, jp = cached_model(arch, policy="fp32")
    jp = jax.tree.map(jnp.asarray, _lively(jp))
    tm = build_model(arch, policy="fp32", reduced=True, device="cpu",
                     prefill_backend="dense")
    rs = np.random.default_rng(5)
    toks = rs.integers(0, tm.cfg.vocab, (B, 24)).astype(np.int32)
    labels = rs.integers(0, tm.cfg.vocab, (B, 24)).astype(np.int32)
    labels[0, :3] = -1
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: jm.forward_train(
        p, jnp.asarray(toks), jnp.asarray(labels))))(jp)
    tree = from_jax_tree(jax.tree.map(np.asarray, jp), device="cpu")
    flat = [p.detach().clone().requires_grad_() for p in leaves(tree)]
    loss = tm.forward_train(unflatten(tree, flat), torch.from_numpy(toks),
                            torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    jflat = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
             jax.tree_util.tree_flatten_with_path(jgrad)[0]]
    assert [p for p, _ in jflat] == [p for p, _ in flatten_with_paths(tree)]
    unread = 0
    for (path, want), got in zip(jflat, grads):
        got = np.zeros_like(want) if got is None else got.numpy()
        den = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= F32_REL * max(den, 1e-30), path
        unread += int(den == 0.0)
    if arch == "zamba2-1.2b":
        assert unread >= 5      # the shared_attn layer's norm1 / norm2 / mlp


def test_train_step_matches_jax_on_zamba2():
    """One ``make_train_step`` step from JAX's state on reduced zamba2
    under ``fp32``: loss, gradient norm and every master leaf, the
    shared_attn layer's unread leaves included (JAX decays them too)."""
    cfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jm, jp = cached_model("zamba2-1.2b", policy="fp32")
    jp = jax.tree.map(jnp.asarray, _lively(jp))
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**cfg),
                                 jget_policy("fp32"))
    rs = np.random.default_rng(4)
    toks = rs.integers(0, 256, (B, 16)).astype(np.int32)
    labels = rs.integers(0, 256, (B, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jp2, js2, jmet = jax.jit(jmake_step(jm, jopt.OptConfig(**cfg), None))(
        jp, jstate, batch)
    tm = build_model("zamba2-1.2b", policy="fp32", reduced=True,
                     device="cpu", prefill_backend="dense")
    st = from_jax_state({"params": jax.tree.map(np.asarray, jp),
                         "opt": jax.tree.map(np.asarray, jstate)}, "cpu")
    tp2, ts2, tmet = make_train_step(tm, topt.OptConfig(**cfg))(
        st["params"], st["opt"], {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        F32_REL * float(jmet["grad_norm"])
    jflat = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
             jax.tree_util.tree_flatten_with_path(js2["master"])[0]]
    tflat = flatten_with_paths(ts2["master"])
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    moved = 0
    for (p, want), (_, got) in zip(jflat, tflat):
        got = _f32(got)
        den = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= 1e-4 * max(den, 1e-30), p
        if "pattern'][1]['mlp" in p:         # an unread shared_attn leaf
            moved += int(not np.array_equal(got, _f32(
                st["opt"]["master"]["pattern"][1]["mlp"][p.split("'")[-2]])))
    assert moved == 3                         # decayed: gate, up, down


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_archs(arch, capsys):
    """``serve`` (fixed batch through ``generate``) and ``train`` run both
    archs on the CPU; ``--ragged``, ``--paged`` and ``--continuous`` are
    refused with JAX's reasons."""
    gen = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen", "3"])
    assert tuple(gen.shape) == (2, 3)
    ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                 "--seq-len", "12", "--global-batch", "2"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out
    name = get_config(arch, reduced=True).name
    mixer = "mamba2" if arch.startswith("zamba2") else "mlstm/slstm"
    with pytest.raises(ValueError, match="ragged"):
        tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                     "--prompt-len", "12", "--gen", "2", "--ragged"])
    for flag in ("--paged", "--continuous"):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", arch, "--device", "cpu", flag])
        assert f"paged_kv is unsupported for {name}: {mixer}" in (
            capsys.readouterr().err)
