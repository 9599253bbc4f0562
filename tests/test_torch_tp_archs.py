"""MLA and the recurrent mixers under a tensor-parallel mesh:
``torch.distributed`` over gloo on the CPU, against the unsharded port in
this process and the JAX package's unsharded model.

Reduced minicpm3-4b and deepseek-v2-lite-16b (MLA: latents gathered whole,
heads sharded), zamba2-1.2b (Mamba2 and the shared GQA block) and
xlstm-1.3b (mLSTM and sLSTM: projections gathered whole, the mixers whole
on every rank, out projections row-parallel) at tp 2, and at tp 4 where
the reduced heads divide (xlstm has 2).  Each case holds:

  * each rank's parameter bytes to what the JAX package's ``param_specs``
    gives its tree at that model size;
  * ``fp32`` prefill logits within 1e-5 of the unsharded port's, and
    within ``test_torch_model``'s bounds (5e-2 / 1e-1) of JAX's (MLA: the
    JAX prompt fed token by token through ``decode_step``, as JAX's own
    MLA prefill leaves prompt keys unrotated);
  * greedy ``generate`` tokens equal to the unsharded port's, the same on
    every rank.

Weights are JAX's (``from_jax_params``) with every norm gain drawn
(JAX's init zeroes them).  One spawn per world size (a module-scoped
fixture) runs every case.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.models import sharding as jsharding  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.launch import sharded_checks as sc  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 5e-2, 1e-1          # tests/test_torch_model.py's bounds
F32_TOL = 1e-5
B, S, GEN = 2, 8, 4
MLA = ("minicpm3-4b", "deepseek-v2-lite-16b")
ARCHS = MLA + ("zamba2-1.2b", "xlstm-1.3b")
#: tp 4 where the reduced heads divide
WIDE = ("minicpm3-4b", "deepseek-v2-lite-16b", "zamba2-1.2b")
GAINS = ("g", "norm", "ln", "q_norm", "kv_norm")


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
            return (rs.randn(*a.shape) * 0.2).astype(a.dtype)
        return a
    return walk(tree)


_WEIGHTS = {}


def _weights(arch):
    """``(jax model, lively JAX tree, the port's params from it)``."""
    if arch not in _WEIGHTS:
        jm, jp = cached_model(arch, policy="fp32")
        tree = _lively(jp)
        _WEIGHTS[arch] = (jm, tree, from_jax_params(tree, device="cpu"))
    return _WEIGHTS[arch]


def _tokens(vocab, seed=5):
    return np.random.RandomState(seed).randint(0, vocab, (B, S))


def _plan(world):
    archs = ARCHS if world == 2 else WIDE
    plan = []
    for a in archs:
        jm, _, params = _weights(a)
        plan.append((a, "logits", (1, world),
                     {"arch": a, "params": params,
                      "tokens": torch.from_numpy(_tokens(jm.cfg.vocab)),
                      "gen_len": GEN}))
    return plan


def _run(world):
    plan = _plan(world)
    ref = sc.run_plan([(n, c, None, kw) for n, c, _, kw in plan])
    return ref, spmd.spawn(sc.rank_main, world, backend="gloo",
                           args=(plan,), timeout=300)


@pytest.fixture(scope="module")
def world2():
    return _run(2)


@pytest.fixture(scope="module")
def world4():
    return _run(4)


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


CASES = [(a, 2) for a in ARCHS] + [(a, 4) for a in WIDE]


def _jax_bytes(tree, world):
    """Per-rank bytes of ``tree`` under the JAX package's ``param_specs``
    at model size ``world``."""
    specs = jsharding.param_specs(tree, model_size=world)
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for a, sp in zip(leaves, spec_leaves):
        split = sum(1 for e in sp if e is not None)
        total += a.nbytes // world ** split
    return total


@pytest.mark.parametrize("arch,world", CASES)
def test_param_bytes_match_jax_param_specs(request, arch, world):
    _, ranks = _world(request, world)
    _, tree, _ = _weights(arch)
    want = _jax_bytes(tree, world)
    full = sum(np.asarray(a).nbytes for a in jax.tree_util.tree_leaves(tree))
    assert want < full
    for out in ranks:
        assert out[arch]["param_bytes"] == want, out["rank"]


@pytest.mark.parametrize("arch,world", CASES)
def test_logits_match_unsharded_port(request, arch, world):
    ref, ranks = _world(request, world)
    want = ref[arch]["logits"]
    for out in ranks:
        got = out[arch]["logits"]
        torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
        # every rank holds the same logits
        assert torch.equal(got, ranks[0][arch]["logits"])
        assert out[arch]["spmd"]["collectives"] > 0


def _jax_logits(arch):
    """JAX's unsharded ``fp32`` logits of the prompt's last position [B,
    1, V]: MLA's through ``decode_step`` token by token, the others'
    ``prefill``."""
    jm, tree, _ = _weights(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    toks = _tokens(jm.cfg.vocab)
    if arch not in MLA:
        lg, _ = jax.jit(lambda p, t: jm.prefill(p, t, max_len=S + GEN))(
            jp, jnp.asarray(toks))
        return np.asarray(lg)
    step = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))
    c = jt.init_caches(jm.cfg, B, S + GEN, jm.policy)
    for i in range(S):
        lg, c = step(jp, jnp.asarray(toks[:, i:i + 1]), c, jnp.int32(i))
    return np.asarray(lg)


@pytest.mark.parametrize("arch,world", CASES)
def test_logits_match_jax_unsharded(request, arch, world):
    _, ranks = _world(request, world)
    want = _jax_logits(arch)
    assert np.abs(want).max() > 0.5                    # a live model
    for out in ranks:
        got = out[arch]["logits"].numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch,world", CASES)
def test_generate_tokens_match_unsharded_port(request, arch, world):
    ref, ranks = _world(request, world)
    want = ref[arch]["tokens"]
    assert want.shape == (B, GEN)
    for out in ranks:
        assert torch.equal(out[arch]["tokens"], want), out["rank"]


def test_zamba2_shared_block_is_head_sharded():
    """``shard_params`` reaches ``params["shared"]``: the shared GQA
    block's projections hold half the heads on each rank (the rest of
    the tree as the rule table cuts it), so its reads run on them."""
    _, tree, params = _weights("zamba2-1.2b")
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.spmd import Group
    from repro_torch.models.sharding import shard_params
    from repro_torch.models.registry import build_model
    cfg = build_model("zamba2-1.2b", reduced=True, device="cpu").cfg
    for rank in range(2):
        grp = Group([0, 1], rank, None)
        mesh = Mesh(("model",), np.arange(2), rank, {"model": grp}, grp)
        local = shard_params(params, mesh, cfg)
        wq = local["shared"]["attn"]["wq"]
        assert wq.shape[-1] * 2 == cfg.n_heads * cfg.head_dim
        want = params["shared"]["attn"]["wq"][:, rank * wq.shape[-1]:
                                              (rank + 1) * wq.shape[-1]]
        assert torch.equal(wq, want)
