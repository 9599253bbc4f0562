"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, and the MoE configs, weights and
model plumbing of qwen3-moe-30b-a3b and deepseek-v2-lite-16b.

Inputs are made with numpy from a seed and go through both frameworks.
Router top-k indices and the set of dropped (token, slot) assignments must
equal JAX's exactly (an exact tie of two router probabilities could order
otherwise, ``torch.topk`` against ``jax.lax.top_k``; random inputs have
none).  Outputs within ``F32_TOL`` under ``fp32`` (the same f32 products
summed in another order: 1.2e-6 measured at |y| <= 2.5) and within one
bf16 ulp of the output's scale, ``BF16_ATOL`` = 2^-8 at |y| < 1, under
``tp_bf16`` (a summation-order difference can flip one bf16 rounding of an
expert output or of the combine: 4.9e-4 measured); the aux loss to 1e-6
relative (f32 means of the same probabilities).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import _to_torch, from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2.0 ** -8

#: (n_experts, top_k, d_expert, n_shared, capacity_factor, d_model, tokens)
CASES = {
    "dropfree": (8, 2, 16, 0, None, 32, 48),
    "dropfree_shared2": (8, 2, 16, 2, None, 32, 48),
    "cap025_top2": (8, 2, 16, 0, 0.25, 32, 48),
    "cap025_top1": (4, 1, 8, 0, 0.25, 16, 64),   # tests/test_moe.py's
}


def _setup(case, policy, seed=0):
    e, k, f, ns, cf, d, t = CASES[case]
    jcfg = jmoe.MoEConfig(n_experts=e, top_k=k, d_expert=f, n_shared=ns,
                          capacity_factor=cf)
    tcfg = tmoe.MoEConfig(n_experts=e, top_k=k, d_expert=f, n_shared=ns,
                          capacity_factor=cf)
    dt = jnp.float32 if policy == "fp32" else jnp.bfloat16
    jp = jmoe.moe_params(jax.random.key(seed), d, jcfg, dt)
    x = np.random.RandomState(seed + 1).randn(t, d).astype(np.float32)
    xj = jnp.asarray(x).astype(dt)
    tp = jax.tree.map(lambda a: _to_torch(np.asarray(a), "cpu"), jp)
    return jcfg, tcfg, jp, tp, xj, _to_torch(np.asarray(xj), "cpu")


def _jax_dispatch(jcfg, jp, xj):
    """JAX's routing and keep mask, by the JAX package's own ops (the lines
    of ``repro.models.moe.moe_core`` that ``moe_core`` does not return):
    ``(idx [T, k], kept [T, k] bool)``."""
    t = xj.shape[0]
    k, e = jcfg.top_k, jcfg.n_experts
    cap = jmoe._capacity(t, jcfg)
    probs = jax.nn.softmax(xj.astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
    rank = jnp.arange(t * k) - first[sorted_e]
    kept_sorted = np.asarray(rank < cap)
    kept = np.zeros(t * k, bool)
    kept[np.asarray(order)] = kept_sorted
    return np.asarray(idx), kept.reshape(t, k)


@pytest.mark.parametrize("policy", ["tp_bf16", "fp32"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_core_matches_jax(case, policy):
    """Router indices and dropped assignments exactly JAX's, outputs and
    aux loss allclose; a capped case drops some but not all."""
    jcfg, tcfg, jp, tp, xj, xt = _setup(case, policy)
    t, k = xj.shape[0], jcfg.top_k
    j_idx, j_kept = _jax_dispatch(jcfg, jp, xj)
    _, _, t_idx = tmoe.route(xt, tp["router"], tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    cap = tmoe._capacity(t, tcfg)
    assert cap == jmoe._capacity(t, jcfg)
    order, slot = tmoe.dispatch_slots(t_idx, cap, tcfg.n_experts)
    t_kept = np.zeros(t * k, bool)
    t_kept[order.numpy()] = (slot < tcfg.n_experts * cap).numpy()
    np.testing.assert_array_equal(t_kept.reshape(t, k), j_kept)
    if jcfg.capacity_factor is None:
        assert j_kept.all()
    else:
        assert 0 < j_kept.sum() < j_kept.size
    yj, auxj = jmoe.moe_block(xj[None], jp, jcfg, jget_policy(policy),
                              mesh=None)
    yt, auxt = tmoe.moe_block(xt[None], tp, tcfg, get_policy(policy))
    assert yt.dtype == _to_torch(np.asarray(yj), "cpu").dtype
    want = np.asarray(yj.astype(jnp.float32))[0]
    got = yt.float().numpy()[0]
    if policy == "fp32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=BF16_ATOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    # a token whose every assignment was dropped gets exactly zero
    dropped = ~j_kept.any(axis=1)
    if jcfg.n_shared == 0 and dropped.any():
        assert not got[dropped].any() and not want[dropped].any()


@pytest.mark.parametrize("policy", ["tp_bf16", "fp32"])
def test_drop_free_output_does_not_depend_on_the_batch(policy):
    """Drop-free dispatch: a token's output is the same alone and inside
    larger batches (the capacity grows with the batch: 8, 16, 24, 40 rows
    a slab), bit for bit on the CPU's GEMMs."""
    _, tcfg, _, tp, _, xt = _setup("dropfree", policy)
    pol = get_policy(policy)
    full, _ = tmoe.moe_core(xt[:40], tp, tcfg, pol)
    for n in (1, 2, 8, 9, 16, 17, 33):
        y, _ = tmoe.moe_core(xt[:n], tp, tcfg, pol)
        assert torch.equal(y, full[:n]), n
    # and a token moved to another place in the batch
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(3))
    y, _ = tmoe.moe_core(xt[:40][perm], tp, tcfg, pol)
    assert torch.equal(y, full[perm])


def test_expert_parallel_paths_raise():
    """Expert parallelism is ported (``tests/test_torch_tp.py`` runs it
    across ranks): a foreign mesh raises, experts that are not an
    ``ep_group``'s shards raise, and a one-rank mesh is the local path
    bitwise."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.spmd import Group
    _, tcfg, _, tp, _, xt = _setup("dropfree", "fp32")
    pol = get_policy("fp32")
    with pytest.raises(TypeError, match="Mesh"):
        tmoe.moe_block(xt[None], tp, tcfg, pol, mesh=object())
    with pytest.raises(ValueError, match="local experts"):
        tmoe.moe_core(xt, tp, tcfg, pol, ep_group=Group([0, 1]))
    y0, a0 = tmoe.moe_block(xt[None], tp, tcfg, pol)
    y1, a1 = tmoe.moe_block(xt[None], tp, tcfg, pol,
                            mesh=make_serving_mesh(1, 1))
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_come_across(arch):
    """``CONFIG`` and ``reduced()`` field for field as the JAX package's,
    the MoE sub-config included; both build (full width and reduced)."""
    import importlib
    mod = arch.replace("-", "_")
    jcfg = importlib.import_module(f"repro.configs.{mod}")
    tcfg = importlib.import_module(f"repro_torch.configs.{mod}")
    for want, got in ((jcfg.CONFIG, tcfg.CONFIG),
                      (jcfg.reduced(), tcfg.reduced())):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "vocab", "q_lora",
                  "kv_lora", "nope_dim", "rope_dim", "v_head_dim",
                  "tie_embeddings", "rope_theta", "norm_eps", "emb_scale",
                  "residual_scale", "logit_softcap"):
            assert getattr(got, f) == getattr(want, f), (arch, f)
        assert [(s.mixer, s.ffn, s.qk_norm, s.window, s.attn_softcap)
                for s in got.layer_list()] == \
            [(s.mixer, s.ffn, s.qk_norm, s.window, s.attn_softcap)
             for s in want.layer_list()]
        for f in ("n_experts", "top_k", "d_expert", "n_shared",
                  "capacity_factor", "router_norm_topk"):
            assert getattr(got.moe, f) == getattr(want.moe, f), (arch, f)
        assert type(got.moe).__module__ == "repro_torch.models.moe"
    for reduced in (False, True):
        m = build_model(arch, reduced=reduced, device="cpu")
        assert not m.cfg.tie_embeddings
        assert any(s.ffn == "moe" for s in m.cfg.layer_list())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_weights_convert_and_init_layout(arch):
    """``from_jax_params``: ``lm_head``, the stacked MoE leaves unstacked per
    layer (the router f32), the shared experts and deepseek's dense prefix
    layer, bit for bit; the port's own ``Model.init`` has the same keys,
    shapes and dtypes."""
    jm, jp = cached_model(arch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_array_equal(
        tp["lm_head"].float().numpy(),
        np.asarray(jp["lm_head"]).astype(np.float32))
    n_pre = len(jm.cfg.prefix)
    assert len(tp["layers"]) == jm.cfg.n_layers
    for i in range(n_pre):
        assert sorted(tp["layers"][i]["mlp"]) == ["down", "gate", "up"]
        np.testing.assert_array_equal(
            tp["layers"][i]["mlp"]["gate"].float().numpy(),
            np.asarray(jp["prefix"][i]["mlp"]["gate"]).astype(np.float32))
    for r in range(jm.cfg.repeats):
        jl = jp["pattern"][0]["mlp"]
        tl = tp["layers"][n_pre + r]["mlp"]
        assert tl["router"].dtype == torch.float32
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                tl[name].float().numpy(),
                np.asarray(jl[name][r]).astype(np.float32))
        if jm.cfg.moe.n_shared:
            np.testing.assert_array_equal(
                tl["shared"]["down"].float().numpy(),
                np.asarray(jl["shared"]["down"][r]).astype(np.float32))
    own = build_model(arch, reduced=True, device="cpu").init(0)
    flat = lambda d: {k: (tuple(v.shape), v.dtype)
                      for k, v in _leaves(d)}
    assert flat(own) == flat(tp)


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, (list, tuple)):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, d


def test_untied_logits_use_lm_head():
    """``Model.logits`` of an untied config multiplies by ``lm_head``
    (``bsd,dv->bsv``) and masks the vocab pad; JAX's logits on the same
    final hidden state agree."""
    jm, jp = cached_model("qwen3-moe-30b-a3b")
    tm = build_model("qwen3-moe-30b-a3b", reduced=True, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    h = np.random.RandomState(5).randn(2, 3, jm.cfg.d_model).astype(
        np.float32)
    hj = jnp.asarray(h).astype(jnp.bfloat16)
    want = np.asarray(jm.logits(jp, hj)).astype(np.float32)
    got = tm.logits(tp, _to_torch(np.asarray(hj), "cpu")).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    ref = (_to_torch(np.asarray(hj), "cpu").float()
           @ tp["lm_head"].float()).numpy()
    np.testing.assert_allclose(got[..., :jm.cfg.vocab],
                               ref[..., :jm.cfg.vocab], rtol=1e-2, atol=1e-2)
