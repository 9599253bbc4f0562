"""The port's sharding rules, meshes and narrow partials against the JAX
package's, in one process (no ranks are spawned here:
``tests/test_torch_tp.py`` runs the sharded path).

  * ``param_specs`` of every registered arch's full-size parameter tree
    (the port's ``Model.init`` on the meta device, stacked into JAX's
    layout by ``models.convert.stack_layers``) equal JAX's
    ``PartitionSpec`` leaf for leaf (JAX's side on ``jax.eval_shape`` of
    ``Model.init``), at model sizes 2, 4, 8 and 16, with the same
    divisibility warnings;
  * ``cache_specs`` of the contiguous, paged, MLA and recurrent caches
    (the port's per-layer caches against JAX's ``Caches``) under a
    namespace mesh;
  * ``narrow_partials`` on one device against JAX's ``tp_einsum``;
  * ``make_serving_mesh`` / ``replica_meshes`` / ``make_production_mesh``
    validation with JAX's messages, and ``local_shard`` / ``shard_params``
    slicing.
"""
import types
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.policy import PRESETS as JPRESETS  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import sharding as jshard  # noqa: E402
from repro.models.transformer import init_caches as jinit_caches  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.policy import PRESETS as TPRESETS  # noqa: E402
from repro_torch.launch import engine as tengine  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import sharding as tshard  # noqa: E402
from repro_torch.models.convert import stack_layers  # noqa: E402
from repro_torch.models.paged import PageAllocator  # noqa: E402

SIZES = (2, 4, 8, 16)
_TREES = {}


def _trees(arch):
    """(JAX's eval_shape tree, the port's stacked meta tree) at full
    width."""
    if arch not in _TREES:
        jm = jreg.build_model(treg.ALIASES.get(arch, arch))
        jt = jax.eval_shape(jm.init, jax.random.key(0))
        tm = treg.build_model(arch, device="meta")
        tt = stack_layers(tm.init(torch.Generator()), tm.cfg)
        _TREES[arch] = (jt, tt)
    return _TREES[arch]


def _flat(tree, path=()):
    """{path: leaf}, list and tuple indices as ints, None leaves dropped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {} if tree is None else {path: tree}


def _specs(fn, tree, size):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        specs = fn(tree, model_size=size)
    return specs, sorted(str(w.message) for w in rec)


def _port_flat_specs(tree):
    """The port's spec tree, flattened with specs (tuples) as leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update({(k,) + p: s for p, s in _port_flat_specs(v).items()})
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update({(i,) + p: s for p, s in _port_flat_specs(v).items()})
        return out
    return {(): tree}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_param_specs_match_jax(arch, size):
    jt, tt = _trees(arch)
    jspecs, jwarn = _specs(jshard.param_specs, jt, size)
    tspecs, twarn = _specs(tshard.param_specs, tt, size)
    want = {p: tuple(s) for p, s in _flat(jspecs).items()}
    got = _port_flat_specs(tspecs)
    assert set(got) == set(want)
    assert got == want
    # the same leaves fall back to replication, with JAX's text
    assert twarn == jwarn


def test_param_specs_shard_something_everywhere():
    """Every arch shards its embedding and at least one projection at
    model size 16 (the comparison above is not between two empty
    tables)."""
    for arch in treg.ARCHS:
        _, tt = _trees(arch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            flat = _port_flat_specs(tshard.param_specs(tt, model_size=16))
        assert flat[("embed",)] == ("model", None), arch
        assert sum("model" in s for s in flat.values()) > 1, arch


def test_param_divisibility_fallback_warns():
    params = {"wq": torch.empty((32, 13), device="meta"),
              "g": torch.empty((32,), device="meta")}
    with pytest.warns(UserWarning,
                      match=r"'wq' \(32, 13\).*16-way 'model'.*replicated"):
        specs = tshard.param_specs(params, model_size=16)
    assert specs["wq"] == ()
    assert specs["g"] == ()


def test_param_specs_divisible_no_warning(recwarn):
    specs = tshard.param_specs({"wq": torch.empty((32, 64), device="meta")},
                               model_size=16)
    assert specs["wq"] == (None, "model")
    assert not [w for w in recwarn.list
                if "replicated instead" in str(w.message)]


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------
def _fake_mesh(model=2, data=1):
    return types.SimpleNamespace(shape={"model": model, "data": data},
                                 axis_names=("data", "model"))


CACHE_CASES = [("gemma2-9b", {}), ("gemma2-9b", {"paged_kv": True,
                                                 "page_size": 8}),
               ("minicpm3-4b", {}), ("zamba2-1.2b", {}), ("xlstm-1.3b", {}),
               ("whisper-small", {})]


def _spec_leaves(tree) -> list:
    """The specs of a cache spec tree, in order, as tuples (a non-empty
    tuple of axis names / None is a spec; JAX's are ``P``s)."""
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    if isinstance(tree, tuple) and tree and not hasattr(tree, "_fields") \
            and all(e is None or isinstance(e, str) for e in tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _spec_leaves(v)]
    assert tree is None, type(tree)
    return []


def _jax_layer_specs(jspecs, cfg):
    """JAX's Caches specs as one entry per layer (the port's layout): the
    pattern's stacking lead dropped."""
    out = list(jspecs.prefix)
    for _ in range(cfg.repeats):
        for c in jspecs.pattern:
            out.append(jax.tree.map(lambda s: P(*tuple(s)[1:]), c,
                                    is_leaf=lambda x: isinstance(x, P)))
    return out + list(jspecs.suffix)


@pytest.mark.parametrize("model_size", (1, 2, 4))
@pytest.mark.parametrize("arch,cfg", CACHE_CASES,
                         ids=[f"{a}{'-paged' if c else ''}"
                              for a, c in CACHE_CASES])
def test_cache_specs_match_jax(arch, cfg, model_size):
    jm = jreg.build_model(treg.ALIASES[arch], reduced=True)
    if cfg:
        jm = jm.with_cfg(**cfg)
    tm = treg.build_model(arch, reduced=True, device="cpu", **cfg)
    mesh = _fake_mesh(model=model_size, data=2)
    jc = jax.eval_shape(lambda: jinit_caches(jm.cfg, 4, 32, jm.policy))
    jspecs = jshard.cache_specs(jm.cfg, jc, batch=4, mesh=mesh)
    # the same function on JAX's own tree
    same = tshard.cache_specs(jm.cfg, jc, batch=4, mesh=mesh)
    assert _spec_leaves(same) == _spec_leaves(jspecs)
    # and on the port's per-layer caches
    got = tshard.cache_specs(tm.cfg, tm.init_caches(4, 32), batch=4,
                             mesh=mesh)
    want = _jax_layer_specs(jspecs, tm.cfg)
    assert len(got) == len(want) == tm.cfg.n_layers
    for g, w in zip(got, want):
        fields = (dict(zip(g._fields, g)) if type(g).__name__ != "CrossCache"
                  else None)
        if fields is None:          # whisper: {"kv", "xkv"} in JAX's tree
            assert tuple(g.kv) == tuple(tuple(s) for s in w["kv"])
            assert tuple(g.xkv) == tuple(tuple(s) for s in w["xkv"])
        else:
            assert fields == {f: tuple(s) for f, s in
                              zip(w["kv"]._fields, w["kv"])}


def test_cache_specs_paged_leaves():
    from repro_torch.models.paged import PagedKVCache
    mk = lambda h: PagedKVCache(torch.empty((12, h, 8, 16), device="meta"),
                                torch.empty((12, h, 8, 16), device="meta"),
                                torch.empty((3, 4), dtype=torch.int32,
                                            device="meta"))
    got = tshard.cache_specs(None, [mk(4)], batch=3,
                             mesh=_fake_mesh(model=2), batch_axes=())[0]
    assert got.k_pool == (None, "model", None, None)
    assert got.v_pool == (None, "model", None, None)
    assert got.block_table == (None, None)
    bad = tshard.cache_specs(None, [mk(3)], batch=3,
                             mesh=_fake_mesh(model=2), batch_axes=())[0]
    assert bad.k_pool == (None, None, None, None)


def test_batch_and_input_specs():
    mesh = _fake_mesh(model=2, data=4)
    for batch in (1, 2, 4, 6, 8):
        assert (tshard.batch_spec_axes(batch, ("data",), mesh)
                == jshard.batch_spec_axes(batch, ("data",), mesh))
        assert (tshard.input_specs_train(batch, mesh)
                == tuple(jshard.input_specs_train(batch, mesh)))


# ---------------------------------------------------------------------------
# narrow partials (one device)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,shapes", [("ij,jk->ik", ((8, 64), (64, 16))),
                                         ("bsd,de->bse", ((2, 5, 64),
                                                          (64, 24)))])
def test_narrow_partials_against_jax(spec, shapes):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    jpol = JPRESETS["tp_bf16"].replace(narrow_partials=True)
    tpol = TPRESETS["tp_bf16"].replace(narrow_partials=True)
    want = np.asarray(jops.tp_einsum(spec, jnp.asarray(a), jnp.asarray(b),
                                     jpol).astype(jnp.float32))
    got = tops.tp_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                         tpol)
    assert got.dtype == torch.bfloat16
    # a bf16 product: both round one sum to bf16 (at most one bf16 ulp
    # apart where the frameworks' sum orders part)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    mm = tops.tp_matmul(torch.from_numpy(a), torch.from_numpy(b), tpol) \
        if spec == "ij,jk->ik" else got
    assert torch.equal(mm, got)
    # the accumulate type is the narrow output type only when narrower
    assert tops._acc_dtype(tpol, tpol.matmul.resolved_out()) == \
        torch.bfloat16
    assert tops._acc_dtype(tpol, tops.get_format("fp32")) == torch.float32


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_serving_mesh_validation():
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_serving_mesh(0, 1)
    m = tmesh.make_serving_mesh(1, 1)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 1,
                                                             "model": 1}
    assert m.coords == {"data": 0, "model": 0} and m.member
    subs = tmesh.replica_meshes(m)
    assert len(subs) == 1 and subs[0].axis_names == ("model",)
    assert subs[0].group("model").size == 1
    pod = tmesh.Mesh(("pod",), np.zeros((1,), int), 0,
                     {"pod": tmesh.Group([0])}, tmesh.Group([0]))
    with pytest.raises(ValueError, match="serving mesh"):
        tmesh.replica_meshes(pod)
    with pytest.raises(ValueError, match="requested"):
        tmesh.replica_meshes(m, 2)
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.replica_meshes(object(), 2)


def test_mesh_needs_enough_ranks():
    with pytest.raises(ValueError, match=r"mesh \(4096,\) needs 4096 "
                                         r"devices, have 1"):
        tmesh._mk_mesh((4096,), ("model",))
    with pytest.raises(ValueError, match="needs 256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_serving_mesh(2, 2)


def test_dp_axes_and_model_size():
    m = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                              shape={"pod": 2, "data": 16, "model": 16})
    assert tmesh.dp_axes_of(m) == ("pod", "data")
    assert tmesh.model_size(m) == 16 and tmesh.model_size(None) == 1
    assert tmesh.model_size(tmesh.make_serving_mesh(1, 1)) == 1


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------
def _coords_mesh(model, idx):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": model},
                                 coords={"data": 0, "model": idx})


@pytest.mark.parametrize("spec,dim", [((None, "model"), 1),
                                      (("model", None), 0),
                                      (("model", None, None), 0),
                                      ((None, "model", None), 1)])
def test_local_shard_blocks_rebuild_the_tensor(spec, dim):
    t = torch.arange(8 * 4 * (2 if len(spec) == 3 else 1),
                     dtype=torch.float32)
    t = t.reshape((8, 4, 2) if len(spec) == 3 else (8, 4))
    parts = [tshard.local_shard(t, spec, _coords_mesh(2, i))
             for i in range(2)]
    assert all(p.shape[dim] == t.shape[dim] // 2 for p in parts)
    assert torch.equal(torch.cat(parts, dim=dim), t)
    # a shard owns its storage: the full tensor can go
    assert parts[1].untyped_storage().data_ptr() != \
        t.untyped_storage().data_ptr()


def test_shard_params_follow_the_rules():
    tm = treg.build_model("gemma2-9b", reduced=True, device="cpu")
    params = tm.init(0)
    shards = [tshard.shard_params(params, _coords_mesh(2, i), tm.cfg)
              for i in range(2)]
    lay = [s["layers"][0] for s in shards]
    full = params["layers"][0]
    assert torch.equal(torch.cat([s["embed"] for s in shards]),
                       params["embed"])
    assert torch.equal(torch.cat([x["attn"]["wq"] for x in lay], 1),
                       full["attn"]["wq"])
    assert torch.equal(torch.cat([x["attn"]["wo"] for x in lay], 0),
                       full["attn"]["wo"])
    assert torch.equal(torch.cat([x["mlp"]["down"] for x in lay], 0),
                       full["mlp"]["down"])
    assert torch.equal(lay[0]["norm1"]["g"], full["norm1"]["g"])
    # heads that do not split whole keep the attention whole (4 heads,
    # 2 KV heads on a 4-way axis), the MLP still shards
    four = tshard.shard_params(params, _coords_mesh(4, 1), tm.cfg)
    assert torch.equal(four["layers"][0]["attn"]["wk"], full["attn"]["wk"])
    assert four["layers"][0]["mlp"]["gate"].shape[1] == \
        full["mlp"]["gate"].shape[1] // 4
    # no model axis: the params as they are
    assert tshard.shard_params(params, None) is params


# ---------------------------------------------------------------------------
# the fleet's host side (JAX's satellite tests, in the port)
# ---------------------------------------------------------------------------
def test_allocator_isolation():
    a, b = PageAllocator(8), PageAllocator(8)
    got_a = a.alloc(8)
    assert a.try_alloc(1) is None
    assert b.n_free == 8
    got_b = b.alloc(3)
    a.free(got_a[:4])
    assert b.n_live == 3 and b.n_free == 5
    assert a.n_free == 4
    b.free(got_b)
    assert a.peak_live == 8 and b.peak_live == 3


def test_replicated_partition_round_robin():
    eng = tengine.ReplicatedEngine.__new__(tengine.ReplicatedEngine)
    eng.engines = [object(), object()]
    reqs = [tengine.Request(rid=i, tokens=[1], max_new=1, arrival=a)
            for i, a in ((0, 5), (1, 0), (2, 0), (3, 2))]
    parts = tengine.ReplicatedEngine.partition(eng, reqs)
    assert [r.rid for r in parts[0]] == [1, 3]
    assert [r.rid for r in parts[1]] == [2, 0]
    # a sharded fleet holds only its own row's engine, the rows are many
    eng.engines, eng._rows = [object()], 3
    parts = tengine.ReplicatedEngine.partition(eng, reqs)
    assert [[r.rid for r in p] for p in parts] == [[1, 0], [2], [3]]
