"""The sharded serving path across ranks: ``torch.distributed`` over gloo
on the CPU, at world sizes 2 and 4, against the unsharded port in this
process (and, for the logits, the JAX package's unsharded model).  The
claims are ``tests/test_sharded_serving.py``'s, at its sizes (``B, S, DM,
H, HKV, HD = 2, 16, 32, 8, 8, 16``):

  * every attend route (dense and kernel; contiguous and paged prefill
    and decode; verify; cross) is BITWISE per head at tp 2 and tp 4;
  * the row-parallel ``wo``: bitwise under ``tp_bf16`` (its output snap
    absorbs the f32 reduction order), within 1e-5 under ``fp32``;
  * reduced gemma2's ``fp32`` logits at tp 2 within ``test_torch_model``'s
    tolerance of JAX's unsharded model, and 1e-5 of the port's;
  * engine greedy tokens at tp 2 (and at tp 4, where 2 KV heads do not
    split and attention runs whole beside sharded MLPs and vocab) equal
    the unsharded port's;
  * ``ReplicatedEngine`` on ``(2, 1)`` and ``(2, 2)``: streams, order and
    the stats identities of JAX's
    ``test_replicated_engine_token_parity_and_stats``;
  * MoE expert parallelism at tp 2 against the local path: router indices
    and the dropped (token, slot) set exact, y within 2e-5, aux within
    1e-5 (JAX's ``test_moe_ep_on_model_only_mesh`` bounds);
  * the launcher's ``--mesh 1,2 --dist-backend gloo`` (gemma2 and MLA's
    minicpm3), and ``--mesh 2,1`` with ``--fault-replica`` / ``--journal``
    against the meshless ``--replicas 2`` fleet.

One spawn per world size (a module-scoped fixture) runs every case; the
ranks return their results through ``launch.spmd.spawn``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from conftest import cached_model  # noqa: E402

from repro_torch.core.policy import PRESETS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import sharded_checks as sc  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)

#: seconds before a hung rank's spawn is killed (the spawns take ~35 s)
SPAWN_S = 300
RTOL, ATOL = 5e-2, 1e-1          # tests/test_torch_model.py's bf16 bounds
NARROW = PRESETS["tp_bf16"].replace(narrow_partials=True)

READS = [name.format(be=be) for be in ("dense", "auto")
         for name in ("prefill_{be}", "paged_prefill_{be}_0",
                      "paged_prefill_{be}_4", "decode_{be}",
                      "paged_decode_{be}", "verify_{be}",
                      "paged_verify_{be}", "cross_{be}",
                      "cross_decode_{be}")]


def _weights(policy="tp_bf16", **cfg):
    _, jp = cached_model("gemma2-9b", policy=policy, **cfg)
    return from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def inputs():
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 12), 0, 256))
    return {"fp32": _weights("fp32"),
            "paged": _weights(paged_kv=True, page_size=16),
            "tokens": torch.from_numpy(toks)}


def _plan(inputs, world):
    eng = {"params": inputs["paged"]}
    if world == 2:
        return [("attend", "attend", (1, 2), {}),
                ("logits", "logits", (1, 2),
                 {"params": inputs["fp32"], "tokens": inputs["tokens"]}),
                ("logits_narrow", "logits", (1, 2),
                 {"params": inputs["paged"], "tokens": inputs["tokens"],
                  "policy": NARROW}),
                ("engine", "engine", (1, 2), eng),
                ("replicated", "replicated", (2, 1), eng),
                ("moe", "moe", (1, 2), {}),
                ("moe_drops", "moe", (1, 2), {"capacity_factor": 0.25})]
    return [("attend", "attend", (1, 4), {}),
            ("engine", "engine", (1, 4), eng),
            ("replicated", "replicated", (2, 2), eng)]


def _unsharded(plan):
    return sc.run_plan([(n, c, None, kw) for n, c, dims, kw in plan
                        if c != "replicated"])


@pytest.fixture(scope="module")
def world2(inputs):
    plan = _plan(inputs, 2)
    return _unsharded(plan), spmd.spawn(sc.rank_main, 2, backend="gloo",
                                        args=(plan,), timeout=SPAWN_S)


@pytest.fixture(scope="module")
def world4(inputs):
    plan = _plan(inputs, 4)
    return _unsharded(plan), spmd.spawn(sc.rank_main, 4, backend="gloo",
                                        args=(plan,), timeout=SPAWN_S)


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("read", READS)
def test_attend_per_head_bitexact(request, world, read):
    ref, ranks = _world(request, world)
    want = ref["attend"][read]
    for out in ranks:
        got = out["attend"][read]
        assert torch.equal(got, sc.head_slice(want, out["rank"], world)), \
            (read, out["rank"])


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("form", ("proj", "proj_decode"))
def test_projection_bitexact_under_bf16_snap(request, world, form):
    ref, ranks = _world(request, world)
    for out in ranks:
        assert torch.equal(out["attend"][f"{form}_tp_bf16"],
                           ref["attend"][f"{form}_tp_bf16"])


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("form", ("proj", "proj_decode"))
def test_projection_allclose_fp32(request, world, form):
    ref, ranks = _world(request, world)
    want = ref["attend"][f"{form}_fp32"]
    for out in ranks:
        got = out["attend"][f"{form}_fp32"]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        # every rank holds the same sum
        assert torch.equal(got, ranks[0]["attend"][f"{form}_fp32"])


# ---------------------------------------------------------------------------
# the model and the engines
# ---------------------------------------------------------------------------
def test_full_model_logits_against_jax(world2, inputs):
    ref, ranks = world2
    jm, jp = cached_model("gemma2-9b", policy="fp32")
    want = np.asarray(jax.jit(lambda p, t: jm.prefill(p, t, max_len=24))(
        jp, inputs["tokens"].numpy())[0])
    for out in ranks:
        got = out["logits"]["logits"]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))
        torch.testing.assert_close(got, ref["logits"]["logits"], rtol=0,
                                   atol=1e-5)


def test_narrow_partials_across_ranks(world2):
    """``narrow_partials``: the MLPs' row-parallel partials come out in
    bf16 and are summed in bf16 in rank order, not in f32; reduced
    gemma2's logits stay within the bf16 model-level bound of the
    unsharded model's (where the one-device product's accumulate type is
    bf16 too), argmax equal."""
    ref, ranks = world2
    want = ref["logits_narrow"]["logits"]
    for out in ranks:
        got = out["logits_narrow"]["logits"]
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert torch.equal(got, ranks[0]["logits_narrow"]["logits"])


@pytest.mark.parametrize("world", (2, 4))
def test_engine_tp_token_parity(request, world):
    ref, ranks = _world(request, world)
    for out in ranks:
        assert out["engine"]["tokens"] == ref["engine"]["tokens"]
        assert out["engine"]["rids"] == ref["engine"]["rids"]
        assert out["engine"]["spmd"]["collectives"] > 0


@pytest.mark.parametrize("world", (2, 4))
def test_replicated_engine_token_parity_and_stats(request, world):
    ref, ranks = _world(request, world)
    base = ref["engine"]
    for out in ranks:
        rep = out["replicated"]
        assert rep["tokens"] == base["tokens"]
        assert rep["rids"] == base["rids"]
        assert rep["stats"]["replicas_n"] == 2
        assert len(rep["replica_rounds"]) == 2
        assert rep["pool"]["n_pages"] == sum(rep["pool"]["replica_pages"])
        assert rep["stats"]["decode_rounds"] == sum(rep["replica_rounds"])
        # every rank returns the fleet's result
        assert rep == ranks[0]["replicated"] | {"spmd": rep["spmd"]}


@pytest.mark.parametrize("case", ("moe", "moe_drops"))
def test_moe_ep_on_model_only_mesh(world2, case):
    ref, ranks = world2
    want = ref[case]
    if case == "moe_drops":
        assert int(want["dropped"].sum()) > 0
    for out in ranks:
        got = out[case]
        assert torch.equal(got["idx"], want["idx"])
        assert torch.equal(got["dropped"], want["dropped"])
        torch.testing.assert_close(got["y"], want["y"], rtol=2e-5,
                                   atol=2e-5)
        torch.testing.assert_close(got["aux"], want["aux"], rtol=1e-5,
                                   atol=0)
        assert got["spmd"]["collectives"] > 0


def test_launcher_mesh_gloo(capfd):
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen", "4"]
    want = serve.main(argv)
    got = serve.main(argv + ["--mesh", "1,2", "--dist-backend", "gloo"])
    out = capfd.readouterr().out        # rank 0 prints, in its process
    assert torch.equal(got, want)
    assert "serving mesh: 1 data-parallel replica(s) x 2-way" in out


def test_launcher_mesh_flag_errors(capsys):
    for argv, msg in ((["--mesh", "2,1"], "requires --continuous"),
                      (["--mesh", "0,2"], ">= 1"),
                      (["--mesh", "1,2", "--loop", "python"], "--loop"),
                      (["--mesh", "1,2"], "gloo with --device cpu"),
                      (["--continuous", "--mesh", "2,1", "--replicas", "2"],
                       "exclusive"),
                      (["--continuous", "--mesh", "1,2", "--dist-backend",
                        "gloo", "--fault-replica", "0:3"],
                       "needs a replicated engine")):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu"] + argv)
        assert msg in capsys.readouterr().err, argv


def _ha_lines(out: str) -> list:
    """The launcher's per-request and ``replica HA`` lines (the rest
    carries timings and the engine's count of stragglers)."""
    return [ln for ln in out.splitlines()
            if ln.startswith("  req") or ln.startswith("replica HA")]


@pytest.mark.parametrize("flags", (
    ["--fault-replica", "0:3"],
    ["--fault-replica", "0:3:hang", "--preempt", "swap"],
    ["--fault-replica", "0:3", "--journal"]),
    ids=("kill", "hang", "journal"))
def test_launcher_mesh_fleet_faults(capfd, tmp_path, flags):
    """``--mesh 2,1`` takes ``--fault-replica`` and ``--journal`` (on a mesh
    with dp > 1) and serves as the meshless ``--replicas 2`` fleet does:
    the same per-request lines, the same ``replica HA`` line, and the
    journal file byte for byte."""
    def run(tag, fleet):
        argv = ["--continuous", "--device", "cpu"] + fleet + flags
        if argv[-1] == "--journal":
            argv.append(str(tmp_path / f"{tag}.jsonl"))
        serve.main(argv)
        return capfd.readouterr().out
    want = run("replicas", ["--replicas", "2"])
    got = run("mesh", ["--mesh", "2,1", "--dist-backend", "gloo"])
    assert "serving mesh: 2 data-parallel replica(s)" in got
    assert _ha_lines(got) == _ha_lines(want)
    assert "1 kills" in got or "1 hangs" in got
    if flags[-1] == "--journal":
        assert (tmp_path / "mesh.jsonl").read_bytes() == \
            (tmp_path / "replicas.jsonl").read_bytes()


def test_launcher_tp_mesh_journal_has_one_writer(capfd, tmp_path):
    """``--mesh 1,2 --journal``: both ranks run the one replica's
    scheduler, and only global rank 0 writes the file — the bytes the
    unsharded ``--journal`` writes, each record once."""
    def run(tag, mesh):
        path = tmp_path / f"{tag}.jsonl"
        serve.main(["--continuous", "--device", "cpu", "--requests", "4",
                    "--journal", str(path)] + mesh)
        return capfd.readouterr().out, path.read_bytes()
    want_out, want = run("plain", [])
    got_out, got = run("mesh", ["--mesh", "1,2", "--dist-backend", "gloo"])
    assert "serving mesh: 1 data-parallel replica(s) x 2-way" in got_out
    assert _ha_lines(got_out) == _ha_lines(want_out)
    assert got.count(b'"kind":"admit"') == 4
    assert got == want


def test_launcher_serves_minicpm3_on_a_mesh(capfd):
    """``--arch minicpm3-4b --mesh 1,2``: MLA's heads split over two gloo
    ranks, the tokens the unsharded launcher's."""
    argv = ["--device", "cpu", "--arch", "minicpm3-4b", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    want = serve.main(argv)
    got = serve.main(argv + ["--mesh", "1,2", "--dist-backend", "gloo"])
    assert "2-way" in capfd.readouterr().out
    assert torch.equal(got, want)
