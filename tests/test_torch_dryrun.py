"""The dry run (``repro_torch.launch.dryrun``) against real steps, on the
CPU, at reduced sizes:

  * on a one-rank ``(1, 1)`` mesh the dry run of each kind of step (train,
    prefill, decode; meta tensors on the CPU's op path) counts exactly
    what the same counters count around the same step on real CPU tensors:
    FLOPs (``FlopCounterMode``), bytes, transcendentals and every memory
    figure; its argument bytes are the real tensors' bytes;
  * on ``(1, 2)`` and ``(2, 2)`` its collective table (``op@group_size``:
    calls and output bytes) and FLOPs equal what rank 0 of a real gloo run
    of the same step records (one spawn of four ranks for every cell);
  * the CLI runs one reduced cell of each kind on the production mesh,
    ``--multi-pod`` and ``--costs``, and keeps JAX's skip rules;
  * a dry group refuses tensors with values.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, spmd  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402

torch.set_num_threads(1)

#: (shape, seq, batch) of the reduced steps
KINDS = (("train_4k", 32, 4), ("prefill_32k", 32, 2), ("decode_32k", 32, 2))


def _storage_bytes(tree) -> int:
    seen = {}
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            seen[t.untyped_storage()._cdata] = t.numel() * t.element_size()
    return sum(seen.values())


@pytest.mark.parametrize("shape,seq,batch", KINDS, ids=[k[0] for k in KINDS])
def test_dry_counts_equal_the_real_step(shape, seq, batch):
    cfg = get_config("gemma2-9b", reduced=True)
    mesh = dryrun.dry_mesh(shape=(1, 1))
    step, args = dryrun.build_step(cfg, shape, mesh, "tp_bf16", seq=seq,
                                   batch=batch)
    dry = dryrun.count(step, args, card=False)
    step, real_args = dryrun.build_step(cfg, shape, mesh, "tp_bf16",
                                        device="cpu", seq=seq, batch=batch)
    assert all(t.device.type == "cpu" for t in
               torch.utils._pytree.tree_leaves(real_args)
               if isinstance(t, torch.Tensor))
    real_bytes = _storage_bytes(real_args)
    real = dryrun.count(step, real_args, card=False)
    assert dry["flops"] == real["flops"] > 0
    assert dry["memory"]["argument_bytes"] == real_bytes
    assert dry["memory"] == real["memory"]
    assert dry["bytes"] == real["bytes"] > 0
    assert dry["transcendentals"] == real["transcendentals"] > 0
    assert dry["coll"] == real["coll"] == {}
    if shape == "decode_32k":           # the caches are written in place
        assert dry["memory"]["alias_bytes"] > 0


#: the cells of the gloo comparison: gemma2 (heads split at 2) in each
#: kind across the two meshes, qwen3-moe's decode (expert all-to-all)
GLOO_CELLS = [("gemma2-9b", "train_4k", (1, 2), 16, 4),
              ("gemma2-9b", "decode_32k", (1, 2), 16, 2),
              ("gemma2-9b", "train_4k", (2, 2), 16, 4),
              ("gemma2-9b", "prefill_32k", (2, 2), 16, 2),
              ("qwen3-moe-30b-a3b", "decode_32k", (2, 2), 16, 2)]


def test_dry_collectives_equal_a_gloo_run():
    ranks = spmd.spawn(dryrun.real_rank, 4, backend="gloo",
                       args=(GLOO_CELLS,), timeout=240)
    for (arch, shape, ms, seq, batch), real in zip(GLOO_CELLS, ranks[0]):
        mesh = dryrun.dry_mesh(shape=ms)
        step, args = dryrun.build_step(get_config(arch, reduced=True), shape,
                                       mesh, "tp_bf16", seq=seq, batch=batch)
        dry = dryrun.count(step, args, card=False)
        where = (arch, shape, ms)
        assert dry["coll"] == real["coll"], where
        assert dry["flops"] == real["flops"], where
        assert dry["coll"], where
        if arch.startswith("qwen3"):
            assert f"all-to-all@{ms[1]}" in dry["coll"]
    # ranks outside (1, 2) ran nothing there
    assert ranks[2][0] is None and ranks[2][2] is not None


@pytest.mark.parametrize("argv", [
    ["--shape", "train_4k"], ["--shape", "prefill_32k"],
    ["--shape", "decode_32k", "--multi-pod"],
    ["--shape", "decode_32k", "--costs"]],
    ids=["train", "prefill", "decode-pod2", "decode-costs"])
def test_cli_reduced_cells(argv, tmp_path, capsys):
    out = tmp_path / "rec.json"
    rec = dryrun.main(["--arch", "gemma2-9b", "--reduced", "--json",
                       str(out)] + argv)
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["ok"] and rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["mesh"] == ("2x16x16" if "--multi-pod" in argv else "16x16")
    assert rec["coll"] and all("@16" in k for k in rec["coll"])
    if "--costs" in argv:
        assert rec["params"] == get_config("gemma2-9b",
                                           reduced=True).param_counts()
        assert "memory" not in rec and rec["method"]
    else:
        m = rec["memory"]
        assert m["peak_bytes"] >= m["argument_bytes"] > 0
    if argv[1] == "decode_32k":
        assert rec["memory" if "--costs" not in argv else "coll"]


def test_cli_skip_rules(capsys):
    rec = dryrun.main(["--arch", "gemma2-9b", "--reduced", "--shape",
                       "long_500k"])
    assert not rec["ok"] and "long_500k" in rec["skipped"]
    rec = dryrun.main(["--arch", "gemma2-9b", "--reduced", "--shape",
                       "decode_32k", "--compress", "fp8"])
    assert not rec["ok"] and "compress" in rec["skipped"]
    from repro.launch import dryrun as jdryrun
    assert list(dryrun.all_cells()) == list(jdryrun.all_cells())
    assert dryrun.SHAPES == jdryrun.SHAPES
    assert dryrun.ARCH_IDS == jdryrun.ARCH_IDS


def test_dry_group_refuses_values():
    mesh = dryrun.dry_mesh(shape=(1, 2))
    with pytest.raises(ValueError, match="meta tensors only"):
        spmd.all_reduce_sum(torch.ones(3), mesh.group("model"))
    got = spmd.all_gather(torch.empty((2, 3), device="meta"),
                          mesh.group("model"), dim=0)
    assert got.shape == (4, 3) and got.device.type == "meta"


def test_s_linear_prefill_is_exact_on_reduced_xlstm(monkeypatch):
    """The sLSTM prefill's extrapolation from two lengths equals the count
    at a third in every summed figure (flops, bytes, transcendentals,
    collectives; 4 and 8 mLSTM chunks of 4 tokens, extrapolated to 16).
    The peak is an estimate (a maximum, not a sum), and the record says
    so."""
    sets = ["mlstm.chunk=4"]
    cfg = dryrun._apply_sets(get_config("xlstm-1.3b", reduced=True), sets)
    assert dryrun.s_linear(cfg, "prefill_32k") == dryrun.S_LINEAR
    assert dryrun.s_linear(cfg, "train_4k") is None
    assert dryrun.s_linear(get_config("gemma2-9b"), "prefill_32k") is None
    mesh = dryrun.dry_mesh(shape=(1, 2))
    r1, r2, r3 = (dryrun.count(*dryrun.build_step(
        cfg, "prefill_32k", mesh, "tp_bf16", seq=s, batch=4))
        for s in (16, 32, 64))
    got = dryrun._affine(r1, r2, (64 - 16) / (32 - 16))
    summed = ("flops", "bytes", "transcendentals", "coll")
    assert {k: got[k] for k in summed} == {k: r3[k] for k in summed}
    assert got["memory"]["argument_bytes"] == r3["memory"]["argument_bytes"]
    # the record names the method
    monkeypatch.setattr(dryrun, "S_LINEAR", (16, 32))
    monkeypatch.setitem(dryrun.SHAPES, "prefill_32k",
                        dict(seq=64, batch=4, kind="prefill"))
    rec = dryrun.run_cell("xlstm-1.3b", "prefill_32k", False, "tp_bf16",
                          sets=sets, reduced=True, mesh_shape=(1, 2))
    assert rec["method"].startswith("S-linear")
    assert "peak an affine estimate" in rec["method"]
    assert {k: rec[k] for k in summed} == {k: r3[k] for k in summed}
