"""The trainer's checkpoints, data, fault tolerance and launcher in the
port, against the JAX package where it has a twin, on reduced
fpnew-case-study; and the kernel wrappers' refusal of inputs that
require grad.

* checkpoints: the JAX file format both ways, bit for bit (JAX's
  ``TrainLoop`` checkpoint restores into the port's loop, which runs on;
  JAX's ``restore_pytree`` reads the port's), bf16 / fp8 / f16 / int
  leaves round-tripped bitwise, keep-N, atomicity, the host copy made
  before the writer thread starts;
* data: determinism under restart, host partitioning, the learnable
  progression (the numpy draws differ from JAX's threefry ones);
* faults: the loss falls by 0.5 in 30 steps (the JAX suite's bar), a
  restart resumes from its checkpoint and reproduces the uninterrupted
  run bitwise (stochastic re-quantisation included), ``StragglerMonitor``
  and ``FailurePlan`` act as JAX's on the same series.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro.train.loop import LoopConfig as JLoopConfig  # noqa: E402
from repro.train.loop import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch.ckpt.checkpoint import (  # noqa: E402
    CheckpointManager, restore_pytree, save_pytree)
from repro_torch.core.tree import flatten_with_paths, leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.fault import (  # noqa: E402
    FailurePlan, StragglerMonitor, run_with_restarts)
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402

torch.set_num_threads(1)

ARCH = "fpnew-case-study"


def _tmodel(policy):
    return build_model(ARCH, policy=policy, reduced=True, device="cpu",
                       prefill_backend="dense")


def _same_paths(jtree, ttree):
    """Both trees' leaves by keystr path, asserting the paths agree."""
    jflat = [(jax.tree_util.keystr(p), v) for p, v in
             jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tflat = flatten_with_paths(ttree)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    return [(p, j, t) for (p, j), (_, t) in zip(jflat, tflat)]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _jax_loop(tmp, total, **kw):
    from repro.models.registry import build_model as jbuild
    jm = jbuild(ARCH, policy="tp_bf16", reduced=True)
    return JTrainLoop(jm, jopt.OptConfig(lr=3e-3, warmup_steps=2,
                                         total_steps=total),
                      JDataConfig(vocab=256, seq_len=32, global_batch=4),
                      JLoopConfig(total_steps=total, log_every=0,
                                  ckpt_every=4, ckpt_dir=str(tmp), **kw))


def _port_loop(tmp, total, policy="tp_bf16", plan=None, ckpt_every=4):
    """The JAX suite's ``_mk_loop`` in the port (checkpoints every 4)."""
    return TrainLoop(_tmodel(policy),
                     topt.OptConfig(lr=3e-3, warmup_steps=5,
                                    total_steps=total, weight_decay=0.0),
                     DataConfig(vocab=256, seq_len=64, global_batch=8,
                                noise=0.0),
                     LoopConfig(total_steps=total, log_every=0,
                                ckpt_every=ckpt_every, ckpt_dir=str(tmp)),
                     failure_plan=plan)


def test_port_restores_a_jax_checkpoint_and_continues(tmp_path):
    jl = _jax_loop(tmp_path, 8)
    jl.run()
    loop = _port_loop(tmp_path, 12)
    assert loop.step == 8 and loop.data.step == 8
    for p, want, got in _same_paths({"params": jl.params,
                                     "opt": jl.opt_state},
                                    loop.state_tree()):
        w = np.asarray(want)
        if w.dtype == ml_dtypes.bfloat16:
            w = w.view(np.uint16)
            got = got.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=p)
    log = loop.run()
    assert [r["step"] for r in log] == [8, 9, 10, 11]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert loop.ckpt.latest_step() == 12


def test_jax_reads_a_port_checkpoint(tmp_path):
    loop = _port_loop(tmp_path, 4)
    loop.run()
    jl = _jax_loop(tmp_path / "jax_like", 4)
    like = {"params": jl.params, "opt": jl.opt_state}
    tree, extra = jckpt.restore_pytree(loop.ckpt.path(4), like)
    assert extra["step"] == 4 and extra["data"] == {"step": 4}
    for p, got, mine in _same_paths(tree, loop.state_tree()):
        g = np.asarray(got)
        if g.dtype == ml_dtypes.bfloat16:
            assert mine.dtype == torch.bfloat16
            g = g.view(np.uint16)
            mine = mine.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(g, np.asarray(mine), err_msg=p)


def test_checkpoint_roundtrip_bf16_bitwise(tmp_path):
    bits = torch.from_numpy(np.array(
        [0x3F80, 0x7F80, 0xFF80, 0x7FC1, 0x0001, 0x8000], np.uint16).view(
            np.int16)).view(torch.bfloat16)
    tree = {"a": bits.reshape(2, 3),
            "b": (torch.tensor(3.5), torch.arange(4, dtype=torch.int32)),
            "k": torch.zeros((2,), dtype=torch.float16),
            "f8": torch.tensor([1.0, -2.5, 57344.0]).to(torch.float8_e5m2)}
    save_pytree(str(tmp_path / "c"), tree, {"step": 7})
    got, extra = restore_pytree(str(tmp_path / "c"), tree)
    assert extra["step"] == 7
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        raw = {2: torch.int16, 1: torch.int8, 4: torch.int32}[
            a.element_size()]
        assert torch.equal(a.view(raw), b.view(raw))
    # and JAX's reader takes the port's bf16 leaf bit for bit
    like = {"a": np.zeros((2, 3), ml_dtypes.bfloat16),
            "b": (np.float32(0), np.zeros(4, np.int32)),
            "f8": np.zeros(3, ml_dtypes.float8_e5m2),
            "k": np.zeros(2, np.float16)}
    jt, _ = jckpt.restore_pytree(str(tmp_path / "c"), like)
    assert np.array_equal(np.asarray(jt["a"]).view(np.uint16).ravel(),
                          bits.view(torch.int16).numpy().view(np.uint16))


def test_checkpoint_manager_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones((2,))}
    for s in (10, 20, 30):
        mgr.save(s, tree, sync=True)
    assert mgr.latest_step() == 30
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [20, 30]
    step, got, extra = mgr.restore_latest(tree)
    assert step == 30 and extra["step"] == 30


def test_checkpoint_atomic_no_partial_state(tmp_path):
    """A tmp dir left by a 'crashed' save must not shadow the real one,
    and the next save of that step replaces the debris."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones((2,))}
    mgr.save(5, tree, sync=True)
    os.makedirs(str(tmp_path / "step_00000009.tmp"))
    assert mgr.latest_step() == 5
    mgr.save(9, {"w": torch.full((2,), 3.0)}, sync=True)
    assert mgr.latest_step() == 9
    assert not os.path.exists(tmp_path / "step_00000009.tmp")
    assert float(mgr.restore_latest(tree)[1]["w"][0]) == 3.0


def test_async_save_copies_to_the_host_first(tmp_path):
    """Overwriting a tensor in place after ``save`` returns leaves the
    checkpoint with the values at the call."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save(1, {"w": w})
    w.fill_(-1.0)
    _, got, _ = mgr.restore_latest({"w": w})
    assert torch.equal(got["w"], torch.arange(1 << 16, dtype=torch.float32))


def test_restore_refuses_another_structure(tmp_path):
    save_pytree(str(tmp_path / "c"), {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="target structure"):
        restore_pytree(str(tmp_path / "c"), {"v": torch.ones(2)})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_data_deterministic_and_restartable():
    cfg = DataConfig(vocab=512, seq_len=64, global_batch=8)
    d1 = SyntheticLMData(cfg)
    batches = [next(d1) for _ in range(3)]
    d2 = SyntheticLMData(cfg)
    d2.load_state_dict({"step": 2})
    b2 = next(d2)
    assert torch.equal(batches[2]["tokens"], b2["tokens"])
    assert torch.equal(batches[2]["labels"], b2["labels"])
    assert d2.state_dict() == {"step": 3}
    assert b2["tokens"].dtype == torch.int32
    assert torch.equal(b2["tokens"][:, 1:], b2["labels"][:, :-1])
    other = SyntheticLMData(dataclasses.replace(cfg, seed=1)).batch_at(2)
    assert not torch.equal(other["tokens"], b2["tokens"])


def test_data_host_sharding_partitions_batch():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=8)
    h0 = SyntheticLMData(cfg, host_index=0, host_count=2).batch_at(0)
    h1 = SyntheticLMData(cfg, host_index=1, host_count=2).batch_at(0)
    assert h0["tokens"].shape == (4, 32)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    again = SyntheticLMData(cfg, host_index=1, host_count=2).batch_at(0)
    assert torch.equal(h1["tokens"], again["tokens"])


def test_data_is_learnable_structure():
    """Tokens follow the arithmetic progression (noise 0); with noise the
    corrupted fraction is near ``noise``."""
    cfg = DataConfig(vocab=512, seq_len=128, global_batch=4, noise=0.0)
    t = SyntheticLMData(cfg).batch_at(0)["tokens"].numpy()
    d = np.diff(t, axis=1) % cfg.vocab
    assert (d == d[:, :1]).all()
    assert ((d[:, 0] >= 1) & (d[:, 0] <= cfg.max_stride)).all()
    noisy = DataConfig(vocab=512, seq_len=512, global_batch=16, noise=0.1)
    a = SyntheticLMData(noisy).batch_at(3)["tokens"].numpy()
    b = SyntheticLMData(dataclasses.replace(noisy, noise=0.0)).batch_at(
        3)["tokens"].numpy()
    assert 0.05 < (a != b).mean() < 0.15
    # a frontend adds its embeddings beside the same tokens
    fr = SyntheticLMData(dataclasses.replace(
        cfg, frontend="patch", n_frontend_tokens=8, d_model=16)).batch_at(0)
    assert fr["frontend_embeds"].shape == (4, 8, 16)
    assert (fr["tokens"].numpy() == t).all()
    with pytest.raises(ValueError, match="frontend"):
        SyntheticLMData(dataclasses.replace(cfg, frontend="video"))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def test_loop_loss_decreases(tmp_path):
    loop = _port_loop(tmp_path, 30, ckpt_every=0)
    log = loop.run()
    first = np.mean([m["loss"] for m in log[:5]])
    last = np.mean([m["loss"] for m in log[-5:]])
    assert last < first - 0.5, (first, last)


def test_loop_restart_after_failure_resumes_not_restarts(tmp_path):
    plan = FailurePlan(fail_at=(13,))

    def make():
        return _port_loop(tmp_path, 24, plan=plan)

    loop, restarts = run_with_restarts(make, max_restarts=2)
    assert restarts == 1 and loop.step == 24
    assert loop.metrics_log[0]["step"] == 12      # the step-12 checkpoint


@pytest.mark.parametrize("policy", ["tp_bf16", "prod_tp"])
def test_restart_reproduces_uninterrupted_run(tmp_path, policy):
    """Crash + restore == never crashed, bit for bit: params, master and
    moments; under ``prod_tp`` the stochastic re-quantisation too."""
    a = _port_loop(tmp_path / "a", 12, policy)
    a.run()
    plan = FailurePlan(fail_at=(10,))
    b, restarts = run_with_restarts(
        lambda: _port_loop(tmp_path / "b", 12, policy, plan), max_restarts=1)
    assert restarts == 1 and b.metrics_log[0]["step"] == 8
    for x, y in zip(leaves(a.state_tree()), leaves(b.state_tree())):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_straggler_monitor_and_failure_plan_match_jax():
    rs = np.random.default_rng(3)
    dts = list(rs.uniform(0.9, 1.1, 60))
    for i in (7, 8, 20, 33, 34, 35, 50):
        dts[i] *= rs.uniform(1.5, 6.0)
    for kw in (dict(), dict(alpha=0.5, threshold=2.0, warmup=3),
               dict(alpha=0.2, threshold=1.4, warmup=0)):
        mine, theirs = StragglerMonitor(**kw), jfault.StragglerMonitor(**kw)
        flags = [(mine.record(i, dt), theirs.record(i, dt))
                 for i, dt in enumerate(dts)]
        assert all(a == b for a, b in flags)
        assert mine.flagged == theirs.flagged and mine.ewma == theirs.ewma
    assert any(a for a, _ in flags)
    plan, jplan = FailurePlan(fail_at=(2, 5)), jfault.FailurePlan(
        fail_at=(2, 5))
    for step in (0, 2, 2, 5, 3, 5):
        raised = []
        for p in (plan, jplan):
            try:
                p.maybe_fail(step)
                raised.append(None)
            except RuntimeError as e:
                raised.append(str(e))
        assert raised[0] == raised[1]


# ---------------------------------------------------------------------------
# the launcher, and no kernel under autograd
# ---------------------------------------------------------------------------
def test_launcher_runs_three_steps_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--device", "cpu", "--steps", "3", "--seq-len", "32",
                  "--global-batch", "4", "--ckpt-dir", str(tmp_path),
                  "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "done: 3 steps, final loss" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]


class _Launched(Exception):
    pass


def _stub(*args, **kwargs):
    raise _Launched


_WRAPPERS = {
    "flash_attention": ("flash_attention_cuda", lambda x: kops.flash_attention(
        x.reshape(1, 2, 4, 8), x.reshape(1, 2, 4, 8), x.reshape(1, 2, 4, 8),
        backend="kernel")),
    "decode_attention": ("decode_attention_cuda", lambda x: kops.decode_attention(
        x.reshape(4, 2, 1, 8)[:1], x.reshape(1, 2, 8, 4).transpose(2, 3)
        .reshape(1, 2, 4, 8), x.reshape(1, 2, 4, 8), kv_len=4,
        backend="kernel")),
    "tp_matmul": ("tp_matmul_cuda", lambda x: kops.tp_matmul(
        x.reshape(8, 8), x.reshape(8, 8))),
    "tp_quantize": ("tp_quantize_cuda", lambda x: kops.tp_quantize(
        x.reshape(8, 8), fmt="fp8")),
    "cast_and_pack": ("cast_and_pack_cuda", lambda x: kops.cast_and_pack(
        x.reshape(8, 8), x.reshape(8, 8), fmt="fp8")),
    "dotp_ex": ("dotp_ex_cuda", lambda x: kops.dotp_ex(x, x)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_kernel_wrappers_refuse_inputs_that_require_grad(monkeypatch, name):
    """On the kernel route, a wrapper given an input that requires grad
    under grad mode raises (the kernels have no backward) and never
    launches; under ``no_grad`` it launches.  The route is forced here, as
    a CUDA tensor would force it; the launch is a stub."""
    cuda_fn, call = _WRAPPERS[name]
    monkeypatch.setattr(kops, cuda_fn, _stub)
    monkeypatch.setattr(kops, "_on_card", lambda x: True)
    monkeypatch.setattr(kops, "resolve_backend", lambda b, d: "kernel")
    x = torch.randn(64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    with torch.no_grad(), pytest.raises(_Launched):
        call(x)
    with pytest.raises(_Launched):
        call(x.detach())
