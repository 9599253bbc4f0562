"""The training loop: data + step + checkpoint + fault handling, the JAX
package's ``train/loop.py`` on one device.

``TrainLoop`` builds the params (``Model.init(seed)`` stacked into JAX's
layout by ``stack_layers``), the optimizer state and the data, restores
the latest checkpoint of ``ckpt_dir`` if there is one, then runs: a
batch is ``batch_at(step)``, so a restarted loop repeats the batches of
an uninterrupted one.  Safe to re-instantiate after a crash
(``run_with_restarts`` does exactly that).  An injected failure
(:class:`SimulatedFailure`) first lets the loop's in-flight checkpoint
write finish: the node dies after its last save is durable, which is
what the restart reads.

Under a ``(data, model)`` mesh, any arch (every rank of it runs the
loop, as JAX's one program does): ``dp_axes = ("data",)`` as JAX's loop
sets it (a ``pod`` axis then replicates; ``make_train_step(dp_axes=
("pod", "data"))`` is the step over both), the params are this rank's
``shard_params``, each data rank takes its rows of the global
``batch_at(step)`` (so the run is the unsharded one's, batch for batch),
the compressed sync's error feedback is carried and checkpointed under
``"ef"``, and global rank 0 logs.  A checkpoint holds whole leaves in
JAX's format (the shards gathered first, the error feedback ``[n_dp,
...]``), written by global rank 0; a restore cuts them for this mesh,
whatever mesh wrote them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticLMData
from ..launch import spmd
from ..models.convert import stack_layers
from ..models.sharding import gather_whole, map_specs, shard_params
from ..models.transformer import Model
from ..optim.optimizer import OptConfig, init_opt_state
from .fault import FailurePlan, SimulatedFailure, StragglerMonitor
from .train_step import (init_error_feedback, local_rows, make_train_step,
                         param_layout)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    compress_grads: Optional[str] = None
    remat: bool = True
    seed: int = 0


class TrainLoop:
    """Build everything, optionally restore, run (on every rank of
    ``mesh``)."""

    def __init__(self, model: Model, opt_cfg: OptConfig, data_cfg: DataConfig,
                 loop_cfg: LoopConfig, mesh=None,
                 failure_plan: Optional[FailurePlan] = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.mesh = mesh
        self.failure_plan = failure_plan
        self.data = SyntheticLMData(data_cfg)
        self.monitor = StragglerMonitor()
        self.metrics_log: list = []
        self.dp_axes = () if mesh is None else ("data",)
        self.step_fn = make_train_step(
            model, opt_cfg, mesh, dp_axes=self.dp_axes or ("data",),
            compress_grads=loop_cfg.compress_grads, remat=loop_cfg.remat)
        self.params = stack_layers(model.init(loop_cfg.seed), model.cfg)
        self.layout = None
        if mesh is not None:
            self.layout = param_layout(model, mesh)
            self.params = shard_params(self.params, mesh, model.cfg)
        self.opt_state = init_opt_state(self.params, opt_cfg, model.policy)
        self.ef = (init_error_feedback(self.params)
                   if loop_cfg.compress_grads and mesh is not None else None)
        self.step = 0
        self.ckpt = (CheckpointManager(loop_cfg.ckpt_dir,
                                       keep=loop_cfg.keep_ckpts)
                     if loop_cfg.ckpt_dir else None)
        if self.ckpt is not None:
            self._try_restore()

    @property
    def lead(self) -> bool:
        """Whether this rank logs and writes checkpoints."""
        return self.mesh is None or self.mesh.rank == 0

    # -- checkpoint plumbing -------------------------------------------------
    def state_tree(self) -> dict:
        t = {"params": self.params, "opt": self.opt_state}
        if self.ef is not None:
            t["ef"] = self.ef
        return t

    def state_specs(self) -> dict:
        """The spec tree of ``state_tree()`` under the mesh (``ef``'s
        leading dim over ``data``)."""
        lay = self.layout
        sp = {"params": lay.param_specs,
              "opt": lay.state_specs(self.opt_state)}
        if self.ef is not None:
            sp["ef"] = map_specs(lambda _, s: ("data",) + tuple(s),
                                 self.ef, lay.param_specs)
        return sp

    def whole_state(self) -> dict:
        """``state_tree()`` with every leaf whole (a collective over the
        mesh: every rank calls it)."""
        if self.mesh is None:
            return self.state_tree()
        return map_specs(lambda x, s: gather_whole(x, s, self.mesh),
                         self.state_tree(), self.state_specs())

    def _try_restore(self):
        shardings = None
        if self.mesh is not None:
            # the lead rank's last write is durable before anyone reads
            if self.lead:
                self.ckpt.wait()
            spmd.barrier(self.mesh.everyone)
            shardings = (self.state_specs(), self.mesh)
        step, tree, extra = self.ckpt.restore_latest(self.state_tree(),
                                                     shardings)
        if step is not None:
            self.params = tree["params"]
            self.opt_state = tree["opt"]
            if self.ef is not None:
                self.ef = tree["ef"]
            self.step = int(extra["step"])
            self.data.load_state_dict(extra["data"])

    def _save(self, sync=False):
        if self.ckpt is None:
            return
        tree = self.whole_state()
        if self.lead:
            self.ckpt.save(self.step, tree,
                           extra={"data": self.data.state_dict()}, sync=sync)
        if sync and self.mesh is not None:
            spmd.barrier(self.mesh.everyone)

    # -- the loop -------------------------------------------------------------
    def run(self):
        try:
            return self._run()
        except SimulatedFailure:
            if self.ckpt is not None:
                self.ckpt.wait()
            raise

    def _run(self):
        lc = self.loop_cfg
        dev = self.model.device
        sr_seed = (lc.seed + 1 if self.ef is not None
                   or self.model.policy.stochastic_grad_round else None)
        while self.step < lc.total_steps:
            if self.failure_plan is not None:
                self.failure_plan.maybe_fail(self.step)
            batch = local_rows(self.data.batch_at(self.data.step), self.mesh,
                               self.dp_axes)
            batch = {k: v.to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            if self.ef is not None:
                self.params, self.opt_state, metrics, self.ef = self.step_fn(
                    self.params, self.opt_state, batch, self.ef, sr_seed)
            else:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, sr_seed=sr_seed)
            metrics = {k: float(v) for k, v in metrics.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            straggler = self.monitor.record(self.step, dt)
            metrics.update(step=self.step, dt=dt, straggler=straggler)
            self.metrics_log.append(metrics)
            if lc.log_every and self.step % lc.log_every == 0 and self.lead:
                print(f"step {self.step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} gnorm "
                      f"{metrics['grad_norm']:.3f} {dt*1e3:.0f}ms"
                      + (" STRAGGLER" if straggler else ""))
            self.step += 1
            self.data.step = self.step
            if lc.ckpt_every and self.step % lc.ckpt_every == 0:
                self._save()
        self._save(sync=True)
        return self.metrics_log
