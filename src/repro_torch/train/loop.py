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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticLMData
from ..models.convert import stack_layers
from ..models.transformer import Model
from ..optim.optimizer import OptConfig, init_opt_state
from .fault import FailurePlan, SimulatedFailure, StragglerMonitor
from .train_step import make_train_step


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
    """Build everything, optionally restore, run."""

    def __init__(self, model: Model, opt_cfg: OptConfig, data_cfg: DataConfig,
                 loop_cfg: LoopConfig, mesh=None,
                 failure_plan: Optional[FailurePlan] = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.failure_plan = failure_plan
        self.data = SyntheticLMData(data_cfg)
        self.monitor = StragglerMonitor()
        self.metrics_log: list = []
        self.step_fn = make_train_step(
            model, opt_cfg, mesh, compress_grads=loop_cfg.compress_grads,
            remat=loop_cfg.remat)
        self.params = stack_layers(model.init(loop_cfg.seed), model.cfg)
        self.opt_state = init_opt_state(self.params, opt_cfg, model.policy)
        self.step = 0
        self.ckpt = (CheckpointManager(loop_cfg.ckpt_dir,
                                       keep=loop_cfg.keep_ckpts)
                     if loop_cfg.ckpt_dir else None)
        if self.ckpt is not None:
            self._try_restore()

    # -- checkpoint plumbing -------------------------------------------------
    def state_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _try_restore(self):
        step, tree, extra = self.ckpt.restore_latest(self.state_tree())
        if step is not None:
            self.params = tree["params"]
            self.opt_state = tree["opt"]
            self.step = int(extra["step"])
            self.data.load_state_dict(extra["data"])

    def _save(self, sync=False):
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self.state_tree(),
                       extra={"data": self.data.state_dict()}, sync=sync)

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
        sr_seed = (lc.seed + 1 if self.model.policy.stochastic_grad_round
                   else None)
        while self.step < lc.total_steps:
            if self.failure_plan is not None:
                self.failure_plan.maybe_fail(self.step)
            batch = {k: v.to(dev) for k, v in
                     self.data.batch_at(self.data.step).items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, sr_seed=sr_seed)
            metrics = {k: float(v) for k, v in metrics.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            straggler = self.monitor.record(self.step, dt)
            metrics.update(step=self.step, dt=dt, straggler=straggler)
            self.metrics_log.append(metrics)
            if lc.log_every and self.step % lc.log_every == 0:
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
