"""Fault-tolerance example on the PyTorch port: train with checkpoints,
inject a node failure mid-run, restart from the latest checkpoint, and
verify the final weights are bit-identical to an uninterrupted run
(exactly-once semantics); the twin of ``examples/fault_tolerant_train.py``.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_train.py \
          [--device cpu]
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.fault import FailurePlan, run_with_restarts
from repro_torch.train.loop import LoopConfig, TrainLoop

STEPS = 20


def build(tmp, device, fail_at=(), steps=STEPS, seq_len=64, global_batch=8):
    model = build_model("fpnew-case-study", policy="tp_bf16", reduced=True,
                        device=device, prefill_backend="dense")
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                    weight_decay=0.0)
    data = DataConfig(vocab=model.cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, noise=0.0)
    lc = LoopConfig(total_steps=steps, log_every=5,
                    ckpt_every=max(1, 3 * steps // 10), ckpt_dir=tmp)
    return TrainLoop(model, opt, data, lc,
                     failure_plan=FailurePlan(fail_at=fail_at)
                     if fail_at else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps of each run; the failure strikes half way")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    size = dict(steps=args.steps, seq_len=args.seq_len,
                global_batch=args.global_batch)
    fail = args.steps // 2
    tmp_a = tempfile.mkdtemp()
    tmp_b = tempfile.mkdtemp()
    try:
        print("--- reference run (no failures) ---")
        ref = build(tmp_a, args.device, **size)
        ref.run()

        print(f"\n--- faulty run: node failure injected at step {fail} ---")
        plan = FailurePlan(fail_at=(fail,))

        def make():
            loop = build(tmp_b, args.device, **size)
            loop.failure_plan = plan
            return loop

        loop, restarts = run_with_restarts(make, max_restarts=2)
        print(f"\nrecovered with {restarts} restart(s); resumed from step "
              f"{loop.metrics_log[0]['step']} (latest checkpoint)")

        for x, y in zip(leaves(ref.params), leaves(loop.params)):
            assert torch.equal(x.float().cpu(), y.float().cpu())
        print("final weights BIT-IDENTICAL to the uninterrupted run  [OK]")
        if loop.monitor.flagged:
            print("stragglers flagged:", loop.monitor.flagged)
        return restarts
    finally:
        shutil.rmtree(tmp_a, ignore_errors=True)
        shutil.rmtree(tmp_b, ignore_errors=True)


if __name__ == "__main__":
    main()
