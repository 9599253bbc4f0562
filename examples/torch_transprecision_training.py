"""End-to-end run on the PyTorch port: train the ~110M-parameter
case-study LM for a few hundred steps under three precision policies and
reproduce the paper's Table-III claim at training scale (the twin of
``examples/transprecision_training.py``): the expanding-FMA policy
(narrow multiply, fp32 accumulate) tracks the fp32 baseline's loss while
the energy model predicts a saving, here at the H100's measured pJ/flop
per format (``core.energy.H100_PJ_PER_FLOP``).

Run:  PYTHONPATH=src python examples/torch_transprecision_training.py \
          [--steps 300] [--policy tp_bf16] [--compare] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import energy
from repro_torch.core.policy import PRESETS
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.loop import LoopConfig, TrainLoop


def train_one(policy: str, steps: int, ckpt_dir=None, reduced=True,
              device=None, seq_len=256, global_batch=16):
    model = build_model("fpnew-case-study", policy=policy, reduced=reduced,
                        device=device, prefill_backend="dense")
    cfg = model.cfg
    opt = OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps,
                    weight_decay=0.0)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, noise=0.02)
    lc = LoopConfig(total_steps=steps, log_every=max(steps // 10, 1),
                    ckpt_every=0, ckpt_dir=ckpt_dir)
    loop = TrainLoop(model, opt, data, lc)
    t0 = time.time()
    log = loop.run()
    wall = time.time() - t0
    losses = [m["loss"] for m in log]
    n = cfg.param_counts()["flops"]
    tokens = steps * data.global_batch * data.seq_len
    flops = 6 * n * tokens
    src = PRESETS[policy].matmul.src_fmt.name
    pj = energy.H100_PJ_PER_FLOP.get(src, energy.H100_PJ_PER_FLOP["fp32"])
    joules = flops * pj * 1e-12
    return dict(policy=policy, first=float(np.mean(losses[:10])),
                last=float(np.mean(losses[-10:])), wall_s=wall,
                train_flops=flops, model_joules=joules)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--policy", default="tp_bf16")
    ap.add_argument("--compare", action="store_true",
                    help="run fp32 / tp_bf16 / em_fp8 and compare")
    ap.add_argument("--full", action="store_true",
                    help="full 110M config")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    policies = (["fp32", "tp_bf16", "em_fp8"] if args.compare
                else [args.policy])
    results = [train_one(p, args.steps, reduced=not args.full,
                         device=args.device, seq_len=args.seq_len,
                         global_batch=args.global_batch)
               for p in policies]

    print("\n=== transprecision training (paper Table III, at LM scale) ===")
    print(f"{'policy':10s} {'loss first':>11s} {'loss last':>10s} "
          f"{'modelled energy':>16s}  (H100 rows: {energy.H100_CARD})")
    base = results[0]
    for r in results:
        print(f"{r['policy']:10s} {r['first']:11.3f} {r['last']:10.3f} "
              f"{r['model_joules']:13.2f} J "
              f"({r['model_joules']/base['model_joules']:.2f}x)")
    if args.compare and len(results) >= 2:
        # the paper's claim: narrow-multiply/wide-accumulate keeps accuracy
        assert abs(results[1]["last"] - results[0]["last"]) < 0.35, results
        print("claim: tp_bf16 (expanding FMA) matches fp32 loss  [OK]")
    return results


if __name__ == "__main__":
    main()
