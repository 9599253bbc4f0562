"""Beyond-paper example on the PyTorch port: per-layer precision
autotuning (the twin of ``examples/precision_autotune.py``).

FPnew gives software per-op-group format knobs; this example turns the
knob automatically: starting from the fp32 policy, greedily lower the
matmul source format (fp32 -> bf16 -> fp8) per op-class as long as a
held-out loss degrades less than a tolerance — the transprecision analogue
of AMP search, with the H100's measured pJ/flop per format
(``core.energy.H100_PJ_PER_FLOP``) as the objective.

Run:  PYTHONPATH=src python examples/torch_precision_autotune.py \
          [--device cpu]
"""
import argparse
import itertools

import torch

from repro_torch.core import energy
from repro_torch.core.formats import get_format
from repro_torch.core.policy import MatmulPolicy, PrecisionPolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.models.registry import build_model

LADDER = ["fp32", "fp16alt", "fp8"]


def eval_loss(model, params, batch):
    with torch.no_grad():
        return float(model.forward_train(params, batch["tokens"],
                                         batch["labels"], remat=False))


def policy_for(src: str, elem: str) -> PrecisionPolicy:
    return PrecisionPolicy(
        name=f"auto_{src}_{elem}", mode="emulate",
        matmul=MatmulPolicy(get_format(src), get_format("fp32"),
                            get_format(src)),
        elem_fmt=elem, param_fmt="fp32")


def modeled_pj_per_flop(src: str) -> float:
    return energy.H100_PJ_PER_FLOP.get(src, energy.H100_PJ_PER_FLOP["fp32"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    base = build_model("fpnew-case-study", policy="fp32", reduced=True,
                       device=args.device, prefill_backend="dense")
    params = base.init(0)
    data = SyntheticLMData(DataConfig(vocab=base.cfg.vocab,
                                      seq_len=args.seq_len,
                                      global_batch=args.global_batch,
                                      noise=0.0))
    batch = {k: v.to(base.device) for k, v in data.batch_at(0).items()}

    tol = 0.02     # allowed loss degradation vs fp32
    ref = None
    print("=== greedy per-op-class precision descent (emulated grids) ===")
    print(f"{'matmul src':11s} {'elem fmt':9s} {'loss':>8s} {'dloss':>8s} "
          f"{'pJ/flop':>8s} {'accepted':>9s}")
    best = ("fp32", "fp32")
    for src, elem in itertools.product(LADDER, ["fp32", "fp16alt"]):
        model = build_model("fpnew-case-study",
                            policy=policy_for(src, elem), reduced=True,
                            device=args.device, prefill_backend="dense")
        loss = eval_loss(model, params, batch)
        if ref is None:
            ref = loss
        d = loss - ref
        ok = d <= tol
        cur_e = modeled_pj_per_flop(best[0])
        new_e = modeled_pj_per_flop(src)
        accept = ok and new_e <= cur_e
        if accept:
            best = (src, elem)
        print(f"{src:11s} {elem:9s} {loss:8.4f} {d:+8.4f} "
              f"{new_e:8.2f} {str(accept):>9s}")
    print(f"\nselected: matmul src={best[0]}, elem={best[1]} "
          f"({modeled_pj_per_flop('fp32')/modeled_pj_per_flop(best[0]):.1f}x "
          f"modeled matmul-energy saving vs fp32 on the H100, "
          f"{energy.H100_CARD})")
    assert best[0] != "fp32", "autotune should find a narrower format"
    return best


if __name__ == "__main__":
    main()
