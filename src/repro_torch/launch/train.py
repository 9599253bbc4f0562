"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``,
the JAX package's ``launch/train.py`` flags plus ``--device``.

Runs on the GPU unless ``--device cpu`` is given (without a card it then
raises, never falls back).  ``--reduced`` (the default) trains the arch's
two-layer cut, ``--full`` the published widths.  Training attention is the
dense path (the attention kernels have no backward).  ``--mesh
pod1|pod2`` is not ported (ROADMAP Queue 1 item 8b); ``--compress-grads``
only acts under a mesh, as in JAX, and is ignored here.  As the JAX
launcher's, the data carry no frontend: ``--arch internvl2-26b`` trains
on text alone, and ``--arch whisper-small`` raises in ``encode`` at the
first step (no frame embeddings), where JAX's fails on ``None``.
``--arch zamba2-1.2b`` and ``--arch xlstm-1.3b`` train through the
recurrent mixers' chunked forms (no cache).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fpnew-case-study")
    ap.add_argument("--policy", default="tp_bf16")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", default=None,
                    help="fp8|fp16alt: compressed DP gradient sync (acts "
                         "only under a mesh)")
    ap.add_argument("--mesh", choices=["none", "pod1", "pod2"],
                    default="none")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training under a mesh is not ported "
            f"(ROADMAP Queue 1 item 8b; serving shards)")

    from ..data.pipeline import DataConfig
    from ..models.registry import build_model
    from ..optim.optimizer import OptConfig
    from ..train.loop import LoopConfig, TrainLoop

    model = build_model(args.arch, policy=args.policy, reduced=args.reduced,
                        device=args.device, prefill_backend="dense")
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps)
    data = DataConfig(vocab=model.cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    lc = LoopConfig(total_steps=args.steps,
                    log_every=max(args.steps // 20, 1),
                    ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                    compress_grads=args.compress_grads)
    loop = TrainLoop(model, opt, data, lc)
    log = loop.run()
    print(f"done: {len(log)} steps, final loss {log[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
