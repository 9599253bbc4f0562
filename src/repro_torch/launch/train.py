"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``,
the JAX package's ``launch/train.py`` flags plus ``--device``.

Runs on the GPU unless ``--device cpu`` is given (without a card it then
raises, never falls back).  ``--reduced`` (the default) trains the arch's
two-layer cut, ``--full`` the published widths.  Training attention is the
dense path (the attention kernels have no backward).  ``--mesh
pod1|pod2`` builds JAX's production mesh (``launch.mesh.
make_production_mesh``: ``(data=16, model=16)``, or ``(pod=2, data=16,
model=16)``) over one rank a device, spawned on ``--dist-backend`` (the
serving launcher's flag and default), each rank running ``TrainLoop(mesh=)``
and rank 0 printing; where the ranks cannot be had (one device for
``--device cpu``, the visible cards otherwise) it raises JAX's
``_mk_mesh`` message ("mesh (16, 16) needs 256 devices, have N").
``--compress-grads`` acts under a mesh only, as in JAX.  Every arch trains
under ``--mesh`` (MoE with JAX's aux loss by mesh and expert parallelism;
MLA, the recurrent mixers and whisper's encoder tensor parallel).  There
is no
``DP,TP`` flag, as JAX's training launcher has none: small meshes are
driven through ``TrainLoop(mesh=)`` in spawned ranks
(``train.mesh_checks``).  As the JAX
launcher's, the data carry no frontend: ``--arch internvl2-26b`` trains
on text alone, and ``--arch whisper-small`` raises in ``encode`` at the
first step (no frame embeddings), where JAX's fails on ``None``.
``--arch zamba2-1.2b`` and ``--arch xlstm-1.3b`` train through the
recurrent mixers' chunked forms (no cache).
"""
from __future__ import annotations

import argparse
import math

from . import spmd

#: the production meshes' shapes (JAX's ``make_production_mesh``)
MESH_SHAPES = {"pod1": (16, 16), "pod2": (2, 16, 16)}


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
    ap.add_argument("--dist-backend", choices=spmd.BACKENDS, default="nccl",
                    help="torch.distributed backend of --mesh: nccl (one "
                         "rank a card) or gloo")
    args = ap.parse_args(argv)

    if args.mesh == "none":
        return _train(args)
    shape = MESH_SHAPES[args.mesh]
    n = math.prod(shape)
    if args.device == "cpu":
        have = 1
    else:
        import torch
        have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    return spmd.spawn(_mesh_rank, n, backend=args.dist_backend,
                      args=(args,))[0]


def _mesh_rank(rank: int, world: int, args):
    """One rank of ``--mesh``: its card, the production mesh, the loop."""
    from .mesh import make_production_mesh
    if args.device != "cpu":
        args.device = f"cuda:{rank}"
    mesh = make_production_mesh(multi_pod=args.mesh == "pod2")
    return _train(args, mesh)


def _train(args, mesh=None):
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
    loop = TrainLoop(model, opt, data, lc, mesh=mesh)
    log = loop.run()
    if loop.lead:
        print(f"done: {len(log)} steps, final loss {log[-1]['loss']:.4f}")
    return log


if __name__ == "__main__":
    main()
