"""Serving launcher of the port: a request queue served by the
continuous-batching engine.

``--continuous`` serves the deterministic ``chat`` queue of
``engine.synthetic_trace`` (``--requests`` requests over ``--slots`` batch
slots, prompts up to ``--prompt-len``, budgets up to ``--gen``) through
``ContinuousEngine``: paged KV in ``--page-size``-token pages, prompts
consumed in ``--chunk``-token chunks, greedy decode.  The model is the
reduced config unless ``--full``; weights are random from seed 0.  It runs
once to warm up, then once timed, and prints per-request admit / finish
rounds, occupancy, peak live pages and tok/s.

Runs on the GPU unless ``--device cpu`` is given; without a card and
without ``--device`` it raises.  The fixed-batch ``generate`` paths of the
JAX package's launcher (scan / python loops, sampling, penalties,
speculation, meshes, replicas, fault injection) are not ported.

    python -m repro_torch.launch.serve --continuous --full
    python -m repro_torch.launch.serve --continuous --device cpu \\
        --slots 4 --requests 10 --prompt-len 16 --gen 24
"""
from __future__ import annotations

import argparse
import time

import torch

from ..models.registry import build_model
from .engine import ContinuousEngine, synthetic_trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--policy", default="tp_bf16")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (the only ported path)")
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots of the continuous engine")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests in the synthetic queue")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk width of the continuous engine")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the arch at full width")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("only --continuous is ported (the fixed-batch generate "
                 "paths are not)")

    model = build_model(args.arch, policy=args.policy, reduced=args.reduced,
                        device=args.device, paged_kv=True,
                        page_size=args.page_size)
    params = model.init(0)
    reqs = synthetic_trace(args.requests, args.slots, args.prompt_len,
                           args.gen, model.cfg.vocab)
    max_len = max(r.prompt_len + r.max_new for r in reqs)
    eng = ContinuousEngine(model, params, slots=args.slots, max_len=max_len,
                           chunk=args.chunk)
    eng.run(reqs)                       # warm-up (kernel build, allocator)
    t0 = time.perf_counter()
    fin, stats = eng.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else str(model.device))
    print(f"continuous engine on {where}: {model.cfg.name}, "
          f"{args.slots} slots, page={args.page_size}, chunk={args.chunk}, "
          f"{len(reqs)} requests, pool {stats['n_pages']} pages")
    for f in fin:
        print(f"  req {f.rid:3d}: prompt {f.prompt_len:3d} -> "
              f"{len(f.tokens):3d} tokens  (slot {f.slot}, admitted "
              f"r{f.admit_round}, finished r{f.finish_round})")
    n_tok = sum(len(f.tokens) for f in fin)
    print(f"occupancy {stats['occupancy']:.2f} over "
          f"{stats['decode_rounds']} rounds / {stats['bursts']} bursts; "
          f"peak live pages {stats['peak_live_pages']} vs "
          f"{stats['fixed_equiv_pages']} fixed-batch equivalent "
          f"(pool {stats['n_pages']}, {stats['pages_live_end']} live at end)")
    print(f"{n_tok} tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s "
          f"(prefill {stats['prefill_s']:.3f} s, decode "
          f"{stats['decode_s']:.3f} s)")
    return fin, stats


if __name__ == "__main__":
    main()
