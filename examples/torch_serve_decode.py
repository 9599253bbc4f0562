"""Serving example on the PyTorch port: prefill a batch of prompts, then
decode with a transprecision KV cache (the paper's storage-format knob
applied to the dominant serving memory term); the twin of
``examples/serve_decode.py``.

Decoding runs through ``Model.generate`` (a fixed-trip loop of decode
steps); with ``--decode-backend kernel`` (``pallas``, JAX's name, is the
same) every step's attention runs the hand-written decode kernel and the
prefill the flash kernel, on the card.  ``dense`` is the masked-softmax
path.

Runs a reduced config; the same code path serves the decode_32k /
long_500k dry-run cells (``python -m repro_torch.launch.dryrun``).

Run:  PYTHONPATH=src python examples/torch_serve_decode.py \
          [--arch gemma2-9b] [--decode-backend kernel] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--policy", default="tp_bf16")
    ap.add_argument("--decode-backend",
                    choices=("dense", "kernel", "pallas", "plain", "auto"),
                    default="dense")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    backend = "kernel" if args.decode_backend == "pallas" \
        else args.decode_backend

    model = build_model(args.arch, policy=args.policy, reduced=True,
                        device=args.device, decode_backend=backend,
                        prefill_backend=backend)
    cfg, dev = model.cfg, model.device
    params = model.init(0)
    max_len = args.prompt_len + args.gen
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        t0 = time.time()
        logits, _ = model.prefill(params, prompts, max_len=max_len)
        sync()
        t_prefill = time.time() - t0
        model.generate(params, prompts, gen_len=args.gen, max_len=max_len)
        sync()                                   # warm-up (kernel build)
        t0 = time.time()
        out = model.generate(params, prompts, gen_len=args.gen,
                             max_len=max_len)[0]
        sync()
        t_dec = time.time() - t0

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else str(dev)
    kv_fmt = model.policy.kv_fmt.name if model.policy.kv_fmt else "param fmt"
    print(f"arch {cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{t_prefill*1e3:.0f} ms; generate made {args.gen} tokens/row in "
          f"{t_dec*1e3:.0f} ms ({args.gen*args.batch/t_dec:.1f} tok/s on "
          f"{where}, prefill incl.)")
    print(f"KV cache format: {kv_fmt} (policy '{model.policy.name}', "
          f"decode backend {cfg.decode_backend})")
    gen_ids = out.cpu()
    print("generated ids (row 0):", gen_ids[0].tolist())
    assert gen_ids.shape == (args.batch, args.gen)
    assert int(gen_ids.max()) < cfg.vocab
    assert torch.equal(gen_ids[:, 0], logits[:, -1].argmax(-1).cpu())
    if backend == "kernel":
        from repro_torch.kernels.decode_attention import decode_attention_cuda
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        print(f"kernel launches: decode_attention "
              f"{decode_attention_cuda.launches}, flash_attention "
              f"{flash_attention_cuda.launches}")
    return gen_ids


if __name__ == "__main__":
    main()
