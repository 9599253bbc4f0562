#!/usr/bin/env python3
"""Sweeps the kernels' launch knobs on the card at the port's serving
shapes and writes the shipped winners (``src/repro_torch/kernels/
pretuned.json`` in the repo).

    python3 scripts/pretune.py --out results/pretuned.json

Every shape of ``SHAPES`` (the attention reads and products that
``chip_smoke.py``'s kernel cases hold) goes through the tuner's CLI,
``repro_torch.kernels.autotune.main``, into a temporary user cache, with
the shipped file switched off so that every candidate is timed afresh.
The output holds the header (the card as ``nvidia-smi`` names it with its
power limit, torch, CUDA, each library's source digest), ``entries`` (the
winners, heuristic ones included, in the tuner's key format) and
``sweeps`` (every candidate's median and spread device ms beside the
heuristic and the winner).  It prints one ``SWEEP`` line a shape.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: (case, op, shape, dtype): the serving shapes of the smoke's cases
#: (decode: rows = slots x KV heads, live units of the widest row, unit,
#: G, D; attn: Sq, BKV, group, D, Dv; matmul: M, K, N)
SHAPES = (
    # gemma2-9b, the slice: local / global decode of 4 slots at 4112 keys
    ("decode_bf16_p64_local", "decode_attn", (32, 65, 64, 2, 256), "bfloat16"),
    ("decode_f32_p64_local", "decode_attn", (32, 65, 64, 2, 256), "float32"),
    ("decode_bf16_p64_b1_global", "decode_attn", (8, 128, 64, 2, 256),
     "bfloat16"),
    ("decode_bf16_p64_b16_local", "decode_attn", (128, 65, 64, 2, 256),
     "bfloat16"),
    ("decode_bf16_p64_generate", "decode_attn", (32, 17, 64, 2, 256),
     "bfloat16"),
    ("flash_bf16_p64_chunk", "attn", (256, 16, 2, 256, 256), "bfloat16"),
    ("flash_bf16_contig_nocap", "attn", (1024, 16, 2, 256, 256), "bfloat16"),
    ("flash_bf16_p64_generate", "attn", (1024, 32, 2, 256, 256), "bfloat16"),
    # qwen3-moe (G 8, D 128)
    ("decode_bf16_p64_qwen3", "decode_attn", (16, 65, 64, 8, 128),
     "bfloat16"),
    ("decode_fp8_p64_qwen3", "decode_attn", (16, 65, 64, 8, 128),
     "float8_e5m2"),
    ("flash_bf16_p64_qwen3_chunk", "attn", (256, 8, 8, 128, 128), "bfloat16"),
    # granite-20b (MQA, G 48)
    ("decode_bf16_p64_granite", "decode_attn", (4, 65, 64, 48, 128),
     "bfloat16"),
    ("decode_fp8_p64_granite", "decode_attn", (4, 65, 64, 48, 128),
     "float8_e5m2"),
    ("decode_f32_p64_granite", "decode_attn", (4, 65, 64, 48, 128),
     "float32"),
    ("flash_bf16_p64_granite_chunk", "attn", (256, 2, 48, 128, 128),
     "bfloat16"),
    # MLA's expanded prefills: minicpm3-4b (96, 64), deepseek (192, 128)
    ("flash_mla_bf16_uniform", "attn", (1024, 160, 1, 96, 64), "bfloat16"),
    ("flash_mla_bf16_192", "attn", (1024, 64, 1, 192, 128), "bfloat16"),
    # gemma3-12b (window 1024), internvl2-26b (G 6), whisper-small, zamba2
    ("decode_bf16_p64_gemma3", "decode_attn", (32, 17, 64, 2, 256),
     "bfloat16"),
    ("flash_bf16_p64_gemma3_chunk", "attn", (256, 16, 2, 256, 256),
     "bfloat16"),
    ("decode_bf16_p64_internvl2", "decode_attn", (32, 17, 64, 6, 128),
     "bfloat16"),
    ("flash_bf16_p64_internvl2", "attn", (1024, 32, 6, 128, 128), "bfloat16"),
    ("decode_bf16_whisper_cross", "decode_attn", (48, 24, 64, 1, 64),
     "bfloat16"),
    ("decode_bf16_whisper_self", "decode_attn", (48, 1, 64, 1, 64),
     "bfloat16"),
    ("flash_bf16_whisper_encoder", "attn", (1500, 48, 1, 64, 64), "bfloat16"),
    ("flash_bf16_whisper_cross", "attn", (32, 48, 1, 64, 64), "bfloat16"),
    ("decode_bf16_zamba2", "decode_attn", (128, 17, 64, 1, 64), "bfloat16"),
    ("flash_bf16_zamba2_prefill", "attn", (1000, 128, 1, 64, 64), "bfloat16"),
    # the op path at gemma2-9b's MLP widths
    ("mm_bf16_mlp_up", "matmul", (256, 3584, 14336), "bfloat16"),
    ("mm_bf16_mlp_down", "matmul", (256, 14336, 3584), "bfloat16"),
    ("mm_bf16_decode", "matmul", (4, 3584, 14336), "bfloat16"),
    ("mm_em_fp8_mlp_up", "matmul", (256, 3584, 14336), "float32+fp8"),
    ("mm_em_fp8_mlp_down", "matmul", (256, 14336, 3584), "float32+fp8"),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--repeats", type=int, default=None)
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="pretune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "cache.json")
    os.environ["REPRO_TORCH_PRETUNED_CACHE"] = os.path.join(tmp, "none.json")
    import torch
    from repro_torch.kernels import _build, autotune
    autotune.reset()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all(sorted(set(autotune.LIBRARY.values())))
    entries, sweeps = {}, {}
    for case, op, shape, dtype in SHAPES:
        key = autotune._key(op, shape, dtype, "cuda")
        if key in entries:               # another case of the same bucket
            sweeps[key].append({"case": case, "same_as": sweeps[key][0][
                "case"]})
            continue
        argv = ["--op", op, "--shape", "x".join(map(str, shape)),
                "--dtype", dtype]
        if args.repeats:
            argv += ["--repeats", str(args.repeats)]
        winner, timings = autotune.main(argv)
        entries[key] = list(winner)
        rec = {"case": case, "heuristic": list(autotune.default_block(
            op, shape, dtype)), "winner": list(winner), "candidates": [
            [list(b), t["ms"], t["spread_ms"]] for b, t in timings.items()]}
        sweeps.setdefault(key, []).append(rec)
        print("SWEEP " + json.dumps(dict(key=key, **rec)), flush=True)
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "digests": {lib: _build.source_digest(lib)
                       for lib in sorted(set(autotune.LIBRARY.values()))},
           "script": "scripts/pretune.py", "entries": entries,
           "sweeps": sweeps}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"{len(entries)} entries -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
