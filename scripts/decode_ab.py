#!/usr/bin/env python3
"""Times the decode kernel of one checkout at the serving shapes, for an
A/B of two commits in one chip call (``chip_smoke.decode_case`` of that
checkout: kernel, kernel-only and flags-on device ms, and the error
against the plain version).

    mkdir -p results/ab/parent && git archive HEAD~1 | tar -x -C results/ab/parent
    for t in results/ab/parent . . results/ab/parent; do
        python3 scripts/decode_ab.py $t; done

Each run builds only the decode library of its checkout, then prints one
line ``AB <checkout> {case: [kernel_ms, kernel_only_ms, flags_ms,
max_abs_err]}``.  The granite cases (group 48) run where the checkout's
kernel takes them.
"""
import json
import os
import sys


def main(tree: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import chip_smoke as c          # puts ``root/src`` first on the path
    import torch
    from repro_torch.kernels import _build, decode_attention
    _build.build_all(["decode_attention"])
    bf16, fp8, f32 = torch.bfloat16, torch.float8_e5m2, torch.float32
    local = dict(page=64, kv_lens=[1056, 540, 0, 4111], window=4096,
                 softcap=50.0, alias=4)
    q3 = dict(page=64, kv_lens=[1056, 540, 0, 4112], window=None,
              softcap=None, alias=4, heads=(4, 8), d=128)
    cases = [("decode_bf16_p64_local", dict(dtype=bf16, seed=1, **local)),
             ("decode_f32_p64_local", dict(dtype=f32, seed=12, **local)),
             ("decode_bf16_p64_b16_local", dict(
                 dtype=bf16, page=64, kv_lens=[4111 - 97 * i
                                               for i in range(16)],
                 window=4096, softcap=50.0, alias=4, seed=9)),
             ("decode_bf16_p64_qwen3", dict(dtype=bf16, seed=16, **q3)),
             ("decode_fp8_p64_qwen3", dict(dtype=fp8, seed=17, **q3))]
    if hasattr(decode_attention, "kernel_takes"):
        gr = dict(q3, heads=(1, 48))
        cases += [(f"decode_{n}_p64_granite", dict(dtype=dt, seed=s, **gr))
                  for n, dt, s in (("bf16", bf16, 20), ("fp8", fp8, 21),
                                   ("f32", f32, 22))]
    out = {}
    for name, kw in cases:
        r = c.decode_case(name, **kw)
        out[name] = [r["kernel_ms"], r["kernel_only_ms"], r["flags_ms"],
                     r["max_abs_err"]]
    print("AB", tree, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
