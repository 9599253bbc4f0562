#!/usr/bin/env python3
"""Where the split route's time goes on the card: device time by kernel.

    python3 scripts/split_probe.py

The split route runs two kernels a call: a staging pass that cuts the
operands into bf16 pieces (``tp_matmul``: both operands; flash: K and V)
and the tensor-core kernel that sums the piece products.  For the op
path's f32 products at gemma2-9b's MLP widths and for the kernel phase's
f32 attention cases (``chip_smoke.flash_case``'s inputs; the chunk also
through 8192-key block tables, whose staging must follow the live keys
and not the table), this prints one
JSON line each: the device ms a call of every kernel launched, from
``torch.profiler`` over ``CALLS`` calls, beside the whole call's device
time from a replayed CUDA graph (``chip_smoke.device_ms``) and the
16-bit tensor-core product at the same shape.  Needs a card.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: profiled calls per case
CALLS = 5


def by_kernel(fn) -> dict:
    """Device ms a call of each kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out[name] = round(us / 1e3 / CALLS, 5)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("split_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_split
    from repro_torch.kernels.tp_matmul import tp_matmul_split, tp_matmul_tc
    _build.build_all(["flash_attention", "tp_matmul"])
    print(c.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (m, k, n) in (("mm_fp32_mlp_up", (256, c.D_MODEL, c.D_FF)),
                            ("mm_fp32_mlp_down", (256, c.D_FF, c.D_MODEL))):
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        ab, bb = a.bfloat16(), b.bfloat16()
        print(json.dumps({"case": name, "kernels": by_kernel(
            lambda: tp_matmul_split(a, b)),
            "call_ms": c.device_ms(lambda: tp_matmul_split(a, b)),
            "bf16_tc_ms": c.device_ms(lambda: tp_matmul_tc(
                ab, bb, out_dtype=torch.bfloat16))}), flush=True)
    for name, kw in (
            ("flash_f32_p64_chunk", dict(page=64, rows=[256, 200],
                                         q_offset=768, chunk=256,
                                         window=4096, softcap=50.0)),
            # the chunk through 8192-key block tables
            ("flash_f32_p64_wide_table", dict(page=64, rows=[256, 200],
                                              q_offset=768, chunk=256,
                                              window=4096, softcap=50.0,
                                              pages=128)),
            ("flash_f32_contig_nocap", dict(page=0, rows=[1024, 1024],
                                            q_offset=0, chunk=1024,
                                            window=None, softcap=None))):
        b, hkv, g, d = 2, 8, 2, 256
        page, chunk = kw["page"], kw["chunk"]
        q = torch.randn((b, hkv * g, chunk, d), generator=gen, device="cuda")
        if page:
            pages = kw.get("pages", -(-(kw["q_offset"] + chunk) // page))
            kp, vp, table = c._pool_and_table(gen, b, hkv, pages, page, d,
                                              torch.float32, 4)
        else:
            kp, vp = (torch.randn((b, hkv, chunk, d), generator=gen,
                                  device="cuda") for _ in range(2))
            table = None
        kvl = torch.tensor([kw["q_offset"] + r for r in kw["rows"]],
                           dtype=torch.int32, device="cuda")
        args, fkw = c._flat_flash(q, kp, vp, kvl, table, "fp32")
        fkw.update(causal=True, window=kw["window"],
                   softcap=kw["softcap"], q_offset=kw["q_offset"])
        call = lambda: flash_attention_split(*args, **fkw)
        print(json.dumps({"case": name, "kernels": by_kernel(call),
                          "call_ms": c.device_ms(call)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
