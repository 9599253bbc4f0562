"""Quickstart of the PyTorch port: the transprecision numerics layer in
five minutes (the twin of ``examples/quickstart.py``).

Shows the paper's primitives as torch ops: arbitrary-format quantization
with all rounding modes, the expanding FMA (multiply narrow, accumulate
wide, one rounding), policy-driven matmuls, cast-and-pack, and the
per-format energy model: the paper's silicon and the H100's measured rows.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import energy, softfloat
from repro_torch.core.device import resolve_device
from repro_torch.core.formats import get_format
from repro_torch.core.ops import cast_and_pack, tp_einsum, tp_fma
from repro_torch.core.policy import PRESETS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. arbitrary IEEE-style formats -------------------------------------
    x = torch.linspace(-3, 3, 8, device=dev)
    for fmt in ("fp16", "fp16alt", "fp8", (4, 3)):
        q = softfloat.quantize(x, fmt)
        f = get_format(fmt)
        print(f"{str(f):16s} width {f.width:2d}  q(x) = "
              f"{q.cpu().numpy().round(4)}")

    # rounding modes bracket the value
    v = torch.tensor(1.2345, device=dev)
    for mode in ("rne", "rtz", "rdn", "rup", "stochastic"):
        gen = (torch.Generator(device=dev).manual_seed(0)
               if mode == "stochastic" else None)
        q = softfloat.quantize(v, "fp8", mode, generator=gen)
        print(f"  fp8[{mode:10s}] {float(v):.6f} -> {float(q):.6f}")

    # 2. the expanding FMA (paper §II.B.4): fp16 multiply, fp32 accumulate
    pol = PRESETS["em_fp16"]
    a = b = torch.tensor(1.0009765625, device=dev)
    c = torch.tensor(100.0, device=dev)
    print(f"\nexpanding FMA fmacex.s.h: {float(tp_fma(a, b, c, pol)):.10f}"
          f"  (fp16 accumulate would lose the product tail)")

    # 3. policy-driven matmul: same code, different formats per op group
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((64, 128), generator=gen, device=dev)
    B = torch.randn((128, 32), generator=gen, device=dev)
    exact = (A.double() @ B.double()).float()
    for name in ("fp32", "tp_bf16", "tp_fp8", "em_fp8"):
        r = tp_einsum("ij,jk->ik", A, B, PRESETS[name])
        err = float((r.float() - exact).abs().max())
        print(f"policy {name:8s} mode {PRESETS[name].mode:7s} "
              f"src {PRESETS[name].matmul.src_fmt.name:8s} max|err| {err:.4f}")

    # 4. cast-and-pack (paper §III.A.2c)
    s1 = torch.arange(4, dtype=torch.float32, device=dev)[None]
    packed = cast_and_pack(s1, -s1, "fp8", PRESETS["em_fp8"])
    print(f"\ncast-and-pack fp8: {packed.cpu().numpy()[0]}")

    # 5. the energy model (paper Table IV): why narrow formats pay
    print("\nFMA energy/efficiency (paper's silicon, 0.8V):")
    for fmt in ("fp64", "fp32", "fp16alt", "fp8"):
        print(f"  {fmt:8s} scalar {energy.fma_energy_pj(fmt):6.2f} pJ   "
              f"{energy.fma_efficiency_gflops_w(fmt):8.1f} Gflop/sW")
    print(f"  fp8 SIMD  {energy.fma_energy_pj('fp8', True):6.2f} pJ   "
          f"{energy.fma_efficiency_gflops_w('fp8', True):8.1f} Gflop/sW "
          f"(16.6x fp64)")
    print(f"\nGEMM energy on the H100 (measured, power above idle / rate, "
          f"{energy.H100_CARD}; idle {energy.H100_IDLE_W:.1f} W):")
    for fmt, pj in energy.H100_PJ_PER_FLOP.items():
        print(f"  {fmt:8s} {pj:7.3f} pJ/flop")
    print(f"  HBM copy {energy.H100_PJ_PER_HBM_BYTE:7.2f} pJ/byte")
    assert np.isfinite(float(packed.abs().sum()))


if __name__ == "__main__":
    main()
