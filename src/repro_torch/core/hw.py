"""Target-hardware constants for the roofline analysis and the dry run:
one NVIDIA H100 (SXM, 80 GB HBM3), the JAX package's ``core/hw.py`` names
where their meaning holds.

Peak rates scale with format width as FPnew's SIMD lanes do (paper
§II.B.3: k = w_fpu / w_f lanes): fp8 doubles the 16-bit tensor-core rate.

Card: NVIDIA H100 80GB HBM3, power limit 700.00 W.  Every rate is the
data sheet's (dense, no sparsity, at the full 700 W): 989 TFLOP/s bf16 /
fp16, 1979 fp8, 67 f32 outside the tensor cores (TF32 is off in the
port) and 67 fp64 on the tensor cores; 3.35 TB/s of HBM; 132 SMs; NVLink
900 GB/s per card, both directions together (not measured: the machines
that measured the port have one card).  ``HBM_PER_CHIP`` is read on the
card (``torch.cuda.get_device_properties(0).total_memory``).
"""
from __future__ import annotations

from .formats import get_format

# per-card peaks (data sheet)
PEAK_FLOPS_BF16 = 989e12          # bf16/fp16 tensor-core peak, FLOP/s
PEAK_FLOPS_BY_FMT = {
    "fp32": 67e12,                # CUDA cores (TF32 off)
    "fp16": PEAK_FLOPS_BF16,
    "fp16alt": PEAK_FLOPS_BF16,
    "fp8": 1979e12,
    "fp64": 67e12,                # fp64 tensor cores
}
HBM_BW = 3.35e12                  # bytes/s per card
N_SMS = 132
NVLINK_BW_DATASHEET = 900e9       # bytes/s per card, not measured
HBM_PER_CHIP = 85017493504        # bytes (79.18 GiB), read on the card


def peak_flops(fmt) -> float:
    return PEAK_FLOPS_BY_FMT[get_format(fmt).name]
