"""Multi-format (expanding-FMA) matmul — FPnew's merged multi-format FMA
slice as a GEMM.

``tp_matmul_cuda`` is the port of the TPU kernel
``repro.kernels.tp_matmul.tp_matmul_pallas``: a hand-written CUDA kernel
(``csrc/tp_matmul.cu``, sm_90a) for tensors on the card.
``tp_matmul_plain`` is its plain-torch version (``ref.tp_matmul_ref``).
``kernels.ops.tp_matmul`` chooses between them by the tensors' device.

  stage           FPnew block   what happens
  operand snap    CONV          with ``quant_fmt_name``, f32 operands are
                                RNE-snapped (FTZ) onto that grid as they
                                are staged (the fused CONV->ADDMUL step)
  a @ b           ADDMUL        exact widening to f32, f32 sums over K
  store           CONV          RNE cast to ``out_dtype`` (f32/bf16/fp16)

Operands: a [M, K], b [K, N], both f32, bf16, fp16 or fp8 e5m2 (one dtype
for both).  M, K and N are arbitrary: the kernel masks the ragged edges
itself.  The f32 sum order differs from the plain version's ``bk``
schedule, so the two agree within ``2 K 2^-24 (|A| @ |B|)`` (plus one ulp
of a bf16/fp16 output), not bitwise; the snapped operands are bitwise equal.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from . import ref

_OPERANDS = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e5m2)
_OUTPUTS = (torch.float32, torch.bfloat16, torch.float16)


def tp_matmul_plain(a, b, *, out_dtype=torch.float32,
                    quant_fmt_name: Optional[str] = None,
                    bk: Optional[int] = None):
    """The kernel's function in plain torch; ``bk`` fixes the K-block
    summation schedule (None: one block)."""
    return ref.tp_matmul_ref(a, b, out_dtype=out_dtype,
                             quant_fmt_name=quant_fmt_name, bk=bk)


def tp_matmul_cuda(a, b, *, out_dtype=torch.float32,
                   quant_fmt_name: Optional[str] = None):
    """``a [M, K] @ b [K, N]`` with f32 accumulation and an ``out_dtype``
    store; one launch per call.  Raises on tensors that do not lie on a
    CUDA device and on shapes or dtypes the kernel does not take."""
    if a.device.type != "cuda":
        raise ValueError(f"the tp_matmul kernel needs CUDA tensors, got "
                         f"{a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} are "
                         f"not [M, K] and [K, N]")
    if a.dtype != b.dtype or a.dtype not in _OPERANDS:
        raise TypeError(f"operands {a.dtype}, {b.dtype}: need one dtype of "
                        f"{_OPERANDS}")
    if out_dtype not in _OUTPUTS:
        raise TypeError(f"out_dtype {out_dtype} is not one of {_OUTPUTS}")
    if b.device != a.device:
        raise ValueError("a and b must lie on one CUDA device")
    snap = (_build.grid_args(quant_fmt_name) if quant_fmt_name
            else _build.snap_args(None))
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _build.load("tp_matmul").tp_matmul_launch
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
             _build.dtype_code(a.dtype), _build.dtype_code(out_dtype), *snap,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tp_matmul")
    tp_matmul_cuda.launches += 1
    return out


#: launches of the CUDA kernel (CPU calls and plain-version calls add none)
tp_matmul_cuda.launches = 0

_OUT_MANT = {torch.bfloat16: 7, torch.float16: 10}


def agreement_tol(a, b, got, want, quant_fmt_name: Optional[str] = None):
    """Elementwise bound on ``|kernel - plain|`` for one product: two f32
    sums of the same K products in different orders differ by at most
    ``2 K 2^-24 (|A| @ |B|)`` (A, B the operands as multiplied, snapped
    when ``quant_fmt_name`` is given), plus, for a bf16 / fp16 output, one
    ulp of that type at the larger of the two results (the two f32 sums may
    round to neighbouring outputs)."""
    sa, sb = a.to(torch.float32), b.to(torch.float32)
    if quant_fmt_name:
        sa = ref.tp_quantize_ref(sa, fmt_name=quant_fmt_name)
        sb = ref.tp_quantize_ref(sb, fmt_name=quant_fmt_name)
    tol = (2.0 * a.shape[1] * 2.0 ** -24) * (sa.abs() @ sb.abs())
    m = _OUT_MANT.get(got.dtype)
    if m is not None:
        mag = torch.maximum(got.float().abs(), want.float().abs())
        _, e = torch.frexp(mag)
        tol = tol + torch.ldexp(torch.ones_like(mag), e - 1 - m)
    return tol
