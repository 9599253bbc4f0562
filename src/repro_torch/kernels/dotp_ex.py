"""Expanding dot-product accumulation — the paper's case-study kernel
(Fig 10/11e): products of two narrow input streams accumulated in f32
(``fmacex.s.h``), f32 accuracy at fp16 storage cost.

``dotp_ex_cuda`` is the port of the TPU kernel
``repro.kernels.dotp_ex.dotp_ex_pallas``: a hand-written CUDA kernel
(``csrc/dotp_ex.cu``, sm_90a) for tensors on the card.  ``dotp_ex_plain``
is its plain-torch version.  ``kernels.ops.dotp_ex`` chooses between them
by the tensors' device and adds the lanes.

Contract: two streams of n elements (f32 / bf16 / fp16, one dtype) laid
out as rows of ``LANES`` lanes (element e in lane e % 128 — the TPU
kernel's (R, 128) tiles, the ragged last row zero-filled); each element
widened to ``src_dtype``, exact products, f32 sums per lane -> (1, 128).
The two versions sum each lane in another order (the kernel in a fixed
two-pass tree), so they agree to f32 summation error, not bitwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LANES = 128
_INPUTS = (torch.float32, torch.bfloat16, torch.float16)


def dotp_ex_plain(a, b, *, src_dtype=torch.float16):
    """Lane sums of the widened products, in plain torch: (1, 128) f32."""
    n = a.numel()
    pad = (-n) % LANES
    pa = a.reshape(-1).to(src_dtype).to(torch.float32)
    pb = b.reshape(-1).to(src_dtype).to(torch.float32)
    prod = F.pad(pa * pb, (0, pad)).reshape(-1, LANES)
    return prod.sum(dim=0, keepdim=True)


def dotp_ex_cuda(a, b, *, src_dtype=torch.float16):
    """Lane sums (1, 128) f32 of the widened products of two equal-length
    streams; one launch per call (the kernel's two passes).  Raises on
    tensors that do not lie on a CUDA device."""
    if a.device.type != "cuda":
        raise ValueError(f"the dotp_ex kernel needs CUDA tensors, got "
                         f"{a.device}")
    if a.numel() != b.numel() or a.dtype != b.dtype \
            or a.dtype not in _INPUTS or b.device != a.device:
        raise ValueError(f"a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype}: need equal lengths "
                         f"and one dtype of {_INPUTS} on one device")
    a, b = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    lib = _build.load("dotp_ex")
    partial = torch.empty((lib.dotp_ex_max_blocks(), LANES),
                          dtype=torch.float32, device=a.device)
    out = torch.empty((1, LANES), dtype=torch.float32, device=a.device)
    err = lib.dotp_ex_launch(a.data_ptr(), b.data_ptr(), partial.data_ptr(),
                             out.data_ptr(), a.numel(),
                             _build.dtype_code(a.dtype),
                             _build.src_kind(src_dtype),
                             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "dotp_ex")
    dotp_ex_cuda.launches += 1
    return out


#: launches of the CUDA kernel (CPU calls and plain-version calls add none)
dotp_ex_cuda.launches = 0
