"""Fused quantize / cast-and-pack (FPnew CONV block).

``tp_quantize_cuda`` and ``cast_and_pack_cuda`` are the ports of the TPU
kernels ``repro.kernels.tp_quant.tp_quantize_pallas`` and
``cast_and_pack_pallas``: one hand-written CUDA source
(``csrc/tp_quant.cu``, sm_90a) with two entry points, for tensors on the
card.  ``tp_quantize_plain`` / ``cast_and_pack_plain`` are their plain-torch
versions (``quant_common.quantize_bits``, the same integer stage).
``kernels.ops`` chooses between them by the tensors' device.

  * quantize: f32 [R, C] -> ``fmt``'s grid, RNE or stochastic, FTZ below
    min normal, stored in ``out_dtype`` (f32 / bf16 / fp16);
  * cast-and-pack: two f32 streams quantized (b with ``~rbits``) and their
    columns interleaved, ``out[:, 2i] = qa[:, i]``, ``out[:, 2i+1] =
    qb[:, i]`` -> [R, 2C] f32.

``rbits`` is x's shape of 32 random bits (int32 on the device; the bit
pattern is what counts), drawn by the caller (``kernels.ops``), so the
kernels and their plain versions agree BITWISE in both modes.
"""
from __future__ import annotations

import torch

from . import _build
from .quant_common import quantize_bits

_OUTPUTS = (torch.float32, torch.bfloat16, torch.float16)


def tp_quantize_plain(x, rbits=None, *, fmt_name: str,
                      stochastic: bool = False, out_dtype=torch.float32):
    """The quantize kernel's function in plain torch."""
    return quantize_bits(x, rbits, fmt_name, stochastic).to(out_dtype)


def cast_and_pack_plain(a, b, rbits=None, *, fmt_name: str,
                        stochastic: bool = False, out_dtype=torch.float32):
    """The cast-and-pack kernel's function in plain torch."""
    if rbits is not None and rbits.dtype != torch.int32:
        rbits = rbits.view(torch.int32)     # ``~`` on the bit pattern
    qa = quantize_bits(a, rbits, fmt_name, stochastic)
    qb = quantize_bits(b, None if rbits is None else ~rbits, fmt_name,
                       stochastic)
    r, c = qa.shape
    return torch.stack([qa, qb], dim=-1).reshape(r, 2 * c).to(out_dtype)


def _check(name, xs, rbits, stochastic, out_dtype):
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel needs CUDA tensors, got "
                         f"{x.device}")
    for t in xs:
        if t.dtype != torch.float32 or t.shape != x.shape \
                or t.device != x.device:
            raise ValueError(f"{name}: inputs must be f32 tensors of one "
                             f"shape on one device")
    if x.dim() != 2:
        raise ValueError(f"{name}: inputs must be 2-D, got {tuple(x.shape)}")
    if out_dtype not in _OUTPUTS:
        raise TypeError(f"out_dtype {out_dtype} is not one of {_OUTPUTS}")
    if stochastic:
        if rbits is None or rbits.shape != x.shape \
                or rbits.dtype not in (torch.int32, torch.uint32) \
                or rbits.device != x.device:
            raise ValueError(f"{name}: stochastic mode needs int32 rbits of "
                             f"the inputs' shape on their device")
        return rbits.contiguous()
    return None


def tp_quantize_cuda(x, rbits=None, *, fmt_name: str,
                     stochastic: bool = False, out_dtype=torch.float32):
    """Quantize a 2-D f32 tensor onto ``fmt_name``'s grid; one launch per
    call.  Raises on tensors that do not lie on a CUDA device."""
    r = _check("tp_quantize", (x,), rbits, stochastic, out_dtype)
    snap = _build.grid_args(fmt_name)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    fn = _build.load("tp_quant").tp_quantize_launch
    err = fn(x.data_ptr(), r.data_ptr() if r is not None else None,
             out.data_ptr(), x.numel(), int(stochastic),
             _build.dtype_code(out_dtype), *snap,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "tp_quantize")
    tp_quantize_cuda.launches += 1
    return out


def cast_and_pack_cuda(a, b, rbits=None, *, fmt_name: str,
                       stochastic: bool = False, out_dtype=torch.float32):
    """Quantize two 2-D f32 tensors and interleave their columns; one
    launch per call.  Raises on tensors that do not lie on a CUDA device."""
    r = _check("cast_and_pack", (a, b), rbits, stochastic, out_dtype)
    snap = _build.grid_args(fmt_name)
    a, b = a.contiguous(), b.contiguous()
    rows, cols = a.shape
    out = torch.empty((rows, 2 * cols), dtype=out_dtype, device=a.device)
    fn = _build.load("tp_quant").cast_and_pack_launch
    err = fn(a.data_ptr(), b.data_ptr(),
             r.data_ptr() if r is not None else None, out.data_ptr(),
             a.numel(), int(stochastic), _build.dtype_code(out_dtype), *snap,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "cast_and_pack")
    cast_and_pack_cuda.launches += 1
    return out


#: launches of the CUDA kernels (CPU calls and plain-version calls add none)
tp_quantize_cuda.launches = 0
cast_and_pack_cuda.launches = 0
