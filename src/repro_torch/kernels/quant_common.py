"""Shared CONV-stage helpers (FPnew CONV block) in torch.

Integer-space RNE rounding of f32 containers onto an arbitrary (e, m) grid
— the plain-torch twin of the ``__device__`` functions in
``csrc/quant_common.cuh`` that both attention kernels use to widen their
operands.  The arithmetic is int32: the magnitude of an f32 fits in 31 bits,
and torch on the CPU has no uint32 ``>>``, ``+`` or ``<``.

Semantics (bit for bit as the JAX package's ``quant_common``): normals
round to nearest even; below min normal the value flushes to zero, except
the RNE boundary band ``[min_normal * (1 - 2^-(m+1)), min_normal)`` which
rounds up to min normal; overflow goes to ±Inf (±max normal with
``saturate=True``); Inf and NaN pass through.
"""
from __future__ import annotations

import torch

from ..core.formats import FPFormat, get_format

_SIGN = -(1 << 31)          # 0x80000000 as int32
_MAG = (1 << 31) - 1        # 0x7FFFFFFF
_INF = 0xFF << 23


def quantize_rne_bits(x: torch.Tensor, fmt: FPFormat,
                      saturate: bool = False) -> torch.Tensor:
    """RNE grid snap of an f32 tensor onto ``fmt`` (FTZ below min normal,
    boundary band to min normal)."""
    fmt = get_format(fmt)
    m, emax, emin = fmt.m_bits, fmt.emax, fmt.emin
    assert x.dtype == torch.float32, x.dtype
    assert 1 <= m < 23 and fmt.e_bits <= 8, fmt
    s = 23 - m
    bits = x.contiguous().view(torch.int32)
    sign = bits & _SIGN
    mag = bits & _MAG
    special = mag >= _INF
    mag_c = torch.where(special, torch.zeros_like(mag), mag)
    tie = (mag_c >> s) & 1
    rmag = ((mag_c + ((1 << (s - 1)) - 1) + tie) >> s) << s
    max_bits = ((emax + 127) << 23) | (((1 << m) - 1) << s)
    ovf = max_bits if saturate else _INF
    rmag = torch.where(rmag > max_bits, torch.full_like(rmag, ovf), rmag)
    min_bits = (emin + 127) << 23
    boundary = ((emin - 1 + 127) << 23) | (((1 << m) - 1) << (23 - m))
    low = torch.where(mag_c >= boundary, torch.full_like(rmag, min_bits),
                      torch.zeros_like(rmag))
    rmag = torch.where(rmag < min_bits, low, rmag)
    rmag = torch.where(special, mag, rmag)
    return (sign | rmag).view(torch.float32)


def widen(x: torch.Tensor, fmt, src_dtype: torch.dtype) -> torch.Tensor:
    """CONV stage: storage format -> compute format at the FMA input.
    Native narrow dtypes widen exactly; f32 containers RNE-snap onto the
    storage grid first (emulated narrow storage)."""
    if fmt is not None and x.dtype == torch.float32:
        x = quantize_rne_bits(x, fmt)
    return x.to(src_dtype)
