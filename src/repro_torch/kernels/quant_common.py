"""Shared CONV-stage helpers (FPnew CONV block) in torch.

Integer-space rounding (RNE or stochastic) of f32 containers onto an
arbitrary (e, m) grid — the plain-torch twin of the ``__device__`` functions
in ``csrc/quant_common.cuh`` that every CUDA kernel of the port uses: the
attention kernels to widen their operands, tp_matmul for its fused operand
snap, tp_quant for the standalone CONV.  The arithmetic is int32: the
magnitude of an f32 fits in 31 bits, and torch on the CPU has no uint32
``>>``, ``+`` or ``<``.

Semantics (bit for bit as the JAX package's ``quant_common``): normals
round to nearest even (or up by a random s-bit addend); below min normal the
value flushes to zero, except the RNE boundary band
``[min_normal * (1 - 2^-(m+1)), min_normal)`` which rounds up to min normal;
overflow goes to ±Inf (±max normal with ``saturate=True``); Inf and NaN pass
through.
"""
from __future__ import annotations

import torch

from ..core.formats import FPFormat, get_format

_SIGN = -(1 << 31)          # 0x80000000 as int32
_MAG = (1 << 31) - 1        # 0x7FFFFFFF
_INF = 0xFF << 23


def quantize_bits(x: torch.Tensor, rbits, fmt, stochastic: bool,
                  saturate: bool = False) -> torch.Tensor:
    """Integer-space rounding of an f32 tensor onto ``fmt``'s grid (normals;
    FTZ below min normal, the MXU-input-stage contract of the JAX
    package's ``quantize_bits``; ``softfloat.quantize`` keeps the gradual-
    underflow oracle).

    ``rbits`` holds x's shape of 32 random bits (int32 or uint32; the bit
    pattern is what counts) for the stochastic addend; ignored (may be
    None) when ``stochastic`` is False.  RNE rounds the boundary band
    ``[min_normal * (1 - 2^-(m+1)), min_normal)`` up to min normal;
    stochastic mode flushes everything below min normal.  ``saturate=True``
    clamps overflow to +-max normal instead of +-Inf."""
    fmt = get_format(fmt)
    m, emax, emin = fmt.m_bits, fmt.emax, fmt.emin
    assert x.dtype == torch.float32, x.dtype
    assert 1 <= m < 23 and fmt.e_bits <= 8, fmt
    s = 23 - m
    bits = x.contiguous().view(torch.int32)
    sign = bits & _SIGN
    mag = bits & _MAG
    special = mag >= _INF
    mag_c = torch.where(special, 0, mag)
    if stochastic:
        r = rbits if rbits.dtype == torch.int32 else rbits.view(torch.int32)
        addend = r.reshape(x.shape) & ((1 << s) - 1)
    else:
        addend = ((1 << (s - 1)) - 1) + ((mag_c >> s) & 1)
    rmag = ((mag_c + addend) >> s) << s
    max_bits = ((emax + 127) << 23) | (((1 << m) - 1) << s)
    rmag = torch.where(rmag > max_bits, max_bits if saturate else _INF, rmag)
    min_bits = (emin + 127) << 23
    if stochastic:
        low = 0
    else:
        boundary = ((emin - 1 + 127) << 23) | (((1 << m) - 1) << s)
        low = torch.where(mag_c >= boundary, min_bits, 0).to(torch.int32)
    rmag = torch.where(rmag < min_bits, low, rmag)
    rmag = torch.where(special, mag, rmag)
    return (sign | rmag).view(torch.float32)


def quantize_rne_bits(x: torch.Tensor, fmt: FPFormat,
                      saturate: bool = False) -> torch.Tensor:
    """RNE grid snap of an f32 tensor onto ``fmt`` (FTZ below min normal,
    boundary band to min normal)."""
    return quantize_bits(x, None, fmt, stochastic=False, saturate=saturate)


def widen(x: torch.Tensor, fmt, src_dtype: torch.dtype) -> torch.Tensor:
    """CONV stage: storage format -> compute format at the FMA input.
    Native narrow dtypes widen exactly; f32 containers RNE-snap onto the
    storage grid first (emulated narrow storage)."""
    if fmt is not None and x.dtype == torch.float32:
        x = quantize_rne_bits(x, fmt)
    return x.to(src_dtype)


def exact_tile_dtype(fmt):
    """The 16-bit type that holds every RNE-snapped value of ``fmt``'s grid
    exactly (FTZ: normals only, plus zeros, Inf and NaN), or None: a grid
    with e <= 5 and m <= 10 lies inside fp16, one with e <= 8 and m <= 7
    inside bf16.  The tensor-core kernel variants multiply such operands
    in that type."""
    f = get_format(fmt)
    if f.e_bits <= 5 and f.m_bits <= 10:
        return torch.float16
    if f.e_bits <= 8 and f.m_bits <= 7:
        return torch.bfloat16
    return None


def operand_tile_dtype(src_dtype, grid=None):
    """The 16-bit type that holds every operand multiplied in
    ``src_dtype`` exactly, or None: bf16 and fp16 as they are; f32
    containers only when they are snapped onto ``grid`` and that grid lies
    inside a 16-bit type (``exact_tile_dtype``).  The attention kernels'
    tensor-core routes are chosen by this rule."""
    if src_dtype in (torch.bfloat16, torch.float16):
        return src_dtype
    if src_dtype == torch.float32 and grid:
        return exact_tile_dtype(grid)
    return None
