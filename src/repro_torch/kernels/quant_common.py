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
through.  ``quantize_flag_masks`` / ``widen_with_flags`` add the IEEE status
flags (OF, UF, NX, NV) of that snap, the telemetry the attention kernels
count (``flag_bits`` in ``csrc/quant_common.cuh``).
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


def quantize_flag_masks(x: torch.Tensor, fmt, saturate: bool = False):
    """RNE grid snap plus the IEEE status flags it raises (FPnew's fflags,
    FTZ flavor): ``(y, of, uf, nx, nv)`` with per-element bool masks, bit
    for bit as the JAX package's ``quantize_flag_masks``.

    OF: |x| rounded beyond max normal (raised in both overflow modes;
    ``saturate`` changes the value written, not the flag).  UF: nonzero
    |x| below min normal and inexact.  NX: y != x.  NV: x is NaN.  Inf
    and NaN pass through and raise only NV (NaN)."""
    fmt = get_format(fmt)
    assert 1 <= fmt.m_bits < 23 and fmt.e_bits <= 8, fmt
    return quantize_flag_masks_grid(x, fmt.m_bits, fmt.emax, fmt.emin,
                                    saturate)


def quantize_flag_masks_grid(x: torch.Tensor, m, emax, emin,
                             saturate: bool = False):
    """``quantize_flag_masks`` onto the grid (m mantissa bits, exponents
    [emin, emax]) given as ints or as int32 tensors that broadcast against
    ``x`` — one grid per row, say, as ``models.attention.quantize_kv_rows``
    snaps each row onto its own rung in one pass."""
    assert x.dtype == torch.float32, x.dtype
    m, emax, emin = (torch.as_tensor(v, dtype=torch.int32, device=x.device)
                     for v in (m, emax, emin))
    one = torch.ones_like(m)
    s = 23 - m
    bits = x.contiguous().view(torch.int32)
    sign = bits & _SIGN
    mag = bits & _MAG
    special = mag >= _INF
    nv = mag > _INF
    mag_c = torch.where(special, 0, mag)
    rmag = ((mag_c + ((one << (s - 1)) - 1) + ((mag_c >> s) & 1)) >> s) << s
    frac = ((one << m) - 1) << s
    max_bits = ((emax + 127) << 23) | frac
    over = rmag > max_bits
    rmag = torch.where(over, max_bits if saturate else _INF, rmag)
    min_bits = (emin + 127) << 23
    boundary = ((emin - 1 + 127) << 23) | frac
    low = torch.where(mag_c >= boundary, min_bits, 0).to(torch.int32)
    rmag = torch.where(rmag < min_bits, low, rmag)
    of = over & ~special
    nx = (rmag != mag) & ~special
    uf = (mag != 0) & (mag < min_bits) & nx
    rmag = torch.where(special, mag, rmag)
    return (sign | rmag).view(torch.float32), of, uf, nx, nv


def widen(x: torch.Tensor, fmt, src_dtype: torch.dtype) -> torch.Tensor:
    """CONV stage: storage format -> compute format at the FMA input.
    Native narrow dtypes widen exactly; f32 containers RNE-snap onto the
    storage grid first (emulated narrow storage)."""
    if fmt is not None and x.dtype == torch.float32:
        x = quantize_rne_bits(x, fmt)
    return x.to(src_dtype)


def widen_with_flags(x: torch.Tensor, fmt, src_dtype: torch.dtype):
    """``widen`` plus the flag masks the CONV stage raises: ``(y, of, uf,
    nx, nv)``.  An f32 container with a grid reports the full set of its
    snap; native storage (or no grid) widens exactly, so what remains
    observable is the damage already stored: OF := stored +-Inf, NV :=
    stored NaN, UF = NX = False."""
    if fmt is not None and x.dtype == torch.float32:
        y, of, uf, nx, nv = quantize_flag_masks(x, fmt)
        return y.to(src_dtype), of, uf, nx, nv
    none = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    xf = x.to(torch.float32)          # exact: isinf / isnan of any storage
    return x.to(src_dtype), torch.isinf(xf), none, none, torch.isnan(xf)


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


def split_pieces(src_dtype, grid=None):
    """The bf16 pieces the split route cuts each operand into — the route
    for f32 operands that no 16-bit type holds exactly — or None (a 16-bit
    tile takes them, or they are not f32 values the kernels split).  A
    piece carries 8 significant bits and leaves at most ``bits - 9``
    behind (the sign of RNE's remainder), so two pieces hold a value of up
    to 17 significant bits exactly (a grid with m <= 16: tf32 among them)
    and three every normal f32 (no grid)."""
    if grid:
        f = get_format(grid)
        if (exact_tile_dtype(f) is not None
                or not (1 <= f.m_bits < 23 and f.e_bits <= 8)):
            return None
        return 2 if f.m_bits <= 16 else 3
    return 3 if src_dtype == torch.float32 else None


def split_bf16(x: torch.Tensor, pieces: int):
    """The plain twin of ``tc::split_bf16`` (``csrc/tc_common.cuh``): f32
    ``x`` as ``pieces`` f32 tensors holding bf16 values, piece i the RNE
    bf16 of what the pieces before it leave (each subtraction exact).  A
    finite x that RNE would round past bf16's largest finite value gets
    its truncation as the first piece; Inf and NaN go whole into the last
    piece, the others 0."""
    r = x.to(torch.float32)
    fin = torch.isfinite(r)
    r = torch.where(fin, r, torch.zeros_like(r))
    out = []
    for i in range(pieces):
        h = r.to(torch.bfloat16).to(torch.float32)
        if i == 0:
            trunc = (r.contiguous().view(torch.int32) & -65536).view(
                torch.float32)
            h = torch.where(torch.isinf(h), trunc, h)
        r = r - h
        out.append(h)
    out[-1] = torch.where(fin, out[-1], x.to(torch.float32))
    return out


def split_pairs(pa: int, pb: int, top: int = 2):
    """The piece pairs ``(i, j)`` a split product keeps, in the kernels'
    order (``tc::for_each_pair``): ``i + j <= top`` — at ``top`` 2 the
    pairs of weight 2^-16 and up, all four at two pieces, six at three;
    flash's P V keeps ``top`` 1, three pairs of two pieces — smallest
    weight first."""
    return [(i, w - i) for w in range(top, -1, -1)
            for i in range(pa - 1, -1, -1) if 0 <= w - i < pb]


def split_product(f, x: torch.Tensor, y: torch.Tensor, px: int, py: int,
                  top: int = 2, repair: bool = True):
    """A bilinear ``f(x, y)`` (a matmul, an einsum) as the split route
    computes it: ``f`` of the kept piece pairs (``split_pairs``), summed in
    f32 in the kernels' order.  Every piece product is exact in f32.  With
    ``repair``, a NaN the pairs make is ``f`` of the operands whole, as the
    kernels recompute it (a non-finite operand meeting a partner's zero
    piece gives NaN where IEEE's product gives +-Inf)."""
    xs, ys = split_bf16(x, px), split_bf16(y, py)
    out = None
    for i, j in split_pairs(px, py, top):
        t = f(xs[i], ys[j])
        out = t if out is None else out + t
    if repair:
        out = torch.where(torch.isnan(out), f(x.to(torch.float32),
                                              y.to(torch.float32)), out)
    return out
