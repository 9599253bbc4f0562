"""Bit-exact software emulation of arbitrary IEEE-754-style formats, in torch.

The numerical heart of the FPnew reproduction: every functional unit (FMA,
add, mul, conversions) produces results *as if* computed in the target
format with a single rounding.  That is emulated by snapping container
values (f32, or f64 for formats whose container is f64) onto the target
format's grid with correct handling of

  * all five IEEE rounding modes (RNE, RTZ, RDN, RUP, RMM) + stochastic,
  * gradual underflow (subnormals),
  * overflow to +/-inf (or saturation, as a non-IEEE option),
  * signed zeros, inf and NaN propagation.

The rounding is done in integer bit arithmetic on the container's bit
pattern: mantissa carries propagate into the exponent field, as in a
hardware rounding stage.  Torch on the CPU has no uint32 ``>>``, ``+`` or
``<``, so the arithmetic runs in int32 (f32 containers) or int64 (f64
containers) on the magnitude, which fits in 31 or 63 bits; specials are
zeroed before the sums so nothing overflows.

The target-subnormal region (where the grid spacing is constant across
several container binades) is rounded in fixed point, ``k = x / 2^(emin-m)``
in floating point, where every quantity is container-normal and exact.
Container-subnormal inputs get the closed-form result instead (0, or one
min-subnormal step for the away-from-zero directed modes), so the result is
the same whether or not the device keeps subnormals.

Double rounding through the container is innocuous because every supported
(container, target) pair satisfies p_container >= 2*p_target + 2
(Figueroa).  Stochastic mode draws its bits from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .formats import FPFormat, get_format

__all__ = ["quantize", "quantize_with_flags", "ROUNDING_MODES", "FLAG_NAMES"]

# IEEE-754 status flags raised by a conversion (FPnew exposes these as
# RISC-V fflags).  DZ cannot fire on a cast, so the telemetry tuple is:
#   OF  overflow   — |x| rounded beyond the target's max normal
#   UF  underflow  — tiny (below min normal, before rounding) AND inexact
#   NX  inexact    — the snapped value differs from the input
#   NV  invalid    — the input was NaN
FLAG_NAMES = ("of", "uf", "nx", "nv")

ROUNDING_MODES = ("rne", "rtz", "rdn", "rup", "rmm", "stochastic")

# container descriptors: (signed int dtype of the same width, mantissa bits,
# exponent bias, exponent mask)
_CONTAINERS = {
    torch.float32: (torch.int32, 23, 127, 0xFF),
    torch.float64: (torch.int64, 52, 1023, 0x7FF),
}


def _exp_mant(dtype: torch.dtype):
    """(exponent bits, explicit mantissa bits) of a torch float dtype."""
    fi = torch.finfo(dtype)
    m = int(round(-math.log2(fi.eps)))
    return fi.bits - 1 - m, m


def _covers(fmt: FPFormat, dtype: torch.dtype) -> bool:
    """True when ``fmt``'s grid is a superset of ``dtype``'s."""
    e, m = _exp_mant(dtype)
    return fmt.e_bits >= e and fmt.m_bits >= m


def _pick(cond, a: int, b: int, dtype: torch.dtype) -> torch.Tensor:
    """``where(cond, a, b)`` for two integer constants, in ``dtype``."""
    return torch.where(cond, torch.tensor(a, dtype=dtype, device=cond.device),
                       torch.tensor(b, dtype=dtype, device=cond.device))


def _round_signed(r, mode: str, u):
    """Round an exactly-representable signed ratio ``r`` to an integer-valued
    float per ``mode``.  ``u`` is uniform [0,1) noise for stochastic mode."""
    if mode == "rne":
        return torch.round(r)  # round-half-to-even
    if mode == "rtz":
        return torch.trunc(r)
    if mode == "rdn":
        return torch.floor(r)
    if mode == "rup":
        return torch.ceil(r)
    if mode == "rmm":
        return torch.sign(r) * torch.floor(r.abs() + 0.5)
    return torch.floor(r + u)


def _quantize_core(x: torch.Tensor, *, fmt: FPFormat, mode: str,
                   saturate: bool,
                   generator: Optional[torch.Generator]):
    """Shared rounding core: the snapped value plus the four per-element
    IEEE flag masks (OF, UF, NX, NV bool tensors)."""
    if mode not in ROUNDING_MODES:
        raise ValueError(f"unknown rounding mode {mode!r}; known: "
                         f"{ROUNDING_MODES}")
    if mode == "stochastic" and generator is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    idt, cm, cbias, emask = _CONTAINERS[x.dtype]
    m, emin, emax = fmt.m_bits, fmt.emin, fmt.emax
    s = cm - m  # constant mantissa-bit shift (valid at/above target emin)

    sign_bit = -(1 << (cm + emask.bit_length()))      # 0x80..0 as signed
    bits = x.contiguous().view(idt)
    sign = bits & sign_bit
    absbits = bits & ~sign_bit
    pos = sign == 0
    inf_bits = emask << cm
    special = absbits >= inf_bits
    mag = torch.where(special, 0, absbits)

    # ---- path 1: round to m mantissa bits in integer bit space -----------
    # Valid everywhere except the target-subnormal region; mantissa carries
    # propagate into the exponent field (1.11..1 rounds up to 2.0).
    if s == 0 or mode == "rtz":
        addend = 0
    elif mode == "rne":
        addend = ((1 << (s - 1)) - 1) + ((mag >> s) & 1)
    elif mode == "rmm":
        addend = 1 << (s - 1)
    elif mode == "rdn":  # toward -inf: away from zero for negatives
        addend = _pick(pos, 0, (1 << s) - 1, idt)
    elif mode == "rup":  # toward +inf: away from zero for positives
        addend = _pick(pos, (1 << s) - 1, 0, idt)
    else:  # stochastic: a uniform s-bit addend
        addend = torch.randint(0, 1 << s, x.shape, dtype=idt,
                               generator=generator, device=x.device)
    rounded = ((mag + addend) >> s) << s

    # ---- path 2: fixed-point rounding for the target-subnormal region ----
    # Only when the target's subnormal range sits strictly above the
    # container's.  There the grid spacing is the constant 2^(emin-m), so
    # k = x / 2^(emin-m) is rounded in floating point; every quantity is
    # container-normal, hence exact.
    if emin > 1 - cbias:
        inv_q = 2.0 ** (m - emin)   # exact powers of two
        qq = 2.0 ** (emin - m)
        uu = (torch.rand(x.shape, dtype=x.dtype, generator=generator,
                         device=x.device) if mode == "stochastic" else None)
        k = _round_signed(x * inv_q, mode, uu)
        fx_bits = (k.abs() * qq).view(idt)
        subnormal_rgn = (absbits >> cm) - cbias < emin
        rounded = torch.where(subnormal_rgn, fx_bits, rounded)
        # Container-subnormal inputs: each is < 2^(1-cbias) <= half the
        # target's min subnormal (by container selection), so the correct
        # rounding is known in closed form: 0, except the away-from-zero
        # directed modes, which give one min-subnormal step.
        csub = (absbits != 0) & (absbits < (1 << cm))
        min_sub_bits = (emin - m + cbias) << cm
        if mode == "rup":
            csub_val = _pick(pos, min_sub_bits, 0, idt)
        elif mode == "rdn":
            csub_val = _pick(pos, 0, min_sub_bits, idt)
        else:
            csub_val = 0
        rounded = torch.where(csub, csub_val, rounded)

    # ---- overflow: compare against target max_normal in container bits ---
    max_bits = ((emax + cbias) << cm) | (((1 << m) - 1) << (cm - m))
    over = rounded > max_bits
    if saturate:
        ovf_val = max_bits
    elif mode in ("rne", "rmm", "stochastic"):
        ovf_val = inf_bits
    elif mode == "rtz":
        ovf_val = max_bits
    elif mode == "rdn":
        ovf_val = _pick(pos, max_bits, inf_bits, idt)
    else:  # rup
        ovf_val = _pick(pos, inf_bits, max_bits, idt)
    rounded = torch.where(over, ovf_val, rounded)

    # ---- IEEE status flags (before specials overwrite ``rounded``) -------
    nv = absbits > inf_bits                      # NaN input
    of = over & ~special
    nx = (rounded != absbits) & ~special         # OF implies NX, per IEEE
    # tininess detected before rounding: nonzero magnitude below min normal
    tiny = (absbits != 0) & ((absbits >> cm) - cbias < emin)
    uf = tiny & nx

    # specials: container inf/NaN propagate untouched
    rounded = torch.where(special, absbits, rounded)
    return (sign | rounded).view(x.dtype), of, uf, nx, nv


def _prepare(x, fmt):
    """(fmt, x as a float tensor, container input or None when an identity
    fast path applies, result of that fast path)."""
    fmt = get_format(fmt)
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    # identity fast path: target grid is a superset of the input's grid
    if _covers(fmt, x.dtype):
        return fmt, None, x
    xin = x.to(fmt.container_dtype())
    # identity fast path: target grid is a superset of the container grid
    if _covers(fmt, xin.dtype):
        return fmt, None, xin
    return fmt, xin, None


def quantize(x, fmt, mode: str = "rne", *, saturate: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Snap ``x`` onto the grid of ``fmt`` with one correct rounding.

    Returns a tensor in the *container* dtype (f32, or f64 when the target
    needs it) whose values are exactly representable in ``fmt``.  This
    models FPnew's CONV block and is the primitive from which multi-format
    FMA semantics are built.  ``mode="stochastic"`` needs ``generator``
    (on ``x``'s device)."""
    fmt, xin, same = _prepare(x, fmt)
    if xin is None:
        return same
    return _quantize_core(xin, fmt=fmt, mode=mode, saturate=saturate,
                          generator=generator)[0]


def quantize_with_flags(x, fmt, mode: str = "rne", *, saturate: bool = False,
                        generator: Optional[torch.Generator] = None):
    """:func:`quantize` plus the IEEE status flags the conversion raises.

    Returns ``(y, flags)``, ``flags`` a dict of per-element bool masks keyed
    by :data:`FLAG_NAMES`.  ``saturate=True`` clamps overflow to
    ±max_normal instead of ±Inf — OF still fires.  Exact conversions
    (identity fast paths) raise no OF/UF/NX; NV still reports NaN inputs."""
    fmt, xin, same = _prepare(x, fmt)
    if xin is None:
        no = torch.zeros(same.shape, dtype=torch.bool, device=same.device)
        return same, {"of": no, "uf": no, "nx": no, "nv": torch.isnan(same)}
    y, of, uf, nx, nv = _quantize_core(xin, fmt=fmt, mode=mode,
                                       saturate=saturate, generator=generator)
    return y, {"of": of, "uf": uf, "nx": nx, "nv": nv}
