"""FP format definitions — the software analogue of FPnew's parametric format
slices (paper §II.A.1), for the PyTorch port.

An :class:`FPFormat` is a frozen (exponent bits, mantissa bits) descriptor
carrying the derived IEEE constants; :data:`REGISTRY` ships the paper's five
formats plus the beyond-paper extras.  Formats with a native torch dtype
expose it as ``native_dtype``:

  fp16     -> torch.float16
  fp16alt  -> torch.bfloat16
  fp8      -> torch.float8_e5m2 (IEEE-style: has Inf)

``fp8_e4m3`` is IEEE-style (has Inf, max normal 240) and has NO torch twin:
``torch.float8_e4m3fn`` is a different format (no Inf, max 448), so the two
are never mapped onto each other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "FPFormat", "REGISTRY", "get_format",
    "FP64", "FP32", "FP16", "FP16ALT", "FP8",
    "FP8_E4M3", "TF32",
]


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """An IEEE-754-style binary format with ``e_bits`` exponent and
    ``m_bits`` explicit mantissa bits (plus sign).  Paper Fig. 1."""

    name: str
    e_bits: int
    m_bits: int
    # torch dtype implementing this format natively, if one exists
    native: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.e_bits < 2 or self.m_bits < 1:
            raise ValueError(
                f"format {self.name}: need >=2 exponent and >=1 mantissa bits"
            )

    @property
    def width(self) -> int:
        return 1 + self.e_bits + self.m_bits

    @property
    def bias(self) -> int:
        return (1 << (self.e_bits - 1)) - 1

    @property
    def emax(self) -> int:
        return self.bias

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def precision(self) -> int:
        """Significand precision incl. hidden bit."""
        return self.m_bits + 1

    @property
    def max_normal(self) -> float:
        return float((2.0 - 2.0 ** (-self.m_bits)) * 2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.emin)

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (self.emin - self.m_bits))

    @property
    def eps(self) -> float:
        return float(2.0 ** (-self.m_bits))

    @property
    def native_dtype(self) -> Optional[torch.dtype]:
        """torch dtype natively implementing this format, or None."""
        return self.native

    def fits_in_f32(self) -> bool:
        return self.e_bits <= 8 and self.m_bits <= 23

    def container_dtype(self) -> torch.dtype:
        """Narrowest standard float dtype whose grid is a superset of ours,
        with enough precision for innocuous double rounding
        (p_container >= 2*p + 2, Figueroa)."""
        if self.fits_in_f32() and 24 >= 2 * self.precision + 2:
            return torch.float32
        return torch.float64

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name}({self.e_bits},{self.m_bits})"


FP64 = FPFormat("fp64", 11, 52, native=torch.float64)
FP32 = FPFormat("fp32", 8, 23, native=torch.float32)
FP16 = FPFormat("fp16", 5, 10, native=torch.float16)
#: paper's binary16alt == bfloat16 encoding, full IEEE semantics
FP16ALT = FPFormat("fp16alt", 8, 7, native=torch.bfloat16)
#: paper's custom quarter-precision minifloat (5, 2) == float8_e5m2
FP8 = FPFormat("fp8", 5, 2, native=torch.float8_e5m2)

# beyond-paper formats exercising the arbitrary-(e,m) machinery
FP8_E4M3 = FPFormat("fp8_e4m3", 4, 3, native=None)  # IEEE-style e4m3 (with inf)
TF32 = FPFormat("tf32", 8, 10, native=None)
FP6_E3M2 = FPFormat("fp6_e3m2", 3, 2, native=None)

REGISTRY = {
    f.name: f
    for f in (FP64, FP32, FP16, FP16ALT, FP8, FP8_E4M3, TF32, FP6_E3M2)
}
# aliases
REGISTRY["bf16"] = FP16ALT
REGISTRY["bfloat16"] = FP16ALT
REGISTRY["float32"] = FP32
REGISTRY["float16"] = FP16


def get_format(fmt) -> FPFormat:
    """Coerce a name / FPFormat / (e,m) tuple to an FPFormat."""
    if isinstance(fmt, FPFormat):
        return fmt
    if isinstance(fmt, str):
        try:
            return REGISTRY[fmt]
        except KeyError:
            raise KeyError(f"unknown FP format {fmt!r}; known: {sorted(REGISTRY)}")
    if isinstance(fmt, (tuple, list)) and len(fmt) == 2:
        e, m = fmt
        return FPFormat(f"fp_e{e}m{m}", e, m)
    raise TypeError(f"cannot interpret {fmt!r} as FP format")
