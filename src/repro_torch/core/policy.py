"""Precision policies — the software analogue of FPnew's per-op-group format
configuration (paper §II.B.2, Tables I/II), field for field as in the JAX
package.

  ADDMUL  -> matmuls / FMAs                      -> :class:`MatmulPolicy`
  DIVSQRT -> elementwise transcendentals         -> ``elem_fmt``
  COMP    -> comparisons, masking, argmax        -> ``comp_fmt``
  CONV    -> dtype conversions, quantization     -> ``rounding`` mode

``native`` mode carries real narrow torch dtypes; ``emulate`` mode keeps
f32 containers snapped onto the target grid (``core.softfloat``).
``EscalationPolicy`` steers the serving engine's flag-driven KV-precision
escalation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .formats import FPFormat, get_format

__all__ = ["MatmulPolicy", "PrecisionPolicy", "EscalationPolicy",
           "get_policy", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class MatmulPolicy:
    """Multi-format FMA configuration: ``dst fma(src, src, dst)`` (§II.B.4).

    ``src_fmt``: operand/multiply format; ``acc_fmt``: accumulation format;
    ``out_fmt``: storage format of the result (None = keep acc)."""
    src_fmt: FPFormat
    acc_fmt: FPFormat
    out_fmt: Optional[FPFormat] = None

    def resolved_out(self) -> FPFormat:
        return self.out_fmt or self.acc_fmt


def _f(x):
    return get_format(x) if x is not None else None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    mode: str = "native"                      # "native" | "emulate"
    matmul: MatmulPolicy = None               # ADDMUL group
    elem_fmt: FPFormat = None                 # DIVSQRT-ish group
    comp_fmt: FPFormat = None                 # COMP group
    rounding: str = "rne"                     # CONV group rounding
    param_fmt: FPFormat = None                # parameter storage
    grad_comm_fmt: Optional[FPFormat] = None  # gradient all-reduce format
    kv_fmt: Optional[FPFormat] = None         # KV-cache storage
    opt_m_fmt: Optional[FPFormat] = None      # optimizer 1st-moment storage
    opt_v_fmt: Optional[FPFormat] = None      # optimizer 2nd-moment storage
    master_fmt: FPFormat = None               # master weights / updates
    stochastic_grad_round: bool = False       # SR when quantizing grads
    narrow_partials: bool = False

    def __post_init__(self):
        object.__setattr__(self, "matmul", self.matmul or MatmulPolicy(
            get_format("fp32"), get_format("fp32")))
        for field in ("elem_fmt", "comp_fmt", "param_fmt", "master_fmt"):
            v = getattr(self, field)
            object.__setattr__(self, field, _f(v) or get_format("fp32"))
        for field in ("grad_comm_fmt", "kv_fmt", "opt_m_fmt", "opt_v_fmt"):
            object.__setattr__(self, field, _f(getattr(self, field)))
        if self.mode not in ("native", "emulate"):
            raise ValueError(f"mode must be native|emulate, got {self.mode}")
        if self.mode == "native":
            for fmt in (self.matmul.src_fmt, self.param_fmt):
                if fmt.native_dtype is None:
                    raise ValueError(
                        f"policy {self.name}: format {fmt} has no native dtype; "
                        f"use mode='emulate'")

    def replace(self, **kw) -> "PrecisionPolicy":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Flag-driven KV-precision escalation — the inverse of graceful
    degradation, steered by the IEEE flags of the write-side CONV stage.

    A serving row starts at ``ladder[0]`` (narrowest).  Its accumulated
    write-time OF / UF counts are its pressure; when either crosses its
    threshold and the row is not at the top rung (``top()``),
    ``launch.engine.ContinuousEngine`` moves it one rung up by a forced
    free-and-reingest, recomputing its K/V at the wider format
    (``formats``).  Refusable per request (``Request.no_escalate``) and
    deferred while fewer than ``min_free_pages`` pages are free.  Every
    rung fits the engine's f32 pool container; ``uf_threshold`` defaults
    effectively off."""
    ladder: tuple = ("fp8", "fp16", "fp16alt")
    of_threshold: int = 8
    uf_threshold: int = 1 << 30
    min_free_pages: int = 0

    def __post_init__(self):
        if len(self.ladder) < 2:
            raise ValueError("escalation ladder needs >= 2 rungs")
        if self.of_threshold < 1 or self.uf_threshold < 1:
            raise ValueError("escalation thresholds must be >= 1")
        for name in self.ladder:
            fmt = get_format(name)
            if fmt.e_bits > 8 or fmt.m_bits > 23:
                raise ValueError(
                    f"ladder rung {name!r} does not fit an f32 container")

    @property
    def formats(self) -> tuple:
        return tuple(get_format(n) for n in self.ladder)

    def top(self) -> int:
        return len(self.ladder) - 1


def _mk(name, src, acc, out=None, **kw) -> PrecisionPolicy:
    return PrecisionPolicy(
        name=name,
        matmul=MatmulPolicy(get_format(src), get_format(acc), _f(out)),
        **kw)


PRESETS = {
    "fp32": _mk("fp32", "fp32", "fp32", param_fmt="fp32", elem_fmt="fp32"),
    "tp_fp16": _mk("tp_fp16", "fp16", "fp32", out="fp16",
                   param_fmt="fp16", elem_fmt="fp32", kv_fmt="fp16"),
    "tp_bf16": _mk("tp_bf16", "fp16alt", "fp32", out="fp16alt",
                   param_fmt="fp16alt", elem_fmt="fp32", kv_fmt="fp16alt"),
    "tp_fp8": _mk("tp_fp8", "fp8", "fp32", out="fp16alt",
                  param_fmt="fp16alt", elem_fmt="fp32", kv_fmt="fp8"),
    "tp_bf16_kv8": _mk("tp_bf16_kv8", "fp16alt", "fp32", out="fp16alt",
                       param_fmt="fp16alt", elem_fmt="fp32", kv_fmt="fp8"),
    "prod_tp": _mk("prod_tp", "fp16alt", "fp32", out="fp16alt",
                   param_fmt="fp16alt", elem_fmt="fp32",
                   grad_comm_fmt="fp8", kv_fmt="fp8",
                   opt_m_fmt="fp16alt", opt_v_fmt="fp16alt",
                   stochastic_grad_round=True),
    "em_fp16": _mk("em_fp16", "fp16", "fp32", out="fp16", mode="emulate",
                   param_fmt="fp16", elem_fmt="fp32"),
    "em_fp8": _mk("em_fp8", "fp8", "fp32", out="fp16", mode="emulate",
                  param_fmt="fp16", elem_fmt="fp32"),
}


def get_policy(p) -> PrecisionPolicy:
    if isinstance(p, PrecisionPolicy):
        return p
    try:
        return PRESETS[p]
    except KeyError:
        raise KeyError(f"unknown policy {p!r}; known: {sorted(PRESETS)}")
