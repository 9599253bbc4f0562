"""Transprecision operations — FPnew's functional units as torch ops
(native mode only).

  * ``tp_einsum`` / ``tp_matmul`` — operands in ``src_fmt``, accumulation in
    ``acc_fmt``, result stored in ``out_fmt`` (the expanding FMA, Fig 11e).
  * ``tp_elementwise`` — DIVSQRT-group ops computed in ``elem_fmt``.

On the CPU the operands are cast to ``src_fmt`` and upcast to f32 before the
product, as the JAX package does there (narrow -> f32 casts are exact).  On
the GPU the product takes bf16/fp16 operands with f32 accumulation; the
reduced-precision reduction and TF32 are switched off when this module is
imported, so a bf16 product is one f32 sum rounded once.  An f32-output
product uses ``torch.mm(..., out_dtype=torch.float32)`` and never widens the
weight operand.  These plain products stay with torch, as the JAX package
leaves them to XLA.

``emulate`` mode (f32 containers snapped onto the format grid by softfloat)
is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .formats import get_format
from .policy import get_policy

__all__ = ["tp_einsum", "tp_matmul", "tp_elementwise", "storage_dtype"]

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_tf32 = False


def _native_only(policy):
    if policy.mode != "native":
        raise NotImplementedError(
            f"policy {policy.name!r}: emulate mode needs the softfloat "
            f"port, which is not done yet")
    if policy.narrow_partials:
        raise NotImplementedError("narrow_partials is not ported")


def storage_dtype(fmt, mode: str) -> torch.dtype:
    """dtype used to store values of ``fmt`` under the given mode."""
    fmt = get_format(fmt)
    if mode == "native":
        assert fmt.native_dtype is not None, f"{fmt} has no native dtype"
        return fmt.native_dtype
    return torch.float32


def _out_dtype(policy, out_fmt) -> torch.dtype:
    out = get_format(out_fmt) if out_fmt is not None \
        else policy.matmul.resolved_out()
    return out.native_dtype


def tp_einsum(spec: str, a, b, policy, *, out_fmt=None):
    """Contraction with multi-format FMA semantics (native mode)."""
    policy = get_policy(policy)
    _native_only(policy)
    mp = policy.matmul
    src = mp.src_fmt.native_dtype
    acc = storage_dtype(mp.acc_fmt, "native")
    out = _out_dtype(policy, out_fmt)
    a, b = a.to(src), b.to(src)
    if a.device.type == "cuda" and out == src and acc == torch.float32:
        return torch.einsum(spec, a, b)          # f32 sum, one rounding
    return torch.einsum(spec, a.to(acc), b.to(acc)).to(out)


def tp_matmul(a, b, policy, *, out_fmt=None):
    """``a [..., K] @ b [K, N]`` under the policy (native mode)."""
    policy = get_policy(policy)
    _native_only(policy)
    mp = policy.matmul
    src = mp.src_fmt.native_dtype
    acc = storage_dtype(mp.acc_fmt, "native")
    out = _out_dtype(policy, out_fmt)
    a, b = a.to(src), b.to(src)
    if a.device.type != "cuda":
        return torch.matmul(a.to(acc), b.to(acc)).to(out)
    if out == src and acc == torch.float32:
        return torch.matmul(a, b)
    lead = a.shape[:-1]
    r = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=acc)
    return r.reshape(*lead, b.shape[-1]).to(out)


_ELEM_FNS = {
    "exp": torch.exp, "log": torch.log, "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt, "div": lambda a, b: a / b, "recip": lambda a: 1.0 / a,
    "tanh": torch.tanh, "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
}


def tp_elementwise(fn: str, *args, policy, out_fmt=None):
    """DIVSQRT-group op computed in ``elem_fmt``."""
    policy = get_policy(policy)
    _native_only(policy)
    cdt = storage_dtype(policy.elem_fmt, "native")
    r = _ELEM_FNS[fn](*[x.to(cdt) for x in args])
    if out_fmt is not None:
        r = r.to(get_format(out_fmt).native_dtype)
    return r
