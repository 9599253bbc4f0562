"""Transprecision operations — FPnew's functional units as torch ops.

  * ``tp_fma``     — expanding FMA ``dst fma(src a, src b, dst c)`` with a
                     single rounding into dst (the paper's Fig 11e).
  * ``tp_matmul`` / ``tp_einsum`` — the same contract lifted to
                     contractions: operands in ``src_fmt``, accumulation in
                     ``acc_fmt``, result stored in ``out_fmt``.
  * ``cast_and_pack`` — convert two scalar streams and pack them as vector
                     elements.
  * ``tp_cast``    — CONV block: format conversion with any rounding mode.
  * ``quantize_ste`` — straight-through-estimator quantization.
  * ``tp_elementwise`` — DIVSQRT-group ops computed in ``elem_fmt``.

``native`` mode emits real narrow torch dtypes.  On the CPU the operands
are cast to ``src_fmt`` and upcast to f32 before the product, as the JAX
package does there (narrow -> f32 casts are exact).  On the GPU the product
takes bf16/fp16 operands with f32 accumulation; the reduced-precision
reduction and TF32 are switched off when this module is imported, so a bf16
product is one f32 sum rounded once.  An f32-output product uses
``torch.mm(..., out_dtype=torch.float32)`` and never widens the weight
operand.  These plain products stay with torch, as the JAX package leaves
them to XLA.

``emulate`` mode snaps f32 containers onto the target grid bit-exactly
(``core.softfloat``).  ``tp_matmul(..., use_kernel=True)`` routes to the
hand-written kernel's wrapper ``kernels.ops.tp_matmul``, which in emulate
mode returns the f32 sum WITHOUT the out-format snap (as the JAX package's
Pallas route does), unlike ``tp_einsum``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import softfloat
from .formats import get_format
from .policy import get_policy

__all__ = ["tp_cast", "quantize_ste", "tp_fma", "tp_einsum", "tp_matmul",
           "cast_and_pack", "tp_elementwise", "storage_dtype"]

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_tf32 = False


def _no_narrow_partials(policy):
    if policy.narrow_partials:
        raise NotImplementedError("narrow_partials is not ported")


def storage_dtype(fmt, mode: str) -> torch.dtype:
    """dtype used to store values of ``fmt`` under the given mode."""
    fmt = get_format(fmt)
    if mode == "native":
        assert fmt.native_dtype is not None, f"{fmt} has no native dtype"
        return fmt.native_dtype
    return torch.float32


def tp_cast(x, fmt, policy=None, *, rounding: Optional[str] = None,
            generator: Optional[torch.Generator] = None,
            saturate: bool = False):
    """CONV block: convert ``x`` to ``fmt`` under the policy's mode."""
    fmt = get_format(fmt)
    policy = get_policy(policy) if policy is not None else None
    mode = policy.mode if policy is not None else "native"
    rounding = rounding or (policy.rounding if policy is not None else "rne")
    x = torch.as_tensor(x)
    if mode == "native":
        if rounding == "stochastic":
            # no native stochastic cast: snap onto the grid, then cast down
            # (the snapped values are exactly representable)
            q = softfloat.quantize(x.to(torch.float32), fmt, "stochastic",
                                   generator=generator, saturate=saturate)
            return q.to(fmt.native_dtype)
        return x.to(fmt.native_dtype)
    return softfloat.quantize(x, fmt, rounding, generator=generator,
                              saturate=saturate)


class _QuantizeSTE(torch.autograd.Function):
    """Grid snap forward, identity gradient backward."""

    @staticmethod
    def forward(ctx, x, fmt, rounding):
        y = softfloat.quantize(x, fmt, rounding)
        return y.clone() if y is x else y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def quantize_ste(x, fmt, rounding: str = "rne"):
    """Quantize to ``fmt``'s grid with a straight-through gradient."""
    return _QuantizeSTE.apply(x, get_format(fmt), rounding)


def tp_fma(a, b, c, policy, *, generator: Optional[torch.Generator] = None):
    """Expanding FMA: multiply ``a*b`` in ``src_fmt`` (exact product),
    accumulate with ``c`` in ``acc_fmt`` with a single rounding.

    Products of two src_fmt values are exact in the f32 container whenever
    2*p_src <= 24, which holds for all of the paper's sub-32-bit formats;
    the one rounding then happens in the snap to acc_fmt."""
    policy = get_policy(policy)
    mp = policy.matmul
    if policy.mode == "native":
        acc = storage_dtype(mp.acc_fmt, "native")
        sa = a.to(mp.src_fmt.native_dtype).to(acc)
        sb = b.to(mp.src_fmt.native_dtype).to(acc)
        return (sa * sb + c.to(acc)).to(acc)
    qa = softfloat.quantize(a, mp.src_fmt, policy.rounding,
                            generator=generator)
    qb = softfloat.quantize(b, mp.src_fmt, policy.rounding,
                            generator=generator)
    return softfloat.quantize(qa * qb + c, mp.acc_fmt, policy.rounding,
                              generator=generator)


def _out_fmt(policy, out_fmt):
    return (get_format(out_fmt) if out_fmt is not None
            else policy.matmul.resolved_out())


def tp_einsum(spec: str, a, b, policy, *, out_fmt=None,
              use_ste: bool = True):
    """Contraction with multi-format FMA semantics.

    native : operands cast to src_fmt's dtype, f32 (acc) sums, output cast
             to out_fmt.
    emulate: operands snapped to the src_fmt grid (STE for training), f32
             products and sums, then the acc snap (acc_fmt narrower than
             fp32) and the out snap."""
    policy = get_policy(policy)
    mp = policy.matmul
    out = _out_fmt(policy, out_fmt)
    if policy.mode == "native":
        _no_narrow_partials(policy)
        src = mp.src_fmt.native_dtype
        acc = storage_dtype(mp.acc_fmt, "native")
        a, b = a.to(src), b.to(src)
        if a.device.type == "cuda" and out.native_dtype == src \
                and acc == torch.float32:
            return torch.einsum(spec, a, b)      # f32 sum, one rounding
        return torch.einsum(spec, a.to(acc), b.to(acc)).to(out.native_dtype)
    if use_ste:
        q = quantize_ste
    else:
        def q(x, f, r):
            return softfloat.quantize(x, f, r)
    qa = q(a, mp.src_fmt, policy.rounding)
    qb = q(b, mp.src_fmt, policy.rounding)
    r = torch.einsum(spec, qa.to(torch.float32), qb.to(torch.float32))
    # f32 container accumulation == acc_fmt when acc is fp32; narrower acc
    # grids get a final snap (chunkwise-rounded model)
    if mp.acc_fmt.name != "fp32":
        r = q(r, mp.acc_fmt, policy.rounding)
    if out.name != "fp32":
        r = q(r, out, policy.rounding)
    return r


def tp_matmul(a, b, policy, *, out_fmt=None, use_kernel: bool = False,
              **kw):
    """``a [..., K] @ b [K, N]`` under the policy; with ``use_kernel`` via
    the hand-written tp_matmul kernel's wrapper (``kernels.ops``)."""
    if use_kernel:
        from ..kernels import ops as kops
        return kops.tp_matmul(a, b, policy=get_policy(policy),
                              out_fmt=out_fmt, **kw)
    policy = get_policy(policy)
    if policy.mode != "native":
        return tp_einsum("...ij,jk->...ik", a, b, policy, out_fmt=out_fmt,
                         **kw)
    _no_narrow_partials(policy)
    mp = policy.matmul
    src = mp.src_fmt.native_dtype
    acc = storage_dtype(mp.acc_fmt, "native")
    out = _out_fmt(policy, out_fmt).native_dtype
    a, b = a.to(src), b.to(src)
    if a.device.type != "cuda":
        return torch.matmul(a.to(acc), b.to(acc)).to(out)
    if out == src and acc == torch.float32:
        return torch.matmul(a, b)
    lead = a.shape[:-1]
    r = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=acc)
    return r.reshape(*lead, b.shape[-1]).to(out)


def cast_and_pack(a, b, fmt, policy=None, *, axis: int = -1):
    """Convert two scalar operand streams to ``fmt`` and pack them as
    interleaved elements of the destination vector along ``axis``:
    ``out[.., 2i, ..] = a[.., i, ..]`` and ``out[.., 2i+1, ..] = b[.., i,
    ..]``, so ``out.shape[axis] == 2 * a.shape[axis]``.  Emulate mode keeps
    gradual underflow (``softfloat``), unlike the kernel route
    ``kernels.ops.cast_and_pack``, which flushes below min normal."""
    fmt = get_format(fmt)
    qa = tp_cast(a, fmt, policy)
    qb = tp_cast(b, fmt, policy)
    axis = axis % qa.dim()
    stacked = torch.stack([qa, qb], dim=axis + 1)
    shape = list(qa.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


_ELEM_FNS = {
    "exp": torch.exp, "log": torch.log, "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt, "div": lambda a, b: a / b, "recip": lambda a: 1.0 / a,
    "tanh": torch.tanh, "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
}


def tp_elementwise(fn: str, *args, policy, out_fmt=None):
    """DIVSQRT-group op computed in ``elem_fmt`` (native: its dtype;
    emulate: operands and result snapped onto its grid)."""
    policy = get_policy(policy)
    ef = policy.elem_fmt
    if policy.mode == "native":
        cdt = storage_dtype(ef, "native")
        r = _ELEM_FNS[fn](*[torch.as_tensor(x).to(cdt) for x in args])
        if out_fmt is not None:
            r = r.to(get_format(out_fmt).native_dtype)
        return r
    qargs = [softfloat.quantize(x, ef, policy.rounding) for x in args]
    r = softfloat.quantize(_ELEM_FNS[fn](*qargs), ef, policy.rounding)
    if out_fmt is not None:
        r = softfloat.quantize(r, out_fmt, policy.rounding)
    return r
