"""Compressed gradient all-reduce with error feedback, the JAX package's
``optim/grad_compress.py``: the paper's "communicate in a narrower
format" applied to the data-parallel gradient sync.

Scheme (per tensor, on each data-parallel rank):
  1. g' = g_local + error_feedback          (EF keeps the sync unbiased)
  2. shared scale s = max over the group of |g'| / max_normal(fmt)
  3. q = Q(g'/s, fmt): stochastic with a generator, RNE without one
  4. g_sync = sum over the group of q (in the wire dtype) * s / n
  5. ef_new = g' - q*s

JAX's psum operand is ``wire.astype(f32)``, whose values lie on the wire
dtype's grid; here the wire dtype's bytes are what moves (an
``all_gather``) and the ranks' values are added in f32 in rank order, so
the wire really is narrow and the sum at two ranks is JAX's bit for bit.
The step counts the bytes sent (``launch.spmd.count_wire``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core import softfloat
from ..core.formats import FPFormat, get_format
from ..launch import spmd

F32 = torch.float32


def _comm_dtype(fmt: FPFormat) -> torch.dtype:
    """The wire dtype: ``fmt``'s own native dtype at width >= 16, bf16
    otherwise (bf16 carries every fp8-grid value exactly)."""
    if fmt.native_dtype is not None and fmt.width >= 16:
        return fmt.native_dtype
    return torch.bfloat16


def wire_bytes(numel: int, fmt) -> int:
    """The bytes one rank sends for ``numel`` gradient values in ``fmt``."""
    return numel * _comm_dtype(get_format(fmt)).itemsize


def compress_sync_local(g, ef, *, group: spmd.Group, fmt,
                        generator: Optional[torch.Generator] = None,
                        n_replicas: int, amax_groups=()):
    """One tensor's compressed sum over ``group`` (the data-parallel
    ranks): ``(synced, ef_new)``, ``synced`` the group's mean of ``g +
    ef`` through ``fmt`` (identical on every rank), ``ef_new`` this rank's
    residual.  ``generator`` (on ``g``'s device): stochastic rounding;
    None: RNE.  ``amax_groups``: further groups the leaf is split over (a
    model axis), whose ranks share the scale as JAX's whole-leaf max
    does."""
    fmt = get_format(fmt)
    gf, q, scale = scale_and_quantize(g, ef, group=group, fmt=fmt,
                                      generator=generator,
                                      amax_groups=amax_groups)
    ef_new = (gf.double() - q.double() * scale.double()).to(F32)
    parts = spmd.all_gather(q.to(_comm_dtype(fmt))[None], group, dim=0)
    total = parts[0].to(F32)
    for p in parts[1:]:
        total = total + p.to(F32)
    return total * (scale * _f32(1.0 / n_replicas, gf)), ef_new


def scale_and_quantize(g, ef, *, group: spmd.Group, fmt,
                       generator: Optional[torch.Generator] = None,
                       amax_groups=()):
    """Steps 1-3: ``(g', q, scale)``, ``q`` on ``fmt``'s grid."""
    fmt = get_format(fmt)
    gf = g.to(F32) + ef.to(F32)
    amax = spmd.all_reduce_max(torch.max(torch.abs(gf)), group)
    for grp in amax_groups:
        amax = spmd.all_reduce_max(amax, grp)
    # XLA compiles JAX's ``amax / max_normal`` (and ``scale / n``) to a
    # product with the f32 reciprocal, and ``g' - q*scale`` to one fused
    # multiply-add (one rounding: the f64 product is exact here)
    scale = torch.clamp(amax * _f32(1.0 / fmt.max_normal, gf), min=1e-30)
    scaled = gf / scale
    if generator is not None:
        q = softfloat.quantize(scaled, fmt, "stochastic", generator=generator)
    else:
        q = softfloat.quantize(scaled, fmt)
    return gf, q, scale


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=like.device)
