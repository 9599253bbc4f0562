"""Fused single-query decode attention over a quantized, paged KV cache —
the serving-path instance of FPnew's CONV->ADDMUL fusion.

``decode_attention_cuda`` is the port of the TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``: a hand-written
CUDA kernel (``csrc/decode_attention.cu``, sm_90a) for tensors on the card.
Each (slot, KV head) row is split over the CTAs of a thread-block cluster
(``cluster_size`` CTAs; the partition is ``plan_splits``'s); the ranks
exchange their maxima through distributed shared memory, so p is rounded
against the exact row max, and rank 0 adds the parts' sums in rank order.
The kernel has two routes, chosen by ``decode_route`` alone:

  ``mma``  q.K^T and p.V on ``mma.sync`` tensor-core tiles, for src bf16 /
           fp16 (the operands as multiplied are exact 16-bit values) and D
           a multiple of 16;
  ``fma``  f32 FMAs, for f32 src and other D.

Both count their launches (``launches_mma`` / ``launches_fma``), and every
launch counts under its cluster size (``launches_by_cluster``).

``decode_attention_plain`` is its plain-torch version (with ``splits=``, it
walks the kernel's partition and adds the parts in rank order).  The choice
between them is made in one place, ``kernels.ops.resolve_backend``: CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.

  stage           FPnew block   what happens
  KV dequant      CONV          K/V enter in their storage format (native
                                bf16 / fp16 / fp8 e5m2, or an f32 container
                                on the ``kv_fmt`` grid) and are widened at
                                the multiplier input
  q.K^T           ADDMUL        src-format products, f32 accumulation
  softmax stats   COMP          exact max, exp and sums in f32
  p.V             ADDMUL        p rounded to the src format, f32 accumulation

Layout: q [BHkv, G, D]; k/v either contiguous strips [BHkv, Smax, D] or
flat page pools [n_pages * Hkv, page, D] with ``block_table`` [BHkv, nk]
flat per-head page ids; ``kv_len`` [BHkv] per-row live lengths.  Output
[BHkv, G, D] in ``out_dtype`` (f32).  Not ported yet: the
``debug_visits`` / ``debug_flags`` side outputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from . import ref
from .quant_common import operand_tile_dtype

#: keys per split unit of a contiguous strip (a paged row splits on pages)
STRIP_UNIT = 64
#: CTAs per cluster at most (above 8 the size is non-portable)
MAX_CLUSTER = 16
#: CTAs of the decode kernel the grid may hold: two waves of two CTAs per
#: SM.  Rows of one decode step differ in length, so a cluster of a short
#: row ends early and frees its SMs for a late one; measured on the H100,
#: 16 CTAs a row beat 4 and 8 at the slice's 32 rows (PERF.md).
GRID_CTAS = 4 * _build.NUM_SMS
#: route codes of the C entry point (mma: + 1 for an fp16 tile)
ROUTES = {"fma": 0, "mma": 1}


def decode_route(src_dtype, d: int) -> str:
    """``"mma"`` (tensor-core tiles) when every operand as multiplied is
    an exact 16-bit value (``quant_common.operand_tile_dtype``) and D is a
    multiple of 16, else ``"fma"``.  The rule is asked without a grid: the
    TPU kernel rounds p to ``src_dtype`` alone, so under an f32 container p
    is an f32 value whatever grid q and K/V are snapped onto (flash
    attention snaps p onto the src grid, and routes such containers to
    tensor cores)."""
    if d % 16 == 0 and operand_tile_dtype(src_dtype) is not None:
        return "mma"
    return "fma"


def cluster_size(rows: int, units: int, unit: int = 1,
                 window: Optional[int] = None) -> int:
    """CTAs per row: the largest power of two up to ``MAX_CLUSTER`` that
    leaves every part at least one split unit and keeps the grid within
    ``GRID_CTAS``.  A row holds ``units`` units of ``unit`` keys; with a
    ``window`` its live keys span at most ceil(window / unit) + 1 of them."""
    if window is not None:
        units = min(units, -(-window // unit) + 1)
    c = 1
    while 2 * c <= min(MAX_CLUSTER, units) and rows * 2 * c <= GRID_CTAS:
        c *= 2
    return c


@dataclass(frozen=True)
class SplitPlan:
    """``size`` CTAs per row; ``bounds`` [rows, size, 2] int64: part ``r``
    of a row holds keys ``[lo, hi)`` (``lo == hi``: no keys)."""
    size: int
    bounds: torch.Tensor


def plan_splits(kv_lens, unit: int, *, units: int,
                window: Optional[int] = None,
                size: Optional[int] = None) -> SplitPlan:
    """The kernel's split-KV partition, on the host (``split_of`` in
    ``csrc/decode_attention.cu`` computes the same on the card).

    ``kv_lens`` [rows] live lengths (clamped to ``units * unit``); ``unit``
    the page (``STRIP_UNIT`` for contiguous strips); ``units`` the units a
    row can hold (its table width).  ``size`` None: ``cluster_size``.  A
    row's live range ``[start, kv_len)`` (``start = max(0, kv_len - window)``) covers ``n`` units from
    ``start // unit``; part ``r`` takes units ``[n r / C, n (r + 1) / C)``,
    clipped to the live range, so parts are disjoint, page-aligned inside
    the range and cover it."""
    lens = torch.as_tensor(kv_lens).reshape(-1).to(torch.int64).cpu()
    lens = lens.clamp(max=units * unit)
    c = (cluster_size(lens.numel(), units, unit, window) if size is None
         else int(size))
    start = (lens - window).clamp(min=0) if window is not None \
        else torch.zeros_like(lens)
    first = start // unit
    n = torch.where(lens > start, (lens - 1) // unit - first + 1, 0)
    r = torch.arange(c, dtype=torch.int64)
    u0 = first[:, None] + n[:, None] * r // c
    u1 = first[:, None] + n[:, None] * (r + 1) // c
    lo = torch.maximum(start[:, None], u0 * unit)
    hi = torch.minimum(lens[:, None], u1 * unit)
    lo = torch.where(hi > lo, lo, hi)            # empty part: lo == hi
    return SplitPlan(c, torch.stack([lo, hi], dim=-1))


def decode_attention_plain(q, k, v, kv_len, block_table=None, *,
                           scale: float = 1.0, window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           kv_fmt_name: Optional[str] = None,
                           q_fmt_name: Optional[str] = None,
                           src_dtype=torch.bfloat16,
                           out_dtype=torch.float32,
                           splits: Optional[SplitPlan] = None):
    """The kernel's function in plain torch (``ref.decode_attention_ref``
    blocked at the page size, or at 64 keys for contiguous strips).  With
    ``splits`` (``plan_splits``'s partition of these rows) the sums run
    part by part and are added in part order, as the kernel's ranks do."""
    kw = dict(kv_len=kv_len, scale=scale, window=window, softcap=softcap,
              kv_fmt_name=kv_fmt_name, q_fmt_name=q_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype,
              bounds=None if splits is None else splits.bounds)
    if block_table is not None:
        return ref.decode_attention_paged_ref(q, k, v, block_table, **kw)
    return ref.decode_attention_ref(q, k, v, bk=64, **kw)


def decode_attention_cuda(q, k, v, kv_len, block_table=None, *,
                          scale: float = 1.0, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          kv_fmt_name: Optional[str] = None,
                          q_fmt_name: Optional[str] = None,
                          src_dtype=torch.bfloat16,
                          out_dtype=torch.float32,
                          _cluster: Optional[int] = None):
    """q [BHkv, G, D]; k/v [BHkv, Smax, D] or pools [n_pages, page, D]
    with ``block_table`` [BHkv, nk]; ``kv_len`` scalar or [BHkv].
    Launches the kernel (one launch per call, ``cluster_size`` CTAs per
    row, on the route ``decode_route`` names); raises on tensors that do
    not lie on a CUDA device, and when the launch fails.  ``_cluster``
    overrides ``cluster_size`` for a diagnostic sweep (``chip_smoke.py``'s
    ``decode_phase(sweep=True)``); the serving path never passes it."""
    if q.device.type != "cuda":
        raise ValueError(f"the decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    bh, g, d = q.shape
    rows, page, dk = k.shape
    if block_table is not None:
        nk = block_table.shape[1]
        if block_table.shape[0] != bh:
            raise ValueError(f"block_table {tuple(block_table.shape)} needs "
                             f"{bh} rows")
        # page ids are bounds-checked on the device (no host sync)
        table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
        unit, smax = page, nk * page
    else:
        if rows != bh:
            raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                             f"disagree on rows")
        table, unit, smax = None, STRIP_UNIT, page
        nk = -(-smax // unit)
    if d != dk or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)} {v.dtype} do not fit together")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if d > 256 or g > 8:
        raise ValueError(f"decode kernel takes D <= 256 and G <= 8, got "
                         f"D={d}, G={g}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32
            and kv_len.shape == (bh,) and kv_len.device == q.device
            and kv_len.is_contiguous()):
        kvl = kv_len  # the per-row lengths ``kernels.ops`` hands over
    else:
        kvl = ref.per_row_lens(kv_len, bh, smax, q.device).to(
            torch.int32).contiguous()
    route = decode_route(src_dtype, d)
    code = ROUTES[route] + (1 if route == "mma"
                            and src_dtype == torch.float16 else 0)
    cluster = (cluster_size(bh, nk, unit, window) if _cluster is None
               else _cluster)
    out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
    scores = torch.empty((bh, g, smax), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attention").decode_attention_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), scores.data_ptr(), bh, g, d, nk, unit, rows,
             smax, cluster, _build.dtype_code(q.dtype),
             _build.dtype_code(k.dtype), _build.src_kind(src_dtype), code,
             *_build.snap_args(kv_fmt_name), *_build.snap_args(q_fmt_name),
             float(scale), -1 if window is None else int(window),
             0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    if route == "mma":
        decode_attention_cuda.launches_mma += 1
    else:
        decode_attention_cuda.launches_fma += 1
    by_cluster = decode_attention_cuda.launches_by_cluster
    by_cluster[cluster] = by_cluster.get(cluster, 0) + 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: launches of the CUDA kernel, in all, by route and by cluster size (CPU
#: calls and plain-version calls add none)
decode_attention_cuda.launches = 0
decode_attention_cuda.launches_mma = 0
decode_attention_cuda.launches_fma = 0
decode_attention_cuda.launches_by_cluster = {}
