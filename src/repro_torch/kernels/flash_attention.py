"""Pruned-schedule transprecision flash attention (prefill).

``flash_attention_cuda`` is the port of the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``: hand-written CUDA
kernels (``csrc/flash_attention.cu``, sm_90a) for tensors on the card, in
two variants chosen by ``tc_tile_dtype`` alone:

  ``flash_tc``   wgmma tiles (QK^T from shared memory, PV with P in
                 registers), K/V fed by TMA or converted by a producer
                 warpgroup, one CTA per (KV row, query tile) carrying all
                 heads of the GQA group; 64-key tiles; for src bf16 / fp16
                 or f32 on a grid exact in 16 bits, D in {64, 128, 256};
  ``flash_fma``  the first, f32-FMA version (32 x 32 tiles), for policy
                 ``fp32``, grids wider than 16 bits and D not in
                 {64, 128, 256}.

``flash_attention_plain`` is the plain-torch version.  The choice between
kernel and plain version is made in one place, ``kernels.ops.resolve_backend``:
CPU tensors take the plain version; CUDA tensors launch a kernel or raise.

QK^T and PV multiply in the src format with f32 accumulation; the online
softmax statistics and the output accumulator stay f32.  Only the key
blocks a query block can see are visited — ``block_schedule`` (a host-side
numpy function, the same as the JAX package's) drives the plain version,
and the CUDA kernels compute the same pruning per query tile on the card:
causal future keys and key tiles left of the sliding window are never read,
and each row stops at its own ``kv_len``.  Key tiles start at multiples of
the tile size (``kernel_block_k``), so the plain version walks the kernel's
own key blocks when given ``block_k=kernel_block_k(...)``: p is rounded to
the src dtype against the running max of that walk.

Layout: q [BH, Sq, D]; k/v contiguous [BKV, Skv, D] or flat page pools
[n_pages * Hkv, page, D] with ``block_table`` [BKV, nk]; BH = BKV * group.
Output [BH, Sq, D] f32.  Not ported yet: ``Dv != D`` (MLA) in the CUDA
kernels and the ``debug_visits`` / ``debug_flags`` side outputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import ref
from .quant_common import operand_tile_dtype

#: query block of the plain version's walk, and its key block unless
#: ``block_k`` is given (paged: the page)
PLAIN_BLOCK = 32
#: key tile of each CUDA variant
TC_BLOCK_K, FMA_BLOCK_K = 64, 32
#: head dims the tensor-core variant takes
TC_HEAD_DIMS = (64, 128, 256)


def plan_q_rows(sq: int, bkv: int, group: int) -> int:
    """Rows of the tensor-core variant's query tile over the group's heads:
    128 (two consumer warpgroups, the faster per CTA on the card) when that
    still gives every SM a CTA, else 64 (one), so that a short prefill chunk
    fills the card (a 256-token chunk of 2 rows x 8 KV heads: 64 CTAs of
    128 rows, 128 of 64)."""
    if group > 64:
        return 128
    ctas = -(-sq // max(1, 128 // group)) * bkv
    return 128 if ctas >= _build.NUM_SMS else 64


def tc_tile_dtype(src_dtype, src_fmt_name: Optional[str], d: int):
    """The 16-bit tile type of the tensor-core variant, or None (the FMA
    variant).  Operands are multiplied in ``src_dtype`` (bf16 / fp16 as
    they are) or, for f32 containers, on ``src_fmt_name``'s grid
    (``quant_common.operand_tile_dtype``; p is snapped onto the same
    grid).  D must be 64, 128 or 256."""
    if d not in TC_HEAD_DIMS:
        return None
    return operand_tile_dtype(src_dtype, src_fmt_name)


def kernel_block_k(src_dtype, src_fmt_name: Optional[str], d: int) -> int:
    """The key tile of the CUDA variant these arguments route to."""
    return (TC_BLOCK_K if tc_tile_dtype(src_dtype, src_fmt_name, d)
            is not None else FMA_BLOCK_K)


def block_schedule(sq: int, skv: int, bq: int, bk: int, *, causal: bool,
                   window: Optional[int], q_offset: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The pruned grid: active ``(iq, ik)`` block pairs, host-side.

    Returns int32 arrays ``(qi, ki, first, last)`` of equal length — for
    each step, the query-block index, the KV-block index, and flags marking
    the first / last KV block of that query block's run.  A KV block is
    scheduled iff some query row in the block can attend to some key in it
    under the static masks (causal: ``ik * bk <= q_offset + (iq+1)*bq - 1``;
    window: not entirely left of ``q_offset + iq*bq - window + 1``).  Every
    query block keeps >= 1 step so its output is always stored."""
    assert sq % bq == 0 and skv % bk == 0, (sq, skv, bq, bk)
    nq, nk = sq // bq, skv // bk
    qi, ki, first, last = [], [], [], []
    for iq in range(nq):
        k_hi = nk - 1
        if causal:
            k_hi = min(k_hi, (q_offset + (iq + 1) * bq - 1) // bk)
        k_lo = 0
        if window is not None:
            k_lo = max(0, (q_offset + iq * bq - window + 1) // bk)
        k_lo = min(k_lo, k_hi)   # degenerate: keep one step for the store
        for ik in range(k_lo, k_hi + 1):
            qi.append(iq)
            ki.append(ik)
            first.append(1 if ik == k_lo else 0)
            last.append(1 if ik == k_hi else 0)
    mk = lambda a: np.asarray(a, np.int32)
    return mk(qi), mk(ki), mk(first), mk(last)


def _pad_rows(x, mult: int):
    r = (-x.shape[1]) % mult
    return F.pad(x, (0, 0, 0, r)) if r else x


def flash_attention_plain(q, k, v, kv_len=None, block_table=None, *,
                          group: int = 1, scale: float = 1.0,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None, q_offset: int = 0,
                          src_fmt_name: Optional[str] = None,
                          src_dtype=torch.bfloat16, out_dtype=torch.float32,
                          block_k: Optional[int] = None):
    """The kernel's function in plain torch: the blocked online-softmax
    walk of ``ref.flash_attention_ref`` over the pruned schedule, keys in
    blocks of ``block_k`` (None: 32, or the page when paged; a CUDA
    variant's own tile is ``kernel_block_k``).  Paged, the walk runs over
    the gathered pages."""
    sq = q.shape[1]
    kw = dict(group=group, scale=scale, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, src_fmt_name=src_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype)
    qp = _pad_rows(q, PLAIN_BLOCK)
    if block_table is not None:
        skv = block_table.shape[1] * k.shape[1]
        kvl = ref.per_row_lens(kv_len, q.shape[0], skv, q.device)
        o = ref.flash_attention_paged_ref(qp, k, v, block_table,
                                          bq=PLAIN_BLOCK, bk=block_k,
                                          kv_len=kvl, **kw)
    else:
        bk = PLAIN_BLOCK if block_k is None else block_k
        kvl = ref.per_row_lens(kv_len, q.shape[0], k.shape[1], q.device)
        o = ref.flash_attention_ref(qp, _pad_rows(k, bk), _pad_rows(v, bk),
                                    kv_len=kvl, bq=PLAIN_BLOCK, bk=bk, **kw)
    return o[:, :sq]


def _launch_args(q, k, v, kv_len, block_table, group):
    """Checks shared by both variants; returns (q, k, v, kv_len int32,
    table or None, out, nk, page, rows)."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel needs CUDA tensors, got "
                         f"{q.device}")
    bh, sq, d = q.shape
    if v.shape[-1] != d:
        raise NotImplementedError("the CUDA flash kernels take Dv == D only")
    rows, page, dk = k.shape
    if block_table is not None:
        nk = block_table.shape[1]
        if block_table.shape[0] * group != bh:
            raise ValueError(f"block_table {tuple(block_table.shape)} x group "
                             f"{group} does not cover {bh} head rows")
        # page ids are bounds-checked on the device (no host sync)
        table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    else:
        if rows * group != bh:
            raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                             f"group {group} disagree on rows")
        nk, table = 1, None
    if d != dk or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)} {v.dtype} do not fit together")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    kvl = ref.per_row_lens(kv_len, bh, nk * page, q.device).to(
        torch.int32).contiguous()
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=q.device)
    return (q.contiguous(), k.contiguous(), v.contiguous(), kvl, table, out,
            nk, page, rows)


def flash_attention_tc(q, k, v, kv_len=None, block_table=None, *,
                       group: int = 1, scale: float = 1.0,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None, q_offset: int = 0,
                       src_fmt_name: Optional[str] = None,
                       src_dtype=torch.bfloat16, out_dtype=torch.float32,
                       q_rows: Optional[int] = None):
    """The tensor-core variant (the arguments must route to a 16-bit
    tile); ``q_rows`` (64 or 128) is the CTA's query tile over the group's
    heads (None: ``plan_q_rows``)."""
    tile = tc_tile_dtype(src_dtype, src_fmt_name, q.shape[-1])
    if tile is None:
        raise ValueError(f"src {src_dtype} / grid {src_fmt_name} at D "
                         f"{q.shape[-1]} does not route to a 16-bit tile")
    q, k, v, kvl, table, out, nk, page, rows = _launch_args(
        q, k, v, kv_len, block_table, group)
    bh, sq, d = q.shape
    if q_rows is None:
        q_rows = plan_q_rows(sq, bh // group, group)
    if not 1 <= group <= q_rows:
        raise ValueError(f"group {group} does not fit a {q_rows}-row tile")
    fn = _build.load("flash_attention").flash_attention_tc_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), bh, group, sq, d, nk, page, rows, int(q_offset),
             int(bool(causal)), -1 if window is None else int(window),
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(src_fmt_name),
             int(tile == torch.bfloat16), int(q_rows),
             float(scale), 0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_tc")
    flash_attention_cuda.launches_tc += 1
    flash_attention_cuda.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def flash_attention_fma(q, k, v, kv_len=None, block_table=None, *,
                        group: int = 1, scale: float = 1.0,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0,
                        src_fmt_name: Optional[str] = None,
                        src_dtype=torch.bfloat16, out_dtype=torch.float32):
    """The f32-FMA variant (D <= 256, any src)."""
    if q.shape[-1] > 256:
        raise ValueError(f"flash kernel takes D <= 256, got {q.shape[-1]}")
    q, k, v, kvl, table, out, nk, page, rows = _launch_args(
        q, k, v, kv_len, block_table, group)
    bh, sq, d = q.shape
    fn = _build.load("flash_attention").flash_attention_fma_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), bh, group, sq, d, nk, page, rows, int(q_offset),
             int(bool(causal)), -1 if window is None else int(window),
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(src_fmt_name),
             float(scale), 0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fma")
    flash_attention_cuda.launches_fma += 1
    flash_attention_cuda.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def flash_attention_cuda(q, k, v, kv_len=None, block_table=None, *,
                         group: int = 1, scale: float = 1.0,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         src_fmt_name: Optional[str] = None,
                         src_dtype=torch.bfloat16, out_dtype=torch.float32):
    """q [BH, Sq, D]; k/v [BKV, Skv, D] or pools [n_pages, page, D] with
    ``block_table`` [BKV, nk]; ``kv_len`` None (= Skv), scalar or [BH].
    One launch per call, of the variant ``tc_tile_dtype`` picks; raises on
    tensors that do not lie on a CUDA device."""
    fn = (flash_attention_tc
          if tc_tile_dtype(src_dtype, src_fmt_name, q.shape[-1]) is not None
          else flash_attention_fma)
    return fn(q, k, v, kv_len, block_table, group=group, scale=scale,
              causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, src_fmt_name=src_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype)


#: launches of the CUDA kernels, in all and by variant (CPU calls and
#: plain-version calls add none)
flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0
flash_attention_cuda.launches_fma = 0
