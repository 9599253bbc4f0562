"""Pruned-schedule transprecision flash attention (prefill).

``flash_attention_cuda`` is the port of the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``: a hand-written
CUDA kernel (``csrc/flash_attention.cu``, sm_90a) for tensors on the card.
``flash_attention_plain`` is its plain-torch version.  The choice between
them is made in one place, ``kernels.ops.resolve_backend``: CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.

QK^T and PV multiply in the src format with f32 accumulation; the online
softmax statistics and the output accumulator stay f32.  Only the key
blocks a query block can see are visited — ``block_schedule`` (a host-side
numpy function, the same as the JAX package's) drives the plain version,
and the CUDA kernel computes the same pruning per query tile on the card:
causal future keys and keys left of the sliding window are never read,
and each row stops at its own ``kv_len``.

Layout: q [BH, Sq, D]; k/v contiguous [BKV, Skv, D] or flat page pools
[n_pages * Hkv, page, D] with ``block_table`` [BKV, nk]; BH = BKV * group.
Output [BH, Sq, D] f32.  Not ported yet: ``Dv != D`` (MLA) in the CUDA
kernel and the ``debug_visits`` / ``debug_flags`` side outputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import ref

#: query / key tile of the plain version's blocked walk (the CUDA kernel's
#: tile is 32 x 32 as well)
PLAIN_BLOCK = 32


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
                          src_dtype=torch.bfloat16, out_dtype=torch.float32):
    """The kernel's function in plain torch: the blocked online-softmax
    walk of ``ref.flash_attention_ref`` over the pruned schedule (keys
    blocked at the page size when paged)."""
    sq = q.shape[1]
    kw = dict(group=group, scale=scale, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, src_fmt_name=src_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype)
    qp = _pad_rows(q, PLAIN_BLOCK)
    if block_table is not None:
        skv = block_table.shape[1] * k.shape[1]
        kvl = ref.per_row_lens(kv_len, q.shape[0], skv, q.device)
        o = ref.flash_attention_paged_ref(qp, k, v, block_table,
                                          bq=PLAIN_BLOCK, kv_len=kvl, **kw)
    else:
        kvl = ref.per_row_lens(kv_len, q.shape[0], k.shape[1], q.device)
        o = ref.flash_attention_ref(qp, _pad_rows(k, PLAIN_BLOCK),
                                    _pad_rows(v, PLAIN_BLOCK), kv_len=kvl,
                                    bq=PLAIN_BLOCK, bk=PLAIN_BLOCK, **kw)
    return o[:, :sq]


def flash_attention_cuda(q, k, v, kv_len=None, block_table=None, *,
                         group: int = 1, scale: float = 1.0,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         src_fmt_name: Optional[str] = None,
                         src_dtype=torch.bfloat16, out_dtype=torch.float32):
    """q [BH, Sq, D]; k/v [BKV, Skv, D] or pools [n_pages, page, D] with
    ``block_table`` [BKV, nk]; ``kv_len`` None (= Skv), scalar or [BH].
    Launches the kernel (one launch per call); raises on tensors that do
    not lie on a CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel needs CUDA tensors, got "
                         f"{q.device}")
    bh, sq, d = q.shape
    if v.shape[-1] != d:
        raise NotImplementedError("the CUDA flash kernel takes Dv == D only")
    if d > 256:
        raise ValueError(f"flash kernel takes D <= 256, got {d}")
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kvl = ref.per_row_lens(kv_len, bh, nk * page, q.device).to(
        torch.int32).contiguous()
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention").flash_attention_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), bh, group, sq, d, nk, page, rows, int(q_offset),
             int(bool(causal)), -1 if window is None else int(window),
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(src_fmt_name),
             float(scale), 0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: launches of the CUDA kernel (CPU calls and plain-version calls add none)
flash_attention_cuda.launches = 0
