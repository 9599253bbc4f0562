"""Pruned-schedule transprecision flash attention (prefill).

``flash_attention_cuda`` is the port of the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``: hand-written CUDA
kernels (``csrc/flash_attention.cu``, sm_90a) for tensors on the card, in
three variants chosen by ``flash_route`` (dtype, grid and head dims) alone:

  ``flash_tc``     wgmma tiles (QK^T from shared memory, PV with P in
                   registers), K/V fed by TMA or converted by a producer
                   warpgroup, one CTA per (KV row, query tile) carrying all
                   heads of the GQA group; 64-key tiles; for src bf16 /
                   fp16 or f32 on a grid exact in 16 bits, (D, Dv) in
                   ``TC_HEAD_PAIRS``;
  ``flash_split``  the split route on the same code, for f32 src that no
                   16-bit type holds (policy ``fp32``, tf32 and grids up to
                   22 mantissa bits) at (D, Dv) in ``TC_HEAD_PAIRS``: a
                   staging pass cuts K into the pieces of
                   ``quant_common.split_pieces`` (three without a grid) and
                   V into two, once a launch (the keys a query can see,
                   ``split_staged_keys``), the kernel reads them by TMA,
                   cuts Q likewise and p into two, and QK^T / PV sum the
                   kept piece products on the tensor cores (PV: the three
                   pairs of weight 2^-8 and up); 64-row query tiles,
                   ``split_block_k`` keys; non-finite operands give
                   IEEE's +-Inf / NaN as the plain version does;
  ``flash_fma``    the first, f32-FMA version (32 x 32 tiles), for every
                   other D, Dv <= 256.

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

Layout: q [BH, Sq, D]; k contiguous [BKV, Skv, D] or a flat page pool
[n_pages * Hkv, page, D] with ``block_table`` [BKV, nk], v the same with
its own head dim Dv (MLA's expanded prefill: D 96, Dv 64 for minicpm3,
D 192, Dv 128 for deepseek-v2-lite); BH = BKV *
group.  Output [BH, Sq, Dv] f32.  With ``debug_visits`` / ``debug_flags`` the
variant's telemetry instantiation runs (``launches_telemetry``) and also
returns the TPU kernel's side outputs, per step of ``block_schedule`` at
the variant's own tiles (``kernel_tiles``; ``ref.flash_telemetry_ref``):
which steps did work and the IEEE flag counts of the CONV stage, the
attention output bitwise the flags-off one (V's flags counted at its
own width).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import ref
from .quant_common import operand_tile_dtype, split_pieces

#: query block of the plain version's walk, and its key block unless
#: ``block_k`` is given (paged: the page)
PLAIN_BLOCK = 32
#: key tile of each CUDA variant, and the FMA variant's query tile
TC_BLOCK_K, FMA_BLOCK_K, FMA_BLOCK_Q = 64, 32, 32
#: (QK head dim, V head dim) pairs the tensor-core and split variants take
TC_HEAD_PAIRS = ((64, 64), (128, 128), (256, 256), (96, 64), (192, 128))
#: the split route's query tile (rows over the group's heads) and the
#: pieces of p and V
SPLIT_Q_ROWS, SPLIT_PV_PIECES = 64, 2


def split_block_k(d: int) -> int:
    """The split route's key tile: 64 keys, or 32 above D 128, where three
    pieces of a 64-row Q tile and two stages of K in three pieces fill the
    card's 227 KB of shared memory."""
    return 32 if d > 128 else 64


def split_staged_keys(nk: int, page: int, sq: int, q_offset: int,
                      causal: bool) -> int:
    """Keys a KV row of the split route's staging buffers holds: those a
    query can see — the table's ``nk * page``, and under the causal mask
    no more than ``q_offset + sq`` — rounded up to 64 (at least 64).  The
    staging pass writes only each row's live keys and its last tile's
    tail, so under the causal mask a block table far wider than the
    context costs neither memory nor time; without it the buffers span
    the table, and only the live keys are written."""
    keys = nk * page
    if causal:
        keys = min(keys, max(0, q_offset + sq))
    return max(64, -(-keys // 64) * 64)


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


def tc_tile_dtype(src_dtype, src_fmt_name: Optional[str], d: int,
                  dv: Optional[int] = None):
    """The 16-bit tile type of the tensor-core variant, or None (the FMA
    variant).  Operands are multiplied in ``src_dtype`` (bf16 / fp16 as
    they are) or, for f32 containers, on ``src_fmt_name``'s grid
    (``quant_common.operand_tile_dtype``; p is snapped onto the same
    grid).  ``(d, dv)`` (dv None: d) must be one of ``TC_HEAD_PAIRS``."""
    if (d, d if dv is None else dv) not in TC_HEAD_PAIRS:
        return None
    return operand_tile_dtype(src_dtype, src_fmt_name)


def flash_route(src_dtype, src_fmt_name: Optional[str], d: int,
                dv: Optional[int] = None) -> str:
    """The variant these arguments launch: "tc" (``tc_tile_dtype``),
    "split" (f32 src whose operands the split route's pieces hold,
    ``quant_common.split_pieces``, at a (D, Dv) of ``TC_HEAD_PAIRS``) or
    "fma"."""
    if tc_tile_dtype(src_dtype, src_fmt_name, d, dv) is not None:
        return "tc"
    if ((d, d if dv is None else dv) in TC_HEAD_PAIRS
            and split_pieces(src_dtype, src_fmt_name) is not None):
        return "split"
    return "fma"


def split_pieces_of(src_dtype, src_fmt_name: Optional[str]):
    """``(QK pieces, PV pieces)`` of the split route for this src, the
    plain version's ``split=`` emulation of the kernel's products."""
    return split_pieces(src_dtype, src_fmt_name), SPLIT_PV_PIECES


def kernel_block_k(src_dtype, src_fmt_name: Optional[str], d: int,
                   dv: Optional[int] = None) -> int:
    """The key tile of the CUDA variant these arguments route to."""
    route = flash_route(src_dtype, src_fmt_name, d, dv)
    if route == "split":
        return split_block_k(d)
    return TC_BLOCK_K if route == "tc" else FMA_BLOCK_K


def kernel_tiles(src_dtype, src_fmt_name: Optional[str], sq: int, bkv: int,
                 group: int, d: int, dv: Optional[int] = None,
                 q_rows: Optional[int] = None) -> Tuple[int, int]:
    """``(bq, bk)``: queries per head and keys of the tile the CUDA
    variant these arguments route to walks — its telemetry's block
    schedule (``flash_tc``: ``q_rows // group`` by 64, ``q_rows`` None:
    ``plan_q_rows``; ``flash_split``: ``64 // group`` by
    ``split_block_k``; ``flash_fma``: 32 by 32)."""
    route = flash_route(src_dtype, src_fmt_name, d, dv)
    if route == "tc":
        if q_rows is None:
            q_rows = plan_q_rows(sq, bkv, group)
        return q_rows // group, TC_BLOCK_K
    if route == "split":
        return SPLIT_Q_ROWS // group, split_block_k(d)
    return FMA_BLOCK_Q, FMA_BLOCK_K


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
                          block_k: Optional[int] = None,
                          block_q: Optional[int] = None,
                          debug_visits: bool = False,
                          debug_flags: bool = False,
                          split: Optional[Tuple[int, int]] = None):
    """The kernel's function in plain torch: the blocked online-softmax
    walk of ``ref.flash_attention_ref`` over the pruned schedule, keys in
    blocks of ``block_k`` (None: 32, or the page when paged; a CUDA
    variant's own tile is ``kernel_block_k``).  Paged, the walk runs over
    the gathered pages.  ``debug_visits`` / ``debug_flags`` append the
    telemetry of ``ref.flash_telemetry_ref`` over query blocks of
    ``block_q`` (None: 32) and those key blocks, in that order (a CUDA
    variant's tiles: ``kernel_tiles``).  ``split`` (``(QK pieces, PV
    pieces)``, ``split_pieces_of``) emulates the split route's products:
    QK^T and PV as sums of bf16 piece products (``quant_common
    .split_product``); None multiplies the f32 operands whole."""
    sq = q.shape[1]
    kw = dict(group=group, scale=scale, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, src_fmt_name=src_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype, split=split)
    qp = _pad_rows(q, PLAIN_BLOCK)
    if block_table is not None:
        skv = block_table.shape[1] * k.shape[1]
        bk = k.shape[1] if block_k is None else block_k
        kvl = ref.per_row_lens(kv_len, q.shape[0], skv, q.device)
        o = ref.flash_attention_paged_ref(qp, k, v, block_table,
                                          bq=PLAIN_BLOCK, bk=bk,
                                          kv_len=kvl, **kw)
    else:
        bk = PLAIN_BLOCK if block_k is None else block_k
        kvl = ref.per_row_lens(kv_len, q.shape[0], k.shape[1], q.device)
        o = ref.flash_attention_ref(qp, _pad_rows(k, bk), _pad_rows(v, bk),
                                    kv_len=kvl, bq=PLAIN_BLOCK, bk=bk, **kw)
    o = o[:, :sq]
    if not (debug_visits or debug_flags):
        return o
    if block_table is not None:
        k, v = ref.paged_gather(k, block_table), ref.paged_gather(v, block_table)
    visits, flags = ref.flash_telemetry_ref(
        q, k, v, group=group, kv_len=kvl, causal=causal, window=window,
        q_offset=q_offset, src_fmt_name=src_fmt_name,
        bq=PLAIN_BLOCK if block_q is None else block_q, bk=bk)
    return ref.with_telemetry(o, visits, flags, debug_visits, debug_flags)


def _telemetry(tele: bool, bh: int, sq: int, skv: int, bq: int, bk: int,
               causal: bool, window, q_offset: int, device):
    """``(n_steps, visits, flags)``: the zeroed telemetry outputs over
    ``block_schedule``'s steps at the tiles (bq, bk), or (0, None, None)."""
    if not tele:
        return 0, None, None
    n = len(block_schedule(-(-sq // bq) * bq, -(-skv // bk) * bk, bq, bk,
                           causal=causal, window=window,
                           q_offset=q_offset)[0])
    return (n, torch.zeros((bh, n), dtype=torch.int32, device=device),
            torch.zeros((bh, n, 4), dtype=torch.int32, device=device))


def _counted(variant: str, d: int, dv: int, causal: bool) -> None:
    """One launch of ``variant`` ("tc" / "split" / "fma") at head dims
    (d, dv)."""
    fn = flash_attention_cuda
    fn.launches += 1
    setattr(fn, f"launches_{variant}", getattr(fn, f"launches_{variant}") + 1)
    fn.launches_by_dims[(d, dv)] = fn.launches_by_dims.get((d, dv), 0) + 1
    fn.launches_noncausal += 0 if causal else 1


def _finish(out, out_dtype, visits, flags, debug_visits, debug_flags):
    """A variant's return: the output, then the telemetry asked for."""
    out = out if out_dtype == torch.float32 else out.to(out_dtype)
    if not (debug_visits or debug_flags):
        return out
    flash_attention_cuda.launches_telemetry += 1
    return ref.with_telemetry(out, visits, flags, debug_visits, debug_flags)


def _launch_args(q, k, v, kv_len, block_table, group):
    """Checks shared by both variants; returns (q, k, v, kv_len int32,
    table or None, out [BH, Sq, Dv], nk, page, rows)."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel needs CUDA tensors, got "
                         f"{q.device}")
    bh, sq, d = q.shape
    rows, page, dk = k.shape
    dv = v.shape[-1]
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
    if d != dk or k.shape[:2] != v.shape[:2] or k.dtype != v.dtype:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)} {v.dtype} do not fit together")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    kvl = ref.per_row_lens(kv_len, bh, nk * page, q.device).to(
        torch.int32).contiguous()
    out = torch.empty((bh, sq, dv), dtype=torch.float32, device=q.device)
    return (q.contiguous(), k.contiguous(), v.contiguous(), kvl, table, out,
            nk, page, rows)


def flash_attention_tc(q, k, v, kv_len=None, block_table=None, *,
                       group: int = 1, scale: float = 1.0,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None, q_offset: int = 0,
                       src_fmt_name: Optional[str] = None,
                       src_dtype=torch.bfloat16, out_dtype=torch.float32,
                       q_rows: Optional[int] = None,
                       debug_visits: bool = False, debug_flags: bool = False):
    """The tensor-core variant (the arguments must route to a 16-bit
    tile); ``q_rows`` (64 or 128) is the CTA's query tile over the group's
    heads (None: ``plan_q_rows``); telemetry steps are at
    ``(q_rows // group, 64)``."""
    tile = tc_tile_dtype(src_dtype, src_fmt_name, q.shape[-1], v.shape[-1])
    if tile is None:
        raise ValueError(f"src {src_dtype} / grid {src_fmt_name} at (D, Dv) "
                         f"{(q.shape[-1], v.shape[-1])} does not route to a "
                         f"16-bit tile")
    q, k, v, kvl, table, out, nk, page, rows = _launch_args(
        q, k, v, kv_len, block_table, group)
    bh, sq, d = q.shape
    if q_rows is None:
        q_rows = plan_q_rows(sq, bh // group, group)
    if q_rows not in (64, 128) or not 1 <= group <= q_rows:
        raise ValueError(f"group {group} does not fit a {q_rows}-row tile "
                         f"(64 or 128 rows)")
    tele = debug_visits or debug_flags
    n_steps, visits, flags = _telemetry(tele, bh, sq, nk * page,
                                        q_rows // group, TC_BLOCK_K, causal,
                                        window, int(q_offset), q.device)
    fn = _build.load("flash_attention").flash_attention_tc_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), visits.data_ptr() if tele else None,
             flags.data_ptr() if tele else None, n_steps,
             bh, group, sq, d, out.shape[-1], nk, page, rows, int(q_offset),
             int(bool(causal)), -1 if window is None else int(window),
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(src_fmt_name),
             int(tile == torch.bfloat16), int(q_rows),
             float(scale), 0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_tc")
    _counted("tc", d, out.shape[-1], causal)
    by_rows = flash_attention_cuda.launches_by_q_rows
    by_rows[q_rows] = by_rows.get(q_rows, 0) + 1
    return _finish(out, out_dtype, visits, flags, debug_visits, debug_flags)


def flash_attention_split(q, k, v, kv_len=None, block_table=None, *,
                          group: int = 1, scale: float = 1.0,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None, q_offset: int = 0,
                          src_fmt_name: Optional[str] = None,
                          src_dtype=torch.float32, out_dtype=torch.float32,
                          debug_visits: bool = False,
                          debug_flags: bool = False):
    """The split route (the arguments must route to it, ``flash_route``);
    64-row query tiles (group <= 64); telemetry steps are at
    ``(64 // group, split_block_k(D))``."""
    d, dv = q.shape[-1], v.shape[-1]
    if flash_route(src_dtype, src_fmt_name, d, dv) != "split":
        raise ValueError(f"src {src_dtype} / grid {src_fmt_name} at (D, Dv) "
                         f"{(d, dv)} does not take the split route")
    if not 1 <= group <= SPLIT_Q_ROWS:
        raise ValueError(f"group {group} does not fit the split route's "
                         f"{SPLIT_Q_ROWS}-row tile")
    q, k, v, kvl, table, out, nk, page, rows = _launch_args(
        q, k, v, kv_len, block_table, group)
    bh, sq, _ = q.shape
    tele = debug_visits or debug_flags
    n_steps, visits, flags = _telemetry(tele, bh, sq, nk * page,
                                        SPLIT_Q_ROWS // group,
                                        split_block_k(d), causal, window,
                                        int(q_offset), q.device)
    # the staging pass's pieces of K and V, each KV row's keys in order
    pieces = split_pieces(src_dtype, src_fmt_name)
    skv_pad = split_staged_keys(nk, page, sq, int(q_offset), causal)
    kp = torch.empty((pieces, bh // group, skv_pad, d), dtype=torch.bfloat16,
                     device=q.device)
    vp = torch.empty((SPLIT_PV_PIECES, bh // group, skv_pad, dv),
                     dtype=torch.bfloat16, device=q.device)
    fn = _build.load("flash_attention").flash_attention_split_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), visits.data_ptr() if tele else None,
             flags.data_ptr() if tele else None, kp.data_ptr(),
             vp.data_ptr(), n_steps,
             bh, group, sq, d, dv, nk, page, rows, int(q_offset),
             int(bool(causal)), -1 if window is None else int(window),
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(src_fmt_name),
             pieces, skv_pad,
             float(scale), 0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_split")
    _counted("split", d, dv, causal)
    return _finish(out, out_dtype, visits, flags, debug_visits, debug_flags)


def flash_attention_fma(q, k, v, kv_len=None, block_table=None, *,
                        group: int = 1, scale: float = 1.0,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0,
                        src_fmt_name: Optional[str] = None,
                        src_dtype=torch.bfloat16, out_dtype=torch.float32,
                        debug_visits: bool = False,
                        debug_flags: bool = False):
    """The f32-FMA variant (D, Dv <= 256, any src); telemetry steps are
    at (32, 32)."""
    if max(q.shape[-1], v.shape[-1]) > 256:
        raise ValueError(f"flash kernel takes D, Dv <= 256, got "
                         f"{(q.shape[-1], v.shape[-1])}")
    q, k, v, kvl, table, out, nk, page, rows = _launch_args(
        q, k, v, kv_len, block_table, group)
    bh, sq, d = q.shape
    tele = debug_visits or debug_flags
    n_steps, visits, flags = _telemetry(tele, bh, sq, nk * page, FMA_BLOCK_Q,
                                        FMA_BLOCK_K, causal, window,
                                        int(q_offset), q.device)
    fn = _build.load("flash_attention").flash_attention_fma_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), visits.data_ptr() if tele else None,
             flags.data_ptr() if tele else None, n_steps,
             bh, group, sq, d, out.shape[-1], nk, page, rows, int(q_offset),
             int(bool(causal)), -1 if window is None else int(window),
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(src_fmt_name),
             float(scale), 0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fma")
    _counted("fma", d, out.shape[-1], causal)
    return _finish(out, out_dtype, visits, flags, debug_visits, debug_flags)


def flash_attention_cuda(q, k, v, kv_len=None, block_table=None, *,
                         group: int = 1, scale: float = 1.0,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         src_fmt_name: Optional[str] = None,
                         src_dtype=torch.bfloat16, out_dtype=torch.float32,
                         q_rows: Optional[int] = None,
                         debug_visits: bool = False,
                         debug_flags: bool = False):
    """q [BH, Sq, D]; k [BKV, Skv, D] or a pool [n_pages, page, D] with
    ``block_table`` [BKV, nk], v likewise at width Dv; ``kv_len`` None (=
    Skv), scalar or [BH].  Returns [BH, Sq, Dv].  One launch per call, of
    the variant ``flash_route`` picks (from the src and D and Dv;
    ``q_rows`` is ``flash_tc``'s query tile, None: ``plan_q_rows``; the
    other routes ignore it: the split route's is 64 rows and ``flash_fma``
    has none); raises on tensors that do not lie on a CUDA device.
    ``debug_visits`` / ``debug_flags`` append the telemetry at the
    variant's tiles (``kernel_tiles``)."""
    kw = dict(group=group, scale=scale, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, src_fmt_name=src_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype,
              debug_visits=debug_visits, debug_flags=debug_flags)
    route = flash_route(src_dtype, src_fmt_name, q.shape[-1], v.shape[-1])
    if route == "tc":
        return flash_attention_tc(q, k, v, kv_len, block_table,
                                  q_rows=q_rows, **kw)
    if route == "split":
        return flash_attention_split(q, k, v, kv_len, block_table, **kw)
    return flash_attention_fma(q, k, v, kv_len, block_table, **kw)


#: launches of the CUDA kernels, in all, by variant, by head dims (D, Dv),
#: by ``flash_tc``'s query tile (64 or 128 rows), without the causal mask
#: (whisper's encoder and cross-attention) and of the telemetry
#: instantiations (CPU calls and plain-version calls add none)
flash_attention_cuda.launches = 0
flash_attention_cuda.launches_noncausal = 0
flash_attention_cuda.launches_tc = 0
flash_attention_cuda.launches_split = 0
flash_attention_cuda.launches_fma = 0
flash_attention_cuda.launches_by_dims = {}
flash_attention_cuda.launches_by_q_rows = {}
flash_attention_cuda.launches_telemetry = 0
