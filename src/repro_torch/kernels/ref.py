"""Plain-torch versions of the attention kernels (the contracts the CUDA
kernels are held against).

Each function computes what one kernel computes — same formats, same
masking, same accumulation dtype — written as straight torch, vectorized
over the flattened head rows.  The blocked modes (``bk=`` for decode,
``bq=``/``bk=`` for prefill) fix the summation schedule the way the JAX
package's oracles do; they agree with the CUDA kernels and with the JAX
kernels up to f32 summation order, never bitwise across frameworks.

The softcap is always the exp form ``cap * (1 - 2 / (exp(2 s / cap) + 1))``
(``softcap_scores``), never ``tanh``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.formats import get_format
from .quant_common import widen

NEG_INF = -1e30


def softcap_scores(s: torch.Tensor, cap: float) -> torch.Tensor:
    """Attention-logit soft-capping via exp: ``cap * tanh(s / cap)`` with
    ``tanh(x) = 1 - 2/(exp(2x) + 1)``."""
    e = torch.exp(s * (2.0 / cap))
    return cap * (1.0 - 2.0 / (e + 1.0))


def per_row_lens(kv_len, rows: int, default: int,
                 device) -> torch.Tensor:
    """Normalize a scalar-or-vector ``kv_len`` to an int64 [rows] tensor.
    ``None`` means ``default``."""
    if kv_len is None:
        kv_len = default
    lens = torch.as_tensor(kv_len, device=device).reshape(-1).to(torch.int64)
    assert lens.shape[0] in (1, rows), (lens.shape, rows)
    return lens.expand(rows)


def _fmt(name):
    return get_format(name) if name else None


def decode_attention_ref(q, k, v, *, kv_len, scale: float = 1.0,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         kv_fmt_name: Optional[str] = None,
                         q_fmt_name: Optional[str] = None,
                         src_dtype=torch.float32, out_dtype=torch.float32,
                         bk: Optional[int] = None):
    """Single-query decode attention with the decode kernel's contract:
    in-container RNE snap of KV (and optionally q) onto the storage grid,
    src-format multiplies with f32 accumulation, an EXACT global softmax
    max (first pass), then blockwise f32 sums of ``p`` and ``p @ V`` with
    ``p`` rounded to ``src_dtype`` before the product (second pass).  Rows
    with ``kv_len == 0`` return zeros.

    q [BHkv, G, D]; k, v [BHkv, Smax, D]; ``kv_len`` scalar or per-row
    [BHkv]; a key ``j`` is live iff ``j < kv_len`` and (with ``window``)
    ``j > kv_len - 1 - window``."""
    bh, g, d = q.shape
    smax = k.shape[1]
    bk = smax if bk is None else bk
    kvl = per_row_lens(kv_len, bh, smax, q.device)[:, None, None]
    qs = widen(q, _fmt(q_fmt_name), src_dtype).float()
    ks = widen(k, _fmt(kv_fmt_name), src_dtype).float()
    vs = widen(v, _fmt(kv_fmt_name), src_dtype).float()
    s = torch.einsum("hgd,hkd->hgk", qs, ks) * scale
    if softcap is not None:
        s = softcap_scores(s, softcap)
    k_idx = torch.arange(smax, device=q.device)[None, None, :]
    mask = k_idx < kvl
    if window is not None:
        mask = mask & (k_idx > kvl - 1 - window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    acc = torch.zeros((bh, g, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, g, 1), dtype=torch.float32, device=q.device)
    vs = torch.where(mask[:, 0, :, None], vs, 0.0)   # dead slots never read
    for kk in range(0, smax, bk):
        blk = slice(kk, kk + bk)
        p = torch.where(mask[..., blk], torch.exp(s[..., blk] - m), 0.0)
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + torch.einsum("hgk,hkd->hgd", p.to(src_dtype).float(),
                                 vs[:, blk])
    return (acc / torch.where(l == 0.0, 1.0, l)).to(out_dtype)


def flash_attention_ref(q, k, v, *, group: int = 1, scale: float = 1.0,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, kv_len=None,
                        q_offset: int = 0, src_fmt_name: Optional[str] = None,
                        src_dtype=torch.bfloat16, out_dtype=torch.float32,
                        bq: Optional[int] = None, bk: Optional[int] = None):
    """Prefill attention with the flash kernel's contract.

    q [BH, Sq, D]; k [BKV, Skv, D]; v [BKV, Skv, Dv]; BH = BKV * group.
    With ``bq``/``bk`` the online-softmax walk runs over the pruned block
    schedule (``flash_attention.block_schedule``) with the kernel's
    per-block update (``NEG_INF/2`` guards, ``p`` widened to ``src_dtype``
    before ``p @ V``); without them it is the one-max dense softmax.
    ``kv_len``: scalar or per-row [BH]; ``q_offset`` shifts query
    positions for the causal / window masks."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    kvl = per_row_lens(kv_len, bh, skv, q.device)
    fmt = _fmt(src_fmt_name)
    qs = widen(q, fmt, src_dtype).float()
    ks = widen(k, fmt, src_dtype).float().repeat_interleave(group, dim=0)
    vs = widen(v, fmt, src_dtype).float().repeat_interleave(group, dim=0)
    if bq is not None or bk is not None:
        assert bq is not None and bk is not None, (bq, bk)
        return _flash_blocked_ref(qs, ks, vs, kvl, scale=scale,
                                  causal=causal, window=window,
                                  softcap=softcap, q_offset=q_offset,
                                  fmt=fmt, src_dtype=src_dtype,
                                  out_dtype=out_dtype, bq=bq, bk=bk)
    s = torch.einsum("hqd,hkd->hqk", qs, ks) * scale
    if softcap is not None:
        s = softcap_scores(s, softcap)
    mask = _mask(q_offset, 0, sq, 0, skv, kvl, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    # as the JAX dense oracle: p on the src grid times V as stored (f32)
    vf = v.float().repeat_interleave(group, dim=0)
    o = torch.einsum("hqk,hkd->hqd", widen(p, fmt, src_dtype).float(), vf)
    return (o / torch.where(l == 0.0, 1.0, l)).to(out_dtype)


def _mask(q_base, k_base, nq, q_start, nk, kvl, causal, window, device):
    """[BH, nq, nk] liveness of keys ``k_base + j`` for queries at
    positions ``q_base + q_start + i``."""
    q_idx = (q_base + q_start
             + torch.arange(nq, device=device))[None, :, None]
    k_idx = (k_base + torch.arange(nk, device=device))[None, None, :]
    mask = k_idx < kvl[:, None, None]
    if causal:
        mask = mask & (q_idx >= k_idx)
    if window is not None:
        mask = mask & ((q_idx - k_idx) < window)
    return mask


def _flash_blocked_ref(qs, ks, vs, kvl, *, scale, causal, window, softcap,
                       q_offset, fmt, src_dtype, out_dtype, bq, bk):
    """Blocked online-softmax walk over the pruned schedule, all head rows
    at once (a row whose block lies past its ``kv_len`` is fully masked
    there, which leaves its online state exactly unchanged — the kernel's
    per-row early-out)."""
    from .flash_attention import block_schedule

    bh, sq, d = qs.shape
    skv, dv = ks.shape[1], vs.shape[-1]
    qi, ki, ff, lf = block_schedule(sq, skv, bq, bk, causal=causal,
                                    window=window, q_offset=q_offset)
    dev = qs.device
    out = torch.empty((bh, sq, dv), dtype=out_dtype, device=dev)
    for step in range(len(qi)):
        iq, ik = int(qi[step]), int(ki[step])
        if ff[step]:
            acc = torch.zeros((bh, bq, dv), dtype=torch.float32, device=dev)
            m = torch.full((bh, bq, 1), NEG_INF, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((bh, bq, 1), dtype=torch.float32, device=dev)
        qb = qs[:, iq * bq:(iq + 1) * bq]
        kb = ks[:, ik * bk:(ik + 1) * bk]
        vb = vs[:, ik * bk:(ik + 1) * bk]
        s = torch.einsum("hqd,hkd->hqk", qb, kb) * scale
        if softcap is not None:
            s = softcap_scores(s, softcap)
        mask = _mask(q_offset, ik * bk, bq, iq * bq, bk, kvl, causal, window,
                     dev)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        dead = m_new <= NEG_INF / 2
        p = torch.where(mask, torch.exp(s - torch.where(dead, 0.0, m_new)),
                        0.0)
        alpha = torch.exp(torch.where(dead, 0.0, m - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vb = torch.where(mask.any(dim=1)[..., None], vb, 0.0)
        pv = torch.einsum("hqk,hkd->hqd", widen(p, fmt, src_dtype).float(),
                          vb)
        acc = acc * alpha + pv
        m = m_new
        if lf[step]:
            out[:, iq * bq:(iq + 1) * bq] = (
                acc / torch.where(l == 0.0, 1.0, l)).to(out_dtype)
    return out


def paged_gather(pool, table):
    """Materialize a paged layout back into per-row contiguous strips:
    ``pool`` [n_pages, page, D] gathered through ``table`` [rows, nk] ->
    [rows, nk * page, D].  Pure data movement."""
    rows, nk = table.shape
    _, page, d = pool.shape
    g = pool.index_select(0, table.reshape(-1).to(torch.int64))
    return g.reshape(rows, nk * page, d)


def decode_attention_paged_ref(q, k_pool, v_pool, block_table, *, kv_len,
                               **kw):
    """Paged decode: gather pages, then ``decode_attention_ref`` with
    ``bk`` pinned to the page size.  q [BHkv, G, D]; pools
    [n_pages, page, D]; block_table [BHkv, nk] flat per-head page ids."""
    page = k_pool.shape[1]
    return decode_attention_ref(q, paged_gather(k_pool, block_table),
                                paged_gather(v_pool, block_table),
                                kv_len=kv_len, bk=page, **kw)


def flash_attention_paged_ref(q, k_pool, v_pool, block_table, *, bq,
                              kv_len=None, **kw):
    """Paged prefill: gather pages, then the blocked walk with ``bk``
    pinned to the page size.  block_table [BKV, nk] per-KV-row page ids."""
    page = k_pool.shape[1]
    return flash_attention_ref(q, paged_gather(k_pool, block_table),
                               paged_gather(v_pool, block_table),
                               kv_len=kv_len, bq=bq, bk=page, **kw)
