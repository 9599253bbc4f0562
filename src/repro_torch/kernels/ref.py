"""Plain-torch oracles of the kernels (the contracts the CUDA kernels are
held against): the two attention kernels and the transprecision op path
(tp_matmul, tp_quantize, cast_and_pack, dotp_ex).

Each function computes what one kernel computes — same formats, same
masking, same accumulation dtype — written as straight torch, vectorized
over the flattened head rows.  The blocked modes (``bk=`` for decode,
``bq=``/``bk=`` for prefill) fix the summation schedule the way the JAX
package's oracles do; they agree with the CUDA kernels and with the JAX
kernels up to f32 summation order, never bitwise across frameworks.

The softcap is always the exp form ``cap * (1 - 2 / (exp(2 s / cap) + 1))``
(``softcap_scores``), never ``tanh``.

The op-path oracles snap with ``softfloat.quantize`` (gradual underflow)
and then flush below min normal (``_ftz``), which is the kernels' CONV
contract (``quant_common.quantize_bits``, RNE) reached another way.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import softfloat
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
                         bk: Optional[int] = None, bounds=None):
    """Single-query decode attention with the decode kernel's contract:
    in-container RNE snap of KV (and optionally q) onto the storage grid,
    src-format multiplies with f32 accumulation, an EXACT global softmax
    max (first pass), then blockwise f32 sums of ``p`` and ``p @ V`` with
    ``p`` rounded to ``src_dtype`` before the product (second pass).  Rows
    with ``kv_len == 0`` return zeros.

    q [BHkv, G, D]; k, v [BHkv, Smax, D]; ``kv_len`` scalar or per-row
    [BHkv]; a key ``j`` is live iff ``j < kv_len`` and (with ``window``)
    ``j > kv_len - 1 - window``.

    ``bounds`` [BHkv, C, 2] (a split-KV partition, as
    ``decode_attention.plan_splits`` gives it): the second pass runs over
    each part ``[lo, hi)`` alone, and the parts' f32 sums of ``p`` and
    ``p @ V`` are added in part order (0, 1, ..., C - 1)."""
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
    vs = torch.where(mask[:, 0, :, None], vs, 0.0)   # dead slots never read
    parts = [mask] if bounds is None else [
        mask & (k_idx >= bounds[:, r, 0, None, None].to(q.device))
        & (k_idx < bounds[:, r, 1, None, None].to(q.device))
        for r in range(bounds.shape[1])]
    for r, live in enumerate(parts):
        acc_r = torch.zeros((bh, g, d), dtype=torch.float32, device=q.device)
        l_r = torch.zeros((bh, g, 1), dtype=torch.float32, device=q.device)
        for kk in range(0, smax, bk):
            blk = slice(kk, kk + bk)
            p = torch.where(live[..., blk], torch.exp(s[..., blk] - m), 0.0)
            l_r = l_r + p.sum(dim=-1, keepdim=True)
            acc_r = acc_r + torch.einsum("hgk,hkd->hgd",
                                         p.to(src_dtype).float(), vs[:, blk])
        acc, l = (acc_r, l_r) if r == 0 else (acc + acc_r, l + l_r)
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
                              bk: Optional[int] = None, kv_len=None, **kw):
    """Paged prefill: gather pages, then the blocked walk over the gathered
    keys in blocks of ``bk`` (None: the page size; the gathered keys are
    zero-padded to a whole number of blocks, past every ``kv_len``).
    block_table [BKV, nk] per-KV-row page ids."""
    page = k_pool.shape[1]
    bk = page if bk is None else bk
    kg = paged_gather(k_pool, block_table)
    vg = paged_gather(v_pool, block_table)
    pad = (-kg.shape[1]) % bk
    if pad:
        kg = torch.nn.functional.pad(kg, (0, 0, 0, pad))
        vg = torch.nn.functional.pad(vg, (0, 0, 0, pad))
    if kv_len is None:
        kv_len = block_table.shape[1] * page
    return flash_attention_ref(q, kg, vg, kv_len=kv_len, bq=bq, bk=bk, **kw)


# ---------------------------------------------------------------------------
# the transprecision op path
# ---------------------------------------------------------------------------
def _ftz(x, fmt):
    """Flush magnitudes below ``fmt``'s min normal to a zero of x's sign."""
    return torch.where(x.abs() < fmt.min_normal,
                       torch.copysign(torch.zeros_like(x), x), x)


def tp_matmul_ref(a, b, *, out_dtype=torch.float32, quant_fmt_name=None,
                  bk: Optional[int] = None):
    """Expanding-FMA matmul oracle: optional fp-grid operand snap (FTZ like
    the kernel), exact widening to f32, f32 accumulation, ``out_dtype``
    store.  ``bk`` fixes the K-block schedule: partial products are summed
    per K-block in order (a last block shorter than ``bk`` is summed as
    it is)."""
    if quant_fmt_name is not None:
        fmt = get_format(quant_fmt_name)
        a = _ftz(softfloat.quantize(a.to(torch.float32), fmt), fmt)
        b = _ftz(softfloat.quantize(b.to(torch.float32), fmt), fmt)
    a, b = a.to(torch.float32), b.to(torch.float32)
    k = a.shape[-1]
    if bk is None or bk >= k:
        r = a @ b
    else:
        r = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                        device=a.device)
        for kk in range(0, k, bk):  # sequential K-block accumulation
            r = r + a[:, kk:kk + bk] @ b[kk:kk + bk, :]
    return r.to(out_dtype)


def tp_quantize_ref(x, *, fmt_name, out_dtype=torch.float32):
    """RNE snap onto ``fmt_name``'s grid with FTZ, stored in ``out_dtype``."""
    fmt = get_format(fmt_name)
    q = _ftz(softfloat.quantize(x.to(torch.float32), fmt), fmt)
    return q.to(out_dtype)


def cast_and_pack_ref(a, b, *, fmt_name, out_dtype=torch.float32):
    """Both streams snapped (RNE, FTZ), columns interleaved a, b, a, b..."""
    qa = tp_quantize_ref(a, fmt_name=fmt_name, out_dtype=out_dtype)
    qb = tp_quantize_ref(b, fmt_name=fmt_name, out_dtype=out_dtype)
    r, c = qa.shape
    return torch.stack([qa, qb], dim=-1).reshape(r, 2 * c)


def dotp_ex_ref(a, b, *, src_dtype=torch.float16):
    """Expanding dot product oracle (f32 accumulate of exact products)."""
    prod = (a.to(src_dtype).to(torch.float32)
            * b.to(src_dtype).to(torch.float32))
    return prod.sum()


def dotp_sequential_ref(a, b, *, src_fmt="fp16", acc_fmt="fp32"):
    """Sequential oracle of the paper's fmacex loop (Fig 11e):
    ``acc_{i+1} = round_acc(acc_i + a_i * b_i)``, products exact, one f32
    step per element in order."""
    src, acc = get_format(src_fmt), get_format(acc_fmt)
    qa = softfloat.quantize(a, src)
    qb = softfloat.quantize(b, src)
    out = torch.zeros((), dtype=qa.dtype, device=qa.device)
    for x, y in zip(qa.reshape(-1), qb.reshape(-1)):
        out = softfloat.quantize(out + x * y, acc)
    return out
