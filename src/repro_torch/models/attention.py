"""GQA attention (local windows, softcap, qk-norm) in prefill and decode
forms, over contiguous or paged KV caches.

Every projection runs through ``core.ops`` under the FPnew multi-format FMA
contract; softmax statistics stay f32.  The attention reads go through
``kernels.ops`` — the hand-written CUDA kernels on the card, their plain
versions on the CPU — unless the config asks for the ``"dense"`` masked-
softmax path (``_masked_softmax_attend`` / the dense ``_decode_attend``).

Caches are updated IN PLACE: ``gqa_attention`` writes the step's K/V into
the cache tensors it is given and returns the same cache object.  With an
escalation ladder (``esc_fmts``) every cache write goes through
``quantize_kv_rows``: each row's K/V snapped onto its own rung with the
saturating cast, its OF / UF write counts returned.

Not ported yet: MLA, cross-attention, tensor-parallel head sharding and
the speculative ``verify`` read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import ops as tp
from ..core.formats import get_format
from ..kernels import ops as kops
from ..kernels.quant_common import quantize_flag_masks_grid
from .layers import apply_rope, dense_init, rmsnorm, softcap
from .paged import (PagedKVCache, gather_paged_kv, paged_update_rows,
                    write_slots)

NEG_INF = -1e30


def kv_store_dtype(policy) -> torch.dtype:
    if policy.kv_fmt is not None and policy.mode == "native":
        return policy.kv_fmt.native_dtype
    return tp.storage_dtype(policy.param_fmt, policy.mode)


def kv_swap_dtype(fmt) -> torch.dtype:
    """Host-side dtype of KV pages swapped out of the pool under a degrade
    format (serving-loop preemption): the format's native container
    (``fp8`` -> ``torch.float8_e5m2``, never ``float8_e4m3fn``, a
    different format).  Swap-in widens back to the pool dtype; on a pool
    that already stores ``fmt`` (policy ``tp_bf16_kv8``) the round trip
    is value-exact."""
    f = get_format(fmt)
    if f.native_dtype is None:
        raise ValueError(
            f"degrade format {f.name!r} has no native container dtype to "
            f"swap KV pages into (use fp8/bf16/fp16)")
    return f.native_dtype


def quantize_kv_rows(x, esc_fmts, levels):
    """Write-time per-row KV quantization for precision escalation.

    ``x`` [B, ...] is a fresh K or V tensor about to land in an f32 pool;
    ``levels`` [B] int picks each row's rung of the ``esc_fmts`` ladder
    (narrow -> wide).  Every rung is snapped with the SATURATING cast
    (overflow clamps to +-max normal, so the stored value stays finite and
    attention never poisons, while OF still fires).  Returns ``(y,
    counts)``, ``counts`` [B, 2] int32 the per-row OF / UF totals of this
    write — bit for bit as the JAX package's ``quantize_kv_rows``."""
    x = x.to(torch.float32)
    top = len(esc_fmts) - 1
    lvl = levels.to(x.device)
    lvl = torch.where((lvl >= 0) & (lvl < top), lvl, top)  # else: the widest
    # each row's grid (m, emax, emin), for one snap pass over every row
    grid = []
    for attr in ("m_bits", "emax", "emin"):
        g = torch.full_like(lvl, getattr(esc_fmts[top], attr),
                            dtype=torch.int32)
        for i in range(top):
            g = torch.where(lvl == i, getattr(esc_fmts[i], attr), g)
        grid.append(g.reshape((-1,) + (1,) * (x.dim() - 1)))
    y, of, uf, _, _ = quantize_flag_masks_grid(x, *grid, saturate=True)
    red = tuple(range(1, x.dim()))
    counts = torch.stack([of.to(torch.int32).sum(dim=red),
                          uf.to(torch.int32).sum(dim=red)], dim=-1)
    return y, counts.to(torch.int32)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, Hkv, Smax, Dh]
    v: torch.Tensor


def init_kv_cache(batch, n_kv_heads, max_len, head_dim, dtype, device):
    shape = (batch, n_kv_heads, max_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _is_vec(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1


def _len_rows(kv_len, device) -> torch.Tensor:
    """Scalar-or-vector ``kv_len`` as a [1]-or-[B] int64 tensor."""
    return torch.as_tensor(kv_len, device=device).reshape(-1).to(torch.int64)


def update_cache_rows(buf, new, pos):
    """Write ``new`` [B, Hkv, S, Dh] into ``buf`` [B, Hkv, Smax, Dh] at
    slot ``pos`` (scalar, or per-row [B]) IN PLACE; returns ``buf``."""
    new = new.to(buf.dtype)
    s = new.shape[2]
    if not _is_vec(pos):
        buf[:, :, int(pos):int(pos) + s] = new
        return buf
    b = buf.shape[0]
    t = pos.to(torch.int64)[:, None] + torch.arange(s, device=buf.device)
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, :, t] = new.permute(0, 2, 1, 3)
    return buf


def gqa_params(gen, d_model, n_heads, n_kv_heads, head_dim, dtype, device,
               qk_norm: bool = False):
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros((head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((head_dim,), dtype=dtype, device=device)
    return p


def _flash_attend(q, k, v, policy, *, causal, window, cap, q_offset=0,
                  kv_len=None, backend="auto"):
    """q [B,H,S,Dh] vs contiguous k/v [B,Hkv,T,Dh] through the flash
    kernel (or its plain version)."""
    return kops.flash_attention(q, k, v, kv_len=kv_len, policy=policy,
                                scale=q.shape[-1] ** -0.5, causal=causal,
                                window=window, softcap=cap, q_offset=q_offset,
                                backend=backend)


def _flash_attend_paged(q, cache: PagedKVCache, policy, *, causal, window,
                        cap, q_offset, kv_len, backend="auto"):
    """Prefill reads against a PAGED cache: the kernel dereferences the
    block table itself; ``q_offset`` is the chunk's start in its row and
    ``kv_len`` the row's total live length (prefix + this chunk)."""
    return kops.flash_attention(q, cache.k_pool, cache.v_pool, kv_len=kv_len,
                                block_table=cache.block_table, policy=policy,
                                scale=q.shape[-1] ** -0.5, causal=causal,
                                window=window, softcap=cap, q_offset=q_offset,
                                backend=backend)


def _masked_softmax_attend(q, k, v, policy, *, causal, window, cap,
                           q_offset, kv_len=None, chunk=512):
    """Dense path: q [B,H,S,Dh] vs k/v [B,Hkv,T,Dh] -> [B,H,S,Dh], one
    query chunk at a time (each chunk sees every key and masks)."""
    b, h, s, dh = q.shape
    _, hkv, t, _ = k.shape
    group = h // hkv
    scale = dh ** -0.5
    kvl = _len_rows(t if kv_len is None else kv_len, q.device)   # [1] or [B]
    qg = q.reshape(b, hkv, group, s, dh)
    k_idx = torch.arange(t, device=q.device)
    lmask = k_idx[None, :] < kvl[:, None]                        # [1|B, t]
    outs = []
    for c0 in range(0, s, chunk):
        qi = qg[:, :, :, c0:c0 + chunk]
        c = qi.shape[3]
        scores = tp.tp_einsum("bhgcd,bhtd->bhgct", qi, k, policy,
                              out_fmt="fp32") * scale
        scores = softcap(scores, cap)
        q_idx = q_offset + c0 + torch.arange(c, device=q.device)
        mask = torch.ones((c, t), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_idx[:, None] >= k_idx[None, :])
        if window is not None:
            mask = mask & ((q_idx[:, None] - k_idx[None, :]) < window)
        full = mask[None, None, None] & lmask[:, None, None, None, :]
        scores = torch.where(full, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - torch.where(m <= NEG_INF / 2, 0.0, m))
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(tp.tp_einsum("bhgct,bhtd->bhgcd", p, v, policy,
                                 out_fmt="fp32"))
    out = torch.cat(outs, dim=3)
    return out.reshape(b, h, s, v.shape[-1])


def _decode_attend(q, ck, cv, policy, *, kv_len, window, cap,
                   backend: str = "auto"):
    """q [B,H,1,Dh] vs cache [B,Hkv,Smax,Dh]; ``kv_len`` scalar or [B]."""
    if backend != "dense":
        return kops.decode_attention(q, ck, cv, kv_len=kv_len, policy=policy,
                                     window=window, softcap=cap,
                                     backend=backend)
    b, h, s, dh = q.shape
    _, hkv, smax, _ = ck.shape
    group = h // hkv
    qg = q.reshape(b, hkv, group * s, dh)
    scores = tp.tp_einsum("bhqd,bhtd->bhqt", qg, ck, policy,
                          out_fmt="fp32") * (dh ** -0.5)
    scores = softcap(scores, cap)
    idx = torch.arange(smax, device=q.device)
    kvl = _len_rows(kv_len, q.device)[:, None]                  # [1|B, 1]
    mask = idx[None, :] < kvl
    if window is not None:
        mask = mask & (idx[None, :] > kvl - 1 - window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores.to(torch.float32), dim=-1)
    # fully masked rows (kv_len == 0, an idle slot) emit zeros
    p = p * mask.any(dim=-1).to(p.dtype)[:, None, None, None]
    out = tp.tp_einsum("bhqt,bhtd->bhqd", p, cv, policy, out_fmt="fp32")
    return out.reshape(b, h, s, dh)


def _decode_attend_paged(q, cache: PagedKVCache, policy, *, kv_len, window,
                         cap, backend: str = "auto"):
    """Paged decode: the kernel dereferences the block table itself; the
    dense path gathers the pages back into the contiguous layout first."""
    if backend != "dense":
        return kops.decode_attention(
            q, cache.k_pool, cache.v_pool, kv_len=kv_len,
            block_table=cache.block_table, policy=policy, window=window,
            softcap=cap, backend=backend)
    return _decode_attend(q, gather_paged_kv(cache.k_pool, cache.block_table),
                          gather_paged_kv(cache.v_pool, cache.block_table),
                          policy, kv_len=kv_len, window=window, cap=cap,
                          backend="dense")


def gqa_attention(x, params, policy, *, n_heads, n_kv_heads, head_dim,
                  positions, causal=True, window=None, attn_softcap=None,
                  rope_theta=1e4, qk_norm=False, norm_eps=1e-6,
                  cache=None, cache_pos=None, use_rope=True, chunk: int = 512,
                  decode_backend: str = "auto",
                  prefill_backend: str = "auto", kv_len=None, esc_fmts=None,
                  kv_levels=None, kv_scale: Optional[float] = None):
    """Returns ``(out [B,S,D], cache)``, or ``(out, cache, kv_flags)``
    when ``esc_fmts`` is given.

    No cache: training-style prefill over the fresh K/V.  With a cache, the
    step's K/V are written first (in place) at ``cache_pos`` (scalar or
    per-row [B]); then:
      * paged prefill (S > 1) attends THROUGH the pool just written, with
        ``cache_pos`` (an int) as the chunk's query offset and ``kv_len``
        the rows' total live lengths — a chunked continuation is the same
        code path as a fresh prompt;
      * contiguous prefill attends the fresh K/V (``kv_len`` = per-row
        prompt lengths);
      * decode (S == 1) attends the cache up to ``kv_len`` (default
        ``cache_pos + 1``), paged or contiguous.

    Escalation write path: ``esc_fmts`` (a tuple of FPFormat rungs, narrow
    -> wide) and ``kv_levels`` ([B] per-row rung) send every cache write
    through ``quantize_kv_rows``; ``kv_flags`` [B, 2] are the rows' OF /
    UF write counts (zeros without a cache).  ``kv_scale`` multiplies K/V
    before the snap: the fault-injection hook that forces a narrow rung
    to overflow."""
    b, s, d = x.shape
    q = tp.tp_matmul(x, params["wq"], policy).reshape(b, s, n_heads, head_dim)
    k = tp.tp_matmul(x, params["wk"], policy).reshape(b, s, n_kv_heads,
                                                      head_dim)
    v = tp.tp_matmul(x, params["wv"], policy).reshape(b, s, n_kv_heads,
                                                      head_dim)
    if qk_norm:
        q = rmsnorm(q, params["q_norm"], norm_eps)
        k = rmsnorm(k, params["k_norm"], norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    kv_flags = torch.zeros((b, 2), dtype=torch.int32, device=x.device)
    if cache is None:
        if prefill_backend == "dense":
            out = _masked_softmax_attend(q, k, v, policy, causal=causal,
                                         window=window, cap=attn_softcap,
                                         q_offset=0, kv_len=kv_len,
                                         chunk=chunk)
        else:
            out = _flash_attend(q, k, v, policy, causal=causal, window=window,
                                cap=attn_softcap, kv_len=kv_len,
                                backend=prefill_backend)
    else:
        paged = isinstance(cache, PagedKVCache)
        if esc_fmts is not None:
            if kv_scale is not None:
                k, v = k * kv_scale, v * kv_scale
            k, kf = quantize_kv_rows(k, esc_fmts, kv_levels)
            v, vf = quantize_kv_rows(v, esc_fmts, kv_levels)
            kv_flags = kf + vf
        if paged:
            # a per-row write index: one slot computation for K and V
            slots = (write_slots(cache.block_table, cache_pos, s,
                                 cache.page_size)
                     if isinstance(cache_pos, torch.Tensor)
                     and cache_pos.dim() >= 1 else None)
            paged_update_rows(cache.k_pool, cache.block_table, k, cache_pos,
                              slots)
            paged_update_rows(cache.v_pool, cache.block_table, v, cache_pos,
                              slots)
        else:
            update_cache_rows(cache.k, k, cache_pos)
            update_cache_rows(cache.v, v, cache_pos)
        if s > 1 and paged:
            live = kv_len if kv_len is not None else cache_pos + s
            if prefill_backend == "dense":
                out = _masked_softmax_attend(
                    q, gather_paged_kv(cache.k_pool, cache.block_table),
                    gather_paged_kv(cache.v_pool, cache.block_table), policy,
                    causal=causal, window=window, cap=attn_softcap,
                    q_offset=int(cache_pos), kv_len=live, chunk=chunk)
            else:
                out = _flash_attend_paged(q, cache, policy, causal=causal,
                                          window=window, cap=attn_softcap,
                                          q_offset=int(cache_pos),
                                          kv_len=live,
                                          backend=prefill_backend)
        elif s > 1:
            if prefill_backend == "dense":
                out = _masked_softmax_attend(q, k, v, policy, causal=causal,
                                             window=window, cap=attn_softcap,
                                             q_offset=int(cache_pos),
                                             kv_len=kv_len, chunk=chunk)
            else:
                out = _flash_attend(q, k, v, policy, causal=causal,
                                    window=window, cap=attn_softcap,
                                    q_offset=int(cache_pos), kv_len=kv_len,
                                    backend=prefill_backend)
        else:
            if kv_len is None:
                kv_len = cache_pos + s
            if paged:
                out = _decode_attend_paged(q, cache, policy, kv_len=kv_len,
                                           window=window, cap=attn_softcap,
                                           backend=decode_backend)
            else:
                out = _decode_attend(q, cache.k, cache.v, policy,
                                     kv_len=kv_len, window=window,
                                     cap=attn_softcap,
                                     backend=decode_backend)

    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    proj = tp.tp_matmul(out, params["wo"], policy)
    if esc_fmts is not None:
        return proj, cache, kv_flags
    return proj, cache
