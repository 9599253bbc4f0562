"""GQA attention (local windows, softcap, qk-norm) in prefill and decode
forms, over contiguous or paged KV caches, and MLA (multi-head latent
attention, DeepSeek-V2 / MiniCPM3) over a contiguous latent cache.

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

Speculative verify (``gqa_attention(verify=True)``): a chunk of S
positions a row is written first, then its queries fold into the batch
and take the exact decode read at the step form's split partition, so
each folded query is bitwise the decode step at its position.

Cross-attention (whisper's decoder, ``gqa_attention(kv_states=)``): K/V
come from the encoder states without rope, are written whole into the
layer's contiguous cross cache at prefill, and every query reads every
frame (non-causal) on the prefill route; decode reads the cached cross
K/V over all frames on the decode route (``cross_attend_cached``).

Tensor parallelism (``mesh`` with a ``model`` axis of size M dividing
both head counts, ``_head_shard_size``): this rank's ``wq`` / ``wk`` /
``wv`` columns, Q/K/V and cache carry only its H/M and Hkv/M heads, so
every read (dense, kernel, prefill, decode, verify, contiguous, paged,
cross) is the unsharded read on a head slice, bitwise per head; the decode
reads pin the split partition of the unsharded call (``cluster`` for B *
Hkv rows), so a head's split does not change with M.  ``wo`` is
row-parallel (``_row_parallel_wo``): f32 partials, an f32 sum across the
model group, one snap after the sum.  MLA under a mesh: its latents
are gathered whole on every rank, its heads sharded (``mla_attention``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import ops as tp
from ..core.formats import get_format
from ..kernels import ops as kops
from ..kernels.quant_common import quantize_flag_masks_grid
from ..launch import spmd
from .layers import (apply_rope, dense_init, rmsnorm, row_parallel, softcap,
                     whole_cols)
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
                           q_offset, kv_len=None, chunk=512,
                           windowed_slice: bool = False):
    """Dense path: q [B,H,S,Dh] vs k/v [B,Hkv,T,Dh] -> [B,H,S,Dh], one
    query chunk at a time (each chunk sees every key and masks).

    ``windowed_slice`` (the JAX package's knob): on a causal sliding-window
    layer query chunk ``i`` reads only the keys ``[start, start + w_eff)``,
    ``start = clip(i * chunk + chunk - w_eff, 0, T - w_eff)``, ``w_eff``
    the window plus a chunk rounded up to 128 (at most T), so the work
    drops from O(S*T) to O(S*(window+chunk)); the KV is broadcast to full
    heads once, outside the chunk loop, as JAX's is."""
    b, h, s, dh = q.shape
    t = k.shape[2]
    scale = dh ** -0.5
    kvl = _len_rows(t if kv_len is None else kv_len, q.device)   # [1] or [B]
    chunk = min(chunk, s)
    w_eff = t                                  # every chunk reads every key
    if (windowed_slice and window is not None and causal and q_offset == 0
            and window + chunk < t):
        w_eff = min(-(-(window + chunk) // 128) * 128, t)
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, dh)
    k_all = torch.arange(t, device=q.device)
    l_all = k_all[None, :] < kvl[:, None]                        # [1|B, t]
    outs = []
    for c0 in range(0, s, chunk):
        qi = qg[:, :, :, c0:c0 + chunk]
        c = qi.shape[3]
        start = min(max(c0 + chunk - w_eff, 0), t - w_eff)
        ks, vs = k[:, :, start:start + w_eff], v[:, :, start:start + w_eff]
        k_idx, lmask = (k_all[start:start + w_eff],
                        l_all[:, start:start + w_eff])
        scores = tp.tp_einsum("bhgcd,bhtd->bhgct", qi, ks, policy,
                              out_fmt="fp32") * scale
        scores = softcap(scores, cap)
        q_idx = q_offset + c0 + torch.arange(c, device=q.device)
        mask = torch.ones((c, w_eff), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_idx[:, None] >= k_idx[None, :])
        if window is not None:
            mask = mask & ((q_idx[:, None] - k_idx[None, :]) < window)
        full = mask[None, None, None] & lmask[:, None, None, None, :]
        scores = torch.where(full, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - torch.where(m <= NEG_INF / 2, 0.0, m))
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(tp.tp_einsum("bhgct,bhtd->bhgcd", p, vs, policy,
                                 out_fmt="fp32"))
    out = torch.cat(outs, dim=3)
    return out.reshape(b, h, s, v.shape[-1])


def _decode_attend(q, ck, cv, policy, *, kv_len, window, cap,
                   backend: str = "auto", cluster: Optional[int] = None):
    """q [B,H,1,Dh] vs cache [B,Hkv,Smax,Dh]; ``kv_len`` scalar or [B];
    ``cluster``: the kernel's split partition (default: these rows')."""
    if backend != "dense":
        return kops.decode_attention(q, ck, cv, kv_len=kv_len, policy=policy,
                                     window=window, softcap=cap,
                                     backend=backend, cluster=cluster)
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
                         cap, backend: str = "auto",
                         cluster: Optional[int] = None):
    """Paged decode: the kernel dereferences the block table itself; the
    dense path gathers the pages back into the contiguous layout first."""
    if backend != "dense":
        return kops.decode_attention(
            q, cache.k_pool, cache.v_pool, kv_len=kv_len,
            block_table=cache.block_table, policy=policy, window=window,
            softcap=cap, backend=backend, cluster=cluster)
    return _decode_attend(q, gather_paged_kv(cache.k_pool, cache.block_table),
                          gather_paged_kv(cache.v_pool, cache.block_table),
                          policy, kv_len=kv_len, window=window, cap=cap,
                          backend="dense")


def _verify_attend(q, cache, policy, *, kv_len, window, cap, backend,
                   shards: int = 1):
    """The verify read: q [B, H, S, Dh] folded to [B*S, H, 1, Dh] through
    the decode read of the just-written cache, at the partition of a
    decode step of the B rows (of the unsharded heads: ``shards``, the
    head-shard count); ``kv_len`` [B, S].  Returns [B, H, S, Dh]."""
    b, h, s, dh = q.shape
    qf = q.transpose(1, 2).reshape(b * s, h, 1, dh)
    kvl = torch.as_tensor(kv_len, device=q.device).reshape(b * s)
    if isinstance(cache, PagedKVCache):
        cluster = kops.decode_cluster(b * shards, cache.k_pool,
                                      cache.block_table, window,
                                      group=h // cache.k_pool.shape[1])
        rep = PagedKVCache(cache.k_pool, cache.v_pool,
                           cache.block_table.repeat_interleave(s, 0))
        out = _decode_attend_paged(qf, rep, policy, kv_len=kvl,
                                   window=window, cap=cap, backend=backend,
                                   cluster=cluster)
    else:
        cluster = kops.decode_cluster(b * shards, cache.k, None, window,
                                      group=h // cache.k.shape[1])
        out = _decode_attend(qf, cache.k.repeat_interleave(s, 0),
                             cache.v.repeat_interleave(s, 0), policy,
                             kv_len=kvl, window=window, cap=cap,
                             backend=backend, cluster=cluster)
    return out.reshape(b, s, h, dh).transpose(1, 2)


def _prefill_attend(q, k, v, policy, *, causal, window, cap, q_offset,
                    kv_len, chunk, backend, windowed_slice: bool = False):
    """q [B,H,S,Dh] vs fresh contiguous k/v [B,Hkv,T,Dh] on the prefill
    route: the dense masked softmax (``windowed_slice`` its knob), or the
    flash kernel (its plain version on the CPU), whose block schedule
    already skips the blocks left of the window."""
    if backend == "dense":
        return _masked_softmax_attend(q, k, v, policy, causal=causal,
                                      window=window, cap=cap,
                                      q_offset=q_offset, kv_len=kv_len,
                                      chunk=chunk,
                                      windowed_slice=windowed_slice)
    return _flash_attend(q, k, v, policy, causal=causal, window=window,
                         cap=cap, q_offset=q_offset, kv_len=kv_len,
                         backend=backend)


# ---------------------------------------------------------------------------
# tensor-parallel head sharding (mesh "model" axis)
# ---------------------------------------------------------------------------
def _head_shard_size(mesh, n_heads, n_kv_heads, axis: str = "model"):
    """Tensor-parallel degree for head-sharded attention, or ``None`` for
    the unsharded path: a mesh with a ``model`` axis of size > 1 that
    divides BOTH head counts (every rank gets whole heads of each, so GQA
    groups never straddle ranks)."""
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        return None
    size = mesh.shape[axis]
    if size <= 1 or n_heads % size or n_kv_heads % size:
        return None
    return size


def _local_heads(params, n_heads, n_kv_heads, head_dim, shards):
    """``(H, Hkv)`` of this rank's slice; raises when ``params`` are not
    this rank's shards (``models.sharding.shard_params``)."""
    h, hkv = n_heads // shards, n_kv_heads // shards
    if params["wq"].shape[-1] != h * head_dim:
        raise ValueError(
            f"wq {tuple(params['wq'].shape)} is not a {shards}-way head "
            f"shard of {n_heads} heads x {head_dim}: pass this rank's "
            f"shards (models.sharding.shard_params)")
    return h, hkv


def _row_parallel_wo(mesh, out, wo, policy, axis: str = "model"):
    """Row-parallel output projection: ``out`` [B, S, H/M*Dv] holds this
    rank's heads, ``wo`` [H/M*Dv, D] the same rows; the f32 partials are
    summed over the model group and snapped once (never in a narrow type:
    JAX's ``_row_parallel_wo`` psums f32 whatever ``narrow_partials``
    says).  Per-head attend outputs are bitwise; this sum's order is not,
    so projections match the unsharded path to f32 reduction noise."""
    return row_parallel(out, wo, policy, mesh.group(axis), narrow=False)


def _project_out(out, params, policy, mesh, shards):
    if shards is None:
        return tp.tp_matmul(out, params["wo"], policy)
    return _row_parallel_wo(mesh, out, params["wo"], policy)


def gqa_attention(x, params, policy, *, n_heads, n_kv_heads, head_dim,
                  positions, causal=True, window=None, attn_softcap=None,
                  rope_theta=1e4, qk_norm=False, norm_eps=1e-6,
                  cache=None, cache_pos=None, kv_states=None,
                  use_rope=True, chunk: int = 512,
                  decode_backend: str = "auto",
                  prefill_backend: str = "auto", kv_len=None, esc_fmts=None,
                  kv_levels=None, kv_scale: Optional[float] = None,
                  verify: bool = False, mesh=None,
                  windowed_slice: bool = False,
                  return_attend: bool = False):
    """Returns ``(out [B,S,D], cache)``, or ``(out, cache, kv_flags)``
    when ``esc_fmts`` is given.  ``return_attend`` (a test hook) returns
    the per-head attend output [B, H, S, Dv] in place of ``out``.
    ``windowed_slice``: the dense prefill read's knob
    (``_masked_softmax_attend``).

    Tensor parallelism: ``mesh`` whose ``model`` axis divides both head
    counts runs every read on this rank's heads (``params`` and ``cache``
    are its shards) and the output projection row-parallel; otherwise the
    unsharded path runs.

    Cross-attention (``kv_states`` [B, T, D], the encoder's output): K/V
    are projected from ``kv_states`` (rope, if any, at positions 0..T-1),
    written whole at slot 0 of the contiguous ``cache`` when one is given,
    and every query attends every one of the T keys (``causal`` and
    ``window`` are not applied) on the prefill route.

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
        ``cache_pos + 1``), paged or contiguous;
      * speculative verify (``verify=True``, S > 1, ``cache_pos`` [B]):
        ``kv_len`` [B, S] gives query i of row b its live length; the S
        queries fold into the batch (query i of row b is row b*S + i) and
        take the decode read at the partition a decode step of these B
        rows picks (``kops.decode_cluster``), the block table repeated per
        query (a contiguous cache is repeated along the batch, as the JAX
        package does), so every folded query is bitwise the decode step at
        its position.

    Escalation write path: ``esc_fmts`` (a tuple of FPFormat rungs, narrow
    -> wide) and ``kv_levels`` ([B] per-row rung) send every cache write
    through ``quantize_kv_rows``; ``kv_flags`` [B, 2] are the rows' OF /
    UF write counts (zeros without a cache).  ``kv_scale`` multiplies K/V
    before the snap: the fault-injection hook that forces a narrow rung
    to overflow."""
    b, s, d = x.shape
    src = x if kv_states is None else kv_states
    t = src.shape[1]
    shards = _head_shard_size(mesh, n_heads, n_kv_heads)
    q_norm, k_norm = params.get("q_norm"), params.get("k_norm")
    if shards is not None:
        n_heads, n_kv_heads = _local_heads(params, n_heads, n_kv_heads,
                                           head_dim, shards)
        # training: the replicated inputs of this rank's heads take the
        # sum of the ranks' gradients
        grp = mesh.group("model")
        x = spmd.grad_sum(x, grp)
        src = x if kv_states is None else spmd.grad_sum(kv_states, grp)
        if qk_norm:
            q_norm, k_norm = (spmd.grad_sum(q_norm, grp),
                              spmd.grad_sum(k_norm, grp))
    q = tp.tp_matmul(x, params["wq"], policy).reshape(b, s, n_heads, head_dim)
    k = tp.tp_matmul(src, params["wk"], policy).reshape(b, t, n_kv_heads,
                                                        head_dim)
    v = tp.tp_matmul(src, params["wv"], policy).reshape(b, t, n_kv_heads,
                                                        head_dim)
    if qk_norm:
        q = rmsnorm(q, q_norm, norm_eps)
        k = rmsnorm(k, k_norm, norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions if kv_states is None
                       else torch.arange(t, device=x.device), rope_theta)

    kv_flags = torch.zeros((b, 2), dtype=torch.int32, device=x.device)
    if kv_states is not None:
        if cache is not None:
            update_cache_rows(cache.k, k, 0)
            update_cache_rows(cache.v, v, 0)
        out = _prefill_attend(q, k, v, policy, causal=False, window=None,
                              cap=attn_softcap, q_offset=0, kv_len=None,
                              chunk=chunk, backend=prefill_backend)
    elif cache is None:
        out = _prefill_attend(q, k, v, policy, causal=causal, window=window,
                              cap=attn_softcap, q_offset=0, kv_len=kv_len,
                              chunk=chunk, backend=prefill_backend,
                              windowed_slice=windowed_slice)
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
        if verify and s > 1:
            out = _verify_attend(q, cache, policy, kv_len=kv_len,
                                 window=window, cap=attn_softcap,
                                 backend=decode_backend,
                                 shards=shards or 1)
        elif s > 1 and paged:
            live = kv_len if kv_len is not None else cache_pos + s
            if prefill_backend == "dense":
                out = _masked_softmax_attend(
                    q, gather_paged_kv(cache.k_pool, cache.block_table),
                    gather_paged_kv(cache.v_pool, cache.block_table), policy,
                    causal=causal, window=window, cap=attn_softcap,
                    q_offset=int(cache_pos), kv_len=live, chunk=chunk,
                    windowed_slice=windowed_slice)
            else:
                out = _flash_attend_paged(q, cache, policy, causal=causal,
                                          window=window, cap=attn_softcap,
                                          q_offset=int(cache_pos),
                                          kv_len=live,
                                          backend=prefill_backend)
        elif s > 1:
            out = _prefill_attend(q, k, v, policy, causal=causal,
                                  window=window, cap=attn_softcap,
                                  q_offset=int(cache_pos), kv_len=kv_len,
                                  chunk=chunk, backend=prefill_backend,
                                  windowed_slice=windowed_slice)
        else:
            if kv_len is None:
                kv_len = cache_pos + s
            pin = None
            if shards is not None:
                # split as the unsharded call's B * Hkv rows would
                pin = kops.decode_cluster(
                    b * shards, cache.k_pool if paged else cache.k,
                    cache.block_table if paged else None, window,
                    group=n_heads // n_kv_heads)
            if paged:
                out = _decode_attend_paged(q, cache, policy, kv_len=kv_len,
                                           window=window, cap=attn_softcap,
                                           backend=decode_backend,
                                           cluster=pin)
            else:
                out = _decode_attend(q, cache.k, cache.v, policy,
                                     kv_len=kv_len, window=window,
                                     cap=attn_softcap,
                                     backend=decode_backend, cluster=pin)

    if return_attend:
        return out, cache
    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    proj = _project_out(out, params, policy, mesh, shards)
    if esc_fmts is not None:
        return proj, cache, kv_flags
    return proj, cache


def cross_attend_cached(x, params, cache: KVCache, policy, *, n_heads,
                        n_kv_heads, head_dim, backend: str = "auto",
                        mesh=None, return_attend: bool = False):
    """Decode-time cross-attention: q from ``x`` [B, 1, D] against the
    whole cached cross K/V [B, Hkv, n_frames, Dh] (the encoder states never
    change while decoding) on the decode route, no window, no softcap.
    ``mesh`` and ``return_attend`` as in ``gqa_attention``."""
    b, s, d = x.shape
    shards = _head_shard_size(mesh, n_heads, n_kv_heads)
    pin = None
    if shards is not None:
        n_heads, n_kv_heads = _local_heads(params, n_heads, n_kv_heads,
                                           head_dim, shards)
        pin = kops.decode_cluster(b * shards, cache.k, None, None,
                                  group=n_heads // n_kv_heads)
    q = tp.tp_matmul(x, params["wq"], policy).reshape(
        b, s, n_heads, head_dim).transpose(1, 2)
    out = _decode_attend(q, cache.k, cache.v, policy,
                         kv_len=cache.k.shape[2], window=None, cap=None,
                         backend=backend, cluster=pin)
    if return_attend:
        return out
    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    return _project_out(out, params, policy, mesh, shards)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------
class MLACache(NamedTuple):
    c_kv: torch.Tensor   # [B, Smax, kv_lora]
    k_pe: torch.Tensor   # [B, Smax, rope_dim]


def init_mla_cache(batch, max_len, kv_lora, rope_dim, dtype, device):
    return MLACache(
        torch.zeros((batch, max_len, kv_lora), dtype=dtype, device=device),
        torch.zeros((batch, max_len, rope_dim), dtype=dtype, device=device))


def update_latent_rows(buf, new, pos):
    """Write ``new`` [B, S, R] into the latent cache ``buf`` [B, Smax, R]
    along axis 1 at slot ``pos`` (scalar, or per-row [B]) IN PLACE;
    returns ``buf``.  As the JAX package's ``dynamic_update_slice`` write,
    a start past ``Smax - S`` is clamped to it."""
    new = new.to(buf.dtype)
    s, smax = new.shape[1], buf.shape[1]
    if not _is_vec(pos):
        start = min(max(int(pos), 0), smax - s)
        buf[:, start:start + s] = new
        return buf
    start = pos.to(torch.int64).clamp(0, smax - s)
    t = start[:, None] + torch.arange(s, device=buf.device)
    buf[torch.arange(buf.shape[0], device=buf.device)[:, None], t] = new
    return buf


def mla_params(gen, d_model, n_heads, *, q_lora, kv_lora, nope_dim, rope_dim,
               v_head_dim, dtype, device):
    p = {
        "w_dkv": dense_init(gen, d_model, kv_lora, dtype, device),
        "w_kr": dense_init(gen, d_model, rope_dim, dtype, device),
        "kv_norm": torch.zeros((kv_lora,), dtype=dtype, device=device),
        "w_uk": dense_init(gen, kv_lora, n_heads * nope_dim, dtype, device),
        "w_uv": dense_init(gen, kv_lora, n_heads * v_head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * v_head_dim, d_model, dtype, device),
    }
    qd = nope_dim + rope_dim
    if q_lora:
        p["w_dq"] = dense_init(gen, d_model, q_lora, dtype, device)
        p["q_norm"] = torch.zeros((q_lora,), dtype=dtype, device=device)
        p["w_uq"] = dense_init(gen, q_lora, n_heads * qd, dtype, device)
    else:
        p["w_q"] = dense_init(gen, d_model, n_heads * qd, dtype, device)
    return p


def _into_heads(t, group):
    """A replicated latent entering this rank's heads: its cotangent
    summed over the model group (``spmd.grad_sum``)."""
    return spmd.grad_sum(t, group)


def mla_attention(x, params, policy, *, n_heads, nope_dim, rope_dim,
                  v_head_dim, positions, rope_theta=1e4, norm_eps=1e-6,
                  cache: Optional[MLACache] = None, cache_pos=None,
                  chunk: int = 512, prefill_backend: str = "auto",
                  kv_len=None, mesh=None, return_attend: bool = False):
    """MLA with decoupled rope: ``(out [B, S, D], cache)``; with
    ``return_attend`` (a test hook) the per-head read [B, H, S, Dv] in
    place of ``out``.

    With a cache, the step's latent ``c_kv`` and rope key ``k_pe`` are
    written first (in place) at ``cache_pos`` (scalar or per-row [B]).
    Decode (S == 1 with a cache) runs the absorbed form against the latent
    cache up to ``kv_len`` (default ``cache_pos + 1``; a row of length 0
    gives zeros); prefill and training expand K [B, H, S, nope + rope] and
    V [B, H, S, v_head] and read them through the flash kernel (``Dv !=
    D``, scale ``(nope + rope)^-0.5``) or, with ``prefill_backend="dense"``,
    the masked-softmax path.

    Tensor parallelism (``mesh`` with a ``model`` axis of M > 1 ranks;
    ``params`` this rank's shards): the down projections ``w_dq`` /
    ``w_dkv`` / ``w_kr`` are ``col``, so each rank computes its block of
    the latents and one ``all_gather_cat`` makes them whole before the
    norms and the cache write (the latent cache is whole on every rank);
    where M divides the heads, ``w_uq`` / ``w_q`` / ``w_uk`` / ``w_uv``
    hold this rank's H/M whole heads, every read (prefill, absorbed
    decode) runs on them and ``wo`` is row-parallel
    (``_row_parallel_wo``); otherwise those leaves are whole
    (``shard_params(cfg=)``) and the heads run unsharded.  Training: the
    gather backprops as this rank's block; ``spmd.grad_sum`` sits on
    ``x`` where it enters a sharded product and, with the heads sharded,
    on ``cq``, ``c_kv`` and ``k_pe`` where they enter this rank's heads
    (the norm gains ``q_norm`` / ``kv_norm`` then get whole gradients).

    Rope: every key is rotated at its own position, in prefill as in
    decode, as MiniCPM3 and DeepSeek-V2 define it.  (The JAX package's
    prefill broadcasts its ``[B, S, 1, rope]`` keys against ``[S]``
    positions and keeps position 0, so it attends and caches prompt keys
    unrotated; its decode rotates them.  This port's prefill equals the
    JAX package's token-by-token decode.)"""
    b, s, _ = x.shape
    qd = nope_dim + rope_dim
    kv_lora = params["kv_norm"].shape[-1]
    shards = _head_shard_size(mesh, n_heads, n_heads)
    group = (mesh.group("model") if mesh is not None
             and mesh.shape.get("model", 1) > 1 else None)
    if shards is not None:
        n_heads //= shards
        wq = params["w_uq" if "w_uq" in params else "w_q"]
        if wq.shape[-1] != n_heads * qd:
            raise ValueError(
                f"MLA query projection {tuple(wq.shape)} is not a "
                f"{shards}-way head shard ({n_heads} heads x {qd}): pass "
                f"this rank's shards (models.sharding.shard_params)")
    names = ["w_dkv", "w_kr"] + (["w_dq"] if "w_dq" in params else [])
    widths = [kv_lora, rope_dim] + (
        [params["q_norm"].shape[-1]] if "w_dq" in params else [])
    # training: x's cotangent sums over the ranks where it enters a
    # column block or this rank's heads, and stays as it is where the
    # product runs whole (a replicated leaf)
    split = [params[k].shape[-1] != n for k, n in zip(names, widths)]
    if "w_q" in params:
        split.append(shards is not None)
    xs = spmd.grad_sum(x, group) if any(split) else x
    parts = whole_cols([tp.tp_matmul(xs if sp else x, params[k], policy)
                        for k, sp in zip(names, split)], widths, group)
    # what enters this rank's heads: replicated values, their cotangents
    # summed over the ranks (with the heads whole, already whole)
    heads = (lambda t: _into_heads(t, group)) if shards is not None \
        else (lambda t: t)
    if "w_dq" in params:
        cq = heads(rmsnorm(parts[2], params["q_norm"], norm_eps))
        q = tp.tp_matmul(cq, params["w_uq"], policy)
    else:
        q = tp.tp_matmul(xs if split[-1] else x, params["w_q"], policy)
    q = q.reshape(b, s, n_heads, qd).transpose(1, 2)         # [B, H, S, qd]
    q_nope = q[..., :nope_dim]
    q_pe = apply_rope(q[..., nope_dim:], positions, rope_theta)
    # [B, S, kv_lora]
    c_kv = heads(rmsnorm(parts[0], params["kv_norm"], norm_eps))
    # [B, 1, S, rope]: the keys take the positions as one head's rows do
    k_pe = heads(apply_rope(parts[1][:, None], positions,
                            rope_theta)[:, 0])              # [B, S, rope]
    scale = qd ** -0.5

    if cache is not None:
        update_latent_rows(cache.c_kv, c_kv, cache_pos)
        update_latent_rows(cache.k_pe, k_pe, cache_pos)
    if cache is not None and s == 1:
        if kv_len is None:
            kv_len = cache_pos + s
        cc, cp = cache
        smax = cc.shape[1]
        # absorbed decode: q_nope into the latent space through W_uk
        w_uk = params["w_uk"].reshape(kv_lora, n_heads, nope_dim)
        q_lat = tp.tp_einsum("bhsn,rhn->bhsr", q_nope, w_uk, policy)
        scores = (tp.tp_einsum("bhsr,btr->bhst", q_lat, cc, policy,
                               out_fmt="fp32")
                  + tp.tp_einsum("bhsr,btr->bhst", q_pe, cp, policy,
                                 out_fmt="fp32")) * scale
        mask = (torch.arange(smax, device=x.device)[None, :]
                < _len_rows(kv_len, x.device)[:, None])
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
        p = torch.softmax(scores.to(torch.float32), dim=-1)
        # kv_len == 0 rows: zeros, not uniform weights over dead slots
        p = p * mask.any(dim=-1).to(p.dtype)[:, None, None, None]
        o_lat = tp.tp_einsum("bhst,btr->bhsr", p, cc, policy, out_fmt="fp32")
        w_uv = params["w_uv"].reshape(kv_lora, n_heads, v_head_dim)
        out = tp.tp_einsum("bhsr,rhv->bhsv", o_lat, w_uv, policy)
    else:
        k_nope = tp.tp_matmul(c_kv, params["w_uk"], policy).reshape(
            b, s, n_heads, nope_dim)
        v = tp.tp_matmul(c_kv, params["w_uv"], policy).reshape(
            b, s, n_heads, v_head_dim)
        k_pe_b = k_pe[:, :, None].expand(b, s, n_heads, rope_dim)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        kk = torch.cat([k_nope, k_pe_b], dim=-1).transpose(1, 2)
        vv = v.transpose(1, 2)
        if prefill_backend == "dense":
            out = _masked_softmax_attend(qq, kk, vv, policy, causal=True,
                                         window=None, cap=None, q_offset=0,
                                         kv_len=kv_len, chunk=chunk)
        else:
            out = _flash_attend(qq, kk, vv, policy, causal=True, window=None,
                                cap=None, kv_len=kv_len,
                                backend=prefill_backend)
    if return_attend:
        return out, cache
    out = out.transpose(1, 2).reshape(b, s, n_heads * v_head_dim)
    return _project_out(out, params, policy, mesh, shards), cache
