"""Public wrappers around the attention kernels: policy plumbing, head
flattening, per-row length and page-table expansion, backend choice.

Backends (``cfg.decode_backend`` / ``cfg.prefill_backend``):

  ``"kernel"`` the hand-written CUDA kernel (CUDA tensors only: asking for
               it on a CPU tensor raises, as do the kernels' launch
               functions themselves);
  ``"plain"``  the kernel's plain-torch version, on any device;
  ``"auto"``   the kernel for CUDA tensors, the plain version for CPU ones;
  ``"dense"``  the model's dense masked-softmax path (no kernel contract;
               handled in ``models.attention``).

The flat pool layout is the JAX package's: the model-level pool
[n_pages, Hkv, page, D] reshapes (zero-copy) to [n_pages * Hkv, page, D],
where page ``p`` of head ``hk`` sits at flat slot ``p * Hkv + hk``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.policy import get_policy
from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain

BACKENDS = ("auto", "kernel", "plain", "dense")


def resolve_backend(backend: str, device) -> str:
    """The one place that picks kernel or plain version: ``"auto"`` ->
    ``"kernel"`` on a CUDA device, ``"plain"`` elsewhere; ``"kernel"`` off
    CUDA raises."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    if backend == "kernel" and device.type != "cuda":
        raise ValueError(f"backend 'kernel' needs CUDA tensors, got {device}")
    return backend


def expand_kv_lens(kv_len, batch: int, heads: int, default, device):
    """Scalar-or-[batch] sequence lengths -> one int32 entry per flattened
    head row ([batch * heads]).  ``None`` means ``default``."""
    kvl = torch.as_tensor(default if kv_len is None else kv_len,
                          device=device).reshape(-1).to(torch.int32)
    if kvl.shape[0] == 1:
        return kvl.expand(batch * heads)
    assert kvl.shape[0] == batch, (kvl.shape, batch)
    return kvl.repeat_interleave(heads)


def expand_block_table(table, heads: int):
    """Per-sequence page table [B, max_pages] -> flat per-head page ids
    [B * heads, max_pages] (page ``p`` of head ``hk`` at ``p*heads+hk``)."""
    b, mp = table.shape
    t = table.to(torch.int32)
    flat = (t[:, None, :] * heads
            + torch.arange(heads, dtype=torch.int32,
                           device=t.device)[None, :, None])
    return flat.reshape(b * heads, mp)


def _src(policy):
    """(multiply dtype, grid the kernel snaps f32 operands onto or None)."""
    mp = policy.matmul
    if policy.mode == "native":
        return mp.src_fmt.native_dtype, None
    # f32 containers: RNE-snap operands onto the src grid in-kernel
    return torch.float32, (mp.src_fmt.name if mp.src_fmt.name != "fp32"
                           else None)


def flash_attention(q, k, v, *, kv_len=None, policy=None, block_table=None,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    backend: str = "auto"):
    """q [B, H, S, D], k/v [B, Hkv, Skv, D] -> [B, H, S, D] f32.

    Paged (``block_table`` [B, max_pages]): k/v are the page pools
    [n_pages, Hkv, page, D] of ``models.paged.PagedKVCache``.  ``kv_len``
    is None (= Skv), a scalar, or per-sequence [B]; ``q_offset`` shifts
    the query positions (a chunk's start in its row)."""
    policy = get_policy(policy if policy is not None else "tp_bf16")
    src_dt, src_fmt_name = _src(policy)
    b, h, sq, d = q.shape
    if block_table is not None:
        n_pages, hkv, page, _ = k.shape
        skv = block_table.shape[1] * page
        kf = k.reshape(n_pages * hkv, page, d)
        vf = v.reshape(n_pages * hkv, page, v.shape[-1])
        table = expand_block_table(block_table, hkv)
    else:
        _, hkv, skv, _ = k.shape
        kf = k.reshape(b * hkv, skv, d)
        vf = v.reshape(b * hkv, skv, v.shape[-1])
        table = None
    fn = (flash_attention_cuda
          if resolve_backend(backend, q.device) == "kernel"
          else flash_attention_plain)
    o = fn(q.reshape(b * h, sq, d), kf, vf,
           expand_kv_lens(kv_len, b, h, skv, q.device), table,
           group=h // hkv, scale=d ** -0.5 if scale is None else scale,
           causal=causal, window=window, softcap=softcap, q_offset=q_offset,
           src_fmt_name=src_fmt_name, src_dtype=src_dt,
           out_dtype=torch.float32)
    return o.reshape(b, h, sq, -1)


def decode_attention(q, k, v, *, kv_len, policy=None, block_table=None,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None, backend: str = "auto"):
    """Fused single-query decode attention over the (quantized) KV cache.

    q [B, H, 1, D]; k/v [B, Hkv, Smax, D] in their storage dtype, or the
    page pools [n_pages, Hkv, page, D] with ``block_table`` [B, max_pages];
    ``kv_len`` scalar or per-sequence [B].  Returns [B, H, 1, D] f32."""
    policy = get_policy(policy if policy is not None else "tp_bf16")
    src_dt, q_fmt_name = _src(policy)
    kv_fmt_name = (policy.kv_fmt.name if policy.mode != "native"
                   and policy.kv_fmt is not None else None)
    b, h, sq, d = q.shape
    assert sq == 1, q.shape
    if block_table is not None:
        n_pages, hkv, page, _ = k.shape
        smax = block_table.shape[1] * page
        kf = k.reshape(n_pages * hkv, page, d)
        vf = v.reshape(n_pages * hkv, page, d)
        table = expand_block_table(block_table, hkv)
    else:
        _, hkv, smax, _ = k.shape
        kf = k.reshape(b * hkv, smax, d)
        vf = v.reshape(b * hkv, smax, d)
        table = None
    group = h // hkv
    fn = (decode_attention_cuda
          if resolve_backend(backend, q.device) == "kernel"
          else decode_attention_plain)
    o = fn(q.reshape(b * hkv, group, d), kf, vf,
           expand_kv_lens(kv_len, b, hkv, smax, q.device), table,
           scale=d ** -0.5 if scale is None else scale, window=window,
           softcap=softcap, kv_fmt_name=kv_fmt_name, q_fmt_name=q_fmt_name,
           src_dtype=src_dt, out_dtype=torch.float32)
    return o.reshape(b, h, 1, d)
