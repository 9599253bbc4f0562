"""Public wrappers around the kernels: policy plumbing, head flattening,
per-row length and page-table expansion, backend choice.

The attention wrappers take a ``backend``; the op-path wrappers
(``tp_matmul``, ``tp_quantize``, ``cast_and_pack``, ``dotp_ex``) choose by
the tensors' device alone (``resolve_backend("auto", ...)``): the kernel
for CUDA tensors, the plain version for CPU ones.  There is no padding:
the kernels mask their ragged edges.

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

import functools
from typing import Optional

import torch

from ..core.formats import get_format
from ..core.policy import get_policy
from .decode_attention import decode_attention_cuda, decode_attention_plain
from .dotp_ex import dotp_ex_cuda, dotp_ex_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .tp_matmul import tp_matmul_cuda, tp_matmul_plain
from .tp_quant import (cast_and_pack_cuda, cast_and_pack_plain,
                       tp_quantize_cuda, tp_quantize_plain)

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


def policy_src(policy):
    """(multiply dtype, grid the kernel snaps f32 operands onto or None)
    of a policy (name or object): what the attention kernels route by."""
    policy = get_policy(policy)
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
                    backend: str = "auto", block_k: Optional[int] = None):
    """q [B, H, S, D], k/v [B, Hkv, Skv, D] -> [B, H, S, D] f32.

    Paged (``block_table`` [B, max_pages]): k/v are the page pools
    [n_pages, Hkv, page, D] of ``models.paged.PagedKVCache``.  ``kv_len``
    is None (= Skv), a scalar, or per-sequence [B]; ``q_offset`` shifts
    the query positions (a chunk's start in its row).  ``block_k`` is the
    plain version's key block (None: its default;
    ``flash_attention.kernel_block_k`` gives the CUDA kernel's own tile);
    the kernels ignore it."""
    policy = get_policy(policy if policy is not None else "tp_bf16")
    src_dt, src_fmt_name = policy_src(policy)
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
    if resolve_backend(backend, q.device) == "kernel":
        fn = flash_attention_cuda
    else:
        fn = functools.partial(flash_attention_plain, block_k=block_k)
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
    src_dt, q_fmt_name = policy_src(policy)
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


# ---------------------------------------------------------------------------
# the transprecision op path
# ---------------------------------------------------------------------------
def _on_card(x) -> bool:
    return resolve_backend("auto", x.device) == "kernel"


def tp_matmul(a, b, *, policy=None, out_fmt=None, bk: Optional[int] = None):
    """Policy-aware kernel matmul ``a [.., M, K] @ b [K, N]``.

    native : operands cast to ``src_fmt``'s dtype, f32 sums, stored in
             ``out_fmt`` (default: the policy's resolved out format).
    emulate: f32 operands snapped onto the ``src_fmt`` grid inside the
             kernel (FTZ), f32 sums, and the f32 result returned WITHOUT an
             out-format snap — the JAX package's Pallas route, which
             differs from ``core.ops.tp_einsum``.
    ``bk`` fixes the plain version's K-block schedule; the CUDA kernel has
    its own and ignores it."""
    policy = get_policy(policy if policy is not None else "tp_bf16")
    mp = policy.matmul
    lead = a.shape[:-2]
    a2 = a.reshape(-1, a.shape[-1])
    if policy.mode == "native":
        src = mp.src_fmt.native_dtype
        a2, b2 = a2.to(src), b.to(src)
        qname = None
        out_fmt = get_format(out_fmt) if out_fmt is not None \
            else mp.resolved_out()
        out_dtype = out_fmt.native_dtype
    else:
        a2, b2 = a2.to(torch.float32), b.to(torch.float32)
        qname = mp.src_fmt.name if mp.src_fmt.name != "fp32" else None
        out_dtype = torch.float32
    if _on_card(a2):
        r = tp_matmul_cuda(a2, b2, out_dtype=out_dtype, quant_fmt_name=qname)
    else:
        r = tp_matmul_plain(a2, b2, out_dtype=out_dtype,
                            quant_fmt_name=qname, bk=bk)
    return r.reshape(*lead, a.shape[-2], b.shape[-1])


def _rbits(shape, generator, device):
    """32 random bits per element (int32), from the caller's generator."""
    if generator is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         generator=generator, device=device)


def tp_quantize(x, *, fmt, stochastic: bool = False,
                generator: Optional[torch.Generator] = None,
                out_dtype=None):
    """Kernel quantization of a 2-D f32 tensor onto ``fmt``'s grid (CONV
    block): RNE or stochastic, FTZ below min normal, stored in
    ``out_dtype`` (default f32).  Stochastic bits come from ``generator``
    (on x's device), drawn here and handed to the kernel."""
    fmt = get_format(fmt)
    x = x.to(torch.float32)
    rbits = _rbits(x.shape, generator, x.device) if stochastic else None
    fn = tp_quantize_cuda if _on_card(x) else tp_quantize_plain
    return fn(x, rbits, fmt_name=fmt.name, stochastic=stochastic,
              out_dtype=out_dtype or torch.float32)


def cast_and_pack(a, b, *, fmt, stochastic: bool = False,
                  generator: Optional[torch.Generator] = None):
    """Kernel cast-and-pack: two 2-D f32 tensors [R, C] snapped onto
    ``fmt``'s grid (b with the complemented random bits) and interleaved
    column by column into [R, 2C] f32.  Flushes below min normal, unlike
    ``core.ops.cast_and_pack``, which keeps gradual underflow."""
    fmt = get_format(fmt)
    a, b = a.to(torch.float32), b.to(torch.float32)
    rbits = _rbits(a.shape, generator, a.device) if stochastic else None
    fn = cast_and_pack_cuda if _on_card(a) else cast_and_pack_plain
    return fn(a, b, rbits, fmt_name=fmt.name, stochastic=stochastic)


def dotp_ex(a, b, *, policy=None):
    """Expanding dot product of two 1-D streams (paper Fig 11e): the
    kernel's 128 lane sums, added here.  Operands widen to ``src_fmt``'s
    dtype in native mode, stay f32 in emulate mode."""
    policy = get_policy(policy if policy is not None else "tp_fp16")
    src_dt = (policy.matmul.src_fmt.native_dtype
              if policy.mode == "native" else torch.float32)
    fn = dotp_ex_cuda if _on_card(a) else dotp_ex_plain
    return fn(a, b, src_dtype=src_dt).sum()
