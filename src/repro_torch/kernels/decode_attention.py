"""Fused single-query decode attention over a quantized, paged KV cache —
the serving-path instance of FPnew's CONV->ADDMUL fusion.

``decode_attention_cuda`` is the port of the TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``: a hand-written
CUDA kernel (``csrc/decode_attention.cu``, sm_90a) for tensors on the card.
``decode_attention_plain`` is its plain-torch version.  The choice between
them is made in one place, ``kernels.ops.resolve_backend``: CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.

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

from typing import Optional

import torch

from . import _build
from . import ref


def decode_attention_plain(q, k, v, kv_len, block_table=None, *,
                           scale: float = 1.0, window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           kv_fmt_name: Optional[str] = None,
                           q_fmt_name: Optional[str] = None,
                           src_dtype=torch.bfloat16,
                           out_dtype=torch.float32):
    """The kernel's function in plain torch (``ref.decode_attention_ref``
    blocked at the page size, or at 64 keys for contiguous strips)."""
    kw = dict(kv_len=kv_len, scale=scale, window=window, softcap=softcap,
              kv_fmt_name=kv_fmt_name, q_fmt_name=q_fmt_name,
              src_dtype=src_dtype, out_dtype=out_dtype)
    if block_table is not None:
        return ref.decode_attention_paged_ref(q, k, v, block_table, **kw)
    return ref.decode_attention_ref(q, k, v, bk=64, **kw)


def decode_attention_cuda(q, k, v, kv_len, block_table=None, *,
                          scale: float = 1.0, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          kv_fmt_name: Optional[str] = None,
                          q_fmt_name: Optional[str] = None,
                          src_dtype=torch.bfloat16,
                          out_dtype=torch.float32):
    """q [BHkv, G, D]; k/v [BHkv, Smax, D] or pools [n_pages, page, D]
    with ``block_table`` [BHkv, nk]; ``kv_len`` scalar or [BHkv].
    Launches the kernel (one launch per call); raises on tensors that do
    not lie on a CUDA device."""
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
    else:
        if rows != bh:
            raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                             f"disagree on rows")
        nk, table = 1, None
    if d != dk or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)} {v.dtype} do not fit together")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if d > 256 or g > 8:
        raise ValueError(f"decode kernel takes D <= 256 and G <= 8, got "
                         f"D={d}, G={g}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kvl = ref.per_row_lens(kv_len, bh, nk * page, q.device).to(
        torch.int32).contiguous()
    smax = nk * page
    out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
    scores = torch.empty((bh, g, smax), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attention").decode_attention_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
             table.data_ptr() if table is not None else None,
             out.data_ptr(), scores.data_ptr(), bh, g, d, nk, page, rows, smax,
             _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
             _build.src_kind(src_dtype), *_build.snap_args(kv_fmt_name),
             *_build.snap_args(q_fmt_name), float(scale),
             -1 if window is None else int(window),
             0.0 if softcap is None else float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: launches of the CUDA kernel (CPU calls and plain-version calls add none)
decode_attention_cuda.launches = 0
