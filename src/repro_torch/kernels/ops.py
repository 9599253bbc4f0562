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

Launch knobs (``decode_pick``, ``flash_q_rows``, ``tp_matmul_plan``):
the one place each kernel's knob is picked, from the tensors' device, by
``autotune.best_block`` — a winner swept on this card and build (the
user's cache, then the shipped ``pretuned.json``), clamped to the live
shape, else the kernel's static rule.  ``picked`` counts the picks of
the default calls that launched a kernel.

The kernels have no backward: on the kernel route every wrapper raises
when grad mode is on and an input requires grad (``_no_grad_into_kernel``),
never detaching quietly.

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
from . import autotune
from .decode_attention import (STRIP_UNIT, decode_attention_cuda,
                               decode_attention_plain, plan_splits)
from .dotp_ex import dotp_ex_cuda, dotp_ex_plain
from .flash_attention import (SPLIT_Q_ROWS, flash_attention_cuda,
                              flash_attention_plain, flash_route)
from .tp_matmul import matmul_route, tc_plan, tp_matmul_cuda, tp_matmul_plain
from .tp_quant import (cast_and_pack_cuda, cast_and_pack_plain,
                       tp_quantize_cuda, tp_quantize_plain)

BACKENDS = ("auto", "kernel", "plain", "dense")

#: picks of the default calls that launched a kernel: op -> {pick: calls},
#: and how many of them a tuned winner made (``tuned``); reset by hand
picked = {"decode_attn": {}, "attn": {}, "matmul": {}}
tuned = {"decode_attn": 0, "attn": 0, "matmul": 0}


def reset_picked() -> None:
    for d in picked.values():
        d.clear()
    for op in tuned:
        tuned[op] = 0


def _count_pick(op: str, pick, was_tuned: bool) -> None:
    picked[op][pick] = picked[op].get(pick, 0) + 1
    tuned[op] += int(was_tuned)


def decode_pick(rows: int, units: int, unit: int, group: int, d: int, dtype,
                device, window: Optional[int] = None,
                with_source: bool = False):
    """CTAs a row of a decode read of ``rows`` rows of ``units`` units of
    ``unit`` keys (live units bounded by ``window`` as ``cluster_size``
    bounds them), group ``group``, head dim ``d``, a pool of ``dtype`` on
    ``device``: the tuned winner clamped to the live units, else
    ``cluster_size``.  ``with_source`` also returns whether a winner made
    it."""
    if window is not None:
        units = min(units, -(-window // unit) + 1)
    (c,), was_tuned = autotune._best(
        "decode_attn", (rows, units, unit, group, d),
        autotune.dtype_name(dtype), torch.device(device))
    while c > 1 and c > units:
        c //= 2
    return (c, was_tuned) if with_source else c


def flash_q_rows(sq: int, bkv: int, group: int, d: int, dv: int, dtype,
                 device, with_source: bool = False):
    """``flash_tc``'s query tile for ``sq`` queries over ``bkv`` KV rows of
    ``group`` heads (QK width ``d``, V width ``dv``, a pool of ``dtype``):
    the tuned winner (128 where the group does not fit 64 rows), else
    ``plan_q_rows``."""
    (r,), was_tuned = autotune._best(
        "attn", (sq, bkv, group, d, dv), autotune.dtype_name(dtype),
        torch.device(device))
    r = r if group <= r else 128
    return (r, was_tuned) if with_source else r


def tp_matmul_plan(m: int, k: int, n: int, dtype, device,
                   quant_fmt_name: Optional[str] = None,
                   with_source: bool = False):
    """The plan of ``[m, k] @ [k, n]`` on operands of ``dtype`` (snapped
    onto ``quant_fmt_name``'s grid): the tuned ``(wm, splits)`` (splits
    clamped to the K steps), else the route's rule (``plan_tc``, or
    ``plan_split`` on the split route, whose tiles are 128 rows)."""
    (wm, splits), was_tuned = autotune._best(
        "matmul", (m, k, n), autotune.dtype_name(dtype, quant_fmt_name),
        torch.device(device))
    if matmul_route(dtype, quant_fmt_name) == "split":
        wm = 1
    plan = tc_plan(m, k, n, wm, splits)
    return (plan, was_tuned) if with_source else plan


def _no_grad_into_kernel(name: str, *tensors) -> None:
    """The hand-written kernels have no backward: their outputs carry no
    ``grad_fn``.  Launching one on an input that requires grad under grad
    mode would cut the graph without a word, so it raises instead (never
    detaches).  Training takes the dense path (``Model.forward_train``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"kernels.ops.{name}: the CUDA kernel has no backward, and an "
            f"input requires grad; run it under torch.no_grad() or take a "
            f"differentiable path (prefill_backend='dense' for training)")


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


def _reduce_flag_cells(cells, b: int, h: int):
    """A kernel's per-(head row, cell) flag counters [B*H, n, 4] summed
    to per-sequence counts [B, 4] int32 (the kernels already zeroed dead
    and padded slots)."""
    return cells.reshape(b, h, -1, cells.shape[-1]).sum(dim=(1, 2)).to(
        torch.int32)


def flash_attention(q, k, v, *, kv_len=None, policy=None, block_table=None,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    backend: str = "auto", block_k: Optional[int] = None,
                    block_q: Optional[int] = None,
                    q_rows: Optional[int] = None,
                    return_flags: bool = False):
    """q [B, H, S, D], k [B, Hkv, Skv, D], v [B, Hkv, Skv, Dv] -> [B, H,
    S, Dv] f32 (Dv != D: MLA's expanded prefill).

    Paged (``block_table`` [B, max_pages]): k/v are the page pools
    [n_pages, Hkv, page, D / Dv] of ``models.paged.PagedKVCache``.
    ``kv_len`` is None (= Skv), a scalar, or per-sequence [B];
    ``q_offset`` shifts the query positions (a chunk's start in its row).  ``block_k`` /
    ``block_q`` are the plain version's key block and telemetry query
    block (None: its default key block, and the query block of the
    variant these arguments route to: ``q_rows // group`` on
    ``flash_tc``, ``64 // group`` on the split route, 32 otherwise;
    ``flash_attention.kernel_tiles``); the kernels ignore them.
    ``q_rows`` is ``flash_tc``'s query tile (None: ``flash_q_rows``); the
    split route's is fixed and ``flash_fma`` has none.

    ``return_flags=True`` also returns per-sequence int32 [B, 4] IEEE flag
    counts (OF, UF, NX, NV summed over heads and scheduled steps, per
    visit), from the telemetry instantiation on the card."""
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
    group, dv = h // hkv, v.shape[-1]
    route = flash_route(src_dt, src_fmt_name, d, dv)
    on_tc = route == "tc"
    default = on_tc and q_rows is None
    if default:
        q_rows, was_tuned = flash_q_rows(sq, b * hkv, group, d, dv, k.dtype,
                                         q.device, with_source=True)
    if resolve_backend(backend, q.device) == "kernel":
        _no_grad_into_kernel("flash_attention", q, k, v)
        fn = functools.partial(flash_attention_cuda, q_rows=q_rows)
        if default:
            _count_pick("attn", q_rows, was_tuned)
    else:
        if block_q is None and on_tc:
            block_q = q_rows // group
        elif block_q is None and route == "split":
            block_q = SPLIT_Q_ROWS // group
        fn = functools.partial(flash_attention_plain, block_k=block_k,
                               block_q=block_q)
    o = fn(q.reshape(b * h, sq, d), kf, vf,
           expand_kv_lens(kv_len, b, h, skv, q.device), table,
           group=group, scale=d ** -0.5 if scale is None else scale,
           causal=causal, window=window, softcap=softcap, q_offset=q_offset,
           src_fmt_name=src_fmt_name, src_dtype=src_dt,
           out_dtype=torch.float32, debug_flags=return_flags)
    if return_flags:
        o, cells = o
        return o.reshape(b, h, sq, -1), _reduce_flag_cells(cells, b, h)
    return o.reshape(b, h, sq, -1)


def _split_units(k, block_table):
    """``(unit, units)``: a decode row's split unit (the page, or
    ``STRIP_UNIT`` keys of a contiguous strip) and the units it holds."""
    if block_table is not None:
        return k.shape[2], block_table.shape[1]
    return STRIP_UNIT, -(-k.shape[2] // STRIP_UNIT)


def decode_cluster(batch: int, k, block_table=None,
                   window: Optional[int] = None, *, group: int,
                   with_source: bool = False):
    """The split partition (CTAs a row, ``decode_pick``) of a decode read
    of ``batch`` sequences of ``group`` query heads a KV head over the
    cache ``k`` ([B, Hkv, Smax, D], or the page pool [n_pages, Hkv, page,
    D] with ``block_table`` [B, max_pages]): what ``decode_attention``
    picks for them by default."""
    unit, units = _split_units(k, block_table)
    return decode_pick(batch * k.shape[1], units, unit, group, k.shape[-1],
                       k.dtype, k.device, window, with_source=with_source)


def decode_attention(q, k, v, *, kv_len, policy=None, block_table=None,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None, backend: str = "auto",
                     return_flags: bool = False,
                     cluster: Optional[int] = None):
    """Fused single-query decode attention over the (quantized) KV cache.

    q [B, H, 1, D]; k/v [B, Hkv, Smax, D] in their storage dtype, or the
    page pools [n_pages, Hkv, page, D] with ``block_table`` [B, max_pages];
    ``kv_len`` scalar or per-sequence [B].  Returns [B, H, 1, D] f32, and
    with ``return_flags=True`` per-sequence int32 [B, 4] IEEE flag counts
    (each live K / V element once, q once per head row: schedule-free).

    ``cluster`` is the split-KV partition's size (CTAs a row), on both
    routes: the kernel launches at it, the plain version walks
    ``plan_splits`` at it and adds the parts in the kernel's order.
    Default: ``decode_cluster`` of these rows.  A row's output depends on
    its own inputs and this size alone, so a read that folds several
    queries a sequence into the batch (speculative verify) is bitwise the
    step-form reads when it passes the step form's size."""
    policy = get_policy(policy if policy is not None else "tp_bf16")
    src_dt, q_fmt_name = policy_src(policy)
    kv_fmt_name = (policy.kv_fmt.name if policy.mode != "native"
                   and policy.kv_fmt is not None else None)
    b, h, sq, d = q.shape
    assert sq == 1, q.shape
    default = cluster is None
    if default:
        cluster, was_tuned = decode_cluster(b, k, block_table, window,
                                            group=h // k.shape[1],
                                            with_source=True)
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
    lens = expand_kv_lens(kv_len, b, hkv, smax, q.device)
    if resolve_backend(backend, q.device) == "kernel":
        _no_grad_into_kernel("decode_attention", q, k, v)
        fn = functools.partial(decode_attention_cuda, cluster=cluster)
        if default:
            _count_pick("decode_attn", cluster, was_tuned)
    else:
        unit, units = _split_units(k, block_table)
        fn = functools.partial(decode_attention_plain, splits=plan_splits(
            lens, unit, units=units, window=window, size=cluster))
    o = fn(q.reshape(b * hkv, group, d), kf, vf, lens, table,
           scale=d ** -0.5 if scale is None else scale, window=window,
           softcap=softcap, kv_fmt_name=kv_fmt_name, q_fmt_name=q_fmt_name,
           src_dtype=src_dt, out_dtype=torch.float32,
           debug_flags=return_flags)
    if return_flags:
        o, cells = o
        return o.reshape(b, h, 1, d), _reduce_flag_cells(cells, b, hkv)
    return o.reshape(b, h, 1, d)


# ---------------------------------------------------------------------------
# the transprecision op path
# ---------------------------------------------------------------------------
def _on_card(x) -> bool:
    return resolve_backend("auto", x.device) == "kernel"


def tp_matmul(a, b, *, policy=None, out_fmt=None, bk: Optional[int] = None,
              plan=None):
    """Policy-aware kernel matmul ``a [.., M, K] @ b [K, N]``.

    native : operands cast to ``src_fmt``'s dtype, f32 sums, stored in
             ``out_fmt`` (default: the policy's resolved out format).
    emulate: f32 operands snapped onto the ``src_fmt`` grid inside the
             kernel (FTZ), f32 sums, and the f32 result returned WITHOUT an
             out-format snap — the JAX package's Pallas route, which
             differs from ``core.ops.tp_einsum``.
    ``bk`` fixes the plain version's K-block schedule; the CUDA kernel has
    its own and ignores it.  ``plan`` is the tensor-core variant's plan
    (None: ``tp_matmul_plan``); the plain version walks its K ranges
    when it is given or tuned, and sums K whole otherwise."""
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
    m, k = a2.shape
    if _on_card(a2):
        _no_grad_into_kernel("tp_matmul", a, b)
        if plan is None and matmul_route(a2.dtype, qname) != "fma":
            plan, was_tuned = tp_matmul_plan(m, k, b2.shape[1], a2.dtype,
                                             a2.device, qname,
                                             with_source=True)
            _count_pick("matmul", (plan.wm, plan.splits), was_tuned)
        r = tp_matmul_cuda(a2, b2, out_dtype=out_dtype, quant_fmt_name=qname,
                           plan=plan)
    else:
        if plan is None:
            tuned_plan, was_tuned = tp_matmul_plan(
                m, k, b2.shape[1], a2.dtype, a2.device, qname,
                with_source=True)
            plan = tuned_plan if was_tuned else None
        r = tp_matmul_plain(a2, b2, out_dtype=out_dtype,
                            quant_fmt_name=qname, bk=bk, plan=plan)
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
    fn = tp_quantize_plain
    if _on_card(x):
        _no_grad_into_kernel("tp_quantize", x)
        fn = tp_quantize_cuda
    rbits = _rbits(x.shape, generator, x.device) if stochastic else None
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
    fn = cast_and_pack_plain
    if _on_card(a):
        _no_grad_into_kernel("cast_and_pack", a, b)
        fn = cast_and_pack_cuda
    rbits = _rbits(a.shape, generator, a.device) if stochastic else None
    return fn(a, b, rbits, fmt_name=fmt.name, stochastic=stochastic)


def dotp_ex(a, b, *, policy=None):
    """Expanding dot product of two 1-D streams (paper Fig 11e): the
    kernel's 128 lane sums, added here.  Operands widen to ``src_fmt``'s
    dtype in native mode, stay f32 in emulate mode."""
    policy = get_policy(policy if policy is not None else "tp_fp16")
    src_dt = (policy.matmul.src_fmt.native_dtype
              if policy.mode == "native" else torch.float32)
    fn = dotp_ex_plain
    if _on_card(a):
        _no_grad_into_kernel("dotp_ex", a, b)
        fn = dotp_ex_cuda
    return fn(a, b, src_dtype=src_dt).sum()
