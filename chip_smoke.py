#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel (one ``nvcc`` per source, all started together), and
   the count of ``HGMMA`` (wgmma) instructions in each library's SASS
   (``cuobjdump -sass``): flash attention and tp_matmul must have some.
2. Kernel phase: each attention kernel against its plain PyTorch version on
   the card, in the working dtype, at the serving path's shapes (head_dim 256, GQA
   group 2, pages of 64 and 16 tokens; bf16 and fp8-e5m2 pools; ragged
   ``kv_len`` with an idle row; window, softcap, aliased pages; a prefill
   chunk at ``q_offset > 0``; one stream at 8191 keys; 16 slots), the
   plain flash version walking the kernel's own key tiles.  One JSON line
   per case: error and tolerance, the variant (and for decode the cluster
   size its launch counted, which must be the one ``cluster_size`` names)
   that ran, kernel / plain / library time, and the card's least time for
   the same work (``bound_ms``).  Kernel and library times are device
   times per call from a replayed CUDA graph (``device_ms``); ``eager_ms``
   is the same call launched from Python, host overhead included;
   ``plain_ms`` is eager; decode's ``kernel_only_ms`` times the kernel's
   own launch without the wrapper's index expansion.  The main flash cases
   also time the kept FMA variant (``fma_ms``) and the tensor-core variant with
   the query tile (64 or 128 rows) that ``plan_q_rows`` did not pick; a small
   policy-``fp32`` case holds the FMA variant against its plain version.
3. Op-path phase: the transprecision op path at gemma2-9b's MLP widths
   (d_model 3584, d_ff 14336).  Each of its kernels (tp_matmul,
   tp_quantize, cast_and_pack, dotp_ex) against its plain version on the
   card: quantize and pack bit for bit, tp_matmul within
   ``2 K 2^-24 (|A| @ |B|)`` plus one output ulp (with its fused snap read
   back bit for bit), dotp_ex within ``1e-5 sum |a b|`` of the exact f64
   sum, and the paper's Table III stream to >= 22 correct bits.  The main
   tp_matmul cases also time the kept FMA variant; a small tf32-grid case
   holds it against its plain version.  Then the
   public entry points in sequence — quantize two weights to fp8, two
   ``core.ops.tp_matmul(..., "em_fp8", use_kernel=True)`` products, pack
   them, and the expanding dot product of the two weights — with every
   launch counter > 0 afterwards and both products on the tensor-core
   variant.
4. Slice phase: full-width gemma2-9b under ``tp_bf16`` with seeded random
   weights, served by ``ContinuousEngine`` (4 slots, 8 requests, pages of
   64 tokens, one request crossing the 4096-token local window).  Every
   request must get its whole budget and both kernels must have launched
   in that run, every flash launch on the tensor-core variant.  A short
   window (the first four requests, 8 tokens each) under
   ``torch.profiler`` gives device time by kernel class and the device's
   idle share.  Every decode launch must take the mma route, at the
   cluster size ``cluster_size`` names for its layer.  Then one request
   is served again with the plain versions and its first-token logits
   and greedy tokens are compared.
5. The kernels line (all six kernels; flash attention, tp_matmul and decode
   attention with their launches by variant, the FMA variant's time,
   decode's slice launches by cluster size), the card line,
   and as the last line
   ``{"ok": true, "device": {...}}``.

Imports no JAX.  Needs one CUDA device and ``nvcc`` (``CUDA_HOME``, PATH
or ``/usr/local/cuda``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM dense peaks (NVIDIA data sheet): HBM3 bytes/s, bf16 / fp16 and
#: fp8 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP8_FLOP_S = 1979e12
F32_FLOP_S = 67e12

#: kernel-vs-plain tolerance: both sum in f32 and round p to bf16 before
#: p.V; a summation-order difference can flip one such rounding, worth up
#: to 2^-8 of a unit-scale output
KERNEL_TOL = 2.0 ** -8

#: the softcap's effect in the cap-region cases (q scaled by ``q_scale``):
#: the kernel's capped and uncapped outputs must differ by at least this,
#: far above ``KERNEL_TOL``, so a kernel that skipped or misplaced the cap
#: would fail its comparison with the plain version
CAP_EFFECT_MIN = 64 * KERNEL_TOL

#: first-token logits, kernel path vs plain path, full-width model: the
#: bf16 residual stream carries last-bit differences through 42 layers;
#: 3x the 0.106 measured on an H100 (|logits| <= 7.1 there)
LOGITS_TOL = 0.3

KERNELS = {
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:196"),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:201"),
    "tp_matmul": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/tp_matmul.cu",
        replaces="src/repro/kernels/tp_matmul.py:61"),
    "tp_quantize": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/tp_quant.cu",
        replaces="src/repro/kernels/tp_quant.py:40"),
    "cast_and_pack": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/tp_quant.cu",
        replaces="src/repro/kernels/tp_quant.py:63"),
    "dotp_ex": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/dotp_ex.cu",
        replaces="src/repro/kernels/dotp_ex.py:43"),
}


#: libraries with a tensor-core (wgmma) variant
TC_LIBRARIES = ("flash_attention", "tp_matmul")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, calls: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured into one
    CUDA graph and replayed ``replays`` times between CUDA events, so the
    host's launch overhead (the Python wrapper, tensor-map encoding, the
    ctypes call) is not counted.  Warm-up calls run first on a side stream,
    as capture requires."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (calls * replays)
    del graph
    return ms


def bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def hgmma_count(lib) -> int:
    """``HGMMA`` (wgmma) instructions in a built library's SASS."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(1 for ln in sass.splitlines() if "HGMMA" in ln)


def build_phase() -> dict:
    """Builds every library; returns {library: HGMMA count}.  The two
    tensor-core libraries must contain wgmma instructions."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, entry in logs.items():
        ptxas = [ln.strip() for ln in entry["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(json.dumps({"build": name, "seconds": round(entry["seconds"], 2),
                        "ptxas": ptxas[:16]}))
    log(f"kernels built in {secs:.1f} s")
    hgmma = {name: hgmma_count(_build.library_path(name))
             for name in _build.KERNELS}
    log(json.dumps({"hgmma_instructions": hgmma}))
    for name in TC_LIBRARIES:
        if hgmma[name] <= 0:
            raise AssertionError(f"{name}: no HGMMA instruction in its build")
    return hgmma


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def _pool_and_table(gen, b, hkv, max_pages, page, d, dtype, alias: int):
    """A shuffled page pool [n_pages, Hkv, page, D] (pool dtype ``dtype``)
    and a [b, max_pages] table; rows 0 and 1 share their first ``alias``
    pages (a common prefix)."""
    import torch
    n_pages = b * max_pages + 1
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    if alias and b > 1:
        table[1, :alias] = table[0, :alias]
    k = torch.randn((n_pages, hkv, page, d), generator=gen, device="cuda")
    v = torch.randn((n_pages, hkv, page, d), generator=gen, device="cuda")
    return k.to(dtype), v.to(dtype), table


def _keys_read(table, page, skv, lo, hi):
    """Distinct K/V positions the function must read: row ``r`` reads keys
    ``lo[r] <= idx < hi[r]``, through ``table`` [B, max_pages] (a page
    shared by two rows counts once) or, with ``table`` None, from its own
    contiguous strip of ``skv`` keys.  One position holds every KV head."""
    import torch
    idx = torch.arange(skv, device="cuda")[None, :]
    live = (idx >= lo[:, None]) & (idx < hi[:, None])
    if table is None:
        pos = torch.arange(len(lo), device="cuda")[:, None] * skv + idx
    else:
        pos = table.long()[:, idx[0] // page] * page + idx % page
    return int(torch.unique(pos[live]).numel())


def _cap_effect(call, got):
    """Largest change the softcap makes to the kernel's output."""
    return (got - call("kernel", None)).abs().max().item()


def _sdpa_decode(q, k_pool, v_pool, table, kv_len, window):
    """The library yardstick for decode: ``scaled_dot_product_attention``
    on the gathered contiguous cache with a boolean live-key mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.paged import gather_paged_kv
    kc = gather_paged_kv(k_pool, table).to(q.dtype)
    vc = gather_paged_kv(v_pool, table).to(q.dtype)
    idx = torch.arange(kc.shape[2], device="cuda")[None, :]
    mask = idx < kv_len[:, None]
    if window is not None:
        mask &= idx > kv_len[:, None] - 1 - window
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)


def decode_case(name, *, dtype, page, kv_lens, window, softcap, alias,
                seed, q_scale=1.0, sweep=False):
    """``q_scale`` > 1 puts the scores into the softcap's bend; the case
    then also checks that the cap changes the output (``CAP_EFFECT_MIN``).
    The launch must count under the cluster size ``cluster_size`` names.
    ``sweep`` also times the kernel alone at 4, 8 and 16 CTAs a row
    (``cluster_ms``)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import (
        cluster_size, decode_attention_cuda, decode_route)
    b, hkv, g, d = len(kv_lens), 8, 2, 256
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_len = max(kv_lens) + 1
    max_pages = -(-max_len // page)
    k, v, table = _pool_and_table(gen, b, hkv, max_pages, page, d, dtype,
                                  alias)
    q = (torch.randn((b, hkv * g, 1, d), generator=gen, device="cuda")
         * q_scale).to(torch.bfloat16)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    policy = "tp_bf16" if dtype == torch.bfloat16 else "tp_bf16_kv8"
    call = lambda backend, cap=softcap: kops.decode_attention(
        q, k, v, kv_len=kvl, block_table=table, policy=policy,
        window=window, softcap=cap, backend=backend)
    src_dt, _ = kops.policy_src(policy)
    variant = decode_route(src_dt, d)
    by_cluster = decode_attention_cuda.launches_by_cluster
    before = (decode_attention_cuda.launches_mma,
              decode_attention_cuda.launches_fma, dict(by_cluster))
    got = call("kernel")
    routed = (decode_attention_cuda.launches_mma - before[0],
              decode_attention_cuda.launches_fma - before[1])
    ran = [c for c, n in by_cluster.items() if n != before[2].get(c, 0)]
    want = call("plain")
    torch.cuda.synchronize()
    if routed != ((1, 0) if variant == "mma" else (0, 1)):
        raise AssertionError(f"{name}: launches (mma, fma) {routed}, "
                             f"expected the {variant} route")
    rule = cluster_size(b * hkv, max_pages, page, window)
    if ran != [rule]:
        raise AssertionError(f"{name}: launch counted under cluster sizes "
                             f"{ran}, the rule names {rule}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    cap = _cap_effect(call, got) if q_scale != 1.0 else None
    live = [min(n, n if window is None else window) for n in kv_lens]
    lo = (torch.zeros_like(kvl) if window is None
          else torch.clamp(kvl - window, min=0))
    keys = _keys_read(table, page, max_pages * page, lo, kvl)
    esz = k.element_size()
    nbytes = (q.numel() * q.element_size() + keys * hkv * d * 2 * esz
              + got.numel() * 4 + kvl.numel() * 4
              + b * max_pages * 4)
    flops = 4.0 * g * d * hkv * sum(live)
    bound_ms, bound_by = bound(nbytes, flops)
    lib = None
    if softcap is None and min(kv_lens) > 0:
        lib = device_ms(_sdpa_decode(q, k, v, table, kvl, window))
    flat = lambda x: x.reshape(-1, page, d)
    lens = kops.expand_kv_lens(kvl, b, hkv, max_pages * page, q.device)
    flat_tab = kops.expand_block_table(table, hkv)
    alone = lambda c=None: decode_attention_cuda(
        q.reshape(b * hkv, g, d), flat(k), flat(v), lens, flat_tab,
        scale=d ** -0.5, window=window, softcap=softcap, src_dtype=src_dt,
        _cluster=c)
    kernel_only = device_ms(alone)
    rec = dict(case=name, kernel="decode_attention", variant=variant,
               cluster=ran[0], ctas=b * hkv * ran[0], max_abs_err=err,
               tol=KERNEL_TOL, q_scale=q_scale, cap_effect=cap,
               kernel_ms=device_ms(lambda: call("kernel")),
               kernel_only_ms=kernel_only,
               eager_ms=cuda_ms(lambda: call("kernel"), 20),
               plain_ms=cuda_ms(lambda: call("plain"), 5),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               shape=dict(slots=b, hkv=hkv, group=g, d=d, page=page,
                          kv_len=kv_lens, window=window, softcap=softcap,
                          pool=str(dtype).replace("torch.", "")))
    if sweep:
        rec["cluster_ms"] = {c: device_ms(lambda c=c: alone(c))
                             for c in (4, 8, 16)}
    log(json.dumps(rec))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_abs_err {err} > {KERNEL_TOL}")
    if cap is not None and not cap >= CAP_EFFECT_MIN:
        raise AssertionError(f"{name}: the softcap changes the output by "
                             f"{cap} < {CAP_EFFECT_MIN}")
    return rec


def _flat_flash(q, k, v, kvl, table, policy):
    """The flattened arguments ``kernels.ops.flash_attention`` hands to the
    kernels (head rows, flat pools, per-head page ids), for timing each
    variant alone."""
    from repro_torch.kernels import ops as kops
    b, h, sq, d = q.shape
    if table is not None:
        n_pages, hkv, page, _ = k.shape
        kf, vf = (x.reshape(n_pages * hkv, page, d) for x in (k, v))
        tab, skv = kops.expand_block_table(table, hkv), table.shape[1] * page
    else:
        _, hkv, skv, _ = k.shape
        kf, vf = (x.reshape(b * hkv, skv, d) for x in (k, v))
        tab = None
    src_dt, src_fmt = kops.policy_src(policy)
    args = (q.reshape(b * h, sq, d), kf, vf,
            kops.expand_kv_lens(kvl, b, h, skv, q.device), tab)
    kw = dict(group=h // hkv, scale=d ** -0.5, src_fmt_name=src_fmt,
              src_dtype=src_dt)
    return args, kw


def flash_case(name, *, dtype, page, rows, q_offset, chunk, window,
               softcap, alias, seed, q_scale=1.0, policy=None, heads=(8, 2),
               d=256, main=False):
    """A prefill chunk of width ``chunk`` at ``q_offset`` for ``rows``
    live chunk lengths, through the paged pool (``page`` > 0) or, with
    ``page == 0``, over contiguous K/V (fresh prompt, q_offset 0).
    ``q_scale`` as in :func:`decode_case`.  The plain version walks the
    kernel's own key tiles.  ``main`` cases also time the FMA variant
    (``fma_ms``) and the tensor-core variant with the query tile that
    ``plan_q_rows`` did not pick (``other_q_rows``: 64 or 128 rows) beside
    the routed kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_fma, flash_attention_tc,
        kernel_block_k, plan_q_rows, tc_tile_dtype)
    b, (hkv, g) = len(rows), heads
    h = hkv * g
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_lens = [q_offset + r for r in rows]
    if policy is None:
        policy = "tp_bf16" if dtype == torch.bfloat16 else "tp_bf16_kv8"
    src_dt, src_fmt = kops.policy_src(policy)
    q_dt = torch.float32 if src_dt == torch.float32 else torch.bfloat16
    q = (torch.randn((b, h, chunk, d), generator=gen, device="cuda")
         * q_scale).to(q_dt)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    if page:
        max_pages = -(-(q_offset + chunk) // page)
        k, v, table = _pool_and_table(gen, b, hkv, max_pages, page, d, dtype,
                                      alias)
    else:
        k = torch.randn((b, hkv, chunk, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((b, hkv, chunk, d), generator=gen,
                        device="cuda").to(dtype)
        table = None
    bk = kernel_block_k(src_dt, src_fmt, d)
    variant = "tc" if tc_tile_dtype(src_dt, src_fmt, d) is not None else "fma"
    call = lambda backend, cap=softcap: kops.flash_attention(
        q, k, v, kv_len=kvl, block_table=table, policy=policy,
        causal=True, window=window, softcap=cap, q_offset=q_offset,
        backend=backend, block_k=bk)
    before = (flash_attention_cuda.launches_tc,
              flash_attention_cuda.launches_fma)
    got = call("kernel")
    routed = (flash_attention_cuda.launches_tc - before[0],
              flash_attention_cuda.launches_fma - before[1])
    want = call("plain")
    torch.cuda.synchronize()
    if routed != ((1, 0) if variant == "tc" else (0, 1)):
        raise AssertionError(f"{name}: launches (tc, fma) {routed}, "
                             f"expected the {variant} variant")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    cap = _cap_effect(call, got) if q_scale != 1.0 else None
    # live (query, key) pairs and distinct keys read, from this run's masks:
    # the chunk's first query sees the window's first key
    qpos = q_offset + torch.arange(chunk, device="cuda")[None, :]
    hi = torch.minimum(kvl[:, None].long(), qpos + 1)
    lo = (torch.zeros_like(qpos) if window is None
          else torch.clamp(qpos - window + 1, min=0))
    pairs = torch.clamp(hi - lo, min=0).sum().item() * h
    skv = table.shape[1] * page if page else k.shape[2]
    keys = _keys_read(table, page, skv, lo[:, 0].expand(b), kvl)
    esz = k.element_size()
    nbytes = (q.numel() * q.element_size() + keys * hkv * d * 2 * esz
              + got.numel() * 4 + kvl.numel() * 4)
    flops = 4.0 * d * pairs
    bound_ms, bound_by = bound(nbytes, flops,
                               BF16_FLOP_S if variant == "tc" else F32_FLOP_S)
    lib = None
    if (softcap is None and window is None and table is None
            and q_offset == 0 and min(rows) == chunk
            and q_dt != torch.float32):
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    extra = {}
    if main:
        args, kw = _flat_flash(q, k, v, kvl, table, policy)
        kw.update(causal=True, window=window, softcap=softcap,
                  q_offset=q_offset)
        rows_planned = plan_q_rows(chunk, b * hkv, g)
        alt = 64 if rows_planned == 128 else 128
        extra = dict(
            fma_ms=device_ms(lambda: flash_attention_fma(*args, **kw), 3, 1),
            q_rows=rows_planned, other_q_rows=alt,
            other_q_rows_ms=device_ms(lambda: flash_attention_tc(
                *args, q_rows=alt, **kw)))
        other = flash_attention_tc(*args, q_rows=alt, **kw)
        extra["other_q_rows_max_abs_err"] = (other.reshape(got.shape)
                                             - want).abs().max().item()
    rec = dict(case=name, kernel="flash_attention", variant=variant,
               block_k=bk, max_abs_err=err,
               tol=KERNEL_TOL, q_scale=q_scale, cap_effect=cap,
               kernel_ms=device_ms(lambda: call("kernel")),
               eager_ms=cuda_ms(lambda: call("kernel"), 10), **extra,
               plain_ms=cuda_ms(lambda: call("plain"), 2, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               shape=dict(rows=b, heads=h, hkv=hkv, d=d, chunk=chunk,
                          q_offset=q_offset, page=page, kv_len=kv_lens,
                          window=window, softcap=softcap, policy=policy,
                          pool=str(dtype).replace("torch.", "")))
    if main:
        rec["speedup_vs_fma"] = rec["fma_ms"] / rec["kernel_ms"]
    log(json.dumps(rec))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_abs_err {err} > {KERNEL_TOL}")
    if main and not extra["other_q_rows_max_abs_err"] <= KERNEL_TOL:
        raise AssertionError(f"{name}: {extra['other_q_rows']}-row tiles, "
                             f"max_abs_err "
                             f"{extra['other_q_rows_max_abs_err']} > "
                             f"{KERNEL_TOL}")
    if cap is not None and not cap >= CAP_EFFECT_MIN:
        raise AssertionError(f"{name}: the softcap changes the output by "
                             f"{cap} < {CAP_EFFECT_MIN}")
    return rec


def decode_phase(sweep: bool = False) -> list:
    """The decode cases; the first is at the serving path's shapes.
    ``sweep``, a diagnostic that ``main`` does not run, times each case's
    kernel at 4, 8 and 16 CTAs a row, the sizes ``cluster_size`` chooses
    among: ``python3 -c "import chip_smoke as c; c.decode_phase(True)"``."""
    import torch
    bf16, fp8 = torch.bfloat16, torch.float8_e5m2
    d = []
    # the slice's decode: 4 slots, a local layer (window 4096, softcap 50),
    # one idle slot, one row past the window, aliased prefix pages
    d.append(decode_case("decode_bf16_p64_local", dtype=bf16, page=64,
                         kv_lens=[1056, 540, 0, 4111], window=4096,
                         softcap=50.0, alias=4, seed=1, sweep=sweep))
    # q x 24: scores near +-80, in the softcap's bend
    d.append(decode_case("decode_fp8_p16_window", dtype=fp8, page=16,
                         kv_lens=[300, 17, 0, 1000], window=64,
                         softcap=50.0, alias=2, seed=2, q_scale=24.0,
                         sweep=sweep))
    d.append(decode_case("decode_bf16_p64_global_nocap", dtype=bf16, page=64,
                         kv_lens=[1056, 540, 128, 4111], window=None,
                         softcap=None, alias=0, seed=3, sweep=sweep))
    # gemma2-9b's single-stream decode on a global layer at full context:
    # 8 rows, the latency case a one-CTA-per-row grid leaves 124 SMs idle
    d.append(decode_case("decode_bf16_p64_b1_global", dtype=bf16, page=64,
                         kv_lens=[8191], window=None, softcap=50.0, alias=0,
                         seed=8, sweep=sweep))
    # 16 slots on a local layer near the window: 128 rows, where
    # ``cluster_size`` drops to 4 CTAs a row
    d.append(decode_case("decode_bf16_p64_b16_local", dtype=bf16, page=64,
                         kv_lens=[4111 - 97 * i for i in range(16)],
                         window=4096, softcap=50.0, alias=4, seed=9,
                         sweep=sweep))
    return d


def kernel_phase() -> dict:
    """Every case; returns {kernel name: [records]} (the first record of
    each kernel is the one at the serving path's shapes)."""
    import torch
    bf16, fp8 = torch.bfloat16, torch.float8_e5m2
    recs = {"decode_attention": decode_phase(), "flash_attention": []}
    f = recs["flash_attention"]
    # the slice's prefill: a 256-token chunk continuing two prompts
    f.append(flash_case("flash_bf16_p64_chunk", dtype=bf16, page=64,
                        rows=[256, 200], q_offset=768, chunk=256,
                        window=4096, softcap=50.0, alias=4, seed=4,
                        main=True))
    f.append(flash_case("flash_fp8_p16_window", dtype=fp8, page=16,
                        rows=[256, 31], q_offset=320, chunk=256, window=200,
                        softcap=50.0, alias=3, seed=5, q_scale=24.0))
    f.append(flash_case("flash_bf16_contig_nocap", dtype=bf16, page=0,
                        rows=[1024, 1024], q_offset=0, chunk=1024,
                        window=None, softcap=None, alias=0, seed=6,
                        main=True))
    # the FMA variant, held against its plain version (policy fp32: f32
    # operands without a grid)
    f.append(flash_case("flash_f32_fp32_small", dtype=torch.float32, page=16,
                        rows=[96, 40], q_offset=32, chunk=96, window=48,
                        softcap=50.0, alias=2, seed=7, policy="fp32",
                        heads=(2, 2), d=128))
    return recs


# ---------------------------------------------------------------------------
# phase 3: the transprecision op path at gemma2-9b's MLP widths
# ---------------------------------------------------------------------------
D_MODEL, D_FF = 3584, 14336
#: integer operations of the CONV snap per element (``quantize_bits``:
#: mask, shift, add, compare and select steps), counted at the f32 rate
SNAP_OPS = 12
#: dotp_ex: each of kernel and plain within this share of sum |a_i b_i| of
#: the exact f64 sum (f32 sums of 51M exact products in two orders)
DOTP_REL_TOL = 1e-5
#: Table III (paper): the expanding FMA keeps >= 22 correct bits (variant e)
TABLE3_MIN_BITS = 22


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bit_mismatches(got, want) -> int:
    """Elements whose bits differ, NaN-aware (a NaN only has to be NaN)
    and sign-of-zero aware."""
    import torch
    idt = {4: torch.int32, 2: torch.int16}[got.element_size()]
    nan_g, nan_w = torch.isnan(got.float()), torch.isnan(want.float())
    diff = (got.view(idt) != want.view(idt)) & ~(nan_g & nan_w)
    return int((diff | (nan_g != nan_w)).sum().item())


def _edges(x):
    """Put the snap's edge cases into the first row of ``x``: both zeros,
    Inf, NaN, an f32 subnormal, values at and under fp8 min normal, fp8 max
    normal and its overflow tie."""
    import torch
    e = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      1e-40, 2.0 ** -14, 2.0 ** -14 * (1 - 2.0 ** -3),
                      2.0 ** -15, 57344.0, 61440.0, -61440.0],
                     device=x.device)
    x[0, :e.numel()] = e
    return x


def _snap_readback(a, b, quant):
    """The kernel's snapped operands, read back through identity products
    (x * 1 plus zeros is exact) in K chunks of 2048, against the plain
    snap.  Values are compared: an f32 sum starting at +0 turns a snapped
    -0 into +0.  Returns the number of differing elements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.tp_matmul import tp_matmul_cuda
    k, c = a.shape[1], 2048
    bad = 0
    for k0 in range(0, k, c):
        eye = torch.eye(min(c, k - k0), device="cuda")
        sa = tp_matmul_cuda(a[:, k0:k0 + c].contiguous(), eye,
                            quant_fmt_name=quant)
        sb = tp_matmul_cuda(eye, b[k0:k0 + c], quant_fmt_name=quant)
        bad += int((sa != ref.tp_quantize_ref(a[:, k0:k0 + c],
                                              fmt_name=quant)).sum().item())
        bad += int((sb != ref.tp_quantize_ref(b[k0:k0 + c],
                                              fmt_name=quant)).sum().item())
    return bad


def mm_case(name, *, m, k, n, dtype, out_dtype, quant=None, seed,
            flop_s=BF16_FLOP_S, library=True, library_note=None, iters=20,
            main=False):
    """One tp_matmul case: ``a [m, k] @ b [k, n]`` (b scaled by k^-1/2,
    a weight's scale) in ``dtype``, stored in ``out_dtype``.  ``main``
    cases also time the FMA variant (``fma_ms``)."""
    import torch
    from repro_torch.kernels.tp_matmul import (agreement_tol, plan_tc,
                                               tc_operand_dtype,
                                               tp_matmul_cuda, tp_matmul_fma,
                                               tp_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    kern = lambda: tp_matmul_cuda(a, b, out_dtype=out_dtype,
                                  quant_fmt_name=quant)
    plain = lambda: tp_matmul_plain(a, b, out_dtype=out_dtype,
                                    quant_fmt_name=quant)
    variant = ("tc" if tc_operand_dtype(dtype, quant) is not None
               else "fma")
    before = tp_matmul_cuda.launches_tc, tp_matmul_cuda.launches_fma
    got = kern()
    routed = (tp_matmul_cuda.launches_tc - before[0],
              tp_matmul_cuda.launches_fma - before[1])
    want = plain()
    torch.cuda.synchronize()
    if routed != ((1, 0) if variant == "tc" else (0, 1)):
        raise AssertionError(f"{name}: launches (tc, fma) {routed}, "
                             f"expected the {variant} variant")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    tol = agreement_tol(a, b, got, want, quant)
    over = int((err > tol).sum().item())
    snap_bad = _snap_readback(a, b, quant) if quant else None
    bound_ms, bound_by = bound(_nbytes(a, b, got), 2.0 * m * k * n, flop_s)
    lib = device_ms(lambda: torch.mm(a, b)) if library else None
    extra = {}
    if main:
        extra["fma_ms"] = device_ms(lambda: tp_matmul_fma(
            a, b, out_dtype=out_dtype, quant_fmt_name=quant), 3, 1)
    plan = plan_tc(m, k, n) if variant == "tc" else None
    rec = dict(case=name, kernel="tp_matmul", variant=variant,
               plan=dataclasses.asdict(plan) if plan else None,
               max_abs_err=err.max().item(),
               elements_over_tol=over,
               max_err_over_tol=(err / tol).max().item(),
               snap_mismatches=snap_bad,
               kernel_ms=device_ms(kern), eager_ms=cuda_ms(kern, iters),
               **extra,
               plain_ms=cuda_ms(plain, 5, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               library_note=library_note,
               shape=dict(m=m, k=k, n=n, operands=str(dtype)[6:],
                          out=str(out_dtype)[6:], quant=quant))
    if main:
        rec["speedup_vs_fma"] = rec["fma_ms"] / rec["kernel_ms"]
    log(json.dumps(rec))
    if over:
        raise AssertionError(f"{name}: {over} elements beyond the tolerance")
    if snap_bad:
        raise AssertionError(f"{name}: {snap_bad} snapped operands differ")
    return rec


def quant_case(name, *, rows, cols, fmt, stochastic, out_dtype, seed,
               pack=False):
    """One tp_quantize (or, with ``pack``, cast_and_pack) case on f32
    weights of scale cols^-1/2 with the edge cases in their first row."""
    import torch
    from repro_torch.kernels.tp_quant import (cast_and_pack_cuda,
                                              cast_and_pack_plain,
                                              tp_quantize_cuda,
                                              tp_quantize_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: _edges(torch.randn((rows, cols), generator=gen,
                                    device="cuda") * cols ** -0.5)
    x = mk()
    y = mk() if pack else None
    rbits = (torch.randint(-(1 << 31), 1 << 31, (rows, cols),
                           dtype=torch.int32, generator=gen, device="cuda")
             if stochastic else None)
    kw = dict(fmt_name=fmt, stochastic=stochastic, out_dtype=out_dtype)
    if pack:
        kern = lambda: cast_and_pack_cuda(x, y, rbits, **kw)
        plain = lambda: cast_and_pack_plain(x, y, rbits, **kw)
        ins = (x, y) + ((rbits,) if stochastic else ())
    else:
        kern = lambda: tp_quantize_cuda(x, rbits, **kw)
        plain = lambda: tp_quantize_plain(x, rbits, **kw)
        ins = (x,) + ((rbits,) if stochastic else ())
    got, want = kern(), plain()
    torch.cuda.synchronize()
    bad = _bit_mismatches(got, want)
    live = ~torch.isnan(want.float())
    err = (got.float() - want.float())[live].abs()
    err = err[torch.isfinite(err)].max().item()
    n_el = x.numel() * (2 if pack else 1)
    bound_ms, bound_by = bound(_nbytes(*ins, got), SNAP_OPS * n_el,
                               F32_FLOP_S)
    rec = dict(case=name, kernel="cast_and_pack" if pack else "tp_quantize",
               max_abs_err=err, bit_mismatches=bad,
               kernel_ms=device_ms(kern), eager_ms=cuda_ms(kern, 20),
               plain_ms=cuda_ms(plain, 5, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_note="no one torch call computes the FTZ grid snap: "
                            ".to(float8_e5m2) / .to(bfloat16) keep "
                            "subnormals",
               shape=dict(rows=rows, cols=cols, fmt=fmt,
                          stochastic=stochastic, out=str(out_dtype)[6:]))
    log(json.dumps(rec))
    if bad:
        raise AssertionError(f"{name}: {bad} elements differ in their bits")
    return rec


def _dotp_check(name, a, b, lanes_k, lanes_p):
    """(kernel total, plain total, exact f64 sum, sum |a b|) on the card;
    raises when either total is off the exact sum by more than the
    tolerance."""
    import torch
    pa, pb = a.double(), b.double()
    exact = (pa * pb).sum().item()
    scale = (pa * pb).abs().sum().item()
    tk, tp = lanes_k.double().sum().item(), lanes_p.double().sum().item()
    for who, t in (("kernel", tk), ("plain", tp)):
        if not (math.isfinite(t) and abs(t - exact) <= DOTP_REL_TOL * scale):
            raise AssertionError(f"{name}: {who} sum {t} vs exact {exact} "
                                 f"(sum |ab| {scale})")
    return tk, tp, exact, scale


def dotp_case(name, *, n, seed):
    """dotp_ex over two fp16 streams of ``n`` values at a weight's scale
    (d_model^-1/2)."""
    import torch
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda, dotp_ex_plain
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.randn(n, generator=gen, device="cuda") * D_MODEL ** -0.5).half()
    b = (torch.randn(n, generator=gen, device="cuda") * D_MODEL ** -0.5).half()
    kern = lambda: dotp_ex_cuda(a, b, src_dtype=torch.float16)
    plain = lambda: dotp_ex_plain(a, b, src_dtype=torch.float16)
    tk, tp, exact, scale = _dotp_check(name, a, b, kern(), plain())
    bound_ms, bound_by = bound(_nbytes(a, b), 2.0 * n, F32_FLOP_S)
    rec = dict(case=name, kernel="dotp_ex", max_abs_err=abs(tk - tp),
               kernel_err_vs_exact=abs(tk - exact),
               plain_err_vs_exact=abs(tp - exact), sum_abs=scale,
               tol=DOTP_REL_TOL * scale,
               kernel_ms=device_ms(kern), eager_ms=cuda_ms(kern, 20),
               plain_ms=cuda_ms(plain, 5, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=device_ms(lambda: torch.mm(
                   a.view(1, -1), b.view(-1, 1), out_dtype=torch.float32)),
               library_note="torch.mm([1, n] fp16, [n, 1] fp16, "
                            "out_dtype=float32)",
               shape=dict(n=n, dtype="float16", src="float16"))
    log(json.dumps(rec))
    return rec


def table3_case(seed: int = 0, n: int = 1024):
    """The paper's Table III stream (``benchmarks/table3_case_study.py``):
    two uniform [0, 1) streams of ``n`` values rounded to fp16; the
    expanding dot product must keep >= ``TABLE3_MIN_BITS`` correct bits
    against the exact f64 sum, in the kernel and in the plain version."""
    import numpy as np
    import torch
    from repro_torch.core import softfloat
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda, dotp_ex_plain
    rs = np.random.RandomState(seed)
    a64, b64 = rs.uniform(0.0, 1.0, n), rs.uniform(0.0, 1.0, n)
    a = softfloat.quantize(torch.tensor(a64, dtype=torch.float32,
                                        device="cuda"), "fp16").half()
    b = softfloat.quantize(torch.tensor(b64, dtype=torch.float32,
                                        device="cuda"), "fp16").half()
    lk = dotp_ex_cuda(a, b, src_dtype=torch.float16)
    lp = dotp_ex_plain(a, b, src_dtype=torch.float16)
    tk, tp, exact, _ = _dotp_check("dotp_fp16_table3", a, b, lk, lp)

    def bits(res):
        rel = abs(res - exact) / abs(exact)
        return 30 if rel == 0 else max(0, math.floor(-math.log2(rel)))
    rec = dict(case="dotp_fp16_table3", kernel="dotp_ex",
               max_abs_err=abs(tk - tp), exact=exact, kernel_sum=tk,
               plain_sum=tp, kernel_bits=bits(tk), plain_bits=bits(tp),
               min_bits=TABLE3_MIN_BITS,
               kernel_ms=device_ms(lambda: dotp_ex_cuda(
                   a, b, src_dtype=torch.float16)),
               bound_ms=bound(_nbytes(a, b), 2.0 * n, F32_FLOP_S)[0],
               shape=dict(n=n, dtype="float16", src="float16"))
    log(json.dumps(rec))
    if min(rec["kernel_bits"], rec["plain_bits"]) < TABLE3_MIN_BITS:
        raise AssertionError(f"Table III stream: {rec['kernel_bits']} / "
                             f"{rec['plain_bits']} correct bits < "
                             f"{TABLE3_MIN_BITS}")
    return rec


def op_kernel_phase() -> dict:
    """Every op-path case; returns {kernel name: [records]} (the first
    record of each kernel is its main case)."""
    import torch
    # switches off reduced-precision bf16 reductions, so torch.mm computes
    # the kernel's function (one f32 sum rounded once)
    import repro_torch.core.ops  # noqa: F401
    bf16, f32 = torch.bfloat16, torch.float32
    recs = {"tp_matmul": [], "tp_quantize": [], "cast_and_pack": [],
            "dotp_ex": []}
    mm = recs["tp_matmul"]
    no_snap_lib = "no one torch call fuses the FTZ fp8 grid snap into the " \
                  "product"
    mm.append(mm_case("mm_bf16_mlp_up", m=256, k=D_MODEL, n=D_FF, dtype=bf16,
                      out_dtype=bf16, seed=11, main=True))
    mm.append(mm_case("mm_bf16_decode", m=4, k=D_MODEL, n=D_FF, dtype=bf16,
                      out_dtype=bf16, seed=12, main=True))
    mm.append(mm_case("mm_em_fp8_mlp_down", m=256, k=D_FF, n=D_MODEL,
                      dtype=f32, out_dtype=f32, quant="fp8", seed=13,
                      library=False, iters=10, library_note=no_snap_lib,
                      main=True))
    # the narrow-N product that the K split is for
    mm.append(mm_case("mm_bf16_mlp_down", m=256, k=D_FF, n=D_MODEL,
                      dtype=bf16, out_dtype=bf16, seed=16))
    mm.append(mm_case("mm_em_fp8_mlp_up", m=256, k=D_MODEL, n=D_FF,
                      dtype=f32, out_dtype=f32, quant="fp8", seed=17,
                      library=False, iters=10, library_note=no_snap_lib))
    # the FMA variant, held against its plain version (tf32 grid: wider
    # than 16 bits)
    mm.append(mm_case("mm_tf32_grid_small", m=96, k=640, n=200, dtype=f32,
                      out_dtype=f32, quant="tf32", seed=18, library=False,
                      library_note="no one torch call fuses the tf32 grid "
                                   "snap into the product"))
    mm.append(mm_case("mm_fp8_native", m=256, k=D_MODEL, n=D_FF,
                      dtype=torch.float8_e5m2, out_dtype=bf16, seed=14,
                      flop_s=FP8_FLOP_S, library=False,
                      library_note="torch.mm does not take float8 operands; "
                                   "torch._scaled_mm is a private call"))
    mm.append(mm_case("mm_ragged", m=50, k=100, n=70, dtype=bf16,
                      out_dtype=bf16, seed=15))
    q = recs["tp_quantize"]
    q.append(quant_case("quant_fp8_rne_weight", rows=D_MODEL, cols=D_FF,
                        fmt="fp8", stochastic=False, out_dtype=f32, seed=21))
    q.append(quant_case("quant_fp8_stoch_weight", rows=D_MODEL, cols=D_FF,
                        fmt="fp8", stochastic=True, out_dtype=f32, seed=22))
    q.append(quant_case("quant_fp16alt_bf16out", rows=D_MODEL, cols=D_FF,
                        fmt="fp16alt", stochastic=False, out_dtype=bf16,
                        seed=23))
    recs["cast_and_pack"].append(quant_case(
        "pack_fp8_weight", rows=D_MODEL, cols=D_FF, fmt="fp8",
        stochastic=False, out_dtype=f32, seed=24, pack=True))
    recs["dotp_ex"].append(dotp_case("dotp_fp16_weight", n=D_MODEL * D_FF,
                                     seed=31))
    recs["dotp_ex"].append(table3_case())
    torch.cuda.empty_cache()
    return recs


def op_path_phase(seed: int = 0) -> dict:
    """The op path's public entry points in sequence at gemma2-9b's MLP
    widths, each through its kernel: two f32 weights [3584, 14336] quantized
    to fp8, the two em_fp8 products of x [256, 3584] with them, the two
    products packed, and the expanding dot product of the two weights as
    fp16 streams.  Every launch counter must be > 0 afterwards and every
    output finite; slices are held against the plain versions."""
    import torch
    from repro_torch.core import ops as tops
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda
    from repro_torch.kernels.tp_matmul import (agreement_tol, tp_matmul_cuda,
                                               tp_matmul_plain)
    from repro_torch.kernels.tp_quant import (cast_and_pack_cuda,
                                              tp_quantize_cuda,
                                              tp_quantize_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1, w2 = (torch.randn((D_MODEL, D_FF), generator=gen, device="cuda")
              * D_MODEL ** -0.5 for _ in range(2))
    x = torch.randn((256, D_MODEL), generator=gen, device="cuda")
    kernels = {"tp_matmul": tp_matmul_cuda, "tp_quantize": tp_quantize_cuda,
               "cast_and_pack": cast_and_pack_cuda, "dotp_ex": dotp_ex_cuda}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    tp_matmul_cuda.launches_tc = tp_matmul_cuda.launches_fma = 0
    t0 = time.perf_counter()
    w1q = kops.tp_quantize(w1, fmt="fp8")
    w2q = kops.tp_quantize(w2, fmt="fp8")
    y1 = tops.tp_matmul(x, w1q, "em_fp8", use_kernel=True)
    y2 = tops.tp_matmul(x, w2q, "em_fp8", use_kernel=True)
    packed = kops.cast_and_pack(y1, y2, fmt="fp8")
    d = kops.dotp_ex(w1q.half().reshape(-1), w2q.half().reshape(-1),
                     policy="tp_fp16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    variants = {"tp_matmul": {"tc": tp_matmul_cuda.launches_tc,
                              "fma": tp_matmul_cuda.launches_fma}}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the op path")
    if variants["tp_matmul"] != {"tc": 2, "fma": 0}:
        raise AssertionError(f"the em_fp8 products did not both take the "
                             f"tensor-core variant: {variants}")
    outs = dict(w1q=w1q, w2q=w2q, y1=y1, y2=y2, packed=packed, d=d)
    for name, t in outs.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"op path: {name} is not finite")
    if packed.shape != (256, 2 * D_FF) or y1.shape != (256, D_FF):
        raise AssertionError(f"op path shapes {tuple(y1.shape)}, "
                             f"{tuple(packed.shape)}")
    # against the plain versions on slices of the same data
    w_bad = _bit_mismatches(w1q[:64], tp_quantize_plain(w1[:64],
                                                        fmt_name="fp8"))
    ys = tp_matmul_plain(x[:16], w1q[:, :256], quant_fmt_name="fp8")
    y_over = int(((y1[:16, :256] - ys).abs() > agreement_tol(
        x[:16], w1q[:, :256], y1[:16, :256], ys, "fp8")).sum().item())
    p_bad = _bit_mismatches(packed[:16, 1::2], tp_quantize_plain(
        y2[:16].contiguous(), fmt_name="fp8"))
    _, _, exact, scale = _dotp_check(
        "op path dotp", w1q.half().reshape(-1), w2q.half().reshape(-1),
        d.reshape(1, 1), d.reshape(1, 1))
    res = dict(wall_s=wall, launches=launches, variants=variants,
               weight_snap_mismatches=w_bad,
               matmul_elements_over_tol=y_over, pack_mismatches=p_bad,
               dotp=d.item(), dotp_exact=exact, dotp_sum_abs=scale,
               fp8_share_of_weight_zero=(w1q == 0).float().mean().item())
    log(json.dumps({"op_path": res}))
    if w_bad or y_over or p_bad:
        raise AssertionError(f"op path disagrees with the plain versions: "
                             f"{res}")
    del w1, w2, x, outs, w1q, w2q, y1, y2, packed
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: the slice, end to end
# ---------------------------------------------------------------------------
#: device-time classes of the profiled run, by kernel-name fragment
KERNEL_CLASSES = (("decode_attention", ("decode_cluster_kernel",)),
                  ("flash_attention", ("flash_kernel", "flash_tc_kernel")),
                  ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))


def profile_run(eng, reqs) -> dict:
    """Where the device time goes in a short window of the slice: ``reqs``
    served once timed, then once under ``torch.profiler`` (CUDA activity
    only, so the host is barely slowed and the trace stays small).  Device
    time is summed over kernel events by class; the idle share is one
    minus that over the unprofiled wall time of the same window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            by_name[ev.key] = (by_name.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e6)
    busy = sum(by_name.values())
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for key, sec in by_name.items():
        low = key.lower()
        cls = next((name for name, frags in KERNEL_CLASSES
                    if any(f in low for f in frags)), "other")
        classes[cls] += sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(requests=len(reqs), max_new=reqs[0].max_new, wall_s=wall,
                device_busy_s=busy,
                device_idle_share=(1.0 - busy / wall) if busy else None,
                device_s_by_class=classes,
                top_kernels=[[k[:90], sec] for k, sec in top])


PROMPTS = (1024, 128, 512, 4080, 768, 256, 896, 384)
ARRIVALS = (0, 0, 0, 0, 2, 4, 6, 8)
GEN = 32


def slice_phase(seed: int = 0) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import (
        cluster_size, decode_attention_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.engine import ContinuousEngine, Request
    from repro_torch.models.registry import build_model

    model = build_model("gemma2-9b", policy="tp_bf16", device="cuda",
                        paged_kv=True, page_size=64)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    log(f"gemma2-9b full width: {model.cfg.n_layers} layers, d_model "
        f"{model.cfg.d_model}, weights "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    reqs = [Request(rid=i, tokens=rng.randint(0, model.cfg.vocab,
                                              size=p).tolist(),
                    max_new=GEN, arrival=a)
            for i, (p, a) in enumerate(zip(PROMPTS, ARRIVALS))]
    max_len = max(p + GEN for p in PROMPTS)
    eng = ContinuousEngine(model, params, slots=4, max_len=max_len,
                           chunk=256)
    eng.run(reqs)                                    # warm-up
    decode_attention_cuda.launches = flash_attention_cuda.launches = 0
    decode_attention_cuda.launches_mma = decode_attention_cuda.launches_fma = 0
    decode_attention_cuda.launches_by_cluster.clear()
    flash_attention_cuda.launches_tc = flash_attention_cuda.launches_fma = 0
    t0 = time.perf_counter()
    fin, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    variants = {"flash_attention": {"tc": flash_attention_cuda.launches_tc,
                                    "fma": flash_attention_cuda.launches_fma},
                "decode_attention": {
                    "mma": decode_attention_cuda.launches_mma,
                    "fma": decode_attention_cuda.launches_fma}}
    by_cluster = dict(decode_attention_cuda.launches_by_cluster)
    for f in fin:
        if len(f.tokens) != GEN:
            raise AssertionError(f"request {f.rid}: {len(f.tokens)} of "
                                 f"{GEN} tokens")
    if stats["pages_live_end"] != 0:
        raise AssertionError(f"pool did not drain: {stats}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if variants["flash_attention"] != {"tc": launches["flash_attention"],
                                       "fma": 0}:
        raise AssertionError(f"flash launches by variant {variants}: the "
                             f"tensor-core variant must take them all")
    if variants["decode_attention"] != {"mma": launches["decode_attention"],
                                        "fma": 0}:
        raise AssertionError(f"decode launches by route {variants}: the "
                             f"mma route must take them all")
    # the sizes ``cluster_size`` names for the engine's rows and table
    rule = {cluster_size(eng.slots * model.cfg.n_kv_heads, eng.max_pages,
                         eng.page, spec.window)
            for spec in model.cfg.layer_list()}
    if (sum(by_cluster.values()) != launches["decode_attention"]
            or not set(by_cluster) <= rule):
        raise AssertionError(f"decode launches by cluster size {by_cluster}:"
                             f" the rule names {sorted(rule)}")
    n_tok = sum(len(f.tokens) for f in fin)
    prompt_tok = sum(PROMPTS)
    res = dict(requests=len(fin), prompt_tokens=prompt_tok,
               generated_tokens=n_tok, wall_s=wall,
               prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_round=(stats["decode_s"] * 1e3
                                    / max(1, stats["decode_rounds"])),
               decode_rounds=stats["decode_rounds"],
               tok_s=n_tok / wall, peak_live_pages=stats["peak_live_pages"],
               launches=launches, variants=variants,
               decode_launches_by_cluster=by_cluster, max_len=max_len,
               crosses_window=max_len > 4096)
    log(json.dumps({"slice": res}))
    window = [dataclasses.replace(r, max_new=min(8, GEN), arrival=0)
              for r in reqs[:4]]
    log(json.dumps({"where_the_time_goes": profile_run(eng, window)}))

    # the same request through the plain versions
    pick = PROMPTS.index(512)
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    toks = torch.tensor([reqs[pick].tokens], device="cuda")
    lg_k, _ = model.prefill(params, toks, max_len=512 + GEN)
    lg_p, _ = plain.prefill(params, toks, max_len=512 + GEN)
    if not (torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()):
        raise AssertionError("first-token logits are not finite")
    lerr = (lg_k - lg_p).abs().max().item()
    solo = ContinuousEngine(plain, params, slots=1, max_len=512 + GEN,
                            chunk=256)
    (fin_p,), _ = solo.run([Request(rid=0, tokens=reqs[pick].tokens,
                                    max_new=GEN)])
    agree = sum(a == b for a, b in zip(fin[pick].tokens, fin_p.tokens))
    top2 = lg_p[0, -1].float().topk(2).values
    cmp = dict(request=pick, prompt=512, logits_max_abs_err=lerr,
               logits_tol=LOGITS_TOL, logits_absmax=lg_k.abs().max().item(),
               plain_top2_margin=(top2[0] - top2[1]).item(),
               greedy_tokens_agree=agree, of=GEN,
               first_token_agree=fin[pick].tokens[0] == fin_p.tokens[0])
    log(json.dumps({"plain_vs_kernel": cmp}))
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"first-token logits differ by {lerr}")
    if not cmp["first_token_agree"]:
        raise AssertionError("the first generated token differs between the "
                             "kernel path and the plain path")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    build_phase()
    recs = kernel_phase()
    recs.update(op_kernel_phase())
    op_res = op_path_phase()
    res = slice_phase()
    launches = {**res["launches"], **op_res["launches"]}
    variants = {**res["variants"], **op_res["variants"]}
    line = []
    for name, cases in recs.items():
        main_case = cases[0]
        entry = dict(
            name=name, **KERNELS[name], launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"])
        if name in variants:
            entry.update(launches_by_variant=variants[name])
            if "fma_ms" in main_case:
                entry["fma_ms"] = main_case["fma_ms"]
        if name == "decode_attention":
            entry["launches_by_cluster"] = res["decode_launches_by_cluster"]
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
