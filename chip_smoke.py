#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the serving path (one ``nvcc`` per source, all
   started together).
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   in the working dtype, at the serving path's shapes (head_dim 256, GQA
   group 2, pages of 64 and 16 tokens; bf16 and fp8-e5m2 pools; ragged
   ``kv_len`` with an idle row; window, softcap, aliased pages; a prefill
   chunk at ``q_offset > 0``).  One JSON line per case: error and
   tolerance, kernel / plain / library time, and the card's least time for
   the same work (``bound_ms``).
3. Slice phase: full-width gemma2-9b under ``tp_bf16`` with seeded random
   weights, served by ``ContinuousEngine`` (4 slots, 8 requests, pages of
   64 tokens, one request crossing the 4096-token local window).  Every
   request must get its whole budget and both kernels must have launched
   in that run.  A short window (the first four requests, 8 tokens each)
   under ``torch.profiler`` gives device time by kernel class and the
   device's idle share.  Then one
   request is served again with the plain versions and its first-token
   logits and greedy tokens are compared.
4. The kernels line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Imports no JAX.  Needs one CUDA device and ``nvcc`` (``CUDA_HOME``, PATH
or ``/usr/local/cuda``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM dense peaks (NVIDIA data sheet): HBM3 bytes/s, bf16 FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12

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
}


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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def build_phase() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, entry in logs.items():
        ptxas = [ln.strip() for ln in entry["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(json.dumps({"build": name, "seconds": round(entry["seconds"], 2),
                        "ptxas": ptxas[:8]}))
    log(f"kernels built in {secs:.1f} s")
    return logs


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
                seed, q_scale=1.0):
    """``q_scale`` > 1 puts the scores into the softcap's bend; the case
    then also checks that the cap changes the output (``CAP_EFFECT_MIN``)."""
    import torch
    from repro_torch.kernels import ops as kops
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
    got, want = call("kernel"), call("plain")
    torch.cuda.synchronize()
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
        lib = cuda_ms(_sdpa_decode(q, k, v, table, kvl, window), 20)
    rec = dict(case=name, kernel="decode_attention", max_abs_err=err,
               tol=KERNEL_TOL, q_scale=q_scale, cap_effect=cap,
               kernel_ms=cuda_ms(lambda: call("kernel"), 50),
               plain_ms=cuda_ms(lambda: call("plain"), 5),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               shape=dict(slots=b, hkv=hkv, group=g, d=d, page=page,
                          kv_len=kv_lens, window=window, softcap=softcap,
                          pool=str(dtype).replace("torch.", "")))
    log(json.dumps(rec))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_abs_err {err} > {KERNEL_TOL}")
    if cap is not None and not cap >= CAP_EFFECT_MIN:
        raise AssertionError(f"{name}: the softcap changes the output by "
                             f"{cap} < {CAP_EFFECT_MIN}")
    return rec


def flash_case(name, *, dtype, page, rows, q_offset, chunk, window,
               softcap, alias, seed, q_scale=1.0):
    """A prefill chunk of width ``chunk`` at ``q_offset`` for ``rows``
    live chunk lengths, through the paged pool (``page`` > 0) or, with
    ``page == 0``, over contiguous K/V (fresh prompt, q_offset 0).
    ``q_scale`` as in :func:`decode_case`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    b, hkv, g, d = len(rows), 8, 2, 256
    h = hkv * g
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_lens = [q_offset + r for r in rows]
    q = (torch.randn((b, h, chunk, d), generator=gen, device="cuda")
         * q_scale).to(torch.bfloat16)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    policy = "tp_bf16" if dtype == torch.bfloat16 else "tp_bf16_kv8"
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
    call = lambda backend, cap=softcap: kops.flash_attention(
        q, k, v, kv_len=kvl, block_table=table, policy=policy,
        causal=True, window=window, softcap=cap, q_offset=q_offset,
        backend=backend)
    got, want = call("kernel"), call("plain")
    torch.cuda.synchronize()
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
    bound_ms, bound_by = bound(nbytes, flops)
    lib = None
    if (softcap is None and window is None and table is None
            and q_offset == 0 and min(rows) == chunk):
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10)
    rec = dict(case=name, kernel="flash_attention", max_abs_err=err,
               tol=KERNEL_TOL, q_scale=q_scale, cap_effect=cap,
               kernel_ms=cuda_ms(lambda: call("kernel"), 10),
               plain_ms=cuda_ms(lambda: call("plain"), 2, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               shape=dict(rows=b, heads=h, hkv=hkv, d=d, chunk=chunk,
                          q_offset=q_offset, page=page, kv_len=kv_lens,
                          window=window, softcap=softcap,
                          pool=str(dtype).replace("torch.", "")))
    log(json.dumps(rec))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_abs_err {err} > {KERNEL_TOL}")
    if cap is not None and not cap >= CAP_EFFECT_MIN:
        raise AssertionError(f"{name}: the softcap changes the output by "
                             f"{cap} < {CAP_EFFECT_MIN}")
    return rec


def kernel_phase() -> dict:
    """Every case; returns {kernel name: [records]} (the first record of
    each kernel is the one at the serving path's shapes)."""
    import torch
    bf16, fp8 = torch.bfloat16, torch.float8_e5m2
    recs = {"decode_attention": [], "flash_attention": []}
    d = recs["decode_attention"]
    # the slice's decode: 4 slots, a local layer (window 4096, softcap 50),
    # one idle slot, one row past the window, aliased prefix pages
    d.append(decode_case("decode_bf16_p64_local", dtype=bf16, page=64,
                         kv_lens=[1056, 540, 0, 4111], window=4096,
                         softcap=50.0, alias=4, seed=1))
    # q x 24: scores near +-80, in the softcap's bend
    d.append(decode_case("decode_fp8_p16_window", dtype=fp8, page=16,
                         kv_lens=[300, 17, 0, 1000], window=64,
                         softcap=50.0, alias=2, seed=2, q_scale=24.0))
    d.append(decode_case("decode_bf16_p64_global_nocap", dtype=bf16, page=64,
                         kv_lens=[1056, 540, 128, 4111], window=None,
                         softcap=None, alias=0, seed=3))
    f = recs["flash_attention"]
    # the slice's prefill: a 256-token chunk continuing two prompts
    f.append(flash_case("flash_bf16_p64_chunk", dtype=bf16, page=64,
                        rows=[256, 200], q_offset=768, chunk=256,
                        window=4096, softcap=50.0, alias=4, seed=4))
    f.append(flash_case("flash_fp8_p16_window", dtype=fp8, page=16,
                        rows=[256, 31], q_offset=320, chunk=256, window=200,
                        softcap=50.0, alias=3, seed=5, q_scale=24.0))
    f.append(flash_case("flash_bf16_contig_nocap", dtype=bf16, page=0,
                        rows=[1024, 1024], q_offset=0, chunk=1024,
                        window=None, softcap=None, alias=0, seed=6))
    return recs


# ---------------------------------------------------------------------------
# phase 3: the slice, end to end
# ---------------------------------------------------------------------------
#: device-time classes of the profiled run, by kernel-name fragment
KERNEL_CLASSES = (("decode_attention", ("decode_kernel",)),
                  ("flash_attention", ("flash_kernel",)),
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
    from repro_torch.kernels.decode_attention import decode_attention_cuda
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
    t0 = time.perf_counter()
    fin, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    for f in fin:
        if len(f.tokens) != GEN:
            raise AssertionError(f"request {f.rid}: {len(f.tokens)} of "
                                 f"{GEN} tokens")
    if stats["pages_live_end"] != 0:
        raise AssertionError(f"pool did not drain: {stats}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    n_tok = sum(len(f.tokens) for f in fin)
    prompt_tok = sum(PROMPTS)
    res = dict(requests=len(fin), prompt_tokens=prompt_tok,
               generated_tokens=n_tok, wall_s=wall,
               prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_round=(stats["decode_s"] * 1e3
                                    / max(1, stats["decode_rounds"])),
               decode_rounds=stats["decode_rounds"],
               tok_s=n_tok / wall, peak_live_pages=stats["peak_live_pages"],
               launches=launches, max_len=max_len,
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
    res = slice_phase()
    line = []
    for name, cases in recs.items():
        main_case = cases[0]
        line.append(dict(
            name=name, **KERNELS[name], launches=res["launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"]))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
