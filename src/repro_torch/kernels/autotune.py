"""Block-shape autotuner for the CUDA kernels' launch knobs.

Each kernel has a knob whose best value depends on the shape, the dtype
and the card, and a static rule that picks it today:

  ``decode_attn``  CTAs per row of the decode kernel's split-KV cluster
                   (``decode_attention.cluster_size``);
  ``attn``         ``flash_tc``'s query tile, 64 or 128 rows over the
                   group's heads (``flash_attention.plan_q_rows``);
  ``matmul``       ``tp_matmul_tc``'s plan ``(wm, splits)``: BM 128 or 256,
                   and K in that many contiguous ranges
                   (``tp_matmul.plan_tc``); the split route's, BM 128
                   (``tp_matmul.plan_split``).

This module times the legal values on the live device and memoizes the
winner in a JSON cache keyed by ``op|shape|dtype|device|build``:

  * ``best_block(op, shape, dtype, device)`` — the picker
    ``kernels/ops.py`` asks: the memoized winner if one exists, else the
    static rule (``default_block``).  It never times anything, and after
    the first call for a shape it costs a dictionary hit.
  * ``autotune_matmul / autotune_attention / autotune_decode`` — sweep
    one shape and persist the winner.
  * CLI: ``python -m repro_torch.kernels.autotune --op decode_attn
    --shape 32x65x64x2x256 --dtype bfloat16`` (on the card unless
    ``--device cpu``).

Shapes (``shape``): ``decode_attn`` (rows = B * Hkv, live units a row,
keys a unit, group G, head dim D); ``attn`` (Sq, BKV = B * Hkv, group, D,
Dv); ``matmul`` (M, K, N).  The length-like axes (rows, units, Sq, BKV, M)
are keyed by their next power of two (``_bucket_shape``), so a ragged
serving mix shares one winner a bucket, which ``kernels/ops.py`` clamps
to the live shape.  ``dtype`` is the KV pool's storage dtype for the
attention ops and the operand dtype for ``matmul``, with ``+grid`` when
the operands are snapped onto an emulated grid (``float32+fp8``).

``device`` is ``cpu`` or the card's name, compute capability and SM
count; ``build`` is the torch version and, on the card, the CUDA version
and the digest of the op's library sources (``_build.source_digest``):
an edited ``.cu`` or header, another torch or another card leaves a
winner unresolved, and the pick falls back to the static rule.

Two files, neither the JAX package's: the user's cache
(``$REPRO_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/autotune.json``), and the shipped one
(``kernels/pretuned.json`` beside this module,
``$REPRO_TORCH_PRETUNED_CACHE`` to override) with the H100's winners at
the shapes the port serves.  The shipped file is loaded after the
user's, so a local winner beats a shipped one, and only its entries whose
build matches the running one are adopted.  Malformed entries are
skipped.

Timing: on the card, device time per call after warm-up (CUDA events
over a replayed CUDA graph of ``CALLS`` calls, ``repeats`` replays, the
median); on the CPU, the host clock around the plain version, which walks
each candidate (the decode partition, ``tp_matmul``'s K ranges, flash's
telemetry tiles).  A candidate displaces the heuristic only when it beats
the heuristic's median by more than ``MIN_GAIN`` and by more than both
spreads (max - min of the repeats).  Candidates are legal by
construction, so one that fails to launch, or whose output strays from
the plain version at the same candidate, raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.device import resolve_device
from . import _build
from .decode_attention import MAX_CLUSTER, cluster_size
from .flash_attention import TC_HEAD_PAIRS, kernel_block_k, plan_q_rows
from .tp_matmul import (agreement_tol, matmul_route, plan_split, plan_tc,
                        tc_plan, tp_matmul_plain)

__all__ = [
    "best_block", "lookup", "record", "reset", "candidates", "default_block",
    "autotune_matmul", "autotune_attention", "autotune_decode",
    "pretuned_path", "cache_path", "pretuned_status",
]

OPS = ("decode_attn", "attn", "matmul")
#: the library whose sources an op's winners were timed on
LIBRARY = {"decode_attn": "decode_attention", "attn": "flash_attention",
           "matmul": "tp_matmul"}
#: per-op axes whose sizes vary with batch / prompt length (bucketed in
#: keys); the other axes are architectural constants and stay exact
_BUCKET_AXES = {"decode_attn": (0, 1), "attn": (0, 1), "matmul": (0,)}
_DIMS = {"decode_attn": 5, "attn": 5, "matmul": 3}

#: calls captured in the timed CUDA graph, and the default replays
CALLS, REPEATS = 10, 5
#: share of the heuristic's median a candidate must gain to displace it
MIN_GAIN = 0.03
#: candidate-vs-plain tolerance of the attention ops (``KERNEL_TOL`` of
#: the card tests: p rounded to bf16 in another summation order)
ATTN_TOL = 2.0 ** -8

_MEM: Dict[str, List[int]] = {}        # every loaded or recorded entry
_SHIPPED: set = set()                  # keys adopted from the shipped file
_FILE_LOADED = False
#: best_block's memo: (op, shape, dtype, device) -> winner or None
_PICKS: Dict[tuple, Optional[Tuple[int, ...]]] = {}
_DEVICE_TAGS: Dict[torch.device, str] = {}
_BUILD_TAGS: Dict[Tuple[str, bool], str] = {}


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def pretuned_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_PRETUNED_CACHE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "pretuned.json"))


def _pow2_bucket(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 0 else 0


def _bucket_shape(op: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """Length-like dims to their next power of two (one key a bucket)."""
    axes = _BUCKET_AXES[op]
    return tuple(_pow2_bucket(int(s)) if i in axes else int(s)
                 for i, s in enumerate(shape))


def dtype_name(dtype, grid: Optional[str] = None) -> str:
    """The key's dtype field: ``bfloat16``, ``float32+fp8``, ...  A string
    is taken as already named."""
    name = dtype if isinstance(dtype, str) else str(dtype).replace(
        "torch.", "")
    return f"{name}+{grid}" if grid else name


def _split_dtype(name: str) -> Tuple[torch.dtype, Optional[str]]:
    base, _, grid = name.partition("+")
    return getattr(torch, base), grid or None


def device_tag(device) -> str:
    """``cpu``, or the card's ``name smXY xSMs`` (memoized per device)."""
    device = torch.device(device)
    tag = _DEVICE_TAGS.get(device)
    if tag is None:
        if device.type == "cuda":
            p = torch.cuda.get_device_properties(
                device.index if device.index is not None
                else torch.cuda.current_device())
            tag = f"{p.name} sm{p.major}{p.minor} x{p.multi_processor_count}"
        else:
            tag = device.type
        _DEVICE_TAGS[device] = tag
    return tag


def build_tag(op: str, cuda: bool) -> str:
    """``torch-<version>``, on the card ``+cuda-<version>+<source
    digest of the op's library>`` (memoized)."""
    tag = _BUILD_TAGS.get((op, cuda))
    if tag is None:
        tag = f"torch-{torch.__version__}"
        if cuda:
            tag += (f"+cuda-{torch.version.cuda}"
                    f"+{_build.source_digest(LIBRARY[op])}")
        _BUILD_TAGS[(op, cuda)] = tag
    return tag


def _key(op: str, shape: Sequence[int], dtype, device) -> str:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    device = torch.device(device)
    shape = _bucket_shape(op, shape)
    return (f"{op}|{'x'.join(str(s) for s in shape)}|{dtype_name(dtype)}|"
            f"{device_tag(device)}|{build_tag(op, device.type == 'cuda')}")


def _entry(k, v) -> Optional[Tuple[str, List[int]]]:
    """A well-formed ``(key, block)`` or None."""
    try:
        block = [int(x) for x in v]
    except (TypeError, ValueError):
        return None
    parts = k.split("|") if isinstance(k, str) else []
    if len(parts) != 5 or parts[0] not in OPS or not block:
        return None
    return k, block


def _load_pretuned() -> None:
    """Adopt the shipped winners whose build matches the running one
    (``setdefault``: the user's winners beat them)."""
    try:
        with open(pretuned_path()) as f:
            ship = json.load(f)
    except (OSError, ValueError):
        return
    if not isinstance(ship, dict) or not isinstance(ship.get("entries"), dict):
        return
    for k, v in ship["entries"].items():
        e = _entry(k, v)
        if e is None:
            continue
        parts = k.split("|")
        if parts[4] != build_tag(parts[0], parts[3] != "cpu") or k in _MEM:
            continue                     # stale build, or a local winner
        _MEM[k] = e[1]
        _SHIPPED.add(k)


def _load_file() -> None:
    global _FILE_LOADED
    if _FILE_LOADED:
        return
    _FILE_LOADED = True
    try:
        with open(cache_path()) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        disk = {}
    for k, v in (disk.items() if isinstance(disk, dict) else ()):
        e = _entry(k, v)
        if e is not None:
            _MEM[k] = e[1]
    _load_pretuned()


def reset(clear_env_cache: bool = False) -> None:
    """Drop the in-process cache and the picks' memo (tests; or after
    pointing the variables elsewhere).  ``clear_env_cache`` also deletes
    the user's cache file."""
    global _FILE_LOADED
    _MEM.clear()
    _SHIPPED.clear()
    _PICKS.clear()
    _BUILD_TAGS.clear()
    _FILE_LOADED = False
    if clear_env_cache:
        try:
            os.remove(cache_path())
        except OSError:
            pass


def lookup(op: str, shape: Sequence[int], dtype, device=None
           ) -> Optional[Tuple[int, ...]]:
    """The recorded winner of this bucket on ``device`` (None: the card),
    or None."""
    _load_file()
    v = _MEM.get(_key(op, shape, dtype, resolve_device(device)))
    return tuple(v) if v is not None else None


def record(op: str, shape: Sequence[int], dtype, block: Sequence[int],
           device=None, persist: bool = True) -> None:
    """Record ``block`` as this bucket's winner; ``persist`` writes the
    user's cache (every entry but the adopted shipped ones)."""
    _load_file()
    k = _key(op, shape, dtype, resolve_device(device))
    _MEM[k] = [int(x) for x in block]
    _SHIPPED.discard(k)
    _PICKS.clear()
    if persist:
        path = cache_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        own = {k: v for k, v in _MEM.items() if k not in _SHIPPED}
        with open(path, "w") as f:
            json.dump(own, f, indent=2, sort_keys=True)


def pretuned_status(device=None) -> dict:
    """How many shipped entries were adopted for ``device`` (None: the
    card) and the running build, and how many the file holds."""
    _load_file()
    tag = device_tag(resolve_device(device))
    try:
        with open(pretuned_path()) as f:
            total = len(json.load(f).get("entries", {}))
    except (OSError, ValueError, AttributeError):
        total = 0
    return {"path": pretuned_path(), "entries": total,
            "adopted": sum(k.split("|")[3] == tag for k in _SHIPPED)}


# ---------------------------------------------------------------------------
# heuristics + candidate grids
# ---------------------------------------------------------------------------
def _matmul_split(dtype) -> bool:
    """Whether a ``matmul`` dtype (None: a 16-bit tile) takes the split
    route, whose plans are 128-row tiles (``plan_split``)."""
    return dtype is not None and matmul_route(
        *_split_dtype(dtype_name(dtype))) == "split"


def default_block(op: str, shape: Sequence[int], dtype=None
                  ) -> Tuple[int, ...]:
    """The static rules the kernels picked by before the tuner (``dtype``
    picks ``matmul``'s route: ``plan_split`` on the split route, else
    ``plan_tc``)."""
    if op == "decode_attn":
        rows, units, unit, _, _ = shape
        return (cluster_size(rows, units, unit),)
    if op == "attn":
        sq, bkv, group = shape[:3]
        return (plan_q_rows(sq, bkv, group),)
    if op == "matmul":
        p = (plan_split if _matmul_split(dtype) else plan_tc)(*shape)
        return (p.wm, p.splits)
    raise ValueError(op)


def _flash_tc(shape, dtype) -> bool:
    """Whether an ``attn`` shape and dtype route to ``flash_tc`` (an f32
    pool without a grid takes the split route, whose query tile is
    fixed, or ``flash_fma``)."""
    if (shape[3], shape[4]) not in TC_HEAD_PAIRS:
        return False
    return dtype is None or dtype_name(dtype) != "float32"


def candidates(op: str, shape: Sequence[int], dtype=None
               ) -> List[Tuple[int, ...]]:
    """Legal values for one op / shape, deduplicated, heuristic first (so
    a tie keeps it).  ``dtype`` tells the route: one without a knob
    (flash's split route, ``flash_fma``, ``tp_matmul_fma``) has the
    heuristic alone; ``tp_matmul``'s split route has 128-row tiles (wm 1)
    at power-of-two K splits."""
    out = [default_block(op, shape, dtype)]
    if op == "decode_attn":
        units = shape[1]
        c = 1
        while c <= min(MAX_CLUSTER, max(1, units)):
            if (c,) not in out:
                out.append((c,))
            c *= 2
    elif op == "attn":
        if _flash_tc(shape, dtype) and shape[2] <= 64:
            for rows in (64, 128):
                if (rows,) not in out:
                    out.append((rows,))
    elif op == "matmul":
        m, k, n = shape
        route = ("tc" if dtype is None
                 else matmul_route(*_split_dtype(dtype_name(dtype))))
        if route != "fma":
            k_steps = max(1, -(-k // 64))
            for wm in ((1, 2) if route == "tc" else (1,)):
                s = 1
                while s <= k_steps:
                    p = tc_plan(m, k, n, wm, s)
                    if (p.wm, p.splits) not in out:
                        out.append((p.wm, p.splits))
                    s *= 2
    else:
        raise ValueError(op)
    return out


def _best(op: str, shape: Tuple[int, ...], dtype, device
          ) -> Tuple[Tuple[int, ...], bool]:
    """``(block, tuned)``: the winner and True, or the heuristic and
    False.  A meta tensor (the dry run) takes the heuristic."""
    device = torch.device(device)
    if device.type == "meta":
        return default_block(op, shape, dtype), False
    memo = (op, shape, dtype, device)
    try:
        win = _PICKS[memo]
    except KeyError:
        win = _PICKS[memo] = lookup(op, shape, dtype, device)
    if win is None:
        return default_block(op, shape, dtype), False
    return win, True


def best_block(op: str, shape: Sequence[int], dtype, device=None
               ) -> Tuple[int, ...]:
    """The picker for kernels/ops.py: memoized winner, else the static
    rule.  Never times anything."""
    return _best(op, tuple(int(s) for s in shape), dtype_name(dtype),
                 resolve_device(device))[0]


# ---------------------------------------------------------------------------
# timing sweeps
# ---------------------------------------------------------------------------
def _times_card(fn, repeats: int) -> List[float]:
    """Device ms per call, one figure a replay of a CUDA graph of
    ``CALLS`` calls (warm-up calls first, on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) / CALLS)
    del graph
    return out


def _times_host(fn, repeats: int) -> List[float]:
    """Host ms per call (one warm-up call first)."""
    fn()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _winner(timings: Dict[Tuple[int, ...], dict], heuristic
            ) -> Tuple[int, ...]:
    """The heuristic, unless a candidate beats its median by more than
    ``MIN_GAIN`` of it and by more than both spreads: then the fastest
    such candidate."""
    h = timings[heuristic]
    best = heuristic
    for c, t in timings.items():
        gain = h["ms"] - t["ms"]
        if (gain > MIN_GAIN * h["ms"] and gain > h["spread_ms"]
                and gain > t["spread_ms"] and t["ms"] < timings[best]["ms"]):
            best = c
    return best


def _sweep(op: str, shape, dtype, device, run, check, *, repeats: int,
           persist: bool, verbose: bool):
    """Hold each candidate to its plain version (``check(block)``), time
    ``run(block)``, record the winner.  Returns ``(winner, {block:
    {"ms": median, "spread_ms": max - min}})``."""
    timer = _times_card if device.type == "cuda" else _times_host
    cands = candidates(op, shape, dtype)
    timings: Dict[Tuple[int, ...], dict] = {}
    for block in cands:
        check(block)
        ts = timer(lambda: run(block), max(1, repeats))
        timings[block] = {"ms": statistics.median(ts),
                          "spread_ms": max(ts) - min(ts)}
        if verbose:
            print(f"  {op} {block}: {timings[block]['ms']:.5f} ms "
                  f"(spread {timings[block]['spread_ms']:.5f})", flush=True)
    winner = _winner(timings, cands[0])
    record(op, shape, dtype, winner, device=device, persist=persist)
    return winner, timings


def _attn_policy(dtype) -> str:
    return {torch.bfloat16: "tp_bf16", torch.float16: "tp_fp16",
            torch.float8_e5m2: "tp_bf16_kv8", torch.float32: "fp32"}[dtype]


def _near(name, got, want, tol) -> None:
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: candidate output off its plain "
                             f"version by {err} > {tol}")


def autotune_decode(rows: int, units: int, unit: int, group: int, d: int,
                    dtype=torch.bfloat16, *, device=None,
                    repeats: int = REPEATS, persist: bool = True,
                    verbose: bool = False, seed: int = 0):
    """Sweep the decode cluster for ``rows`` rows (one KV head each) of up
    to ``units`` pages of ``unit`` keys, ``group`` query heads of width
    ``d``, on a pool of ``dtype``.  The rows are ragged, as a continuous
    batch's are: row r holds ceil((r + 1) / rows) of the full width, so
    the longest row, whose split sets the time, is full."""
    from . import ops as kops
    device = resolve_device(device)
    dtype = _split_dtype(dtype_name(dtype))[0]
    policy = _attn_policy(dtype)
    src, _ = kops.policy_src(policy)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pages = rows * units + 1
    k, v = (torch.randn((n_pages, 1, unit, d), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen, device=device)[
        :rows * units].reshape(rows, units).to(torch.int32) + 1)
    q = torch.randn((rows, group, 1, d), generator=gen, device=device).to(src)
    kvl = ((torch.arange(1, rows + 1, device=device) * units * unit
            + rows - 1) // rows).to(torch.int32)
    call = lambda c, backend="auto": kops.decode_attention(
        q, k, v, kv_len=kvl, block_table=table, policy=policy,
        backend=backend, cluster=c[0])

    def check(c):
        if device.type == "cuda":
            _near(f"decode cluster {c}", call(c), call(c, "plain"), ATTN_TOL)

    with torch.no_grad():
        return _sweep("decode_attn", (rows, units, unit, group, d), dtype,
                      device, call, check, repeats=repeats, persist=persist,
                      verbose=verbose)


def autotune_attention(sq: int, bkv: int, group: int, d: int,
                       dv: Optional[int] = None, dtype=torch.bfloat16, *,
                       device=None, repeats: int = REPEATS,
                       persist: bool = True, verbose: bool = False,
                       seed: int = 0):
    """Sweep ``flash_tc``'s query tile for a causal prefill of ``sq``
    queries from position 0 over ``bkv`` contiguous KV rows of ``group``
    query heads each (QK width ``d``, V width ``dv``, None: ``d``)."""
    from . import ops as kops
    device = resolve_device(device)
    dtype = _split_dtype(dtype_name(dtype))[0]
    dv = d if dv is None else dv
    policy = _attn_policy(dtype)
    src, fmt = kops.policy_src(policy)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((bkv, group, sq, d), generator=gen, device=device).to(
        src)
    k = torch.randn((bkv, 1, sq, d), generator=gen, device=device).to(dtype)
    v = torch.randn((bkv, 1, sq, dv), generator=gen, device=device).to(dtype)
    kvl = torch.full((bkv,), sq, dtype=torch.int32, device=device)
    bk = kernel_block_k(src, fmt, d, dv)
    call = lambda c, backend="auto": kops.flash_attention(
        q, k, v, kv_len=kvl, policy=policy, backend=backend, block_k=bk,
        q_rows=c[0])

    def check(c):
        if device.type == "cuda":
            _near(f"flash q_rows {c}", call(c), call(c, "plain"), ATTN_TOL)

    with torch.no_grad():
        return _sweep("attn", (sq, bkv, group, d, dv), dtype, device, call,
                      check, repeats=repeats, persist=persist,
                      verbose=verbose)


def _matmul_policy(dtype, grid):
    """The policy whose ``kernels.ops.tp_matmul`` runs these operands: a
    preset, or for a grid without one (tf32) ``em_fp8``'s emulation on
    that grid."""
    if grid:
        from ..core.formats import get_format
        from ..core.policy import PRESETS
        if f"em_{grid}" in PRESETS:
            return f"em_{grid}"
        em = PRESETS["em_fp8"]
        return em.replace(name=f"em_{grid}", matmul=dataclasses.replace(
            em.matmul, src_fmt=get_format(grid)))
    return {torch.bfloat16: "tp_bf16", torch.float16: "tp_fp16",
            torch.float8_e5m2: "tp_fp8", torch.float32: "fp32"}[dtype]


def autotune_matmul(m: int, k: int, n: int, dtype=torch.bfloat16, *,
                    device=None, repeats: int = REPEATS, persist: bool = True,
                    verbose: bool = False, seed: int = 0):
    """Sweep ``tp_matmul``'s plan (``tp_matmul_tc``'s, or the split
    route's 128-row plans) for ``a [m, k] @ b [k, n]`` in
    ``dtype`` (``float32+fp8``: f32 operands snapped onto fp8 in the
    kernel, policy ``em_fp8``); b scaled by k^-1/2, a weight's scale."""
    from . import ops as kops
    device = resolve_device(device)
    name = dtype_name(dtype)
    base, grid = _split_dtype(name)
    policy = _matmul_policy(base, grid)
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(base)
    b = (torch.randn((k, n), generator=gen, device=device)
         * k ** -0.5).to(base)
    plan = lambda c: tc_plan(m, k, n, *c)
    call = lambda c: kops.tp_matmul(a, b, policy=policy, plan=plan(c))

    def check(c):
        if device.type != "cuda":
            return
        got = call(c)
        want = tp_matmul_plain(a, b, out_dtype=got.dtype,
                               quant_fmt_name=grid, plan=plan(c))
        tol = agreement_tol(a, b, got, want, grid)
        over = int(((got.float() - want.float()).abs() > tol).sum())
        if over:
            raise AssertionError(f"matmul plan {c}: {over} elements beyond "
                                 f"agreement_tol")

    with torch.no_grad():
        return _sweep("matmul", (m, k, n), name, device, call, check,
                      repeats=repeats, persist=persist, verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", choices=OPS, required=True)
    ap.add_argument("--shape", required=True,
                    help="decode_attn: ROWSxUNITSxUNITxGxD; attn: "
                         "SQxBKVxGROUPxDxDV; matmul: MxKxN")
    ap.add_argument("--dtype", default="bfloat16",
                    help="bfloat16, float16, float8_e5m2, float32; matmul "
                         "also float32+<grid> (em_<grid>)")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    try:
        dims = tuple(int(x) for x in args.shape.lower().split("x"))
    except ValueError:
        ap.error(f"--shape wants 'x'-separated integers, got {args.shape!r}")
    if len(dims) != _DIMS[args.op]:
        ap.error(f"--shape wants {_DIMS[args.op]} 'x'-separated dims for "
                 f"{args.op}, got {args.shape!r}")
    try:
        _split_dtype(args.dtype)
    except AttributeError:
        ap.error(f"--dtype {args.dtype!r} is not a torch dtype")
    device = resolve_device(args.device)
    fn = {"matmul": autotune_matmul, "attn": autotune_attention,
          "decode_attn": autotune_decode}[args.op]
    winner, timings = fn(*dims, dtype=args.dtype, device=device,
                         repeats=args.repeats, verbose=True)
    print(f"winner for {args.op} {args.shape} [{args.dtype}] on "
          f"{device_tag(device)}: {winner} ({timings[winner]['ms']:.5f} ms; "
          f"heuristic {default_block(args.op, dims, args.dtype)}) -> "
          f"{cache_path()}")
    return winner, timings


if __name__ == "__main__":
    main()
