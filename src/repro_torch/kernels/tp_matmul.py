"""Multi-format (expanding-FMA) matmul — FPnew's merged multi-format FMA
slice as a GEMM.

``tp_matmul_cuda`` is the port of the TPU kernel
``repro.kernels.tp_matmul.tp_matmul_pallas``: hand-written CUDA kernels
(``csrc/tp_matmul.cu``, sm_90a) for tensors on the card, in three variants
chosen by ``matmul_route`` (dtype and grid) alone:

  ``tp_matmul_tc``     wgmma tiles fed by TMA (after a staging pass into
                       16-bit copies where the operands need one), for every
                       product whose operands as multiplied are exact in
                       bf16 or fp16;
  ``tp_matmul_split``  the split route, for f32 operands no 16-bit type
                       holds (f32 without a grid, tf32 and other grids of
                       up to 22 mantissa bits): the staging pass cuts each
                       operand into 2 or 3 bf16 pieces
                       (``quant_common.split_pieces``) and the same wgmma
                       machinery sums the piece products of weight 2^-16
                       and up (``quant_common.split_pairs``) into one f32
                       accumulator, at 128-row tiles (``plan_split``);
  ``tp_matmul_fma``    the first, f32-FMA version: every product the
                       contract takes routes to one of the two above since
                       the split route, so it runs only when called by
                       name (timed beside the split route as ``fma_ms``).

``tp_matmul_plain`` is the plain-torch version (``ref.tp_matmul_ref``).
``kernels.ops.tp_matmul`` chooses between kernel and plain version by the
tensors' device.

  stage           FPnew block   what happens
  operand snap    CONV          with ``quant_fmt_name``, f32 operands are
                                RNE-snapped (FTZ) onto that grid as they
                                are staged (the fused CONV->ADDMUL step)
  a @ b           ADDMUL        exact widening, f32 sums over K
  store           CONV          RNE cast to ``out_dtype`` (f32/bf16/fp16)

Operands: a [M, K], b [K, N], both f32, bf16, fp16 or fp8 e5m2 (one dtype
for both).  M, K and N are arbitrary: the kernels mask the ragged edges
themselves.  The f32 sum order differs from the plain version's ``bk``
schedule, so the two agree within ``2 K 2^-24 (|A| @ |B|)`` (plus one ulp
of a bf16/fp16 output), not bitwise; the snapped operands are bitwise equal.
The split route keeps IEEE's non-finite results: an Inf or NaN is its own
last piece, and a NaN sum (an Inf met a partner's zero piece) is
recomputed from the pieces' values over the split's K range.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build
from . import ref
from .quant_common import exact_tile_dtype, split_pieces, split_product

_OPERANDS = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e5m2)
_OUTPUTS = (torch.float32, torch.bfloat16, torch.float16)


def tp_matmul_plain(a, b, *, out_dtype=torch.float32,
                    quant_fmt_name: Optional[str] = None,
                    bk: Optional[int] = None, plan=None):
    """The kernel's function in plain torch; ``bk`` fixes the K-block
    summation schedule (None: one block).  With ``plan`` (a ``TcPlan`` of
    this product) the sum runs split by split over ``plan.k_ranges`` and
    the f32 partial sums are added in split order, as the tensor-core
    kernel's second pass adds them."""
    if plan is None or plan.splits == 1:
        return ref.tp_matmul_ref(a, b, out_dtype=out_dtype,
                                 quant_fmt_name=quant_fmt_name, bk=bk)
    total = None
    for lo, hi in plan.k_ranges(a.shape[1]):
        part = ref.tp_matmul_ref(a[:, lo:hi], b[lo:hi], out_dtype=torch.float32,
                                 quant_fmt_name=quant_fmt_name, bk=bk)
        total = part if total is None else total + part
    return total.to(out_dtype)


def tc_operand_dtype(dtype, quant_fmt_name: Optional[str] = None):
    """The 16-bit type in which the operands, as the contract multiplies
    them, are exact — the tensor-core variant's tile type — or None (the
    FMA variant).  With a grid the operands are its RNE-snapped values
    (``quant_common.exact_tile_dtype``).  Without one: bf16 and fp16 as
    they are, e5m2 widened to fp16 (exact), f32 None."""
    if quant_fmt_name:
        return exact_tile_dtype(quant_fmt_name)
    return {torch.bfloat16: torch.bfloat16, torch.float16: torch.float16,
            torch.float8_e5m2: torch.float16}.get(dtype)


def matmul_route(dtype, quant_fmt_name: Optional[str] = None) -> str:
    """The variant a product of ``dtype`` operands (snapped onto
    ``quant_fmt_name``'s grid) launches: "tc" when a 16-bit tile holds the
    operands (``tc_operand_dtype``), "split" when the split route's pieces
    do (``quant_common.split_pieces``), else "fma"."""
    if tc_operand_dtype(dtype, quant_fmt_name) is not None:
        return "tc"
    if split_pieces(dtype, quant_fmt_name) is not None:
        return "split"
    return "fma"


#: the tensor-core variant's tile: BM = 128 * wm rows, 128 columns, K in
#: steps of 64; a K split keeps at least this many steps per split
TC_BN, TC_BK, TC_MIN_STEPS_PER_SPLIT = 128, 64, 8


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """Tiles and K split of one tensor-core product.  Split ``z`` sums the
    K steps ``[z * steps_per_split, min((z + 1) * steps_per_split,
    k_steps))`` of every output tile; the partial sums are added in split
    order."""
    wm: int
    m_tiles: int
    n_tiles: int
    k_steps: int
    splits: int
    steps_per_split: int

    def k_ranges(self, k: int):
        """The K range ``(lo, hi)`` of each split, in summation order."""
        return [(z * self.steps_per_split * TC_BK,
                 min(k, (z + 1) * self.steps_per_split * TC_BK))
                for z in range(self.splits)]


def tc_plan(m: int, k: int, n: int, wm: int, splits: int) -> TcPlan:
    """The plan of ``wm`` (1: BM 128, 2: BM 256) and K cut into about
    ``splits`` contiguous ranges of whole 64-wide steps: ``splits`` is
    clamped to [1, K steps], and ranges of ``ceil(steps / splits)`` steps
    may need fewer splits than asked (56 steps asked for 32 splits give
    28 of 2)."""
    if wm not in (1, 2):
        raise ValueError(f"wm must be 1 or 2, got {wm}")
    m_tiles = -(-m // (128 * wm))
    n_tiles = -(-n // TC_BN)
    k_steps = max(1, -(-k // TC_BK))
    per = -(-k_steps // max(1, min(int(splits), k_steps)))
    return TcPlan(wm, m_tiles, n_tiles, k_steps, -(-k_steps // per), per)


def plan_tc(m: int, k: int, n: int, sms: int = _build.NUM_SMS) -> TcPlan:
    """The heuristic plan.  One CTA covers all rows up to M = 256 (BM 256
    above M = 128), so each weight element is read once; when the output
    tiles fill fewer than ``sms`` SMs, K is split into up to ``sms //
    tiles`` contiguous ranges of at least ``TC_MIN_STEPS_PER_SPLIT``
    steps."""
    wm = 1 if m <= 128 else 2
    tiles = -(-m // (128 * wm)) * -(-n // TC_BN)
    k_steps = max(1, -(-k // TC_BK))
    return tc_plan(m, k, n, wm, max(1, min(
        sms // tiles, k_steps // TC_MIN_STEPS_PER_SPLIT)))


def plan_split(m: int, k: int, n: int, sms: int = _build.NUM_SMS) -> TcPlan:
    """The split route's plan: 128-row tiles (three pieces of A and B for
    a 64-deep step fill 96 KB of shared memory, so a 256-row tile would
    leave one stage), K split as ``plan_tc`` splits it."""
    tiles = -(-m // 128) * -(-n // TC_BN)
    k_steps = max(1, -(-k // TC_BK))
    return tc_plan(m, k, n, 1, max(1, min(
        sms // tiles, k_steps // TC_MIN_STEPS_PER_SPLIT)))


def split_matmul_plain(a, b, *, out_dtype=torch.float32,
                       quant_fmt_name: Optional[str] = None,
                       plan: Optional[TcPlan] = None):
    """The split route's arithmetic in plain torch (for tests): the
    operands as multiplied, cut into the route's pieces, the kept piece
    products summed in f32 in the kernel's pair order (split by split over
    ``plan``'s K ranges, added in split order; a NaN sum of a split
    recomputed from the operands, as the kernel repairs it)."""
    sa, sb = a.to(torch.float32), b.to(torch.float32)
    if quant_fmt_name:
        sa = ref.tp_quantize_ref(sa, fmt_name=quant_fmt_name)
        sb = ref.tp_quantize_ref(sb, fmt_name=quant_fmt_name)
    pieces = split_pieces(a.dtype, quant_fmt_name)
    ranges = (plan.k_ranges(a.shape[1]) if plan is not None
              else [(0, a.shape[1])])
    total = None
    for lo, hi in ranges:
        part = split_product(torch.matmul, sa[:, lo:hi], sb[lo:hi], pieces,
                             pieces)
        total = part if total is None else total + part
    return total.to(out_dtype)


def _check(a, b, out_dtype):
    if a.device.type != "cuda":
        raise ValueError(f"the tp_matmul kernel needs CUDA tensors, got "
                         f"{a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} are "
                         f"not [M, K] and [K, N]")
    if a.dtype != b.dtype or a.dtype not in _OPERANDS:
        raise TypeError(f"operands {a.dtype}, {b.dtype}: need one dtype of "
                        f"{_OPERANDS}")
    if out_dtype not in _OUTPUTS:
        raise TypeError(f"out_dtype {out_dtype} is not one of {_OUTPUTS}")
    if b.device != a.device:
        raise ValueError("a and b must lie on one CUDA device")


def tp_matmul_tc(a, b, *, out_dtype=torch.float32,
                 quant_fmt_name: Optional[str] = None,
                 plan: Optional[TcPlan] = None):
    """The tensor-core variant (operands must route to a 16-bit tile), at
    ``plan`` (a ``tc_plan`` of this product; None: ``plan_tc``)."""
    _check(a, b, out_dtype)
    tile = tc_operand_dtype(a.dtype, quant_fmt_name)
    if tile is None:
        raise ValueError(f"{a.dtype} operands with grid {quant_fmt_name} are "
                         f"not exact in a 16-bit type")
    snap = (_build.grid_args(quant_fmt_name) if quant_fmt_name
            else _build.snap_args(None))
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if plan is None:
        plan = plan_tc(m, k, n)
    elif plan != tc_plan(m, k, n, plan.wm, plan.splits):
        raise ValueError(f"{plan} is not a plan of a [{m}, {k}] @ [{k}, {n}] "
                         f"product")
    ws = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                      device=a.device) if plan.splits > 1 else None)
    # TMA reads the operands as they are only when they already are the
    # tile type's values in rows of whole 16-byte units
    staged = (a.dtype != tile or bool(quant_fmt_name) or k % 8 or n % 8
              or a.data_ptr() % 16 or b.data_ptr() % 16)
    a16 = b16 = None
    if staged:
        a16 = torch.empty((m, -(-k // 8) * 8), dtype=tile, device=a.device)
        b16 = torch.empty((k, -(-n // 8) * 8), dtype=tile, device=a.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = _build.load("tp_matmul").tp_matmul_tc_launch
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(ws), ptr(a16),
             ptr(b16), m, k, n,
             _build.dtype_code(a.dtype), _build.dtype_code(out_dtype),
             int(tile == torch.bfloat16), *snap, plan.wm, plan.splits,
             plan.steps_per_split,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tp_matmul_tc")
    tp_matmul_cuda.launches_tc += 1
    tp_matmul_cuda.launches += 1
    by_plan = tp_matmul_cuda.launches_by_plan
    key = (plan.wm, plan.splits)
    by_plan[key] = by_plan.get(key, 0) + 1
    return out


def tp_matmul_split(a, b, *, out_dtype=torch.float32,
                    quant_fmt_name: Optional[str] = None,
                    plan: Optional[TcPlan] = None):
    """The split route (operands must route to it, ``matmul_route``), at
    ``plan`` (a ``tc_plan`` of this product with wm 1; None:
    ``plan_split``)."""
    _check(a, b, out_dtype)
    if matmul_route(a.dtype, quant_fmt_name) != "split":
        raise ValueError(f"{a.dtype} operands with grid {quant_fmt_name} do "
                         f"not take the split route")
    pieces = split_pieces(a.dtype, quant_fmt_name)
    snap = (_build.grid_args(quant_fmt_name) if quant_fmt_name
            else _build.snap_args(None))
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if plan is None:
        plan = plan_split(m, k, n)
    elif plan.wm != 1 or plan != tc_plan(m, k, n, 1, plan.splits):
        raise ValueError(f"{plan} is not a 128-row plan of a [{m}, {k}] @ "
                         f"[{k}, {n}] product")
    ws = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                      device=a.device) if plan.splits > 1 else None)
    a16 = torch.empty((pieces, m, -(-k // 8) * 8), dtype=torch.bfloat16,
                      device=a.device)
    b16 = torch.empty((pieces, k, -(-n // 8) * 8), dtype=torch.bfloat16,
                      device=a.device)
    fn = _build.load("tp_matmul").tp_matmul_split_launch
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None, a16.data_ptr(),
             b16.data_ptr(), m, k, n, _build.dtype_code(a.dtype),
             _build.dtype_code(out_dtype), pieces, *snap, plan.splits,
             plan.steps_per_split,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tp_matmul_split")
    tp_matmul_cuda.launches_split += 1
    tp_matmul_cuda.launches += 1
    by_plan = tp_matmul_cuda.launches_by_plan
    key = (plan.wm, plan.splits)
    by_plan[key] = by_plan.get(key, 0) + 1
    return out


def tp_matmul_fma(a, b, *, out_dtype=torch.float32,
                  quant_fmt_name: Optional[str] = None):
    """The f32-FMA variant (any operands the contract takes)."""
    _check(a, b, out_dtype)
    snap = (_build.grid_args(quant_fmt_name) if quant_fmt_name
            else _build.snap_args(None))
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _build.load("tp_matmul").tp_matmul_fma_launch
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
             _build.dtype_code(a.dtype), _build.dtype_code(out_dtype), *snap,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tp_matmul_fma")
    tp_matmul_cuda.launches_fma += 1
    tp_matmul_cuda.launches += 1
    return out


def tp_matmul_cuda(a, b, *, out_dtype=torch.float32,
                   quant_fmt_name: Optional[str] = None,
                   plan: Optional[TcPlan] = None):
    """``a [M, K] @ b [K, N]`` with f32 accumulation and an ``out_dtype``
    store; one launch per call, of the variant ``matmul_route`` picks
    (``plan``: the tensor-core variant's or the split route's tiles and K
    split, None: ``plan_tc`` / ``plan_split``; the FMA variant has none).
    Raises on tensors that do not lie on a CUDA device and on shapes or
    dtypes the kernels do not take."""
    _check(a, b, out_dtype)
    route = matmul_route(a.dtype, quant_fmt_name)
    if route == "tc":
        return tp_matmul_tc(a, b, out_dtype=out_dtype,
                            quant_fmt_name=quant_fmt_name, plan=plan)
    if route == "split":
        return tp_matmul_split(a, b, out_dtype=out_dtype,
                               quant_fmt_name=quant_fmt_name, plan=plan)
    return tp_matmul_fma(a, b, out_dtype=out_dtype,
                         quant_fmt_name=quant_fmt_name)


#: launches of the CUDA kernels, in all, by variant and, for the
#: tensor-core and split variants, by plan ``(wm, splits)`` (CPU calls and
#: plain-version calls add none)
tp_matmul_cuda.launches = 0
tp_matmul_cuda.launches_tc = 0
tp_matmul_cuda.launches_split = 0
tp_matmul_cuda.launches_fma = 0
tp_matmul_cuda.launches_by_plan = {}

_OUT_MANT = {torch.bfloat16: 7, torch.float16: 10}


def agreement_tol(a, b, got, want, quant_fmt_name: Optional[str] = None):
    """Elementwise bound on ``|kernel - plain|`` for one product: two f32
    sums of the same K products in different orders differ by at most
    ``2 K 2^-24 (|A| @ |B|)`` (A, B the operands as multiplied, snapped
    when ``quant_fmt_name`` is given), plus, for a bf16 / fp16 output, one
    ulp of that type at the larger of the two results (the two f32 sums may
    round to neighbouring outputs)."""
    sa, sb = a.to(torch.float32), b.to(torch.float32)
    if quant_fmt_name:
        sa = ref.tp_quantize_ref(sa, fmt_name=quant_fmt_name)
        sb = ref.tp_quantize_ref(sb, fmt_name=quant_fmt_name)
    tol = (2.0 * a.shape[1] * 2.0 ** -24) * (sa.abs() @ sb.abs())
    m = _OUT_MANT.get(got.dtype)
    if m is not None:
        mag = torch.maximum(got.float().abs(), want.float().abs())
        _, e = torch.frexp(mag)
        tol = tol + torch.ldexp(torch.ones_like(mag), e - 1 - m)
    return tol
