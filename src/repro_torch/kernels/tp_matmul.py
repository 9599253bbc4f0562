"""Multi-format (expanding-FMA) matmul — FPnew's merged multi-format FMA
slice as a GEMM.

``tp_matmul_cuda`` is the port of the TPU kernel
``repro.kernels.tp_matmul.tp_matmul_pallas``: hand-written CUDA kernels
(``csrc/tp_matmul.cu``, sm_90a) for tensors on the card, in two variants
chosen by ``tc_operand_dtype`` alone:

  ``tp_matmul_tc``   wgmma tiles fed by TMA (after a staging pass into
                     16-bit copies where the operands need one), for every
                     product whose operands as multiplied are exact in bf16
                     or fp16;
  ``tp_matmul_fma``  the first, f32-FMA version, for the rest (f32 without a
                     grid, tf32 and other grids wider than 16 bits).

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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build
from . import ref
from .quant_common import exact_tile_dtype

_OPERANDS = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e5m2)
_OUTPUTS = (torch.float32, torch.bfloat16, torch.float16)


def tp_matmul_plain(a, b, *, out_dtype=torch.float32,
                    quant_fmt_name: Optional[str] = None,
                    bk: Optional[int] = None):
    """The kernel's function in plain torch; ``bk`` fixes the K-block
    summation schedule (None: one block)."""
    return ref.tp_matmul_ref(a, b, out_dtype=out_dtype,
                             quant_fmt_name=quant_fmt_name, bk=bk)


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


def plan_tc(m: int, k: int, n: int, sms: int = _build.NUM_SMS) -> TcPlan:
    """One CTA covers all rows up to M = 256 (BM 256 above M = 128), so
    each weight element is read once; when the output tiles fill fewer
    than ``sms`` SMs, K is split into up to ``sms // tiles`` contiguous
    ranges of at least ``TC_MIN_STEPS_PER_SPLIT`` steps."""
    wm = 1 if m <= 128 else 2
    m_tiles = -(-m // (128 * wm))
    n_tiles = -(-n // TC_BN)
    k_steps = max(1, -(-k // TC_BK))
    tiles = m_tiles * n_tiles
    splits = max(1, min(sms // tiles, k_steps // TC_MIN_STEPS_PER_SPLIT))
    per = -(-k_steps // splits)
    return TcPlan(wm, m_tiles, n_tiles, k_steps, -(-k_steps // per), per)


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
                 quant_fmt_name: Optional[str] = None):
    """The tensor-core variant (operands must route to a 16-bit tile)."""
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
    plan = plan_tc(m, k, n)
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
                   quant_fmt_name: Optional[str] = None):
    """``a [M, K] @ b [K, N]`` with f32 accumulation and an ``out_dtype``
    store; one launch per call, of the variant ``tc_operand_dtype`` picks.
    Raises on tensors that do not lie on a CUDA device and on shapes or
    dtypes the kernels do not take."""
    _check(a, b, out_dtype)
    fn = (tp_matmul_tc if tc_operand_dtype(a.dtype, quant_fmt_name)
          is not None else tp_matmul_fma)
    return fn(a, b, out_dtype=out_dtype, quant_fmt_name=quant_fmt_name)


#: launches of the CUDA kernels, in all and by variant (CPU calls and
#: plain-version calls add none)
tp_matmul_cuda.launches = 0
tp_matmul_cuda.launches_tc = 0
tp_matmul_cuda.launches_fma = 0

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
