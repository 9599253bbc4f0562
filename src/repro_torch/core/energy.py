"""Energy model: the paper's GF22FDX silicon measurements, and the
H100's energy per operation and per byte as measured on the card.

The FPnew silicon model is the JAX package's ``repro.core.energy``,
verbatim (the paper's own measurements, not any accelerator's):

  * :data:`FMA_PJ_PER_FLOP` — Table IV, measured pJ/flop of the FMA per
    format, scalar and SIMD (whole-FPU energy at 0.8 V, 923 MHz, 22FDX).
  * :data:`OP_ENERGY_PJ` — Fig 7 per-instruction energies (FMA anchor values
    are exact from Table IV; mul/add/comparison anchors estimated from the
    bar chart, chained with the relative gains quoted in §IV.B.3b).
  * :class:`DVFSModel` — Fig 8's voltage/frequency scaling, an alpha-power
    CV²f + leakage model fitted to the published (perf, efficiency) extremes.
  * :class:`CoreModel` — Ariane/RI5CY core-level overheads (Fig 9,
    §IV.A.2) used by the Table III case-study reproduction.

The device rows (``H100_PJ_PER_FLOP``, ``H100_PJ_PER_HBM_BYTE``,
``H100_IDLE_W``) take the place of JAX's TPU rows: ``chip_smoke.py``'s
energy leg runs a GEMM loop per format and a device-to-device copy for at
least 3 s each while ``nvidia-smi`` samples the board's power every
100 ms, and each row is the mean power over the rate (W / (flop/s), W /
(B/s)), idle power included.  :func:`step_energy_joules` maps a step's
counted flops (``launch.dryrun``) and bytes onto joules with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .formats import get_format

# ---------------------------------------------------------------------------
# Table IV — measured energy per flop (pJ), whole TP-FPU, 0.8 V, 923 MHz.
# FMA = 2 flops.  keys: (format, simd?)
# ---------------------------------------------------------------------------
FMA_PJ_PER_FLOP: Dict[tuple, float] = {
    ("fp64", False): 13.36,
    ("fp32", False): 4.72,
    ("fp16", False): 2.48,
    ("fp16alt", False): 2.18,
    ("fp8", False): 1.27,
    ("fp32", True): 5.01,
    ("fp16", True): 2.01,
    ("fp16alt", True): 1.72,
    ("fp8", True): 0.80,
}

#: Table IV — throughput in FMA-ops/cycle (SIMD lane counts) and latency.
FMA_LANES = {("fp64", False): 1, ("fp32", False): 1, ("fp16", False): 1,
             ("fp16alt", False): 1, ("fp8", False): 1,
             ("fp32", True): 2, ("fp16", True): 4, ("fp16alt", True): 4,
             ("fp8", True): 8}
FMA_LATENCY = {"fp64": 4, "fp32": 3, "fp16": 3, "fp16alt": 3, "fp8": 2}

NOMINAL_FREQ_HZ = 923e6      # measured nominal (0.8 V, 25C)
NOMINAL_VDD = 0.8

# ---------------------------------------------------------------------------
# Fig 7 — per-instruction FPU energy (pJ).  FMA values derived exactly from
# Table IV (pJ/flop * 2 flops [* lanes for SIMD]); mul/add/cmp anchors are
# estimated from the figure and chained with the quoted relative gains:
#   mul:  65/47/52/47 % cheaper per next-smaller format (from FP64)
#   add:  53/47/57/47 %
#   cmp:  38/34/35/22 %
# ---------------------------------------------------------------------------
def _chain(anchor: float, gains) -> list:
    vals = [anchor]
    for g in gains:
        vals.append(vals[-1] * (1.0 - g))
    return vals


_FMTS = ["fp64", "fp32", "fp16", "fp16alt", "fp8"]
# NB: gains for fp16alt are quoted w.r.t. fp32 (the "next larger" format),
# not w.r.t. fp16 — build fp16 and fp16alt both from fp32.
def _chain_tree(anchor, g32, g16, g16a, g8):
    v64 = anchor
    v32 = v64 * (1 - g32)
    v16 = v32 * (1 - g16)
    v16a = v32 * (1 - g16a)
    v8 = v16 * (1 - g8)
    return {"fp64": v64, "fp32": v32, "fp16": v16, "fp16alt": v16a, "fp8": v8}


OP_ENERGY_PJ = {
    # scalar FMA (exact, Table IV)
    ("fma", False): {f: FMA_PJ_PER_FLOP[(f, False)] * 2 for f in _FMTS},
    # SIMD FMA per instruction (pJ/flop * 2 * lanes)
    ("fma", True): {f: FMA_PJ_PER_FLOP[(f, True)] * 2 * FMA_LANES[(f, True)]
                    for f in _FMTS if (f, True) in FMA_PJ_PER_FLOP},
    # scalar mul/add/cmp (anchor estimated from Fig 7 bar chart)
    ("mul", False): _chain_tree(19.5, 0.65, 0.47, 0.52, 0.47),   # estimated
    ("add", False): _chain_tree(11.0, 0.53, 0.47, 0.57, 0.47),   # estimated
    ("cmp", False): _chain_tree(2.9, 0.38, 0.34, 0.35, 0.22),    # estimated
}

# Scalar FP-FP conversion energies, §IV.B.3b: 7.0 pJ for fp64<->fp32; the
# halved-width chain is 30 % / 35 % cheaper per step.
CONV_SCALAR_PJ = {("fp64", "fp32"): 7.0,
                  ("fp32", "fp16"): 7.0 * 0.70,
                  ("fp16", "fp8"): 7.0 * 0.70 * 0.65}
#: vectorial casts per instruction, §IV.B.3b ("2.2 pJ to 4.9 pJ per datum")
CONV_VEC_PJ = {("fp32", "fp16"): 4.9, ("fp16", "fp8"): 4.9 * 0.905}
#: cast-and-pack of two scalars: ~1.3x one scalar conversion (§IV.B.3b)
CASTPACK_FACTOR = 1.3


def conv_energy_pj(src, dst, simd: bool = False) -> float:
    s, d = get_format(src).name, get_format(dst).name
    s, d = ("fp16" if s == "fp16alt" else s), ("fp16" if d == "fp16alt" else d)
    table = CONV_VEC_PJ if simd else CONV_SCALAR_PJ
    key = (s, d) if (s, d) in table else (d, s)
    if key in table:
        return table[key]
    # multi-step conversions: sum the chain (worst case estimate)
    order = ["fp64", "fp32", "fp16", "fp8"]
    i, j = sorted((order.index(s), order.index(d)))
    return sum(table.get((order[k], order[k + 1]),
                         list(table.values())[0]) for k in range(i, j))


def fma_energy_pj(fmt, simd: bool = False) -> float:
    """Per-instruction FMA energy (whole FPU), Table IV exact."""
    f = get_format(fmt).name
    per_flop = FMA_PJ_PER_FLOP[(f, simd)]
    lanes = FMA_LANES[(f, simd)]
    return per_flop * 2 * lanes


def fma_perf_gflops(fmt, simd: bool = False,
                    freq_hz: float = NOMINAL_FREQ_HZ) -> float:
    """Table IV performance column: 2 flops * lanes * f."""
    return 2 * FMA_LANES[(get_format(fmt).name, simd)] * freq_hz / 1e9


def fma_efficiency_gflops_w(fmt, simd: bool = False) -> float:
    """Table IV efficiency column: 1e3/pJ-per-flop = Gflop/sW."""
    return 1000.0 / FMA_PJ_PER_FLOP[(get_format(fmt).name, simd)]


# ---------------------------------------------------------------------------
# Fig 8 — DVFS model.  f_max(V) linear through the two published frequency
# points; per-op energy = dynamic (V^2-scaled, anchored so that the TOTAL at
# 0.8 V equals the measured pJ/flop) + leakage/op (leakage power / flop
# rate).  Published anchors:
#   0.8 V  -> 923 MHz,  FP64 FMA eff 74.83 Gflop/sW
#   1.2 V  -> 1585 MHz  (3.17 Gflop/s FP64 peak perf)
#   ~0.45 V -> peak eff 178 Gflop/sW FP64; 2.95 Tflop/sW FP8 SIMD
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DVFSModel:
    v_t: float = 0.2423        # from the two (V, f) anchors
    f_slope_hz_per_v: float = 1.655e9  # f_max(V) = slope * (V - v_t)
    leak_w_at_08: float = 3.5e-3
    leak_exp: float = 1.5      # leakage ~ (V/0.8)^exp (FD-SOI, weak body bias)

    def f_max(self, v: float) -> float:
        return max(self.f_slope_hz_per_v * (v - self.v_t), 1e6)

    def perf_gflops(self, v: float, lanes: int = 1) -> float:
        return 2 * lanes * self.f_max(v) / 1e9

    def efficiency_gflops_w(self, v: float, lanes: int = 1,
                            pj_per_flop_nominal: float = 13.36) -> float:
        flop_rate = 2 * lanes * self.f_max(v)
        leak_per_flop_08 = self.leak_w_at_08 / (2 * lanes *
                                                self.f_max(NOMINAL_VDD))
        e_dyn0 = (pj_per_flop_nominal * 1e-12 - leak_per_flop_08)
        e_dyn = e_dyn0 * (v / NOMINAL_VDD) ** 2
        e_leak = (self.leak_w_at_08 * (v / 0.8) ** self.leak_exp) / flop_rate
        return 1e-9 / (e_dyn + e_leak)


# ---------------------------------------------------------------------------
# Core-level model (Ariane, Fig 9): during an FP64 FMA the FPU is 39 % of
# core energy -> ~41.8 pJ/instruction of non-FPU core overhead, amortized
# over SIMD lanes for vector instructions.
# ---------------------------------------------------------------------------
ARIANE_CORE_OVERHEAD_PJ = 26.7 / 0.39 - 26.7  # = 41.77 pJ / instruction

# ---------------------------------------------------------------------------
# RI5CY merged-slice energies (pJ/op) for the Table III case study.
# The RI5CY TP-FPU uses MERGED ADDMUL and CONV slices (Table I): narrow
# formats reuse the fp32-wide datapath, so fp16 ops cost nearly as much as
# fp32 ops (the very effect that makes variant c of Fig 11 a net LOSS) and
# conversions are cheap.  fma_fp32 = 3.9 pJ is the paper's measured value
# (§IV.A.2); the others are fitted once against Table III's published
# relative energies and kept fixed.
# ---------------------------------------------------------------------------
RI5CY_MERGED_PJ = {
    "fma_fp32": 3.9,      # measured, §IV.A.2
    "fma_fp16": 3.3,      # merged slice: ~85% of fp32
    "fmacex": 3.5,        # fp16 mul + fp32 acc in the merged FMA
    "mul_fp16": 4.6,      # merged multiplier, fp16 operands (Table III's c)
    "add_fp32": 2.6,
    "cvt": 0.8,           # merged CONV, 32-bit datapath
    "vfmul_fp16": 9.5,    # 2-lane SIMD mul in the merged slice
}
RI5CY_CORE_PJ = {
    "overhead_per_instr": 1.9,   # decode/regfile/pipeline
    "load_extra": 0.4,           # lh/lw datapath cost in-core
    "mem_extra": 2.0,            # system-level memory access adder
    "background_per_instr": 12.7,  # SoC static+clock per cycle (system)
}


@dataclasses.dataclass(frozen=True)
class CoreModel:
    """Per-instruction core+system energy: E = n_instr * (overhead + fpu_op).

    Used by the Table III case-study reproduction (RI5CY-class core);
    overheads are fitted there against the published relative energies.
    """
    core_overhead_pj: float = 3.3      # non-FPU core energy / instruction
    mem_pj: float = 4.0                # extra energy of a load/store at system level
    fpu_scale: float = 1.0             # RI5CY FPU energy scale vs Ariane table

    def instr_energy(self, kind: str, fmt: str, simd: bool = False,
                     system: bool = False) -> float:
        base = self.core_overhead_pj
        if kind in ("lh", "lw", "load", "store"):
            return base + (self.mem_pj if system else 0.0)
        if kind == "fma":
            e = fma_energy_pj(fmt, simd)
        elif kind in ("mul", "add", "cmp"):
            e = OP_ENERGY_PJ[(kind, False)][get_format(fmt).name]
            if simd:
                lanes = FMA_LANES[(get_format(fmt).name, True)]
                e = e * lanes * 0.85  # SIMD amortization, Fig 7 right
        elif kind == "cvt":
            e = conv_energy_pj("fp32", fmt, simd)
        elif kind == "castpack":
            e = conv_energy_pj("fp32", fmt, False) * CASTPACK_FACTOR
        else:
            raise KeyError(kind)
        return base + self.fpu_scale * e


# ---------------------------------------------------------------------------
# The H100's rows (``chip_smoke.energy_phase`` on NVIDIA H100 80GB HBM3,
# power limit 700.00 W): board power above idle over the achieved rate,
# pJ per flop of a GEMM loop per format (fp32 on CUDA cores with TF32
# off; bf16, fp16 and fp8 on tensor cores, fp8 through
# ``torch._scaled_mm``) and pJ per byte moved by a device-to-device copy
# (read + write).  These are the dynamic rows: ``H100_IDLE_W``, the board
# at rest before the loops, is kept apart, so a step is charged for the
# board once (``step_energy_joules(seconds=)``), not once per row.  The
# byte row is the whole card's extra power while it copies (SMs, caches
# and HBM together), not a DRAM access energy.
# ---------------------------------------------------------------------------
# (the run read 50.97 / 674.4 / 648.5 / 1220 TFLOP/s at 698.6 / 697.9 /
# 698.6 / 697.0 W, and 3.039 TB/s at 410.7 W for the copy, idle 120.05 W)
H100_PJ_PER_FLOP = {
    "fp32": 11.349536243909764,
    "fp16alt": 0.8568332960573836,
    "fp16": 0.892225174576938,
    "fp8": 0.4730342502140646,
}
H100_PJ_PER_HBM_BYTE = 95.64054641116677
H100_IDLE_W = 120.05
H100_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def step_energy_joules(flops_by_fmt: Dict[str, float], hbm_bytes: float,
                       link_bytes: float = 0.0, *,
                       seconds: float = 0.0) -> float:
    """Joules of a step on the H100: ``flops_by_fmt`` (format -> flops) at
    the format's measured pJ/flop above idle, plus ``hbm_bytes`` at the
    copy's pJ/byte above idle, plus the board's idle power over the step's
    ``seconds`` (0: the dynamic energy alone).  The rows are each measured
    alone at full rate, so a step that computes and moves bytes at once is
    charged their sum, an upper bound on the dynamic part.  ``link_bytes``
    must be 0: no link energy has been measured (the machine that measured
    these rows has one card)."""
    if link_bytes:
        raise ValueError(
            "step_energy_joules: no link energy has been measured (the "
            "rows come from a one-card machine); pass link_bytes=0")
    e = sum(H100_PJ_PER_FLOP[get_format(f).name] * n
            for f, n in flops_by_fmt.items())
    e += H100_PJ_PER_HBM_BYTE * hbm_bytes
    return e * 1e-12 + H100_IDLE_W * seconds
