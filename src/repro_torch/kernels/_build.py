"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with plain C entry points, loaded through ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes).  Libraries land in the
git-ignored ``build/`` directory beside this module, named by a digest of
the sources and flags, so an edited source rebuilds and an unchanged one
loads as is.  ``build_all`` starts one ``nvcc`` per missing library, all
at once, and waits for them together.  Nothing here runs at import time:
this module is imported on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from ..core.formats import get_format

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("decode_attention", "flash_attention", "tp_matmul", "tp_quant",
           "dotp_ex")
#: streaming multiprocessors of the target card (H100 SXM), for the
#: kernels' host-side tile planning
NUM_SMS = 132
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
#: library -> {C entry point: argtypes}; every pointer and the stream are
#: ``c_void_p``, and every entry point returns an int (a cudaError_t)
ARGTYPES = {
    "decode_attention": {"decode_attention_launch":
                         [_VOIDP] * 7 + [_INT] * 18
                         + [_FLOAT, _INT, _FLOAT, _VOIDP]},
    "flash_attention": {"flash_attention_fma_launch":
                        [_VOIDP] * 6 + [_INT] * 16 + [_FLOAT, _FLOAT, _VOIDP],
                        "flash_attention_tc_launch":
                        [_VOIDP] * 6 + [_INT] * 18 + [_FLOAT, _FLOAT, _VOIDP]},
    "tp_matmul": {"tp_matmul_fma_launch": [_VOIDP] * 3 + [_INT] * 8 + [_VOIDP],
                  "tp_matmul_tc_launch": [_VOIDP] * 6 + [_INT] * 12
                  + [_VOIDP]},
    "tp_quant": {"tp_quantize_launch": [_VOIDP] * 3 + [_LL] + [_INT] * 5
                 + [_VOIDP],
                 "cast_and_pack_launch": [_VOIDP] * 4 + [_LL] + [_INT] * 5
                 + [_VOIDP]},
    "dotp_ex": {"dotp_ex_launch": [_VOIDP] * 4 + [_LL, _INT, _INT, _VOIDP],
                "dotp_ex_max_blocks": []},
}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.name == f"{name}.cu" or src.suffix == ".cuh":
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel; raise with nvcc's output if any build fails.  Returns
    name -> {"seconds": wall time until its build ended (0.0 when it was
    built already), "log": nvcc's output (registers, shared memory,
    spills)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in ARGTYPES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float8_e5m2": 3}
SRC_KINDS = {"float32": 0, "bfloat16": 1, "float16": 2}


def dtype_code(dt) -> int:
    name = str(dt).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels do not take {dt}")
    return DTYPE_CODES[name]


def src_kind(dt) -> int:
    name = str(dt).replace("torch.", "")
    if name not in SRC_KINDS:
        raise TypeError(f"src dtype {dt} is not f32 / bf16 / fp16")
    return SRC_KINDS[name]


def snap_args(fmt_name):
    """(m_bits, emax, emin) of an emulated storage grid, zeros for none."""
    if not fmt_name:
        return (0, 0, 0)
    f = get_format(fmt_name)
    return (f.m_bits, f.emax, f.emin)


def grid_args(fmt_name):
    """``snap_args`` of a grid the in-kernel snap can take: one that fits an
    f32 container (e_bits <= 8, 1 <= m_bits < 23); raises otherwise."""
    f = get_format(fmt_name)
    if f.e_bits > 8 or not 1 <= f.m_bits < 23:
        raise ValueError(f"{f}: the in-kernel snap needs a grid inside f32 "
                         f"(e_bits <= 8, 1 <= m_bits < 23)")
    return snap_args(f)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
