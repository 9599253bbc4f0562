"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C entry point, loaded through ``ctypes`` (no PyTorch
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
KERNELS = ("decode_attention", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

_VOIDP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    "decode_attention": [_VOIDP] * 7 + [_INT] * 16 + [_FLOAT, _INT, _FLOAT,
                                                      _VOIDP],
    "flash_attention": [_VOIDP] * 6 + [_INT] * 16 + [_FLOAT, _FLOAT, _VOIDP],
}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
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
        out = _target(name)
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
        path = _target(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float8_e5m2": 3}
SRC_KINDS = {"float32": 0, "bfloat16": 1, "float16": 2}


def dtype_code(dt) -> int:
    name = str(dt).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"the CUDA attention kernels do not take {dt}")
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


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
