"""Boundaries of the port: ``repro_torch`` imports neither JAX nor the JAX
package, runs on the GPU unless the caller asks for the CPU, and counts a
kernel launch only where a CUDA kernel really launched."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.dotp_ex import dotp_ex_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.tp_matmul import tp_matmul_cuda  # noqa: E402
from repro_torch.kernels.tp_quant import (  # noqa: E402
    cast_and_pack_cuda, tp_quantize_cuda)

torch.set_num_threads(1)

PKG = pathlib.Path(repro_torch.__file__).resolve().parent
MODULES = sorted(PKG.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(PKG).parts) - 1
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0, depth
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level, depth


def test_no_module_imports_jax_or_the_jax_package():
    assert len(MODULES) > 20
    for mod in (("train", "fault.py"), ("train", "loop.py"),
                ("train", "train_step.py"), ("optim", "optimizer.py"),
                ("ckpt", "checkpoint.py"), ("data", "pipeline.py"),
                ("launch", "train.py"), ("core", "tree.py"),
                ("configs", "fpnew_case_study.py")):
        assert PKG.joinpath(*mod) in MODULES, mod
    for path in MODULES:
        for name, level, depth in _imports(path):
            top = name.split(".")[0]
            if level == 0:
                assert top not in ("jax", "jaxlib", "repro", "flax",
                                   "ml_dtypes"), (path, name)
            else:
                # relative imports stay inside repro_torch
                assert level <= depth + 1, (path, name, level)


def test_package_imports_with_jax_blocked():
    names = [".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("")
                      .parts).replace(".__init__", "") for p in MODULES]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    src = str(PKG.parent)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240,
                       env={**os.environ, "PYTHONPATH": src})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_without_device_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    from repro_torch.launch import serve, train
    from repro_torch.models.convert import from_jax_params, from_jax_state
    from repro_torch.models.registry import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("gemma2-9b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"pattern": [], "embed": None, "norm_f": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--continuous"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_state({"params": {}, "opt": {"step": 0}})


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """The wrappers of ``kernels.ops`` take the plain version on CPU
    tensors; the kernels' launch functions refuse them and count nothing."""
    decode_attention_cuda.launches = flash_attention_cuda.launches = 0
    decode_attention_cuda.launches_by_cluster.clear()
    q = torch.randn(1, 4, 1, 16).to(torch.bfloat16)
    k = torch.randn(1, 2, 32, 16).to(torch.bfloat16)
    out = kops.decode_attention(q, k, k, kv_len=torch.tensor([5]))
    assert out.shape == (1, 4, 1, 16) and torch.isfinite(out).all()
    out = kops.flash_attention(torch.randn(1, 4, 8, 16).to(torch.bfloat16), k,
                               k, kv_len=torch.tensor([8]))
    assert out.shape == (1, 4, 8, 16) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[0].reshape(2, 2, 16), k[0], k[0],
                              torch.tensor([32, 5]))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(torch.randn(4, 8, 16).to(torch.bfloat16), k[0],
                             k[0], torch.tensor([8, 8, 5, 5]), group=2)
    assert decode_attention_cuda.launches == 0
    assert decode_attention_cuda.launches_by_cluster == {}
    assert flash_attention_cuda.launches == 0
    # the op path: the same rule for its four wrappers and their launchers
    op_kernels = (tp_matmul_cuda, tp_quantize_cuda, cast_and_pack_cuda,
                  dotp_ex_cuda)
    for fn in op_kernels:
        fn.launches = 0
    x, w = torch.randn(6, 10), torch.randn(10, 12)
    assert kops.tp_matmul(x, w, policy="em_fp8").shape == (6, 12)
    assert kops.tp_quantize(w, fmt="fp8").shape == (10, 12)
    assert kops.cast_and_pack(w, w, fmt="fp8").shape == (10, 24)
    assert torch.isfinite(kops.dotp_ex(w.reshape(-1), w.reshape(-1)))
    with pytest.raises(ValueError, match="CUDA"):
        tp_matmul_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tp_quantize_cuda(w, fmt_name="fp8")
    with pytest.raises(ValueError, match="CUDA"):
        cast_and_pack_cuda(w, w, fmt_name="fp8")
    with pytest.raises(ValueError, match="CUDA"):
        dotp_ex_cuda(w.reshape(-1), w.reshape(-1))
    assert [fn.launches for fn in op_kernels] == [0, 0, 0, 0]


def test_backend_resolution():
    assert kops.resolve_backend("auto", "cpu") == "plain"
    assert kops.resolve_backend("auto", "cuda") == "kernel"
    assert kops.resolve_backend("plain", "cuda") == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        kops.resolve_backend("kernel", "cpu")
    with pytest.raises(ValueError):
        kops.resolve_backend("pallas", "cpu")
    q = torch.randn(1, 4, 1, 16)
    k = torch.randn(1, 2, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kops.decode_attention(q, k, k, kv_len=8, backend="kernel")


def _c_params(src: str, entry: str):
    """The parameter types of ``extern "C" int entry(...)`` in a CUDA
    source, in order ("ptr" for pointers, else the type's last word)."""
    import re
    m = re.search(r'extern "C" int ' + entry + r'\((.*?)\)\s*\{', src,
                  re.S)
    assert m, entry
    kinds = []
    for p in m.group(1).split(","):
        p = p.strip()
        if not p:
            continue
        kinds.append("ptr" if "*" in p else p.split()[-2])
    return kinds


def test_ctypes_argtypes_match_the_c_entry_points():
    """Every entry point's ``ARGTYPES`` list has the C function's arity and
    types (a mismatch passes wrong values without any error from ctypes
    when the list is longer, and raises only on the card when shorter)."""
    import ctypes
    from repro_torch.kernels import _build
    names = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float", ctypes.c_longlong: "long"}
    for lib, entries in _build.ARGTYPES.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for entry, argtypes in entries.items():
            assert [names[a] for a in argtypes] == _c_params(src, entry), \
                (lib, entry)
