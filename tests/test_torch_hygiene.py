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
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402

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
    from repro_torch.launch import serve
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.registry import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("gemma2-9b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"pattern": [], "embed": None, "norm_f": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--continuous"])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """The wrappers of ``kernels.ops`` take the plain version on CPU
    tensors; the kernels' launch functions refuse them and count nothing."""
    decode_attention_cuda.launches = flash_attention_cuda.launches = 0
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
    assert flash_attention_cuda.launches == 0


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
