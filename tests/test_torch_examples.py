"""The example twins (``examples/torch_*.py``) and the serving launcher's
tooling flags, on the CPU at reduced sizes:

  * every twin's ``main`` runs with ``--device cpu``, imports no JAX
    package module, and prints what the JAX example prints (the H100's
    energy rows where JAX's printed the TPU's);
  * ``--decode-backend`` / ``--prefill-backend`` reach the model
    (``pallas`` is the kernel: refused on CPU tensors, as ``kernels.ops``
    refuses it), and ``--devices`` runs ``--mesh`` over a larger gloo world
    or raises JAX's "mesh needs n devices, have N" below dp x tp.
"""
import ast
import contextlib
import io
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
torch.set_num_threads(1)

TWINS = {
    "torch_quickstart": ([], "GEMM energy on the H100"),
    "torch_serve_decode": (["--batch", "2", "--prompt-len", "16", "--gen",
                            "6"], "generated ids (row 0)"),
    "torch_transprecision_training": (
        ["--steps", "3", "--seq-len", "16", "--global-batch", "2"],
        "H100 rows: NVIDIA H100 80GB HBM3, 700.00 W"),
    "torch_fault_tolerant_train": (
        ["--steps", "6", "--seq-len", "16", "--global-batch", "2"],
        "final weights BIT-IDENTICAL to the uninterrupted run"),
    "torch_precision_autotune": (["--seq-len", "16", "--global-batch", "2"],
                                 "modeled matmul-energy saving vs fp32 on "
                                 "the H100"),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_example_twin_runs_on_cpu(name):
    path = os.path.join(ROOT, "examples", name + ".py")
    tree = ast.parse(open(path).read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.split(".")[0] in ("jax", "repro") for m in mods)
    argv, want = TWINS[name]
    mod = __import__(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(["--device", "cpu"] + argv)
    assert want in out.getvalue()
    assert "nan" not in out.getvalue().lower().replace("nanosec", "")


def test_backend_flags_reach_the_model(monkeypatch):
    seen = {}
    real = serve.build_model

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(serve, "build_model", spy)
    base = ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
            "3"]
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(base + ["--decode-backend", "plain", "--prefill-backend",
                           "dense"])
    assert seen["decode_backend"] == "plain"
    assert seen["prefill_backend"] == "dense"
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(base)
    assert seen["decode_backend"] == seen["prefill_backend"] == "auto"
    # pallas is JAX's name for the kernel: on CPU tensors it is refused
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(base + ["--decode-backend", "pallas"])
    assert seen["decode_backend"] == "kernel"
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            serve.main(base + ["--decode-backend", "flash"])


def test_devices_flag(capfd):
    base = ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
            "3", "--mesh", "1,2"]
    with pytest.raises(ValueError, match=r"mesh \(1, 2\) needs 2 devices, "
                                         r"have 1"):
        serve.main(base + ["--devices", "1"])
    got = serve.main(base + ["--devices", "3"])     # the ranks print
    assert "2-way tensor parallel over 3 ranks (gloo)" in capfd.readouterr().out
    assert tuple(got.shape) == (2, 3)
