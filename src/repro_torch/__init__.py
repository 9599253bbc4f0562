"""repro_torch — the PyTorch / CUDA port of the ``repro`` package.

The same subpackage and module names as ``src/repro/`` so each piece has an
obvious counterpart; the JAX package stays the reference the port is held
against.  This package imports ``torch`` and never ``jax`` or ``repro``.
"""
