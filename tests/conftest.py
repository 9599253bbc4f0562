"""Shared fixtures for the tier-1 suite.

``cached_model`` is the session-scoped (arch, policy, cfg) -> (model,
params) table: the engine/paged/sharded/speculative suites all serve the
same reduced archs, and re-running ``build_model(...).init(...)`` per
module was pure wall-clock waste.  Params are treated as IMMUTABLE by
every consumer — engines ``device_put`` their own copies for tensor
parallelism and only donate *cache* operands, ``generate``/``*_burst``
never alias params — so sharing one pytree across tests is safe.

Import the helpers directly (``from conftest import cached_model``):
pytest puts this directory on ``sys.path`` (no ``__init__.py``), and a
plain function composes with each suite's existing ``_setup(**cfg)``
idiom better than a fixture-only surface would.  The fixture wrappers
exist for suites that prefer declarative injection.
"""
import jax
import jax.numpy as jnp
import pytest

#: the house ragged-batch lengths (rows at 1/4, 5/8, full prompt width)
LENS = [8, 20, 32]

_MODELS = {}


def cached_model(arch="gemma2-9b", policy="tp_bf16", **cfg):
    """Session-cached ``(model, params)`` for a reduced arch, with any
    ``with_cfg`` overrides folded into the cache key.  Weights always
    come from ``jax.random.key(0)`` — the seed every suite already
    used — so hoisting changes no test's numbers."""
    key = (arch, policy, tuple(sorted(cfg.items())))
    if key not in _MODELS:
        from repro.models.registry import build_model
        model = build_model(arch, policy=policy, reduced=True)
        if cfg:
            model = model.with_cfg(**cfg)
        _MODELS[key] = (model, model.init(jax.random.key(0)))
    return _MODELS[key]


def small_batch(vocab, n=3, width=32):
    """The house prompt pack: ``[n, width]`` tokens from key(1) plus the
    ragged ``LENS`` lengths (cycled when ``n != 3``)."""
    toks = jax.random.randint(jax.random.key(1), (n, width), 0, vocab)
    lens = [LENS[i % len(LENS)] for i in range(n)]
    return toks, jnp.asarray(lens, jnp.int32)


@pytest.fixture(scope="session")
def model_factory():
    """Fixture flavor of ``cached_model`` for declarative injection."""
    return cached_model


@pytest.fixture(scope="session")
def engine_model():
    """The continuous-engine house model: reduced gemma2 over a paged
    16-token-page pool (what every engine suite builds first)."""
    return cached_model("gemma2-9b", paged_kv=True, page_size=16)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skips "
        "without one")
