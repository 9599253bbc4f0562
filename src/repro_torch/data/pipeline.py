"""Deterministic, shard-aware synthetic LM data, the JAX package's
``data/pipeline.py`` with numpy draws.

A batch is a pure function of (seed, step, host index), so a restart
regenerates any batch bit for bit, and each host materialises only its
slice of the global batch.  Each sequence is an arithmetic token
progression ``t_{i+1} = (t_i + delta) mod V`` with a start and a stride
drawn per sequence and a ``noise`` fraction of positions replaced by
random tokens: a model must infer the stride in context, so the loss
drops fast but not to zero.

The draws come from ``numpy.random.default_rng([seed, step, host])``;
JAX's threefry stream cannot be matched, so the tokens differ from the
JAX package's (the semantics do not).  With a frontend (``"patch"`` for
internvl2, ``"audio"`` for whisper) a batch also holds
``frontend_embeds``, standard normal f32 [local_batch,
n_frontend_tokens, d_model] from the same generator, after the tokens."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    max_stride: int = 16
    noise: float = 0.02          # fraction of corrupted positions
    frontend: Optional[str] = None       # "patch" | "audio" stubs
    n_frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLMData:
    """Iterator over ``{"tokens", "labels"[, "frontend_embeds"]}`` batches
    of CPU tensors (int32 [local_batch, seq_len]; the frontend's f32);
    ``host_index`` / ``host_count`` select this host's slice of the global
    batch."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.frontend not in (None, "patch", "audio"):
            raise ValueError(f"frontend must be patch|audio, got "
                             f"{cfg.frontend!r}")
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.step = 0

    # -- deterministic batch construction ---------------------------------
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, step, self.host_index])
        b, s = self.local_batch, cfg.seq_len
        start = rng.integers(0, cfg.vocab, (b, 1))
        stride = rng.integers(1, cfg.max_stride + 1, (b, 1))
        seq = (start + stride * np.arange(s + 1)[None, :]) % cfg.vocab
        if cfg.noise > 0:
            corrupt = rng.random(seq.shape) < cfg.noise
            rand_tok = rng.integers(0, cfg.vocab, seq.shape)
            seq = np.where(corrupt, rand_tok, seq)
        seq = torch.from_numpy(seq.astype(np.int32))
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if cfg.frontend is not None:
            batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32))
        return batch

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- checkpointable state ----------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict):
        self.step = int(state["step"])
