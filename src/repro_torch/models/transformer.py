"""The model: embedding -> a stack of attention + SwiGLU layers -> final
norm -> tied unembedding, with the entry points the serving engine drives:

  ``prefill``        [B, S] tokens -> (last-live-token logits, caches)
  ``decode_step``    one token per row + caches -> (logits, caches)
  ``prefill_chunk``  one prompt chunk into existing paged caches
  ``decode_round``   one greedy decode round over every batch slot
  ``decode_burst``   a Python loop of rounds with the JAX package's exit
                     rules (all rows done, ``n_max`` rounds, or the
                     ``exit_on_finish``-th finish since entry)

Parameters are a plain dict of tensors in the JAX layout (``[d_in,
d_out]``) with the layers UNSTACKED: ``params["layers"][i]`` is layer
``i`` of ``cfg.layer_list()``.  Caches are a list with one entry per
layer, updated IN PLACE.  Attention-only (gqa + swiglu) archs, greedy
decoding; sampling, penalties, non-finite guards and speculative decoding
are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import LayerSpec, ModelConfig
from ..core.policy import PrecisionPolicy
from . import attention as attn
from . import paged
from .layers import (embed_init, mlp_params, param_dtype, rmsnorm, softcap,
                     swiglu)
from ..core import ops as tp

F32 = torch.float32

#: embeddings are padded to a multiple of this; the pad tail is masked
VOCAB_PAD = 256


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def sample_token(lg, *, temperature: float = 0.0, top_k=None, top_p=None):
    """Greedy argmax over logits [B, V] -> [B] int32 (first maximum on
    ties).  Sampling (``temperature > 0``) is not ported yet."""
    if (temperature is not None and temperature > 0.0) or top_k or top_p:
        raise NotImplementedError("sampling is not ported yet (greedy only)")
    return torch.argmax(lg.to(F32), dim=-1).to(torch.int32)


def _check_supported(cfg: ModelConfig):
    bad = sorted({f"{s.mixer}/{s.ffn}" for s in cfg.layer_list()
                  if s.mixer != "gqa" or s.ffn != "swiglu" or s.cross_attn})
    if bad or cfg.encoder is not None or cfg.max_seq or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: only gqa + swiglu rmsnorm stacks are ported "
            f"(got {bad or 'an encoder / learned positions / layernorm'})")


def _norm(x, p, cfg: ModelConfig):
    return rmsnorm(x, p["g"], cfg.norm_eps)


def init_layer(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device):
    z = lambda: {"g": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    p = {"norm1": z(),
         "attn": attn.gqa_params(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, dtype, device,
                                 qk_norm=spec.qk_norm),
         "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, device),
         "norm2": z()}
    if spec.post_norms:
        p["post1"], p["post2"] = z(), z()
    return p


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                policy: PrecisionPolicy, device, page_table=None,
                n_pages: Optional[int] = None) -> List:
    """One cache per layer.  Paged (``cfg.paged_kv``): every layer's pool
    adopts the SAME [B, max_pages] table (default: the identity table)."""
    kv_dtype = attn.kv_store_dtype(policy)
    out = []
    for _ in cfg.layer_list():
        if cfg.paged_kv:
            out.append(paged.init_paged_kv_cache(
                batch, cfg.n_kv_heads, max_len, cfg.page_size, cfg.head_dim,
                kv_dtype, device=device, block_table=page_table,
                n_pages=n_pages))
        else:
            out.append(attn.init_kv_cache(batch, cfg.n_kv_heads, max_len,
                                          cfg.head_dim, kv_dtype, device))
    return out


def caches_with_table(caches: List, table) -> List:
    """The same pools with a fresh [B, max_pages] block table in every
    paged layer — the serving loop's admission/recycling hook."""
    def one(c):
        if not isinstance(c, paged.PagedKVCache):
            return c
        t = torch.as_tensor(np.asarray(table, np.int32)
                            if not isinstance(table, torch.Tensor) else table,
                            device=c.k_pool.device).to(torch.int32)
        return paged.PagedKVCache(c.k_pool, c.v_pool, t)
    return [one(c) for c in caches]


def _caches_table_view(caches: List, rows) -> List:
    """Pools shared, tables gathered to batch slots ``rows``."""
    out = []
    for c in caches:
        r = torch.as_tensor(rows, device=c.block_table.device).reshape(-1)
        out.append(paged.PagedKVCache(c.k_pool, c.v_pool,
                                      c.block_table.index_select(
                                          0, r.to(torch.int64))))
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    policy: PrecisionPolicy
    device: torch.device

    def __post_init__(self):
        _check_supported(self.cfg)

    def with_cfg(self, **overrides) -> "Model":
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, **overrides))

    # -- init ------------------------------------------------------------
    def init(self, seed=0) -> dict:
        """Random weights from a ``torch.Generator`` on the model's device
        (``seed`` is an int or a Generator).  Same distributions as the JAX
        ``Model.init``, different numbers."""
        cfg, dev = self.cfg, self.device
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        dtype = param_dtype(self.policy)
        return {
            "embed": embed_init(gen, padded_vocab(cfg.vocab), cfg.d_model,
                                dtype, dev),
            "norm_f": {"g": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)},
            "layers": [init_layer(gen, s, cfg, dtype, dev)
                       for s in cfg.layer_list()],
        }

    # -- embedding / unembedding ------------------------------------------
    def embed(self, params, tokens):
        x = params["embed"][tokens.to(torch.int64)]
        if self.cfg.emb_scale:
            x = (x.to(F32) * self.cfg.emb_scale).to(x.dtype)
        return x

    @property
    def vocab_out(self) -> int:
        return padded_vocab(self.cfg.vocab)

    def logits(self, params, x):
        cfg = self.cfg
        out_fmt = "fp16alt" if cfg.ce_dtype == "fp16alt" else "fp32"
        lg = tp.tp_matmul(x, params["embed"].t(), self.policy,
                          out_fmt=out_fmt)
        lg = softcap(lg, cfg.logit_softcap)
        vpad = padded_vocab(cfg.vocab)
        if vpad != cfg.vocab:
            live = torch.arange(vpad, device=lg.device) < cfg.vocab
            lg = torch.where(live, lg, -1e30)
        return lg

    # -- the stack -------------------------------------------------------
    def apply_layer(self, x, p, spec: LayerSpec, *, positions, cache=None,
                    cache_pos=None, kv_len=None):
        cfg = self.cfg
        rs = cfg.residual_scale
        h = _norm(x, p["norm1"], cfg)
        mix, cache = attn.gqa_attention(
            h, p["attn"], self.policy, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            positions=positions, causal=True, window=spec.window,
            attn_softcap=spec.attn_softcap, rope_theta=cfg.rope_theta,
            qk_norm=spec.qk_norm, norm_eps=cfg.norm_eps, cache=cache,
            cache_pos=cache_pos, use_rope=spec.use_rope,
            chunk=cfg.attn_chunk, decode_backend=cfg.decode_backend,
            prefill_backend=cfg.prefill_backend, kv_len=kv_len)
        if spec.post_norms:
            mix = _norm(mix, p["post1"], cfg)
        x = x + rs * mix
        h2 = _norm(x, p["norm2"], cfg)
        f = swiglu(h2, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"],
                   self.policy)
        if spec.post_norms:
            f = _norm(f, p["post2"], cfg)
        return x + rs * f, cache

    def _run_stack(self, params, x, *, positions, caches=None,
                   cache_pos=None, kv_len=None):
        if self.cfg.windowed_slice:
            raise NotImplementedError("windowed_slice is not ported")
        new = []
        for i, spec in enumerate(self.cfg.layer_list()):
            c = caches[i] if caches is not None else None
            x, c = self.apply_layer(x, params["layers"][i], spec,
                                    positions=positions, cache=c,
                                    cache_pos=cache_pos, kv_len=kv_len)
            new.append(c)
        return x, (new if caches is not None else None)

    def _final(self, params, x):
        return _norm(x, params["norm_f"], self.cfg)

    # -- entry points ----------------------------------------------------
    def init_caches(self, batch: int, max_len: int, page_table=None,
                    n_pages: Optional[int] = None):
        return init_caches(self.cfg, batch, max_len, self.policy,
                           self.device, page_table=page_table,
                           n_pages=n_pages)

    def prefill(self, params, tokens, *, max_len: int, prompt_lens=None,
                page_table=None, n_pages: Optional[int] = None):
        """Consume a right-padded prompt batch ``tokens`` [B, S]
        (``prompt_lens`` [B]: live lengths of a ragged batch), build caches
        sized ``max_len`` (paged under ``cfg.paged_kv``).  Returns each
        row's last-live-position logits [B, 1, V] (f32) and the caches."""
        cfg = self.cfg
        if not cfg.paged_kv and page_table is not None:
            raise ValueError("page_table given but cfg.paged_kv is off")
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        caches = self.init_caches(b, max_len, page_table=page_table,
                                  n_pages=n_pages)
        lens = (None if prompt_lens is None else
                torch.as_tensor(prompt_lens, device=self.device).to(
                    torch.int64))
        x = self.embed(params, tokens)
        positions = torch.arange(s, device=self.device)
        x, caches = self._run_stack(params, x, positions=positions,
                                    caches=caches, cache_pos=0, kv_len=lens)
        x = self._final(params, x)
        if lens is None:
            xl = x[:, -1:]
        else:
            xl = x[torch.arange(b, device=self.device), lens - 1][:, None]
        return self.logits(params, xl).to(F32), caches

    def decode_step(self, params, token, caches, pos, *, kv_len=None):
        """One decode step: token [B, 1] at write index ``pos`` (int, or a
        per-row [B] tensor) -> (logits [B, 1, V], caches).  ``kv_len``
        overrides the attended live length (default ``pos + 1``)."""
        x = self.embed(params, token)
        if isinstance(pos, torch.Tensor) and pos.dim() >= 1:
            positions = pos[:, None, None]
        else:
            positions = torch.arange(1, device=self.device) + int(pos)
        x, caches = self._run_stack(params, x, positions=positions,
                                    caches=caches, cache_pos=pos,
                                    kv_len=kv_len)
        x = self._final(params, x)
        return self.logits(params, x).to(F32), caches

    def prefill_chunk(self, params, tokens, caches, *, q_offset: int,
                      row=None, chunk_lens=None):
        """Consume ONE prompt chunk [b, C] (right-padded) into EXISTING
        paged caches at query offset ``q_offset`` (an int); ``chunk_lens``
        [b] are the live tokens of the chunk.  ``row`` ([m] batch-slot
        indices) serves a subset of a wider serving batch: writes go into
        the shared pools through those rows' tables.  Returns each row's
        logits at its last live chunk position [b, 1, V] and the caches."""
        cfg = self.cfg
        if not cfg.paged_kv:
            raise ValueError(
                "prefill_chunk requires cfg.paged_kv: a continuation chunk "
                "reads the prefix through the page pool")
        b, s = tokens.shape
        run = _caches_table_view(caches, row) if row is not None else caches
        x = self.embed(params, tokens)
        positions = q_offset + torch.arange(s, device=self.device)
        live = torch.as_tensor(s if chunk_lens is None else chunk_lens,
                               device=self.device).reshape(-1).to(torch.int64)
        x, _ = self._run_stack(params, x, positions=positions, caches=run,
                               cache_pos=int(q_offset), kv_len=q_offset + live)
        x = self._final(params, x)
        last = torch.clamp(live.expand(b), min=1) - 1
        xl = x[torch.arange(b, device=self.device), last][:, None]
        return self.logits(params, xl).to(F32), caches

    def decode_round(self, params, tok, caches, pos, *, lens, done,
                     stop_token: Optional[int] = None):
        """ONE greedy decode round over every batch slot: rows attend
        ``lens`` when done/idle, ``pos + 1`` when running.  Returns
        ``(next_tok [B, 1], logits, caches)``."""
        attend = torch.where(done, lens, pos + 1)
        lg, caches = self.decode_step(params, tok, caches, pos,
                                      kv_len=attend)
        nxt = sample_token(lg[:, -1])[:, None]
        if stop_token is not None:
            nxt = torch.where(done[:, None], stop_token, nxt)
        return nxt, lg, caches

    def decode_burst(self, params, tok, caches, pos, lens, done, limit, *,
                     max_len: int, out_width: int, n_max: int,
                     exit_on_finish: int, stop_token: Optional[int] = None):
        """Up to ``n_max`` decode rounds.  Per-row state: write index
        ``pos``, live length ``lens``, ``done``, and ``limit`` (the pos at
        which a row has emitted its whole budget).  Exits when every row is
        done, after ``n_max`` rounds, or — ``exit_on_finish = k > 0`` — the
        round the k-th running row finishes since entry.  Returns
        ``(out [B, out_width], n_rounds, tok, caches, pos, lens, done)``."""
        b = tok.shape[0]
        pad = stop_token if stop_token is not None else -1
        out = torch.full((b, out_width), pad, dtype=torch.int32,
                         device=tok.device)
        done0 = done.cpu()
        i = 0
        while i < n_max:
            d_host = done.cpu()
            if bool(d_host.all()):
                break
            newly = int((d_host & ~done0).sum())
            if exit_on_finish and newly >= exit_on_finish:
                break
            nxt, _, caches = self.decode_round(params, tok, caches, pos,
                                               lens=lens, done=done,
                                               stop_token=stop_token)
            out[:, i] = nxt[:, 0]
            fin = done | (pos + 1 >= limit)
            if stop_token is not None:
                fin = fin | (nxt[:, 0] == stop_token)
            new_pos = torch.where(done, pos,
                                  torch.clamp(pos + 1, max=max_len - 1))
            lens = torch.where(done, lens, pos + 1)
            tok, pos, done = nxt, new_pos, fin
            i += 1
        return out, i, tok, caches, pos, lens, done

    def generate(self, *args, **kwargs):
        raise NotImplementedError(
            "generate() (scan/while loops, sampling, penalties) is not "
            "ported yet; serve through launch.engine.ContinuousEngine")
