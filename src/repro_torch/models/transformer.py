"""The model: embedding -> a stack of attention + SwiGLU / gelu / MoE
layers -> final norm -> unembedding (tied, or an ``lm_head``), with the
entry points the serving engine drives:

  ``prefill``        [B, S] tokens -> (last-live-token logits, caches)
  ``decode_step``    one token per row + caches -> (logits, caches)
  ``generate``       prefill + ``gen_len`` decode steps in one call, as a
                     fixed-trip loop (``loop="scan"``) or one that exits
                     the step every row is done (``loop="while"``)
  ``prefill_chunk``  one prompt chunk into existing paged caches
  ``decode_round``   one decode round over every batch slot
  ``decode_burst``   a Python loop of rounds with the JAX package's exit
                     rules (all rows done, ``n_max`` rounds, or the
                     ``exit_on_finish``-th finish since entry)
  ``verify_chunk``   a [B, k+1] chunk scored through the decode read, its
                     queries folded into the batch: bitwise k+1
                     ``decode_step`` calls
  ``speculate_step`` / ``speculate_decode`` / ``speculate_burst``
                     greedy self-speculative decoding: a layer-skip draft
                     (``draft_view``) proposes k tokens, one
                     ``verify_chunk`` accepts the longest matching prefix
                     plus its own next token
  ``forward_train``  [B, S] tokens and labels -> the LM loss (+ MoE aux)
                     through the dense attention path, ``chunked_ce`` and
                     per-pattern-repeat remat: the trainer's forward

Every sampling site goes the same way: optional non-finite guard
(``sanitize_logits``), repetition / presence penalties from a per-row
token histogram (``apply_penalties``), then greedy argmax or a
temperature / top-k / top-p draw (``sample_token``) from an explicit
``torch.Generator``.

Parameters are a plain dict of tensors in the JAX layout (``[d_in,
d_out]``) with the layers UNSTACKED: ``params["layers"][i]`` is layer
``i`` of ``cfg.layer_list()``; zamba2's shared attention block is
``params["shared"]``, read at every ``shared_attn`` position.  Caches
are a list with one entry per layer, updated IN PLACE (a recurrent
layer's NamedTuple cache is replaced by the one its mixer returns).
Attention archs: GQA (gemma2, gemma3,
qwen3-moe, granite's MQA, internvl2: contiguous or paged KV) or MLA
(minicpm3, deepseek-v2-lite: a contiguous latent cache,
``attention.MLACache``; no page axis), each layer with a SwiGLU MLP, a
gelu MLP with biases (granite, whisper) or a Mixture-of-Experts FFN
(``moe.moe_block``; serving drops its aux loss, as the JAX package's
serving entry points do), under rmsnorm or layernorm (whisper: ``{g, b}``
params), with rope or learned positions (``params["pos_embed"]``,
``cfg.max_seq``).  A patch frontend (internvl2) overwrites the first
``n_frontend_tokens`` embedded positions with the caller's
``frontend_embeds``; whisper's encoder (``encode``: bidirectional layers,
a gelu MLP, learned frame positions) turns the caller's frame embeddings
into the states every ``cross_attn`` decoder layer reads, whose cache is
a ``CrossCache`` (the self-attention KV and the cross KV of all
frames).  The recurrent archs (``models.ssm``): zamba2's Mamba2 layers
with a shared attention + SwiGLU block at every sixth position, and
xlstm's mLSTM and sLSTM layers, both with ``ffn="none"``; they cannot
page, take no ragged prompt and cannot speculate, as in the JAX package.
The escalation write path (``esc_fmts`` / ``kv_levels``, and overflow
injection ``ovf_at`` / ``ovf_scale`` in ``decode_burst``) snaps every cache
write onto its row's rung and returns the rows' OF / UF write counts
``kv_flags`` [B, 2] last.

Tensor parallelism (``mesh=`` on every entry point, a ``launch.mesh.Mesh``
whose ``model`` axis has M > 1 ranks; ``params`` are this rank's shards,
``models.sharding.shard_params``): attention runs on this rank's heads
with a row-parallel ``wo`` (``attention.gqa_attention``), the MLPs
column / row parallel (``layers.row_parallel``), MoE expert parallel
(``moe.moe_block``), the embedding over this rank's vocab rows (a masked
lookup, then an exact sum across the group) and the logits over its
vocab columns (``all_gather``, then the softcap and the pad mask); the
caches hold this rank's KV heads.  Every replicated value (hidden states,
logits) is bitwise the same on every rank, and every token pick is made
on the group's first rank and broadcast.  MLA gathers its latents whole
on every rank and runs its heads sharded (``attention.mla_attention``);
the recurrent mixers gather their projections whole, run whole on every
rank and project out row-parallel (``models.ssm``); their caches stay
whole on every rank.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import LayerSpec, ModelConfig
from ..core.device import device_generator
from ..core.policy import PrecisionPolicy, get_policy
from ..launch import spmd
from ..launch.mesh import check_mesh, model_size
from . import attention as attn
from . import moe as moe_mod
from . import paged
from . import ssm
from .layers import (dense_init, embed_init, gelu_mlp, layernorm,
                     mlp_params, param_dtype, rmsnorm, softcap, swiglu)
from ..core import ops as tp

F32 = torch.float32

#: embeddings are padded to a multiple of this; the pad tail is masked
VOCAB_PAD = 256


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``like``'s device, made by a fill (no
    host-to-device copy, so no stream sync).  Arithmetic with a device
    tensor rounds as the JAX package's f32 ops do; a Python scalar divisor
    would let CUDA multiply by its reciprocal instead."""
    return torch.full((), x, dtype=F32, device=like.device)


def sample_token(lg, generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None):
    """One sampling step: logits [B, V] -> token ids [B] (int32).

    ``temperature <= 0`` is greedy argmax (first maximum on ties) and
    touches no generator.  Otherwise: temperature scaling, optional top-k
    truncation, optional nucleus (top-p) truncation, then a categorical
    draw.  The rules are the JAX package's: top-k masks logits strictly
    below the k-th largest; top-p sorts descending, takes the f32 softmax
    and its exclusive cumulative mass, keeps ``mass < top_p`` (the first
    token always) and masks logits strictly below the smallest kept one,
    so tokens tied with a threshold survive.  Truncated logits go to
    -1e30 (the vocab pad tail's floor) and are never drawn.

    The draw is Gumbel-max, ``argmax(lg + G)`` with ``G = -log(-log(U))``
    and ``U`` from ``torch.rand(generator=)`` on the logits' device (a
    draw needs the caller's generator).  It follows ``softmax(lg)``; the
    JAX package's threefry stream cannot be matched."""
    lg = lg.to(F32)
    if temperature is None or temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = lg / _f32(temperature, lg)
    if top_k is not None and top_k > 0:
        kth = torch.topk(lg, min(top_k, lg.shape[-1]), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -1e30, lg)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        prob = torch.softmax(srt, dim=-1)
        excl = torch.cumsum(prob, dim=-1) - prob
        kth = torch.where(excl < top_p, srt, torch.inf).amin(-1, keepdim=True)
        lg = torch.where(lg < kth, -1e30, lg)
    if generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    u = torch.rand(lg.shape, generator=generator, dtype=F32, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(F32).tiny)))
    return torch.argmax(lg + gumbel, dim=-1).to(torch.int32)


def apply_penalties(lg, counts, *, repetition_penalty: Optional[float] = None,
                    presence_penalty: Optional[float] = None):
    """Repetition (HF: seen logits divided by the penalty when positive,
    multiplied when negative) and presence (OpenAI: a flat subtraction)
    penalties on logits [B, V] from per-row token counts [B, V], applied
    to the raw logits before temperature / top-k / top-p.  Both key off
    presence (count > 0); unseen tokens are untouched, neutral knobs are
    the identity."""
    lg = lg.to(F32)
    seen = counts > 0
    if repetition_penalty is not None and repetition_penalty != 1.0:
        rp = _f32(repetition_penalty, lg)
        lg = torch.where(seen, torch.where(lg > 0, lg / rp, lg * rp), lg)
    if presence_penalty is not None and presence_penalty != 0.0:
        lg = lg - _f32(presence_penalty, lg) * seen.to(F32)
    return lg


def token_counts(tokens, vocab: int, prompt_lens=None):
    """Per-row token histogram [B, vocab] int32 of a right-padded prompt
    [B, S]; ``prompt_lens`` keeps each row's pad tail out of it."""
    b, s = tokens.shape
    live = torch.ones((b, s), dtype=torch.int32, device=tokens.device)
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, device=tokens.device).reshape(-1, 1)
        live = (torch.arange(s, device=tokens.device)[None, :] < lens).to(
            torch.int32)
    cnt = torch.zeros((b, vocab), dtype=torch.int32, device=tokens.device)
    return cnt.scatter_add_(1, tokens.to(torch.int64), live)


def _bump_counts(cnt, tok):
    """counts [B, V] + 1 at each row's emitted token [B, 1] (a new tensor)."""
    return cnt.scatter_add(1, tok.to(torch.int64),
                           torch.ones_like(tok, dtype=cnt.dtype))


def sanitize_logits(lg):
    """Non-finite logits guard: NaN/Inf entries go to -1e30 (the pad
    tail's floor) and each row holding one is flagged.  Returns ``(clean
    [..., V], bad [...])``.  Finite logits pass unchanged; an all-NaN row
    collapses to the floor and greedy argmax picks token 0."""
    lg = lg.to(F32)
    finite = torch.isfinite(lg)
    return torch.where(finite, lg, -1e30), ~finite.all(dim=-1)


def tp_group(mesh):
    """The model-axis group of ``mesh`` when it shards (M > 1), else
    None."""
    check_mesh(mesh)
    return mesh.group("model") if model_size(mesh) > 1 else None


def _agree(x, mesh):
    """``x`` as the model group's first rank holds it, on every rank (no
    copy without a sharding mesh)."""
    grp = tp_group(mesh)
    return x if grp is None else spmd.broadcast(x, grp)


def _pick(lgv, *, counts, penalties: dict, generator, temperature, top_k,
          top_p, guard: bool, mesh=None):
    """One sampling site: guard, penalties, sample.  Returns ``(tok [B],
    bad [B] or None)``.  Under a sharding ``mesh`` every rank samples (its
    generator advances as the others') and the group's first rank's pick
    is broadcast, so sampling cannot part the ranks."""
    bad = None
    if guard:
        lgv, bad = sanitize_logits(lgv)
    if counts is not None:
        lgv = apply_penalties(lgv, counts, **penalties)
    tok = sample_token(lgv, generator, temperature=temperature, top_k=top_k,
                       top_p=top_p)
    return _agree(tok, mesh), (None if bad is None else _agree(bad, mesh))


def _penalized(repetition_penalty, presence_penalty) -> bool:
    return ((repetition_penalty is not None and repetition_penalty != 1.0)
            or (presence_penalty is not None and presence_penalty != 0.0))


#: the unbatched matmuls ``remat_policy="dots"`` saves (JAX's
#: ``dots_with_no_batch_dims_saveable``): the projections' ``mm`` (the
#: 16-bit-operand f32-output product is ``mm.dtype``); attention's batched
#: einsums (``bmm``) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
         torch.ops.aten.addmm.default)


def _remat(policy: str):
    """``fn(*args)`` wrapped in a non-reentrant ``torch.utils.checkpoint``
    under ``policy`` (``full`` / ``dots``), or None for ``none``."""
    from torch.utils import checkpoint as ckpt
    if policy == "none":
        return None
    if policy == "full":
        return functools.partial(ckpt.checkpoint, use_reentrant=False)
    if policy != "dots":
        raise ValueError(f"remat_policy must be full|dots|none, got {policy!r}")

    def save_dots(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(
        ckpt.checkpoint, use_reentrant=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     save_dots))


#: the recurrent mixers: (sub-config field, mix, cache init, params)
_RECURRENT = {
    "mamba2": ("mamba", ssm.mamba2_mix, ssm.init_mamba2_cache,
               ssm.mamba2_params),
    "mlstm": ("mlstm", ssm.mlstm_mix, ssm.init_mlstm_cache,
              ssm.mlstm_params),
    "slstm": ("slstm", ssm.slstm_mix, ssm.init_slstm_cache,
              ssm.slstm_params)}


def _check_supported(cfg: ModelConfig):
    bad = sorted({f"{s.mixer}/{s.ffn}" for s in cfg.layer_list()
                  if s.mixer not in ("gqa", "mla", "shared_attn", *_RECURRENT)
                  or s.ffn not in ("swiglu", "gelu", "moe", "none")})
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: mixer / ffn {bad} is not one of the JAX "
            f"package's (gqa, mla, shared_attn, mamba2, mlstm, slstm / "
            f"swiglu, gelu, moe, none)")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"{cfg.name}: norm must be rmsnorm|layernorm, got "
                         f"{cfg.norm!r}")


class CrossCache(NamedTuple):
    """A cross-attention layer's cache: its self-attention ``kv`` and the
    cross K/V ``xkv`` [B, Hkv, n_frames, Dh] written whole at prefill."""
    kv: attn.KVCache
    xkv: attn.KVCache


def _norm(x, p, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layernorm(x, p["g"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["g"], cfg.norm_eps)


def _norm_params(cfg: ModelConfig, dtype, device) -> dict:
    """``{g}`` (rmsnorm) or ``{g, b}`` (layernorm), zeros."""
    z = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return {"g": z(), "b": z()} if cfg.norm == "layernorm" else {"g": z()}


def init_layer(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device):
    """One layer's leaves, as the JAX package's ``init_layer``: ``norm1``,
    the mixer's ``attn`` (none for ``shared_attn``, whose attention lives
    in ``params["shared"]``), ``mlp`` and ``norm2`` unless ``ffn="none"``
    (a ``shared_attn`` layer keeps them, unread, as JAX's tree does), and
    ``xattn`` / ``norm_x`` / ``post1`` / ``post2`` where the spec asks."""
    z = lambda: _norm_params(cfg, dtype, device)
    p = {"norm1": z()}
    if spec.mixer == "mla":
        p["attn"] = attn.mla_params(
            gen, cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora,
            kv_lora=cfg.kv_lora, nope_dim=cfg.nope_dim,
            rope_dim=cfg.rope_dim, v_head_dim=cfg.v_head_dim, dtype=dtype,
            device=device)
    elif spec.mixer == "gqa":
        p["attn"] = attn.gqa_params(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, dtype,
                                    device, qk_norm=spec.qk_norm)
    elif spec.mixer in _RECURRENT:
        sub, _, _, init = _RECURRENT[spec.mixer]
        p["attn"] = init(gen, getattr(cfg, sub), dtype, device)
    if spec.cross_attn:
        p["xattn"] = attn.gqa_params(gen, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim, dtype,
                                     device)
        p["norm_x"] = z()
    if spec.ffn != "none":
        p["mlp"] = (moe_mod.moe_params(gen, cfg.d_model, cfg.moe, dtype,
                                       device)
                    if spec.ffn == "moe" else
                    mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, device,
                               kind=spec.ffn))
        p["norm2"] = z()
    if spec.post_norms:
        p["post1"] = z()
        if spec.ffn != "none":
            p["post2"] = z()
    return p


def init_shared_block(gen, cfg: ModelConfig, dtype, device) -> dict:
    """zamba2: one attention + MLP block whose weights every
    ``shared_attn`` position reads (``norm1``, ``attn``, ``norm2``,
    ``mlp`` of ``cfg.shared_block.ffn``)."""
    return {"norm1": _norm_params(cfg, dtype, device),
            "attn": attn.gqa_params(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, dtype,
                                    device),
            "norm2": _norm_params(cfg, dtype, device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, device,
                              kind=cfg.shared_block.ffn)}


def init_encoder(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Whisper's encoder: ``layers`` (one dict per layer: norm1, attn with
    ``n_heads`` heads of ``d_model // n_heads``, norm2, a gelu MLP), the
    learned frame positions ``pos`` [n_frames, d_model] and ``norm_f``."""
    e = cfg.encoder
    head_dim = cfg.d_model // e.n_heads
    layers = [{"norm1": _norm_params(cfg, dtype, device),
               "attn": attn.gqa_params(gen, cfg.d_model, e.n_heads,
                                       e.n_heads, head_dim, dtype, device),
               "norm2": _norm_params(cfg, dtype, device),
               "mlp": mlp_params(gen, cfg.d_model, e.d_ff, dtype, device,
                                 kind="gelu")}
              for _ in range(e.n_layers)]
    pos = torch.randn((e.n_frames, cfg.d_model), generator=gen, dtype=F32,
                      device=device) * 0.01
    return {"layers": layers, "pos": pos.to(dtype),
            "norm_f": _norm_params(cfg, dtype, device)}


def encode(frame_embeds, enc_params, cfg: ModelConfig,
           policy: PrecisionPolicy, mesh=None):
    """Frame embeddings [B, n_frames, d_model] -> the encoder states: the
    learned frame positions added (in the embeddings' dtype), then each
    layer's bidirectional self-attention (no rope, on the prefill route
    ``cfg.prefill_backend``) and gelu MLP as pre-norm residuals, then the
    final norm.  The audio frontend is a stub: without frame embeddings
    this raises, where the JAX package's ``encode`` fails on ``None``."""
    if frame_embeds is None:
        raise ValueError(
            f"{cfg.name}: the encoder needs frame embeddings [B, "
            f"{cfg.encoder.n_frames}, {cfg.d_model}] (frontend_embeds=); the "
            f"audio frontend is a stub whose output the caller passes")
    e = cfg.encoder
    head_dim = cfg.d_model // e.n_heads
    x = frame_embeds + enc_params["pos"].to(frame_embeds.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in enc_params["layers"]:
        a, _ = attn.gqa_attention(
            _norm(x, lp["norm1"], cfg), lp["attn"], policy,
            n_heads=e.n_heads, n_kv_heads=e.n_heads, head_dim=head_dim,
            positions=positions, causal=False, use_rope=False,
            chunk=cfg.attn_chunk, prefill_backend=cfg.prefill_backend,
            mesh=mesh)
        x = x + a
        m = lp["mlp"]
        x = x + gelu_mlp(_norm(x, lp["norm2"], cfg), m["up"], m["b_up"],
                         m["down"], m["b_down"], policy,
                         _ffn_group(mesh, e.d_ff))
    return _norm(x, enc_params["norm_f"], cfg)


def _ffn_group(mesh, width: int):
    """The model group when ``mesh`` shards an MLP of ``width`` (the
    ``col`` / ``row`` rules' divisibility), else None."""
    tp_n = model_size(mesh)
    return (mesh.group("model") if tp_n > 1 and width % tp_n == 0
            else None)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                policy: PrecisionPolicy, device, page_table=None,
                n_pages: Optional[int] = None, mesh=None) -> List:
    """One cache per layer.  Paged (``cfg.paged_kv``): every layer's pool
    adopts the SAME [B, max_pages] table (default: the identity table);
    an arch whose cache has no page axis (MLA, the recurrent mixers, or
    whisper's cross cache) raises, as the JAX package's ``Model.prefill``
    does.  A ``cross_attn`` layer's entry is a ``CrossCache``; a recurrent
    layer's its mixer's state (``ssm.Mamba2Cache`` / ``MLSTMCache`` /
    ``SLSTMCache``, the conv window in the KV store dtype); each of
    zamba2's ``shared_attn`` positions has a KV cache of its own.  Under a
    head-sharding ``mesh`` every KV cache and pool holds this rank's
    ``n_kv_heads / M`` heads."""
    shards = attn._head_shard_size(mesh, cfg.n_heads, cfg.n_kv_heads) or 1
    hkv = cfg.n_kv_heads // shards
    if cfg.paged_kv:
        why = cfg.paged_unsupported_reason()
        if why is not None:
            raise ValueError(
                f"paged_kv is unsupported for {cfg.name}: {why} cannot "
                f"page a contiguous-state cache (attention archs only)")
    kv_dtype = attn.kv_store_dtype(policy)
    out = []
    for spec in cfg.layer_list():
        if spec.mixer == "mla":
            out.append(attn.init_mla_cache(batch, max_len, cfg.kv_lora,
                                           cfg.rope_dim, kv_dtype, device))
        elif spec.mixer in _RECURRENT:
            sub, _, init, _ = _RECURRENT[spec.mixer]
            out.append(init(batch, getattr(cfg, sub), kv_dtype, device))
        elif cfg.paged_kv:
            out.append(paged.init_paged_kv_cache(
                batch, hkv, max_len, cfg.page_size, cfg.head_dim,
                kv_dtype, device=device, block_table=page_table,
                n_pages=n_pages))
        else:
            out.append(attn.init_kv_cache(batch, hkv, max_len,
                                          cfg.head_dim, kv_dtype, device))
        if spec.cross_attn:
            out[-1] = CrossCache(out[-1], attn.init_kv_cache(
                batch, hkv, cfg.encoder.n_frames, cfg.head_dim,
                kv_dtype, device))
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
            device_generator(dev).manual_seed(int(seed))
        dtype = param_dtype(self.policy)
        vpad = padded_vocab(cfg.vocab)
        params = {
            "embed": embed_init(gen, vpad, cfg.d_model, dtype, dev),
            "norm_f": _norm_params(cfg, dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, vpad, dtype, dev)
        if cfg.max_seq:
            params["pos_embed"] = (torch.randn(
                (cfg.max_seq, cfg.d_model), generator=gen, dtype=F32,
                device=dev) * 0.01).to(dtype)
        params["layers"] = [init_layer(gen, s, cfg, dtype, dev)
                            for s in cfg.layer_list()]
        if cfg.shared_block is not None:
            params["shared"] = init_shared_block(gen, cfg, dtype, dev)
        if cfg.encoder is not None:
            params["encoder"] = init_encoder(gen, cfg, dtype, dev)
        return params

    # -- embedding / unembedding ------------------------------------------
    def embed(self, params, tokens, frontend_embeds=None, *, pos_offset=0,
              mesh=None):
        """Token embeddings [B, S, d] (scaled by ``emb_scale``).  A patch
        frontend's ``frontend_embeds`` [B, K, d] overwrite positions 0..K-1
        (in the embeddings' dtype).  Learned positions (``cfg.max_seq``)
        are added from ``pos_offset``: an int (rows share positions
        ``pos_offset ..``, the start clamped so the slice fits, as
        ``dynamic_slice`` does), a [B] tensor (each row of a one-token
        step at its own position) or a [B, S] tensor (one position per
        token).  Under a sharding ``mesh`` the table holds this rank's
        vocab rows: a masked local lookup, then a sum across the model
        group (exact: one rank contributes each row)."""
        cfg = self.cfg
        tab, tokens = params["embed"], tokens.to(torch.int64)
        grp = tp_group(mesh)
        if grp is not None and tab.shape[0] != padded_vocab(cfg.vocab):
            rows = tab.shape[0]
            loc = tokens - grp.index * rows
            hit = (loc >= 0) & (loc < rows)
            x = torch.where(hit[..., None], tab[loc.clamp(0, rows - 1)],
                            torch.zeros((), dtype=tab.dtype,
                                        device=tab.device))
            x = spmd.all_reduce_sum(x, grp).to(tab.dtype)
        else:
            x = tab[tokens]
        if cfg.emb_scale:
            x = (x.to(F32) * cfg.emb_scale).to(x.dtype)
        if cfg.frontend == "patch" and frontend_embeds is not None:
            fe = torch.as_tensor(frontend_embeds, device=x.device).to(x.dtype)
            if fe.shape[1] > x.shape[1]:
                raise ValueError(f"{fe.shape[1]} patch embeddings do not fit "
                                 f"a sequence of {x.shape[1]} tokens")
            x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
        if cfg.max_seq:
            pe = params["pos_embed"]
            if isinstance(pos_offset, torch.Tensor) and pos_offset.dim() >= 1:
                pe = pe[pos_offset.to(torch.int64)]
                if pos_offset.dim() == 1:
                    pe = pe[:, None]
            else:
                s = tokens.shape[1]
                start = max(0, min(int(pos_offset), pe.shape[0] - s))
                pe = pe[start:start + s]
            x = x + pe.to(x.dtype)
        return x

    def encode(self, params, frame_embeds, mesh=None):
        """The encoder states of ``frame_embeds`` [B, n_frames, d]
        (module-level ``encode``)."""
        fe = (None if frame_embeds is None else
              torch.as_tensor(frame_embeds, device=self.device))
        return encode(fe, params["encoder"], self.cfg, self.policy, mesh)

    @property
    def vocab_out(self) -> int:
        return padded_vocab(self.cfg.vocab)

    def logits(self, params, x, mesh=None):
        """Logits over the padded vocab, the pad tail masked.  Under a
        sharding ``mesh`` the tied table / ``lm_head`` hold this rank's
        vocab block: the local product, an ``all_gather`` across the model
        group, then the softcap and the pad mask."""
        cfg = self.cfg
        out_fmt = "fp16alt" if cfg.ce_dtype == "fp16alt" else "fp32"
        w = (params["embed"].t() if cfg.tie_embeddings
             else params["lm_head"])
        vpad = padded_vocab(cfg.vocab)
        grp = tp_group(mesh)
        sharded = grp is not None and w.shape[-1] != vpad
        if sharded:
            x = spmd.grad_sum(x, grp)
        lg = tp.tp_matmul(x, w, self.policy, out_fmt=out_fmt)
        if sharded:
            lg = spmd.all_gather(lg, grp, dim=-1)
        lg = softcap(lg, cfg.logit_softcap)
        if vpad != cfg.vocab:
            live = torch.arange(vpad, device=lg.device) < cfg.vocab
            lg = torch.where(live, lg, -1e30)
        return lg

    # -- the stack -------------------------------------------------------
    def apply_layer(self, x, p, spec: LayerSpec, *, positions, cache=None,
                    cache_pos=None, kv_len=None, enc_states=None,
                    esc_fmts=None, kv_levels=None, kv_scale=None,
                    verify: bool = False, with_aux: bool = False,
                    shared=None, mesh=None, aux_groups=()):
        """One block: ``(x, cache)``, or ``(x, cache, kv_flags [B, 2])``
        when ``esc_fmts`` is given (the escalation write path of
        ``attention.gqa_attention``; an MLA or recurrent layer, as in the
        JAX package, writes its cache as it is and contributes zero flags).
        A ``shared_attn`` layer reads ``norm1`` / ``attn`` / ``norm2`` /
        ``mlp`` from ``shared`` (zamba2's ``params["shared"]``); a
        recurrent layer (``models.ssm``) ignores ``positions``,
        ``cache_pos`` and ``kv_len``, as JAX's do; ``ffn="none"`` skips the
        FFN.
        ``verify`` selects the speculative verify read of a GQA layer
        (``speculate_check`` refuses MLA stacks).  ``with_aux`` (training)
        appends the layer's MoE load-balancing loss (an f32 zero for a
        dense FFN; ``aux_groups`` as ``moe.moe_core``'s).  A
        ``cross_attn`` layer reads ``enc_states`` (prefill,
        training: its cross K/V written into ``cache.xkv``) or, without
        them, the cached cross K/V (decode)."""
        cfg = self.cfg
        rs = cfg.residual_scale
        xcache = None
        if spec.cross_attn and cache is not None:
            cache, xcache = cache
        ap = shared if spec.mixer == "shared_attn" else p
        h = _norm(x, ap["norm1"], cfg)
        zero_flags = lambda: (torch.zeros((x.shape[0], 2), dtype=torch.int32,
                                          device=x.device),)
        if spec.mixer in _RECURRENT:
            sub, mix_fn, _, _ = _RECURRENT[spec.mixer]
            r = mix_fn(h, p["attn"], getattr(cfg, sub), self.policy,
                       cache=cache, group=tp_group(mesh))
            if esc_fmts is not None:
                r += zero_flags()
        elif spec.mixer == "mla":
            r = attn.mla_attention(
                h, p["attn"], self.policy, n_heads=cfg.n_heads,
                nope_dim=cfg.nope_dim, rope_dim=cfg.rope_dim,
                v_head_dim=cfg.v_head_dim, positions=positions,
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                cache=cache, cache_pos=cache_pos, chunk=cfg.attn_chunk,
                prefill_backend=cfg.prefill_backend, kv_len=kv_len,
                mesh=mesh)
            if esc_fmts is not None:
                r += zero_flags()
        else:
            esc_kw = ({} if esc_fmts is None else
                      dict(esc_fmts=esc_fmts, kv_levels=kv_levels,
                           kv_scale=kv_scale))
            r = attn.gqa_attention(
                h, ap["attn"], self.policy, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                positions=positions, causal=True, window=spec.window,
                attn_softcap=spec.attn_softcap, rope_theta=cfg.rope_theta,
                qk_norm=spec.qk_norm, norm_eps=cfg.norm_eps, cache=cache,
                cache_pos=cache_pos, use_rope=spec.use_rope,
                chunk=cfg.attn_chunk, decode_backend=cfg.decode_backend,
                prefill_backend=cfg.prefill_backend, kv_len=kv_len,
                verify=verify, mesh=mesh,
                windowed_slice=cfg.windowed_slice, **esc_kw)
        mix, cache = r[0], r[1]
        if spec.post_norms:
            mix = _norm(mix, p["post1"], cfg)
        x = x + rs * mix
        if spec.cross_attn:
            hx = _norm(x, p["norm_x"], cfg)
            kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.head_dim, mesh=mesh)
            if enc_states is not None:
                mixx, _ = attn.gqa_attention(
                    hx, p["xattn"], self.policy, positions=positions,
                    causal=False, use_rope=False, kv_states=enc_states,
                    cache=xcache, cache_pos=0, chunk=cfg.attn_chunk,
                    prefill_backend=cfg.prefill_backend, **kw)
            else:
                mixx = attn.cross_attend_cached(
                    hx, p["xattn"], xcache, self.policy,
                    backend=cfg.decode_backend, **kw)
            x = x + rs * mixx
            if cache is not None:
                cache = CrossCache(cache, xcache)
        aux = None
        if spec.ffn != "none":
            h2 = _norm(x, ap["norm2"], cfg)
            m = ap["mlp"]
            grp = _ffn_group(mesh, cfg.d_ff)
            if spec.ffn == "swiglu" or (spec.mixer == "shared_attn" and
                                        cfg.shared_block.ffn == "swiglu"):
                f = swiglu(h2, m["gate"], m["up"], m["down"], self.policy,
                           grp)
            elif spec.ffn == "gelu":
                f = gelu_mlp(h2, m["up"], m["b_up"], m["down"], m["b_down"],
                             self.policy, grp)
            else:
                f, aux = moe_mod.moe_block(h2, m, cfg.moe, self.policy,
                                           with_aux=with_aux, mesh=mesh,
                                           aux_groups=aux_groups)
            if spec.post_norms:
                f = _norm(f, p["post2"], cfg)
            x = x + rs * f
        out = (x, cache) + tuple(r[2:])
        if with_aux:
            out += (aux if aux is not None else
                    torch.zeros((), dtype=F32, device=x.device),)
        return out

    def _run_stack(self, params, x, *, positions, caches=None,
                   cache_pos=None, kv_len=None, enc_states=None,
                   esc_fmts=None, kv_levels=None, kv_scale=None,
                   verify: bool = False, mesh=None):
        """``(x, caches)``, with the layers' summed ``kv_flags`` [B, 2]
        appended when ``esc_fmts`` is given."""
        esc = esc_fmts is not None
        flags = (torch.zeros((x.shape[0], 2), dtype=torch.int32,
                             device=x.device) if esc else None)
        new = []
        for i, spec in enumerate(self.cfg.layer_list()):
            c = caches[i] if caches is not None else None
            r = self.apply_layer(x, params["layers"][i], spec,
                                 positions=positions, cache=c,
                                 cache_pos=cache_pos, kv_len=kv_len,
                                 enc_states=enc_states, esc_fmts=esc_fmts,
                                 kv_levels=kv_levels, kv_scale=kv_scale,
                                 verify=verify, shared=params.get("shared"),
                                 mesh=mesh)
            x, c = r[0], r[1]
            if esc:
                flags = flags + r[2]
            new.append(c)
        ret = (x, (new if caches is not None else None))
        return ret + (flags,) if esc else ret

    def _final(self, params, x):
        return _norm(x, params["norm_f"], self.cfg)

    # -- training ----------------------------------------------------------
    def forward_train(self, params, tokens, labels, *, frontend_embeds=None,
                      mesh=None, remat: bool = True, aux_coef: float = 0.01,
                      loss_chunk: int = 1024):
        """[B, S] tokens and labels -> the scalar LM loss (mean NLL over
        labels >= 0, f32 statistics) + ``aux_coef`` x the MoE
        load-balancing loss, as the JAX package's ``forward_train``.

        ``params`` is the port's per-layer dict or the trainer's JAX-layout
        tree (``pattern`` stacked ``[R, ...]``), which ``layer_views``
        unbinds so the gradients land on the stacks.  ``remat`` wraps each
        repeat of the pattern in ``torch.utils.checkpoint`` under
        ``cfg.remat_policy``: ``full`` recomputes the group, ``dots`` saves
        the unbatched matmul outputs and recomputes the rest, ``none``
        saves everything.  Attention takes the dense masked-softmax path,
        as JAX's training does: the hand-written kernels have no backward,
        so any other ``prefill_backend`` raises.  ``frontend_embeds``: the
        patch embeddings (internvl2) or the encoder's frame embeddings
        (whisper).

        ``mesh``: tensor parallel over its model axis, as the serving
        entry points (``params`` this rank's shards): the embedding, the
        layers and the logits run sharded, the logits are gathered whole,
        so every rank computes the same loss; the sums backprop as the
        identity and ``spmd.grad_sum`` sums the gradients of the
        replicated values entering sharded compute; whisper's encoder
        runs under the mesh too.  Every rank of the model group must run
        the same call (remat recomputes the forward collectives in the
        backward, in one order on every rank).  The loss is
        ``nll + aux_coef * aux`` of ``train_terms``."""
        nll, aux = self.train_terms(
            params, tokens, labels, frontend_embeds=frontend_embeds,
            mesh=mesh, remat=remat, loss_chunk=loss_chunk)
        return nll + aux_coef * aux

    def train_terms(self, params, tokens, labels, *, frontend_embeds=None,
                    mesh=None, remat: bool = True, loss_chunk: int = 1024,
                    aux_groups=()):
        """``forward_train``'s two terms apart: ``(nll, aux)``, the mean
        NLL over this call's live labels and the MoE aux summed over the
        layers (an f32 zero without MoE), for a trainer that weighs them
        apart (``train.train_step.loss_and_grads``).  ``aux_groups``: the
        MoE aux over the tokens of every rank of these groups
        (``moe.aux_loss``; the trainer's ``(data, 1)`` plain sync)."""
        cfg = self.cfg
        if cfg.prefill_backend != "dense":
            raise ValueError(
                f"forward_train needs prefill_backend='dense' (got "
                f"{cfg.prefill_backend!r}): the attention kernels have no "
                f"backward; build the model with prefill_backend='dense'")
        if "pattern" in params:
            from .convert import layer_views
            params = layer_views(params)
        tokens = torch.as_tensor(tokens, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        enc = (self.encode(params, frontend_embeds, mesh)
               if cfg.encoder is not None else None)
        x = self.embed(params, tokens, frontend_embeds, mesh=mesh)
        positions = torch.arange(tokens.shape[1], device=self.device)
        layers, specs = params["layers"], cfg.layer_list()
        shared = params.get("shared")
        wrap = _remat(cfg.remat_policy) if remat else None

        def run(h, acc, enc_states, lo, hi):
            for i in range(lo, hi):
                h, _, a = self.apply_layer(h, layers[i], specs[i],
                                           positions=positions,
                                           enc_states=enc_states,
                                           with_aux=True, shared=shared,
                                           mesh=mesh, aux_groups=aux_groups)
                acc = acc + a
            return h, acc

        aux = torch.zeros((), dtype=F32, device=x.device)
        n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
        x, aux = run(x, aux, enc, 0, n_pre)
        for r in range(cfg.repeats):
            lo = n_pre + r * n_pat
            if wrap is None:
                x, aux = run(x, aux, enc, lo, lo + n_pat)
            else:
                x, aux = wrap(run, x, aux, enc, lo, lo + n_pat)
        x, aux = run(x, aux, enc, len(specs) - len(cfg.suffix), len(specs))
        x = self._final(params, x)
        nll = self.chunked_ce(params, x, labels, chunk=loss_chunk, mesh=mesh)
        return nll, aux

    def chunked_ce(self, params, x, labels, *, chunk: int = 1024,
                   mesh=None):
        """Cross-entropy over [B, S] positions a chunk of ``chunk`` at a
        time, so [B, S, V] logits never exist whole: f32 logits,
        log-sum-exp and gold logit, labels < 0 masked, the sum over the
        count of live labels.  Under a sharding ``mesh`` on the logits
        gathered whole (``logits``)."""
        s = x.shape[1]
        chunk = min(chunk, s)
        tot = torch.zeros((), dtype=F32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, s, chunk):
            lg = self.logits(params, x[:, c0:c0 + chunk], mesh).to(F32)
            li = labels[:, c0:c0 + chunk]
            mask = li >= 0
            gold = torch.gather(lg, -1, li.clamp(min=0).to(torch.int64)[
                ..., None])[..., 0]
            nll = torch.where(mask, torch.logsumexp(lg, dim=-1) - gold, 0.0)
            tot = tot + nll.sum()
            cnt = cnt + mask.sum()
        return tot / cnt.clamp(min=1).to(F32)

    # -- entry points ----------------------------------------------------
    def init_caches(self, batch: int, max_len: int, page_table=None,
                    n_pages: Optional[int] = None, mesh=None):
        return init_caches(self.cfg, batch, max_len, self.policy,
                           self.device, page_table=page_table,
                           n_pages=n_pages, mesh=mesh)

    def prefill(self, params, tokens, *, max_len: int, prompt_lens=None,
                page_table=None, n_pages: Optional[int] = None,
                frontend_embeds=None, mesh=None):
        """Consume a right-padded prompt batch ``tokens`` [B, S]
        (``prompt_lens`` [B]: live lengths of a ragged batch), build caches
        sized ``max_len`` (paged under ``cfg.paged_kv``).  Returns each
        row's last-live-position logits [B, 1, V] (f32) and the caches.
        ``frontend_embeds``: internvl2's patch embeddings [B, K, d] (the
        first K positions), or whisper's frame embeddings [B, n_frames, d],
        which the encoder turns into the states whose cross K/V every
        decoder layer caches.  A recurrent arch refuses ``prompt_lens``
        with the JAX package's message: its mixers cannot mask pad tokens
        out of their state."""
        cfg = self.cfg
        if not cfg.paged_kv and page_table is not None:
            raise ValueError("page_table given but cfg.paged_kv is off")
        if prompt_lens is not None:
            rec = sorted({s.mixer for s in cfg.layer_list()
                          if s.mixer in _RECURRENT})
            if rec:
                raise ValueError(
                    f"prompt_lens (ragged serving) is unsupported for "
                    f"{cfg.name}: {'/'.join(rec)} mixers cannot mask pad "
                    f"tokens out of their recurrent state")
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        enc = (self.encode(params, frontend_embeds, mesh)
               if cfg.encoder is not None else None)
        caches = self.init_caches(b, max_len, page_table=page_table,
                                  n_pages=n_pages, mesh=mesh)
        lens = (None if prompt_lens is None else
                torch.as_tensor(prompt_lens, device=self.device).to(
                    torch.int64))
        x = self.embed(params, tokens, frontend_embeds, mesh=mesh)
        positions = torch.arange(s, device=self.device)
        x, caches = self._run_stack(params, x, positions=positions,
                                    caches=caches, cache_pos=0, kv_len=lens,
                                    enc_states=enc, mesh=mesh)
        x = self._final(params, x)
        if lens is None:
            xl = x[:, -1:]
        else:
            xl = x[torch.arange(b, device=self.device), lens - 1][:, None]
        return self.logits(params, xl, mesh).to(F32), caches

    def decode_step(self, params, token, caches, pos, *, kv_len=None,
                    esc_fmts=None, kv_levels=None, kv_scale=None,
                    mesh=None):
        """One decode step: token [B, 1] at write index ``pos`` (int, or a
        per-row [B] tensor) -> (logits [B, 1, V], caches).  ``kv_len``
        overrides the attended live length (default ``pos + 1``).
        ``esc_fmts`` / ``kv_levels`` / ``kv_scale`` (the escalation write
        path, ``attention.quantize_kv_rows``) append the per-row OF / UF
        write counts ``kv_flags`` [B, 2].  Learned positions are read at
        ``pos``."""
        x = self.embed(params, token, pos_offset=pos, mesh=mesh)
        if isinstance(pos, torch.Tensor) and pos.dim() >= 1:
            positions = pos[:, None, None]
        else:
            positions = torch.arange(1, device=self.device) + int(pos)
        r = self._run_stack(params, x, positions=positions, caches=caches,
                            cache_pos=pos, kv_len=kv_len, esc_fmts=esc_fmts,
                            kv_levels=kv_levels, kv_scale=kv_scale,
                            mesh=mesh)
        x = self._final(params, r[0])
        return (self.logits(params, x, mesh).to(F32), r[1]) + tuple(r[2:])

    def prefill_chunk(self, params, tokens, caches, *, q_offset: int,
                      row=None, chunk_lens=None, esc_fmts=None,
                      kv_levels=None, mesh=None):
        """Consume ONE prompt chunk [b, C] (right-padded) into EXISTING
        paged caches at query offset ``q_offset`` (an int); ``chunk_lens``
        [b] are the live tokens of the chunk.  ``row`` ([m] batch-slot
        indices) serves a subset of a wider serving batch: writes go into
        the shared pools through those rows' tables.  Returns each row's
        logits at its last live chunk position [b, 1, V] and the caches.
        ``esc_fmts`` + ``kv_levels`` ([b] rungs aligned to ``tokens``) write
        the chunk through the escalation quantizer and append the rows' OF
        / UF write counts [b, 2]: a re-ingested row re-prefills at its
        escalated rung."""
        cfg = self.cfg
        if not cfg.paged_kv:
            raise ValueError(
                "prefill_chunk requires cfg.paged_kv: a continuation chunk "
                "reads the prefix through the page pool")
        b, s = tokens.shape
        run = _caches_table_view(caches, row) if row is not None else caches
        x = self.embed(params, tokens, pos_offset=q_offset, mesh=mesh)
        positions = q_offset + torch.arange(s, device=self.device)
        live = torch.as_tensor(s if chunk_lens is None else chunk_lens,
                               device=self.device).reshape(-1).to(torch.int64)
        r = self._run_stack(params, x, positions=positions, caches=run,
                            cache_pos=int(q_offset), kv_len=q_offset + live,
                            esc_fmts=esc_fmts, kv_levels=kv_levels,
                            mesh=mesh)
        x = self._final(params, r[0])
        last = torch.clamp(live.expand(b), min=1) - 1
        xl = x[torch.arange(b, device=self.device), last][:, None]
        return (self.logits(params, xl, mesh).to(F32), caches) + \
            tuple(r[2:])

    def decode_round(self, params, tok, caches, pos, *, lens, done,
                     stop_token: Optional[int] = None,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     generator: Optional[torch.Generator] = None,
                     counts=None, repetition_penalty: Optional[float] = None,
                     presence_penalty: Optional[float] = None,
                     poison: bool = False, guard: bool = False,
                     esc_fmts=None, kv_levels=None, kv_scale=None,
                     mesh=None):
        """ONE decode round over every batch slot: rows attend ``lens``
        when done/idle, ``pos + 1`` when running, then sample.  ``counts``
        [B, V] applies the penalties (the caller owns its upkeep);
        ``poison`` (a bool) overwrites the round's logits with NaN;
        ``guard`` sanitizes before sampling and appends the per-row
        ``bad`` flag; ``esc_fmts`` / ``kv_levels`` / ``kv_scale`` (the
        escalation write path) append the per-row OF / UF write counts
        [B, 2].  A draw without ``generator`` uses one seeded 0.
        Returns ``(next_tok [B, 1], logits, caches,
        generator[, bad][, kv_flags])``."""
        if (temperature is not None and temperature > 0.0
                and generator is None):
            generator = torch.Generator(device=tok.device).manual_seed(0)
        attend = torch.where(done, lens, pos + 1)
        r = self.decode_step(params, tok, caches, pos, kv_len=attend,
                             esc_fmts=esc_fmts, kv_levels=kv_levels,
                             kv_scale=kv_scale, mesh=mesh)
        lg, caches = r[0], r[1]
        lgv = lg[:, -1]
        if poison:
            lgv = torch.full_like(lgv, torch.nan)
        nxt, bad = _pick(lgv, counts=counts,
                         penalties=dict(repetition_penalty=repetition_penalty,
                                        presence_penalty=presence_penalty),
                         generator=generator, temperature=temperature,
                         top_k=top_k, top_p=top_p, guard=guard, mesh=mesh)
        nxt = nxt[:, None]
        if stop_token is not None:
            nxt = torch.where(done[:, None], stop_token, nxt)
        ret = (nxt, lg, caches, generator)
        if guard:
            ret += (bad,)
        return ret + tuple(r[2:])

    def decode_burst(self, params, tok, caches, pos, lens, done, limit, *,
                     max_len: int, out_width: int, n_max: int,
                     exit_on_finish: int, stop_token: Optional[int] = None,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     generator: Optional[torch.Generator] = None,
                     counts=None, repetition_penalty: Optional[float] = None,
                     presence_penalty: Optional[float] = None,
                     poison_at: Optional[int] = None, guard: bool = False,
                     esc_fmts=None, kv_levels=None,
                     ovf_at: Optional[int] = None, ovf_scale: float = 1.0,
                     mesh=None):
        """Up to ``n_max`` decode rounds.  Per-row state: write index
        ``pos``, live length ``lens``, ``done``, and ``limit`` (the pos at
        which a row has emitted its whole budget).  Exits when every row is
        done, after ``n_max`` rounds, or — ``exit_on_finish = k > 0`` — the
        round the k-th running row finishes since entry.

        ``counts`` [B, V] rides the loop and applies the penalties every
        round (bumped by each round's tokens); ``poison_at`` (a relative
        round, -1 or None for never) NaN-poisons that round's logits;
        ``guard`` counts, per row, the rounds whose logits went non-finite
        while the row was live entering the round.  Both stay on the
        device: the only host sync per round is the ``done`` read the exit
        rule needs.

        Numerical health: ``esc_fmts`` + ``kv_levels`` ([B] rungs, fixed
        within a burst) write every round's K/V through the escalation
        quantizer; the rows' OF / UF write counts add up over the rounds
        (a round a row enters done adds nothing) and ride back as
        ``kv_flags`` [B, 2]; ``ovf_at`` (a relative round, -1 or None for
        never) multiplies that round's K/V by ``ovf_scale`` before the
        snap — deterministic overflow injection.  Returns ``(out [B,
        out_width], n_rounds, tok, caches, pos, lens, done, generator[,
        bad][, counts][, kv_flags])``."""
        b = tok.shape[0]
        use_pen = counts is not None and _penalized(repetition_penalty,
                                                    presence_penalty)
        if (temperature is not None and temperature > 0.0
                and generator is None):
            generator = torch.Generator(device=tok.device).manual_seed(0)
        pad = stop_token if stop_token is not None else -1
        out = torch.full((b, out_width), pad, dtype=torch.int32,
                         device=tok.device)
        badc = (torch.zeros((b,), dtype=torch.int32, device=tok.device)
                if guard else None)
        esc = esc_fmts is not None
        flacc = (torch.zeros((b, 2), dtype=torch.int32, device=tok.device)
                 if esc else None)
        done0 = done.cpu()
        i = 0
        while i < n_max:
            d_host = done.cpu()
            if bool(d_host.all()):
                break
            newly = int((d_host & ~done0).sum())
            if exit_on_finish and newly >= exit_on_finish:
                break
            r = self.decode_round(
                params, tok, caches, pos, lens=lens, done=done,
                stop_token=stop_token, temperature=temperature, top_k=top_k,
                top_p=top_p, generator=generator,
                counts=counts if use_pen else None,
                repetition_penalty=repetition_penalty,
                presence_penalty=presence_penalty,
                poison=i == poison_at,
                guard=guard, esc_fmts=esc_fmts, kv_levels=kv_levels,
                kv_scale=ovf_scale if esc and i == ovf_at else None,
                mesh=mesh)
            nxt, caches = r[0], r[2]
            out[:, i] = nxt[:, 0]
            fin = done | (pos + 1 >= limit)
            if stop_token is not None:
                fin = fin | (nxt[:, 0] == stop_token)
            if use_pen:
                counts = _bump_counts(counts, nxt)
            if guard:
                badc = badc + (r[4] & ~done).to(torch.int32)
            if esc:
                flacc = flacc + r[-1] * (~done).to(torch.int32)[:, None]
            new_pos = torch.where(done, pos,
                                  torch.clamp(pos + 1, max=max_len - 1))
            lens = torch.where(done, lens, pos + 1)
            tok, pos, done = nxt, new_pos, fin
            i += 1
        ret = (out, i, tok, caches, pos, lens, done, generator)
        if guard:
            ret += (badc,)
        if use_pen:
            ret += (counts,)
        if esc:
            ret += (flacc,)
        return ret

    def generate(self, params, tokens, *, gen_len: int,
                 max_len: Optional[int] = None, return_logits: bool = False,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 prompt_lens=None, stop_token: Optional[int] = None,
                 page_table=None, n_pages: Optional[int] = None,
                 repetition_penalty: Optional[float] = None,
                 presence_penalty: Optional[float] = None,
                 loop: str = "scan", return_trips: bool = False,
                 guard_nonfinite: bool = False, frontend_embeds=None,
                 mesh=None):
        """Prefill + ``gen_len`` generated tokens (the first from the
        prefill logits, then ``gen_len - 1`` decode steps).

        ``loop="scan"`` always runs ``gen_len - 1`` steps (the JAX
        package's ``lax.scan``); ``loop="while"`` runs the SAME step body
        and exits the step every row is done (with ``stop_token``), the
        token buffer's tail pre-frozen to ``stop_token`` — so both forms
        emit the same tokens by construction.  ``prompt_lens`` [B] serves a
        right-padded ragged batch (per-row write index); ``stop_token``
        freezes a row's outputs and live length the step it emits it;
        ``page_table`` / ``n_pages`` pass to ``prefill`` (paged models);
        ``frontend_embeds`` too (patch or frame embeddings).

        Sampling: ``temperature > 0`` draws with ``generator`` (default: a
        generator seeded 0 on the model's device); greedy touches none.
        ``repetition_penalty`` / ``presence_penalty`` discount tokens seen
        so far (prompt, pad excluded, plus emitted) at every step.
        ``guard_nonfinite`` sanitizes every sampling site and counts, per
        row, the steps whose logits were non-finite while the row was live.
        ``mesh``: tensor parallel over its model axis (``params`` this
        rank's shards); every rank returns the same tokens.

        Returns ``(gen_tokens [B, gen_len], logits)``, ``logits`` [B,
        gen_len, V] (prefill's then each step's; zeros after a while-form
        exit) when ``return_logits`` else None; ``return_trips`` appends
        the decode steps run, ``guard_nonfinite`` the per-row guard counts
        [B] int32, in that order."""
        check_mesh(mesh)
        if loop not in ("scan", "while"):
            raise ValueError(f"loop must be scan|while, got {loop!r}")
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev)
        b, prompt_len = tokens.shape
        max_len = max_len if max_len is not None else prompt_len + gen_len
        do_sample = temperature is not None and temperature > 0.0
        if do_sample and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        use_stop = stop_token is not None
        use_pen = _penalized(repetition_penalty, presence_penalty)
        pick = functools.partial(
            _pick, penalties=dict(repetition_penalty=repetition_penalty,
                                  presence_penalty=presence_penalty),
            generator=generator, temperature=temperature, top_k=top_k,
            top_p=top_p, guard=guard_nonfinite, mesh=mesh)
        lens_t = (None if prompt_lens is None else
                  torch.as_tensor(prompt_lens, device=dev).to(torch.int64))
        lg0, caches = self.prefill(params, tokens, max_len=max_len,
                                   prompt_lens=lens_t, page_table=page_table,
                                   n_pages=n_pages,
                                   frontend_embeds=frontend_embeds, mesh=mesh)
        cnt = (token_counts(tokens, self.vocab_out, lens_t) if use_pen
               else None)
        tok0, bad0 = pick(lg0[:, -1], counts=cnt)
        tok = tok0[:, None]
        # per-row write index when ragged, the shared int otherwise
        pos = lens_t if lens_t is not None else prompt_len
        lens = done = None
        if use_stop:
            done = tok[:, 0] == stop_token
            tok = torch.where(done[:, None], stop_token, tok)
            # live length entering the first step: the prompt only
            lens = (lens_t if lens_t is not None else
                    torch.full((b,), prompt_len, dtype=torch.int64,
                               device=dev))
        if use_pen:
            cnt = _bump_counts(cnt, tok)
        bad_acc = bad0.to(torch.int32) if guard_nonfinite else None

        pad = stop_token if use_stop else 0
        gen = torch.full((b, gen_len), pad, dtype=torch.int32, device=dev)
        gen[:, 0] = tok[:, 0]
        lgs = None
        if return_logits:
            lgs = torch.zeros((b, gen_len, lg0.shape[-1]), dtype=F32,
                              device=dev)
            lgs[:, 0] = lg0[:, -1]
        trips = 0
        while trips < gen_len - 1:
            if loop == "while" and use_stop and bool(done.all()):
                break
            # one step body for both loop forms
            attend = torch.where(done, lens, pos + 1) if use_stop else None
            lg, caches = self.decode_step(params, tok, caches, pos,
                                          kv_len=attend, mesh=mesh)
            nxt, bad = pick(lg[:, -1], counts=cnt)
            nxt = nxt[:, None]
            if use_stop:
                nxt = torch.where(done[:, None], stop_token, nxt)
                lens = torch.where(done, lens, pos + 1)
                live_bad = bad & ~done if guard_nonfinite else None
                done = done | (nxt[:, 0] == stop_token)
            else:
                live_bad = bad
            if use_pen:
                cnt = _bump_counts(cnt, nxt)
            if guard_nonfinite:
                bad_acc = bad_acc + live_bad.to(torch.int32)
            tok, pos = nxt, pos + 1
            trips += 1
            gen[:, trips] = tok[:, 0]
            if return_logits:
                lgs[:, trips] = lg[:, 0]
        out = (gen, lgs)
        if return_trips:
            out += (trips,)
        if guard_nonfinite:
            out += (bad_acc,)
        return out

    # -- speculative decoding (draft k cheap, verify once, accept prefix) --
    def speculate_check(self):
        """Raise unless this arch can decode speculatively: the verify read
        folds chunk queries through the GQA decode read, the MLA latent
        cache has no multi-query verify read, and cross-attention decode
        has no verify read (the JAX package's rules and messages)."""
        cfg = self.cfg
        bad = sorted({s.mixer for s in cfg.layer_list()
                      if s.mixer not in ("gqa", "shared_attn", "none")})
        if bad:
            raise ValueError(
                f"speculative decoding is unsupported for {cfg.name}: "
                f"{'/'.join(bad)} mixers cannot roll back rejected tokens")
        if cfg.encoder is not None or any(s.cross_attn
                                          for s in cfg.layer_list()):
            raise ValueError(
                f"speculative decoding is unsupported for {cfg.name}: "
                f"cross-attention decode has no verify read path")

    def draft_view(self, params, caches, draft_repeats, draft_policy=None):
        """Layer-skip draft: the SAME weights cut to the prefix, the first
        ``draft_repeats`` pattern groups and the suffix (the JAX package's
        ``[:r]`` of its stacked pattern, in layer order), optionally under
        ``draft_policy``.  Returns ``(model, params, caches)`` views; the
        draft's caches are the target's own pools for the layers it runs,
        so its writes land there — at or past each row's live length,
        which verify rewrites at every layer before any read.  Writes are
        cast to the pool's dtype, so a narrower draft policy never changes
        the pool."""
        cfg = self.cfg
        r = cfg.repeats if draft_repeats is None else draft_repeats
        r = max(0, min(int(r), cfg.repeats))
        dm, dp, dc = self, params, caches
        if r < cfg.repeats:
            head = len(cfg.prefix) + r * len(cfg.pattern)
            keep = (list(range(head))
                    + list(range(cfg.n_layers - len(cfg.suffix),
                                 cfg.n_layers)))
            dm = self.with_cfg(n_layers=len(keep))
            dp = dict(params, layers=[params["layers"][i] for i in keep])
            if caches is not None:
                dc = [caches[i] for i in keep]
        if draft_policy is not None:
            dm = dataclasses.replace(dm, policy=get_policy(draft_policy))
        return dm, dp, dc

    def verify_chunk(self, params, tokens, caches, pos, *, kv_len,
                     esc_fmts=None, kv_levels=None, kv_scale=None,
                     mesh=None):
        """Score a [B, S] candidate chunk at target precision through the
        DECODE read: the speculative verify call.

        ``pos`` (int or [B]) is each row's write index for the chunk's
        first token; its K/V land at ``pos .. pos+S-1`` (the bytes S
        sequential decode steps write), and ``kv_len`` [B, S] gives each
        query position's live length (running rows ``pos + i + 1``, frozen
        rows their frozen length).  The queries fold into the batch
        (``gqa_attention(verify=True)``) at the step form's split
        partition.  Returns ``(logits [B, S, V] f32, caches[,
        kv_flags])``."""
        self.speculate_check()
        b, s = tokens.shape
        posv = torch.as_tensor(pos, device=self.device).reshape(-1).expand(b)
        offs = posv[:, None] + torch.arange(s, device=self.device)
        kvl = torch.broadcast_to(torch.as_tensor(kv_len, device=self.device),
                                 (b, s))
        x = self.embed(params, tokens, pos_offset=offs, mesh=mesh)
        r = self._run_stack(params, x, positions=offs[:, None, :],
                            caches=caches, cache_pos=posv, kv_len=kvl,
                            esc_fmts=esc_fmts, kv_levels=kv_levels,
                            kv_scale=kv_scale, verify=True, mesh=mesh)
        x = self._final(params, r[0])
        return (self.logits(params, x, mesh).to(F32), r[1]) + tuple(r[2:])

    def speculate_step(self, params, tok, caches, pos, *, lens, done, limit,
                       spec_k: int, draft_repeats=None, k_rows=None,
                       stop_token: Optional[int] = None, guard: bool = False,
                       esc_fmts=None, kv_levels=None, kv_scale=None,
                       poison: bool = False, draft_policy=None,
                       _draft_fn=None, mesh=None):
        """ONE speculative round: draft ``spec_k`` tokens a row with the
        draft pass (``draft_view``), verify the chunk at target precision
        in one ``verify_chunk``, accept the longest matching prefix plus
        the verify model's own next token.  Greedy only: every accepted
        token is the verify argmax, so the stream is greedy decode's and a
        wrong draft lowers only the accept count.  Rejected positions lie
        at or past the row's new ``lens``, dead to every mask, and the next
        chunk rewrites them before they can go live.

        ``k_rows`` [B] caps each row's accepted drafts (0: plain decode
        inside the speculative batch); ``stop_token`` clamps acceptance at
        the first stop, ``limit`` at the row's budget.  ``_draft_fn(tok,
        pos) -> [B, spec_k]`` replaces the draft pass (the test hook for
        never-matching drafts); ``poison`` NaN-poisons the chunk's logits.

        Returns ``(g [B, k+1], n [B], tok, pos, lens, done, caches[,
        bad][, kv_flags])``: ``g[:, :n[b]]`` are row b's emitted tokens
        (``n == 0`` for rows already done); ``bad`` [B] flags rows whose
        ACCEPTED logits were non-finite."""
        b, dev = tok.shape[0], tok.device
        k1 = spec_k + 1
        pos = torch.as_tensor(pos, device=dev).reshape(-1).expand(b)
        if _draft_fn is not None:
            drafts = torch.as_tensor(_draft_fn(tok, pos), device=dev).to(
                tok.dtype)
        elif spec_k == 0:
            drafts = tok[:, :0]
        else:
            dm, dp, dc = self.draft_view(params, caches, draft_repeats,
                                         draft_policy)
            dtok, dpos, seq = tok, pos, []
            for _ in range(spec_k):
                # each draft step attends its own earlier proposals
                dlg, _ = dm.decode_step(dp, dtok, dc, dpos,
                                        kv_len=torch.where(done, lens,
                                                           dpos + 1),
                                        mesh=mesh)
                dtok = torch.argmax(dlg[:, -1], dim=-1).to(tok.dtype)[:, None]
                seq.append(dtok)
                dpos = dpos + 1
            drafts = torch.cat(seq, dim=1)                   # [B, k]
        chunk = torch.cat([tok, drafts], dim=1)              # [B, k+1]
        ar = torch.arange(k1, device=dev)
        offs = pos[:, None] + ar
        r = self.verify_chunk(
            params, chunk, caches, pos,
            kv_len=torch.where(done[:, None], lens[:, None], offs + 1),
            esc_fmts=esc_fmts, kv_levels=kv_levels, kv_scale=kv_scale,
            mesh=mesh)
        lg, caches = r[0], r[1]
        if poison:
            lg = torch.full_like(lg, torch.nan)
        if guard:
            lg, badm = sanitize_logits(lg)                   # badm [B, k+1]
        g = _agree(torch.argmax(lg, dim=-1).to(torch.int32), mesh)
        m = torch.cumprod((drafts == g[:, :-1]).to(torch.int64),
                          dim=1).sum(dim=1)
        if k_rows is not None:
            m = torch.minimum(m, torch.as_tensor(k_rows, device=dev))
        n = m + 1
        if stop_token is not None:
            is_stop = g == stop_token
            first = torch.where(is_stop.any(dim=1),
                                is_stop.to(torch.int32).argmax(dim=1), k1)
            n = torch.minimum(n, first + 1)
        n = torch.minimum(n, torch.clamp(limit - pos, min=1))
        n = torch.where(done, 0, n)
        last_ix = torch.clamp(n - 1, min=0)[:, None]
        new_tok = torch.where(done[:, None], tok,
                              torch.gather(g, 1, last_ix).to(tok.dtype))
        new_pos = pos + n
        new_lens = torch.where(done, lens, new_pos)
        new_done = done | (new_pos >= limit)
        if stop_token is not None:
            hit = torch.gather(g == stop_token, 1, last_ix)[:, 0]
            new_done = new_done | (~done & hit)
        ret = (g, n, new_tok, new_pos, new_lens, new_done, caches)
        if guard:
            # non-finite logits count only where a position was accepted
            ret += ((badm & (ar[None, :] < n[:, None])).any(dim=1),)
        return ret + tuple(r[2:])

    def speculate_decode(self, params, tokens, *, gen_len: int, spec_k: int,
                         draft_repeats=None, max_len: Optional[int] = None,
                         prompt_lens=None, stop_token: Optional[int] = None,
                         page_table=None, n_pages: Optional[int] = None,
                         draft_policy=None, _draft_fn=None,
                         return_stats: bool = False, mesh=None):
        """The speculative twin of greedy ``generate``: prefill, then
        ``speculate_step`` rounds (one host sync each, on ``done``) until
        every row is done, each emitting 1 to ``spec_k + 1`` tokens a row.
        The stream is ``generate(temperature=0)``'s — same ``stop_token``
        freezing, same per-row budgets — however good or bad the draft.

        ``max_len`` must leave ``spec_k`` slots of lookahead past ``prompt
        + gen_len``: every round writes a whole ``spec_k + 1`` chunk.
        ``return_stats`` appends ``(rounds, emitted)`` (ints)."""
        self.speculate_check()
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev)
        b, prompt_len = tokens.shape
        k1 = spec_k + 1
        need = prompt_len + gen_len + spec_k
        max_len = need if max_len is None else max_len
        if max_len < need:
            raise ValueError(
                f"speculative decoding needs max_len >= prompt + gen_len + "
                f"spec_k = {need} (draft lookahead headroom; a clamped "
                f"chunk write would corrupt live slots), got {max_len}")
        lens_t = (None if prompt_lens is None else
                  torch.as_tensor(prompt_lens, device=dev).to(torch.int64))
        lg0, caches = self.prefill(params, tokens, max_len=max_len,
                                   prompt_lens=lens_t, page_table=page_table,
                                   n_pages=n_pages, mesh=mesh)
        tok = _agree(torch.argmax(lg0[:, -1], dim=-1).to(torch.int32),
                     mesh)[:, None]
        pos = (lens_t if lens_t is not None else
               torch.full((b,), prompt_len, dtype=torch.int64, device=dev))
        limit = pos + gen_len - 1
        done = (torch.zeros((b,), dtype=torch.bool, device=dev)
                if stop_token is None else tok[:, 0] == stop_token)
        done = done | (pos >= limit)          # gen_len == 1: prefill only
        pad = stop_token if stop_token is not None else 0
        out = torch.full((b, gen_len + k1), pad, dtype=torch.int32,
                         device=dev)
        out[:, 0] = tok[:, 0]
        rows = torch.arange(b, device=dev)[:, None]
        ar = torch.arange(k1, device=dev)
        ec, lens = torch.ones((b,), dtype=torch.int64, device=dev), pos
        rounds, emitted = 0, torch.zeros((), dtype=torch.int64, device=dev)
        while not bool(done.all()):
            g, n, tok, pos, lens, done, caches = self.speculate_step(
                params, tok, caches, pos, lens=lens, done=done, limit=limit,
                spec_k=spec_k, draft_repeats=draft_repeats,
                stop_token=stop_token, draft_policy=draft_policy,
                _draft_fn=_draft_fn, mesh=mesh)
            valid = ar[None, :] < n[:, None]
            sidx = torch.where(valid, ec[:, None] + ar, gen_len + ar)
            out[rows, sidx] = torch.where(valid, g, pad)
            ec = ec + n
            rounds += 1
            emitted = emitted + n.sum()
        if return_stats:
            return out[:, :gen_len], rounds, int(emitted)
        return out[:, :gen_len]

    def speculate_burst(self, params, tok, caches, pos, lens, done, limit, *,
                        spec_k: int, out_width: int, n_max: int,
                        exit_on_finish: int, draft_repeats=None,
                        k_rows=None, stop_token: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        poison_at: Optional[int] = None, guard: bool = False,
                        esc_fmts=None, kv_levels=None,
                        ovf_at: Optional[int] = None, ovf_scale: float = 1.0,
                        draft_policy=None, _draft_fn=None, mesh=None):
        """The speculative twin of ``decode_burst``: up to ``n_max``
        ``speculate_step`` rounds, with its exit rules (every row done, the
        ``exit_on_finish``-th finish since entry) and one more: another
        whole chunk might not fit ``out_width``.  ``out[b]`` holds row b's
        accepted tokens PACKED, ``new lens - old lens`` of them, so the
        engine's accounting reads it as it reads a plain burst's.  One host
        sync a round (``done`` and the emitted counts, together).

        Greedy only; ``generator`` passes through untouched.  ``k_rows``
        [B] caps each row's accepted drafts (0: ``no_speculate`` rows, one
        verified token a round).  ``poison_at`` / ``guard`` / ``esc_fmts``
        / ``kv_levels`` / ``ovf_at`` / ``ovf_scale`` as in
        ``decode_burst`` (flags attribute the whole chunk to its row).
        Returns ``(out [B, out_width], n_rounds, tok, caches, pos, lens,
        done, generator[, bad][, kv_flags], stats [2])``, ``stats`` =
        (live-row rounds, emitted tokens)."""
        b, dev = tok.shape[0], tok.device
        k1 = spec_k + 1
        pad = stop_token if stop_token is not None else -1
        out = torch.full((b, out_width + k1), pad, dtype=torch.int32,
                         device=dev)
        rows = torch.arange(b, device=dev)[:, None]
        ar = torch.arange(k1, device=dev)
        ec = torch.zeros((b,), dtype=torch.int64, device=dev)
        stats = torch.zeros((2,), dtype=torch.int64, device=dev)
        badc = (torch.zeros((b,), dtype=torch.int32, device=dev)
                if guard else None)
        esc = esc_fmts is not None
        flacc = (torch.zeros((b, 2), dtype=torch.int32, device=dev)
                 if esc else None)
        done0 = done.cpu()
        i = 0
        while i < n_max:
            host = torch.stack([done.to(torch.int64), ec]).cpu()
            d_host = host[0].bool()
            if bool(d_host.all()):
                break
            if exit_on_finish and int((d_host & ~done0).sum()) >= \
                    exit_on_finish:
                break
            if int(torch.where(d_host, 0, host[1]).max()) + k1 > out_width:
                break
            r = self.speculate_step(
                params, tok, caches, pos, lens=lens, done=done, limit=limit,
                spec_k=spec_k, draft_repeats=draft_repeats, k_rows=k_rows,
                stop_token=stop_token, guard=guard, esc_fmts=esc_fmts,
                kv_levels=kv_levels,
                kv_scale=ovf_scale if esc and i == ovf_at else None,
                poison=i == poison_at, draft_policy=draft_policy,
                _draft_fn=_draft_fn, mesh=mesh)
            g, n, tok, pos, new_lens, new_done, caches = r[:7]
            valid = ar[None, :] < n[:, None]
            out[rows, torch.where(valid, ec[:, None] + ar, out_width + ar)] = \
                torch.where(valid, g, pad)
            live = ~done
            stats = stats + torch.stack([live.sum(), n.sum()])
            ec = ec + n
            if guard:
                badc = badc + (r[7] & live).to(torch.int32)
            if esc:
                flacc = flacc + r[-1] * live.to(torch.int32)[:, None]
            lens, done = new_lens, new_done
            i += 1
        ret = (out[:, :out_width], i, tok, caches, pos, lens, done, generator)
        if guard:
            ret += (badc,)
        if esc:
            ret += (flacc,)
        return ret + (stats,)
