"""Model configuration schema, field for field as the JAX package's
``repro.configs.base``.

The attention stacks are ported, GQA (gemma2, gemma3, qwen3-moe,
granite, internvl2, whisper) and MLA (minicpm3, deepseek-v2-lite, with
the MLA dims below), with a SwiGLU MLP, a gelu MLP with biases or a
Mixture-of-Experts FFN (``moe``: a ``models.moe.MoEConfig``), rmsnorm or
layernorm (``norm``), rope or learned positions (``max_seq``), a patch
frontend stub (``frontend="patch"``: ``n_frontend_tokens`` precomputed
embeddings overwrite the first positions) and whisper's encoder
(``encoder``, with ``cross_attn`` decoder layers over its states), and
the recurrent archs: Mamba2, mLSTM and sLSTM mixers (``mamba``,
``mlstm``, ``slstm``: a ``models.ssm.Mamba2Config`` / ``MLSTMConfig`` /
``SLSTMConfig``) and zamba2's shared attention block (``shared_block``,
the ``shared_attn`` mixer).  Defaults differ in one place:
``decode_backend`` / ``prefill_backend`` are ``"auto"`` (the CUDA kernels
for CUDA tensors, their plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["LayerSpec", "EncoderConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's composition: a sequence mixer + a channel mixer (FFN)."""
    mixer: str = "gqa"          # gqa | mla | mamba2 | mlstm | slstm | shared_attn | none
    ffn: str = "swiglu"         # swiglu | gelu | moe | none
    window: Optional[int] = None        # sliding-window size (local attn)
    attn_softcap: Optional[float] = None
    qk_norm: bool = False
    use_rope: bool = True
    post_norms: bool = False            # gemma2-style sandwich norms
    cross_attn: bool = False            # whisper decoder


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder stack (bidirectional attention, gelu FFN)."""
    n_layers: int
    n_frames: int            # frontend sequence length (e.g. 1500)
    n_heads: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: Tuple[LayerSpec, ...] = ()
    suffix: Tuple[LayerSpec, ...] = ()
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None
    emb_scale: Optional[float] = None
    residual_scale: float = 1.0
    mlp_bias: bool = False
    # MLA dims (deepseek / minicpm3)
    q_lora: Optional[int] = None
    kv_lora: int = 0
    nope_dim: int = 0
    rope_dim: int = 0
    v_head_dim: int = 0
    # family sub-configs
    moe: Optional[Any] = None
    mamba: Optional[Any] = None
    mlstm: Optional[Any] = None
    slstm: Optional[Any] = None
    shared_block: Optional[LayerSpec] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None         # "patch" | "audio" stubs
    n_frontend_tokens: int = 0
    max_seq: int = 0         # learned positional table size (0 = rope only)
    sub_quadratic: bool = False
    attn_chunk: int = 512    # query-chunk size of the dense attention path
    unroll_scan: bool = False
    windowed_slice: bool = False
    decode_backend: str = "auto"   # auto | kernel | plain | dense
    prefill_backend: str = "auto"  # auto | kernel | plain | dense
    paged_kv: bool = False
    page_size: int = 64
    ce_dtype: str = "fp32"
    embed_sharding: str = "vocab"
    remat_policy: str = "full"
    narrow_partials: bool = False
    seq_parallel: bool = False
    dropout: float = 0.0

    @property
    def n_scanned(self) -> int:
        return self.n_layers - len(self.prefix) - len(self.suffix)

    @property
    def repeats(self) -> int:
        n, p = self.n_scanned, len(self.pattern)
        assert n % p == 0, (self.name, n, p)
        return n // p

    def layer_list(self) -> Tuple[LayerSpec, ...]:
        return self.prefix + self.pattern * self.repeats + self.suffix

    def paged_unsupported_reason(self) -> Optional[str]:
        """Why ``paged_kv`` cannot serve this arch (None = it can)."""
        bad = sorted({s.mixer for s in self.layer_list()
                      if s.mixer not in ("gqa", "shared_attn", "none")})
        if bad:
            return "/".join(bad)
        if self.encoder is not None:
            return "cross-attention caches"
        return None

    def validate(self):
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name
        assert self.repeats >= 1
        for spec in self.layer_list():
            if spec.mixer == "mla":
                assert self.kv_lora and self.nope_dim and self.rope_dim
            if spec.ffn == "moe":
                assert self.moe is not None
            if spec.mixer == "mamba2":
                assert self.mamba is not None
            if spec.mixer == "mlstm":
                assert self.mlstm is not None
            if spec.mixer == "slstm":
                assert self.slstm is not None
            if spec.mixer == "shared_attn":
                assert self.shared_block is not None
        return self

    # -- parameter count (for roofline MODEL_FLOPS and docs) ------------------
    def param_counts(self) -> dict:
        """Returns three counts:
          total  — distinct parameters stored,
          active — distinct parameters touched per token (MoE: only the
                   routed top-k + shared experts; weight-shared blocks once),
          flops  — per-use parameter count for the 6·N·D FLOPs estimate
                   (weight-shared blocks counted once per invocation)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb

        def attn_params(spec):
            if spec.mixer == "gqa":
                qkv = d * self.n_heads * self.head_dim \
                    + 2 * d * self.n_kv_heads * self.head_dim \
                    + self.n_heads * self.head_dim * d
                return qkv
            if spec.mixer == "mla":
                qd = self.nope_dim + self.rope_dim
                p = d * self.kv_lora + d * self.rope_dim \
                    + self.kv_lora * self.n_heads * (self.nope_dim
                                                     + self.v_head_dim) \
                    + self.n_heads * self.v_head_dim * d
                if self.q_lora:
                    p += d * self.q_lora + self.q_lora * self.n_heads * qd
                else:
                    p += d * self.n_heads * qd
                return p
            if spec.mixer == "mamba2":
                m = self.mamba
                return d * (2 * m.d_inner + 2 * m.n_groups * m.d_state
                            + m.n_heads) + m.d_inner * d \
                    + m.d_conv * m.conv_dim
            if spec.mixer == "mlstm":
                ml = self.mlstm
                # headwise (block-diagonal) qkv: 3 * H * head_dim^2
                return d * 2 * ml.d_inner \
                    + 3 * ml.n_heads * ml.head_dim ** 2 \
                    + ml.d_inner * 2 * ml.n_heads + ml.d_inner * d \
                    + ml.d_conv * ml.d_inner
            if spec.mixer == "slstm":
                sl = self.slstm
                dff = int(sl.proj_factor * d)
                return 4 * d * d + 4 * d * sl.head_dim \
                    + d * 2 * dff + dff * d
            if spec.mixer == "shared_attn":
                sb = self.shared_block
                return d * self.n_heads * self.head_dim * 2 \
                    + 2 * d * self.n_kv_heads * self.head_dim \
                    + (3 * d * self.d_ff if sb.ffn == "swiglu"
                       else 2 * d * self.d_ff)
            return 0

        def ffn_params(spec):
            if spec.ffn == "swiglu":
                return 3 * d * self.d_ff
            if spec.ffn == "gelu":
                return 2 * d * self.d_ff + self.d_ff + d
            if spec.ffn == "moe":
                mc = self.moe
                routed = mc.n_experts * 3 * d * mc.d_expert
                shared = mc.n_shared * 3 * d * mc.d_expert
                act = mc.top_k * 3 * d * mc.d_expert + shared
                return routed + shared + d * mc.n_experts, act
            return 0

        flops = active
        shared_counted = False
        for spec in self.layer_list():
            a = attn_params(spec)
            f = ffn_params(spec)
            f_total, f_active = f if isinstance(f, tuple) else (f, f)
            if spec.mixer == "shared_attn":
                if not shared_counted:
                    total += a + f_total
                    active += a + f_active
                    shared_counted = True
                flops += a + f_active
            else:
                total += a + f_total
                active += a + f_active
                flops += a + f_active
        if self.encoder is not None:
            e = self.encoder
            per = 4 * (d * e.n_heads * (d // e.n_heads)) \
                + 2 * d * e.d_ff + e.d_ff + d
            total += e.n_layers * per
            active += e.n_layers * per
            flops += e.n_layers * per
        return {"total": total, "active": active, "flops": flops}
