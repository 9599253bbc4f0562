"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, per-head q/k RMS norm.

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf].  d_ff=768 is the per-expert intermediate; no
shared experts; head_dim 128; untied embeddings.
"""
from ..models.moe import MoEConfig
from .base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="gqa", ffn="moe", qk_norm=True)

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    pattern=(_L,),
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0),
    rope_theta=1e6, tie_embeddings=False,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=256,
        pattern=(_L,),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=0),
        tie_embeddings=False,
    )
