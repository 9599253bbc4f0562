"""deepseek-v2-lite-16b [moe]: MLA + fine-grained MoE.

27L d_model=2048 16H d_ff=1408 vocab=102400, MLA kv_lora=512 (no q-LoRA),
nope 128 + rope 64, v_head 128, 2 shared + 64 routed experts top-6
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].  Layer 0 is dense
(first_k_dense_replace=1, d_ff 10944), layers 1..26 are MoE; untied
embeddings.
"""
from ..models.moe import MoEConfig
from .base import LayerSpec, ModelConfig

_MLA = dict(mixer="mla")
_DENSE = LayerSpec(ffn="swiglu", **_MLA)
_MOE = LayerSpec(ffn="moe", **_MLA)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=10944,                       # dense layer-0 intermediate
    vocab=102400,
    prefix=(_DENSE,), pattern=(_MOE,),
    q_lora=None, kv_lora=512, nope_dim=128, rope_dim=64, v_head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    rope_theta=1e4, tie_embeddings=False,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, vocab=256,
        prefix=(_DENSE,), pattern=(_MOE,),
        q_lora=None, kv_lora=32, nope_dim=16, rope_dim=8, v_head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2),
        tie_embeddings=False,
    )
