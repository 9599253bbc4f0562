"""minicpm3-4b [dense]: MLA with q-LoRA + mu-parametrization scaling.

Assignment: 62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448
[hf:openbmb/MiniCPM3-4B; hf].  MLA: q_lora=768, kv_lora=256, nope=64,
rope=32, v_head=64.  muP scaling: scale_emb=12, residual scaled by
scale_depth/sqrt(L) = 1.4/sqrt(62).
"""
from .base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="mla", ffn="swiglu")

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
    d_ff=6400, vocab=73448,
    pattern=(_L,),
    q_lora=768, kv_lora=256, nope_dim=64, rope_dim=32, v_head_dim=64,
    emb_scale=12.0, residual_scale=1.4 / (62 ** 0.5),
    tie_embeddings=True,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, vocab=256,
        pattern=(_L,),
        q_lora=32, kv_lora=32, nope_dim=16, rope_dim=8, v_head_dim=16,
        emb_scale=12.0, residual_scale=1.4 / (2 ** 0.5),
        tie_embeddings=True,
    )
