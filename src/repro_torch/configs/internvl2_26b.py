"""internvl2-26b [vlm]: InternViT + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8, group 6) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]; head_dim 128, rope theta 1M, untied embeddings.
The ViT frontend is a stub: the caller passes precomputed patch
embeddings [B, 256, d_model], which overwrite the first
``n_frontend_tokens`` positions of the embedded sequence
(``Model.embed(frontend_embeds=)``).
"""
from .base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="gqa", ffn="swiglu")

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    pattern=(_L,),
    rope_theta=1e6, tie_embeddings=False,
    frontend="patch", n_frontend_tokens=256,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(_L,), tie_embeddings=False,
        frontend="patch", n_frontend_tokens=8,
    )
