"""gemma2-9b [dense]: alternating local/global attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118];
1:1 local (window 4096) : global alternation, attention-logit softcap 50,
final-logit softcap 30, head_dim 256, sandwich (pre+post) norms, embedding
scaled by sqrt(d_model), tied embeddings.
"""
from .base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="gqa", ffn="swiglu", window=4096,
                   attn_softcap=50.0, post_norms=True)
_GLOBAL = LayerSpec(mixer="gqa", ffn="swiglu", window=None,
                    attn_softcap=50.0, post_norms=True)

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    pattern=(_LOCAL, _GLOBAL),
    logit_softcap=30.0, emb_scale=3584 ** 0.5,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(LayerSpec(mixer="gqa", ffn="swiglu", window=16,
                           attn_softcap=50.0, post_norms=True),
                 LayerSpec(mixer="gqa", ffn="swiglu", attn_softcap=50.0,
                           post_norms=True)),
        logit_softcap=30.0, emb_scale=8.0, tie_embeddings=True,
    )
