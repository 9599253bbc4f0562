"""gemma3-12b [dense]: 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt lineage].  Pattern: 5 local (window 1024) + 1
global; qk-norm; head_dim 256; no attention softcap (gemma3 dropped it);
rope theta 1M; sandwich (pre+post) norms; embedding scaled by
sqrt(d_model), tied embeddings.
"""
from .base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="gqa", ffn="swiglu", window=1024, qk_norm=True,
                   post_norms=True)
_GLOBAL = LayerSpec(mixer="gqa", ffn="swiglu", qk_norm=True,
                    post_norms=True)

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    emb_scale=3840 ** 0.5, rope_theta=1e6,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        pattern=(LayerSpec(mixer="gqa", ffn="swiglu", window=16,
                           qk_norm=True, post_norms=True),
                 LayerSpec(mixer="gqa", ffn="swiglu", qk_norm=True,
                           post_norms=True)),
        emb_scale=8.0, tie_embeddings=True,
    )
