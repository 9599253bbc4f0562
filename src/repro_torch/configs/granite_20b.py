"""granite-20b [dense]: MQA code model.

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324;
hf]; d_ff = 4 d, a non-gated gelu MLP with biases (gpt-bigcode lineage);
MQA: one KV head shared by all 48 query heads (group 48), head_dim 128.
"""
from .base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="gqa", ffn="gelu")

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152,
    pattern=(_L,),
    tie_embeddings=True,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=256, vocab=256,
        pattern=(_L,), tie_embeddings=True,
    )
