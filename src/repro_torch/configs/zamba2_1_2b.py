"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.

Assignment: 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64 [arXiv:2411.15242; hf].  38 Mamba2 blocks; one SHARED
attention+MLP block (single weight set) invoked every 6 mamba blocks —
pattern = [5x mamba2, 1x shared_attn] x 6, + 2 trailing mamba blocks.
Sub-quadratic: long_500k runs (O(1) SSM state).
"""
from ..models.ssm import Mamba2Config
from .base import LayerSpec, ModelConfig

_M = LayerSpec(mixer="mamba2", ffn="none")
_SH = LayerSpec(mixer="shared_attn", ffn="swiglu", use_rope=True)

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    pattern=(_M, _M, _M, _M, _M, _SH),
    suffix=(_M, _M),
    mamba=Mamba2Config(d_model=2048, d_state=64, head_dim=64, chunk=256),
    shared_block=_SH,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(_M, _SH),
        suffix=(_M, _M),
        mamba=Mamba2Config(d_model=64, d_state=16, head_dim=16, chunk=8),
        shared_block=_SH,
        tie_embeddings=True, sub_quadratic=True,
    )
