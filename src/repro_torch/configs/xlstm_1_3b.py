"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, xLSTM[7:1].

Assignment: 48L d_model=2048 4H d_ff=0 vocab=50304 [arXiv:2405.04517].
Pattern: 7 mLSTM blocks (matrix memory, chunkwise-parallel) + 1 sLSTM
block (scalar memory, sequential scan) repeated 6x.  d_ff=0: the blocks
carry their own internal up/down projections (proj_factor 2 for mLSTM,
4/3 gated FFN tail for sLSTM).  Sub-quadratic: long_500k runs.
"""
from ..models.ssm import MLSTMConfig, SLSTMConfig
from .base import LayerSpec, ModelConfig

_M = LayerSpec(mixer="mlstm", ffn="none")
_S = LayerSpec(mixer="slstm", ffn="none")

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304,
    pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
    mlstm=MLSTMConfig(d_model=2048, n_heads=4, proj_factor=2.0, chunk=256),
    slstm=SLSTMConfig(d_model=2048, n_heads=4),
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=0, vocab=256,
        pattern=(_M, _S),
        mlstm=MLSTMConfig(d_model=64, n_heads=2, proj_factor=2.0, chunk=16),
        slstm=SLSTMConfig(d_model=64, n_heads=2),
        tie_embeddings=True, sub_quadratic=True,
    )
