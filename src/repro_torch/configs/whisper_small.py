"""whisper-small [audio]: encoder-decoder with a conv frontend stub.

12L d_model=768 12H d_ff=3072 vocab=51865 [arXiv:2212.04356].  12
encoder layers (bidirectional attention, gelu MLP with biases, learned
frame positions) and 12 decoder layers (causal self-attention,
cross-attention over the encoder states, gelu MLP); learned decoder
positions (no rope); layernorm.  The conv1d / log-mel frontend is a
stub: the caller passes precomputed frame embeddings [B, 1500, 768].
"""
from .base import EncoderConfig, LayerSpec, ModelConfig

_DEC = LayerSpec(mixer="gqa", ffn="gelu", use_rope=False, cross_attn=True)

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    pattern=(_DEC,),
    norm="layernorm", norm_eps=1e-5, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=12, n_frames=1500, n_heads=12, d_ff=3072),
    frontend="audio",
    max_seq=65536,             # learned decoder positions
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(_DEC,),
        norm="layernorm", norm_eps=1e-5, tie_embeddings=True,
        encoder=EncoderConfig(n_layers=2, n_frames=30, n_heads=4, d_ff=128),
        frontend="audio", max_seq=4096,
    )
