"""The paper's own configuration analogue: a ~110M-parameter dense LM, the
workload on which the repo reproduces the paper's claim at training scale
(multiply in a narrow format, accumulate in fp32: the expanding FMA).
12 layers, d_model 768, 12 heads of 64 (MHA), a SwiGLU MLP of 2048, vocab
32000, tied embeddings; ``reduced()`` is the tests' two-layer cut.  Field
for field the JAX package's ``configs/fpnew_case_study.py``."""
from .base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="gqa", ffn="swiglu")

CONFIG = ModelConfig(
    name="fpnew-case-study", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048, vocab=32000,
    pattern=(_L,),
    tie_embeddings=True,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="fpnew-case-study-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(_L,), tie_embeddings=True,
    )
