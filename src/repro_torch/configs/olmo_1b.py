"""OLMo-1B [arXiv:2402.00838].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
OLMo uses *non-parametric* LayerNorm (no learned scale/bias) and SwiGLU.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq=2048,
)
