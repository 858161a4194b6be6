"""PaliGemma-3B [arXiv:2407.07726] — SigLIP vision frontend + Gemma-2B LM.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216, head_dim=256.
The SigLIP frontend is a stub, as in the JAX package: the caller passes
precomputed patch embeddings (B, n_prefix_tokens, d_model) as
``prefix_embeds``.  The port's own copy of ``repro.configs.paligemma_3b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq=8192,
    n_prefix_tokens=256,
)
