"""Mixtral-8x7B [arXiv:2401.04088] — 8 experts top-2, sliding-window attn.

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, SWA window 4096.
The port, as the JAX package, keeps every cache row (no ring buffer); the
window masks the keys before cache_len - window.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    max_seq=524288,
)
