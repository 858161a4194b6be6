"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4; unverified].

48L d_model=5120 40H (GQA kv=8) vocab=202048; MoE with 128 routed experts
top-1 + 1 shared expert, expert d_ff=8192, interleaved every 2nd layer
(llama4 style). ~400B total / ~17B active.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared_experts=1),
    moe_every=2,  # MoE layers interleaved with dense layers (llama4 style)
    optimizer="adafactor",  # AdamW fp32 moments (3.2TB) cannot fit 512x16GB
    rope_theta=500000.0,
    max_seq=131072,
)
