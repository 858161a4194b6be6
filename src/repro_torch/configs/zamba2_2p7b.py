"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + SHARED attention blocks.

54 Mamba2 layers, d_model=2560, ssm_state=64; one shared attention+MLP block
(32H MHA kv=32, d_ff=10240) applied every 6 mamba layers with the SAME
parameters each application (zamba-style weight sharing). vocab=32000.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
    attn_every=6,
    max_seq=524288,
)
