"""Llama-2-13B — the paper's largest evaluation model (Table II)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=13824,
    vocab_size=32000,
    rope_theta=10000.0,
    max_seq=4096,
)
