"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD (state-space duality).

64L d_model=2560, d_state=128, head_dim=64, expand=2, vocab=50280.
O(1) decode state -> long_500k runs. The paper's attention-specific
scheduling (flash loop / KV striping) is inapplicable (see DESIGN.md).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    use_rope=False,
    max_seq=524288,
)
