"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder, conv frontend STUB.

32L encoder + 32L decoder, d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
GELU MLP, LayerNorm, sinusoidal positions (no RoPE). The conv frontend is a
STUB: the caller passes precomputed frame embeddings (encoder_seq=1500,
d_model) as ``encoder_embeds``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp="gelu",
    norm="layernorm",
    use_rope=False,
    is_encoder_decoder=True,
    n_encoder_layers=32,
    encoder_seq=1500,
    max_seq=32768,
)
