"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, head_dim=64.
d_model=960 is not divisible by 256, so FSDP shards over ("model",) only.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=10000.0,
    max_seq=2048,
    fsdp_axes=("model",),
)
