"""Config registry of the port: ``get_config("<arch-id>")`` returns the full
ModelConfig.  The registry holds the architectures of ``repro.configs``
under the same arch ids: every one, of the dense, moe, ssm, hybrid, audio
and vlm families.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig, SSMConfig, reduced  # noqa: F401

# arch-id -> module name
_REGISTRY = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "olmo-1b": "olmo_1b",
    "smollm-360m": "smollm_360m",
    "yi-34b": "yi_34b",
    # mixture of experts: mixtral (sliding window), llama4 (shared expert)
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "mixtral-8x7b": "mixtral_8x7b",
    # attention-free SSM and the Mamba2 + shared-attention hybrid
    "mamba2-2.7b": "mamba2_2p7b",
    "zamba2-2.7b": "zamba2_2p7b",
    # encoder-decoder: whisper's encoder over precomputed frame embeddings
    "whisper-large-v3": "whisper_large_v3",
    # vision-language: a bidirectional prefix of precomputed patch embeddings
    "paligemma-3b": "paligemma_3b",
    # the paper's own evaluation models (Table II)
    "llama3.2-1b": "llama32_1b",
    "llama3-8b": "llama3_8b",
    "llama2-13b": "llama2_13b",
}


def list_archs():
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
