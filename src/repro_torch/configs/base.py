"""Config system of the PyTorch port: the same ``ModelConfig`` as
``repro.configs.base``, kept as the port's own copy so that the port
imports nothing of the JAX package.  A config here and its counterpart
there compare field for field (tests/test_torch_models.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # capacity factor for dense dispatch (tokens per expert = tokens/E * cf)
    capacity_factor: float = 1.25
    # llama4-style: a shared (always-on) expert in addition to routed ones
    n_shared_experts: int = 0
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD — state space duality) settings."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2          # d_inner = expand * d_model
    chunk: int = 256         # SSD chunk length
    conv_width: int = 4
    @property
    def n_heads_for(self):  # helper used by layers; actual heads derived
        return None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default: d_model // n_heads
    norm: str = "rmsnorm"                 # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"                   # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    use_rope: bool = True
    max_seq: int = 131072
    sliding_window: Optional[int] = None  # SWA (mixtral)
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # MoE layers every k-th layer (llama4: 2)
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): mamba backbone; one SHARED attention block applied
    # every `attn_every` layers (params reused each application).
    attn_every: int = 0
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500               # precomputed frame embeddings (stub)
    # vlm (paligemma): prefix of precomputed patch embeddings (stub)
    n_prefix_tokens: int = 0
    # sharding knobs
    fsdp_axes: Tuple[str, ...] = ("data", "model")
    remat: bool = True
    optimizer: str = "adamw"     # "adafactor" for models whose fp32 moments
                                 # cannot fit HBM even fully sharded (llama4)
    # dtype of params/activations
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if serve_step at 500k sequence length is sub-quadratic /
        O(1)-state and therefore runnable per the assignment."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window is not None:
            return True
        return False

    def n_params(self, include_embeddings: bool = True) -> int:
        """Analytic parameter count (used by the PICNIC packing model and
        roofline MODEL_FLOPS)."""
        d, h = self.d_model, self.head_dim
        attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h + self.n_heads * h * d
        if self.mlp in ("swiglu", "geglu"):
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        per_layer = 0
        if self.family == "ssm":
            ssm = self.ssm
            d_inner = ssm.expand * d
            n_h = d_inner // ssm.head_dim
            in_proj = d * (2 * d_inner + 2 * ssm.d_state + n_h)
            out_proj = d_inner * d
            conv = ssm.conv_width * (d_inner + 2 * ssm.d_state)
            per_layer = in_proj + out_proj + conv + 2 * n_h  # + A, dt_bias
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            ssm = self.ssm
            d_inner = ssm.expand * d
            n_h = d_inner // ssm.head_dim
            in_proj = d * (2 * d_inner + 2 * ssm.d_state + n_h)
            mamba_layer = in_proj + d_inner * d + ssm.conv_width * (d_inner + 2 * ssm.d_state) + 2 * n_h + d
            shared = attn + ffn_dense + 2 * d  # one shared attn+ffn block
            total = self.n_layers * mamba_layer + shared
        elif self.moe is not None:
            if self.mlp in ("swiglu", "geglu"):
                expert = 3 * d * self.moe.d_ff_expert
            else:
                expert = 2 * d * self.moe.d_ff_expert
            router = d * self.moe.n_experts
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            moe_layer = attn + self.moe.n_experts * expert + router
            moe_layer += self.moe.n_shared_experts * expert
            dense_layer = attn + ffn_dense
            total = n_moe * moe_layer + n_dense * dense_layer
        else:
            per_layer = attn + ffn_dense
            total = self.n_layers * per_layer
            if self.is_encoder_decoder:
                # encoder self-attn+ffn, decoder adds cross-attn
                total = self.n_encoder_layers * per_layer + self.n_layers * (per_layer + attn)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + (emb if include_embeddings else 0)

    def active_params(self, include_embeddings: bool = False) -> int:
        """Active (per-token) parameters — differs from n_params for MoE."""
        if self.moe is None:
            return self.n_params(include_embeddings)
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        expert = mult * d * self.moe.d_ff_expert
        n_moe = self.n_layers // self.moe_every
        n_dense = self.n_layers - n_moe
        moe_layer = attn + (self.moe.top_k + self.moe.n_shared_experts) * expert
        moe_layer += d * self.moe.n_experts
        dense_layer = attn + mult * d * self.d_ff
        total = n_moe * moe_layer + n_dense * dense_layer
        if include_embeddings:
            total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small smoke-test config in the same family (CPU-runnable)."""
    defaults = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.attn_every == 0 else cfg.attn_every),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        max_seq=512,
        fsdp_axes=("data",),
        remat=False,
    )
    if cfg.attn_every:
        defaults["n_layers"] = cfg.attn_every  # one group: mambas + shared attn
        defaults["attn_every"] = cfg.attn_every
    if cfg.moe is not None:
        defaults["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=256,
            n_shared_experts=cfg.moe.n_shared_experts,
        )
    if cfg.ssm is not None:
        defaults["ssm"] = SSMConfig(d_state=16, head_dim=32, expand=2, chunk=32)
    if cfg.is_encoder_decoder:
        defaults["n_encoder_layers"] = 2
        defaults["encoder_seq"] = 64
    if cfg.n_prefix_tokens:
        defaults["n_prefix_tokens"] = 16
    if cfg.sliding_window:
        defaults["sliding_window"] = 64
    defaults.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **defaults)
