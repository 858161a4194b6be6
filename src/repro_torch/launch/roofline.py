"""Roofline terms of a step on an NVIDIA H100, and the analytic model.

Port of ``repro.launch.roofline``, with the H100 SXM's data-sheet peaks in
place of the reference's TPU v5e model:
  HBM3              : 3.35 TB/s per card (``PEAK_BYTES_S``)
  dense tensor core : 989 TFLOP/s bf16, 1,979 TOP/s int8; float32 SIMT
                      67 TFLOP/s (``PEAK_FLOPS``, by dtype)
  NVLink 4          : 450 GB/s per direction per card (``WIRE_BW``), the
                      one wire bandwidth of the collective term, as the
                      reference has one (``ICI_WIRE_BW``).  A ``pod`` axis
                      would cross nodes (InfiniBand); the model does not
                      tell it apart.

Terms (seconds, per step, per rank):
  compute    = FLOPs / PEAK_FLOPS[dtype]
  memory     = HBM bytes / PEAK_BYTES_S
  collective = wire_bytes / WIRE_BW
with ``launch.cost``'s ring-model wire bytes.  ``bound`` is the least time
of one kernel call, the larger of its bytes and its operations over the
peaks.  ``analytic_memory_bytes``, ``_cache_bytes``, ``model_flops``,
``_attn_layer_count`` and ``_causal_pairs`` are the reference's,
verbatim.  The reference's ``parse_collectives`` reads HLO text and has no
counterpart: the port counts its collectives as it issues them
(``launch.cost``).
"""
from __future__ import annotations

from typing import Dict

# H100 SXM data-sheet peaks (dense): memory, bf16 and int8 tensor cores,
# float32 SIMT
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
WIRE_BW = 450e9


def bound(bytes_moved: float, flops: float, dtype: str):
    """(ms, "bytes" or "operations"): the larger of ``bytes_moved`` over
    the memory rate and ``flops`` over the peak of ``dtype``."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   dtype: str = "bfloat16"):
    return {
        "compute_s": flops / PEAK_FLOPS[dtype],
        "memory_s": hbm_bytes / PEAK_BYTES_S,
        "collective_s": wire_bytes / WIRE_BW,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


# ---------------------------------------------------------------------------
# Analytic HBM traffic (per chip, per step)
#
# The HLO-parsed byte count is structurally inflated on the CPU backend
# (bf16->f32 converts, CPU fusion boundaries that a TPU would fuse away),
# so the memory roofline term uses this first-principles model; the parsed
# number is recorded alongside as an upper bound.
# ---------------------------------------------------------------------------

def analytic_memory_bytes(cfg, shape, mesh_shape: dict, mode: str) -> float:
    """Per-chip HBM bytes touched per step."""
    nchips = 1
    for v in mesh_shape.values():
        nchips *= v
    model_div = mesh_shape.get("model", 1)
    N = cfg.n_params(include_embeddings=True)
    P = 2.0 * N                              # bf16 weight bytes
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    tokens_local = B * S / nchips

    if mode == "train":
        # params: fwd + remat-fwd + bwd weight reads (gathered per layer,
        # each chip streams the full gathered weights from HBM per pass)
        w = 3.0 * P
        # grads (bf16 w+r) + AdamW moments (fp32 r+w each), ZeRO-sharded
        opt = (4.0 * N + 16.0 * N) / nchips if cfg.optimizer == "adamw" \
            else (4.0 * N) / nchips
        # activations: ~12 tensor r/w per layer per token (remat keeps the
        # working set at one layer)
        layers = cfg.n_layers + (cfg.n_encoder_layers if cfg.is_encoder_decoder else 0)
        act = 12.0 * layers * tokens_local * d * 2.0
        logits = 6.0 * tokens_local * cfg.vocab_size  # fp32 r/w + bf16
        return w + opt + act + logits
    if mode == "prefill":
        w = 1.0 * P
        layers = cfg.n_layers + (cfg.n_encoder_layers if cfg.is_encoder_decoder else 0)
        act = 8.0 * layers * tokens_local * d * 2.0
        cache = 2.0 * _cache_bytes(cfg, B, S) / nchips
        return w + act + cache
    # decode: every (TP-sharded) weight shard is read once per token;
    # the KV cache shard is read (+appended) once.
    if cfg.moe:
        # only the routed experts' weights are streamed from HBM per token
        # (with batch > experts all experts are usually hit; keep the
        # active-param bound, which is what a well-scheduled kernel reads)
        w = 2.0 * cfg.active_params(True) / max(model_div, 1)
    else:
        w = P / max(model_div, 1)
    cache = _cache_bytes(cfg, B, S) / nchips
    act = 30.0 * cfg.n_layers * (B / max(nchips / model_div, 1)) * d * 2.0
    return w + cache + act


def _cache_bytes(cfg, B: int, S: int) -> float:
    """Global KV/state cache bytes."""
    kinds_attn = 0
    if cfg.family in ("dense", "moe", "vlm"):
        kinds_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        kinds_attn = cfg.n_layers // max(cfg.attn_every, 1)
    elif cfg.family == "audio":
        kinds_attn = cfg.n_layers
    kv = 2.0 * kinds_attn * B * S * cfg.kv_dim * 2.0
    if cfg.is_encoder_decoder:
        kv += 2.0 * cfg.n_layers * B * cfg.encoder_seq * cfg.kv_dim * 2.0
    ssm = 0.0
    if cfg.ssm is not None:
        n_ssm = cfg.n_layers if cfg.family == "ssm" else \
            cfg.n_layers - cfg.n_layers // max(cfg.attn_every, 1) \
            if cfg.family == "hybrid" else 0
        di = cfg.ssm.expand * cfg.d_model
        H = di // cfg.ssm.head_dim
        ssm = n_ssm * B * (H * cfg.ssm.head_dim * cfg.ssm.d_state * 4.0
                           + (cfg.ssm.conv_width - 1) * (di + 2 * cfg.ssm.d_state) * 2.0)
    return kv + ssm


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (global, whole step)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """Useful-math FLOPs for the step: 6·N·D train / 2·N·D inference
    (N = active non-embedding params + lm head), plus exact attention terms.
    """
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_params(include_embeddings=False)
    head = cfg.d_model * cfg.vocab_size          # logits matmul params
    n_attn_layers = _attn_layer_count(cfg)
    if shape.kind == "train":
        tokens = B * S
        mm = 6.0 * (N + head) * tokens
        attn = 3 * 2 * 2 * B * n_attn_layers * cfg.q_dim * _causal_pairs(cfg, S)
        return mm + attn
    if shape.kind == "prefill":
        tokens = B * S
        mm = 2.0 * (N + head) * tokens
        attn = 2 * 2 * B * n_attn_layers * cfg.q_dim * _causal_pairs(cfg, S)
        if cfg.is_encoder_decoder:
            mm += 2.0 * N * B * cfg.encoder_seq   # encoder pass (approx)
        return mm + attn
    # decode: one token against an S-long cache
    mm = 2.0 * (N + head) * B
    kv_span = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
    attn = 2 * 2 * B * n_attn_layers * cfg.q_dim * kv_span
    return mm + attn


def _attn_layer_count(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.is_encoder_decoder:
        return cfg.n_layers + cfg.n_encoder_layers
    return cfg.n_layers


def _causal_pairs(cfg, S: int) -> float:
    if cfg.sliding_window is not None and S > cfg.sliding_window:
        w = cfg.sliding_window
        return w * (w + 1) / 2 + (S - w) * w
    return S * (S + 1) / 2
