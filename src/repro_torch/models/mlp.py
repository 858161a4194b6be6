"""Feed-forward sublayers: SwiGLU / GeGLU / plain GELU with bias.

Port of ``repro.models.mlp``.
"""
from __future__ import annotations

import torch

from .common import ACTS, dense_init, dtype_of


def init_mlp(cfg, gen: torch.Generator, d_ff=None, *, n_stack: int = 0):
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    d = cfg.d_model
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, d_ff), dt, n_stack=n_stack),
            "w_up": dense_init(gen, (d, d_ff), dt, n_stack=n_stack),
            "w_down": dense_init(gen, (d_ff, d), dt, n_stack=n_stack),
        }
    lead = (n_stack,) if n_stack else ()
    return {  # plain 2-matrix MLP (whisper)
        "w_up": dense_init(gen, (d, d_ff), dt, n_stack=n_stack),
        "w_down": dense_init(gen, (d_ff, d), dt, n_stack=n_stack),
        "b_up": torch.zeros(lead + (d_ff,), dtype=dt, device=gen.device),
        "b_down": torch.zeros(lead + (d,), dtype=dt, device=gen.device),
    }


def mlp_sublayer(cfg, p, x):
    act = ACTS[cfg.mlp]
    if cfg.mlp in ("swiglu", "geglu"):
        return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return act(x @ p["w_up"] + p["b_up"]) @ p["w_down"] + p["b_down"]
