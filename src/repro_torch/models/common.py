"""Shared model primitives: norms, RoPE, activations, init helpers.

Port of ``repro.models.common``.  Params are nested dicts of tensors;
layer stacks keep the stacked leading axis of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no card and no explicit device this raises instead of
    carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain PyTorch path on the CPU")
    return torch.device("cuda")


_KEPT: Dict[Tuple, torch.Tensor] = {}


def kept(key: Tuple, device, make) -> torch.Tensor:
    """``make()``, made once per key and device and kept, so every step
    reads the same tensor.  One made while a CUDA graph is being captured
    lives in that graph's memory pool and is not kept, nor is a fake tensor
    (made while a step is costed, ``launch.cost``)."""
    from torch._subclasses.fake_tensor import is_fake
    device = torch.device(device)
    t = _KEPT.get(key + (device,))
    if t is None:
        t = make()
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()
                or is_fake(t)):
            _KEPT[key + (device,)] = t
    return t


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if scale is not None and scale.ndim:
        x = x * (1.0 + scale.float())
    return x.to(dt)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(cfg, p: Optional[Params], x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"] if p else None)
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"] if p else None, p["bias"] if p else None)
    if cfg.norm == "nonparam_ln":  # OLMo: LN without learned affine
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


def init_norm(cfg, shape_prefix=(), *, device=None) -> Params:
    shape = tuple(shape_prefix) + (cfg.d_model,)
    dt = dtype_of(cfg)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=dt, device=device),
                "bias": torch.zeros(shape, dtype=dt, device=device)}
    return {}  # nonparam_ln


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates
    halves (``x1, x2 = split(x, 2)``), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    ang = positions[..., :, None].float() * freqs           # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal positions (whisper)
# ---------------------------------------------------------------------------
# Angles reach the largest position in radians, where one float32 step of
# the angle is ~1.2e-4 at 1500; the JAX package's own table and its
# sinusoidal_at differ by that much, so the port's agree with them to a
# step of the angle, not bit for bit (ROADMAP hazard 9).

def sinusoidal_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (seq, d_model) float32: sin of
    ``pos / 10000 ** (2 i / d_model)`` for i < d_model / 2, then cos."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000 ** (2 * dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_at(pos, d_model: int, device=None) -> torch.Tensor:
    """The embedding at one position -> (d_model,) float32 on ``pos``'s
    device (an int's on ``device``).  ``pos`` is an int or a 0-dim tensor,
    whose value is not read on the host (a CUDA graph can capture the
    call)."""
    pos = torch.as_tensor(pos, device=device)
    ang = pos.to(torch.float32) / _sinusoidal_divisors(d_model, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoidal_divisors(d_model: int, device) -> torch.Tensor:
    """``10000 ** (2 i / d_model)`` for i < d_model / 2, float32, made once
    per device and kept (a decode step reads it and does not rebuild it)."""
    def make():
        dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)
        return 10000 ** (2 * dim / d_model)
    return kept(("sinusoidal", d_model), device, make)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return x * torch.sigmoid(x)


ACTS = {"swiglu": silu, "geglu": gelu, "gelu": gelu}


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
               *, n_stack: int = 0) -> torch.Tensor:
    """Normal init scaled by fan-in, drawn in float32 from ``gen`` on its
    device and cast to ``dtype``.  ``n_stack > 0`` prepends a stacked layer
    axis; each layer is drawn on its own, so the float32 draw never holds
    more than one layer's tensor."""
    fan_in = shape[0]
    s = scale if scale is not None else fan_in ** -0.5
    if not n_stack:
        return (torch.randn(shape, generator=gen, device=gen.device)
                * s).to(dtype)
    out = torch.empty((n_stack,) + tuple(shape), dtype=dtype, device=gen.device)
    for i in range(n_stack):
        out[i] = torch.randn(shape, generator=gen, device=gen.device) * s
    return out


# ---------------------------------------------------------------------------
# Param trees (nested dicts of tensors)
# ---------------------------------------------------------------------------

def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def tree_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in tree_leaves(params))


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
