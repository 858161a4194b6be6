"""Mamba2 (SSD, state-space duality) layer: prefill through the chunked scan
and the O(1) recurrent decode update.

Port of ``repro.models.ssm``.  The prefill's SSD goes to
``kernels.ops.ssd_scan``: the Hopper kernel on a CUDA tensor (under grad
with its backward kernel), its plain version (a transcription of
``ssd_chunked``) on a CPU tensor.  The causal
convolution stays the shifted adds of the JAX package, not ``F.conv1d``,
whose float32 path on the card runs in TF32 by default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import current, seq_gather, seq_slice
from .common import dense_init, dtype_of, rmsnorm, silu


def d_inner_of(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner_of(cfg) // cfg.ssm.head_dim


def conv_dim_of(cfg) -> int:
    return d_inner_of(cfg) + 2 * cfg.ssm.d_state


def init_mamba(cfg, gen: torch.Generator, *, n_stack: int = 0):
    """The JAX package's keys and distributions; ``in_proj`` columns are
    ordered ``[z di | x di | B N | C N | dt H]``."""
    ssm = cfg.ssm
    dt = dtype_of(cfg)
    d, di, H, N = cfg.d_model, d_inner_of(cfg), n_ssm_heads(cfg), ssm.d_state
    lead = (n_stack,) if n_stack else ()
    dev = gen.device

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * N + H), dt, n_stack=n_stack),
        "conv_w": dense_init(gen, (ssm.conv_width, di + 2 * N), dt, scale=0.5,
                             n_stack=n_stack),
        "conv_b": full((di + 2 * N,), 0.0, dt),
        "a_log": full((H,), 0.0, torch.float32),      # A = -exp(a_log) = -1
        "dt_bias": full((H,), 0.0, torch.float32),
        "d_skip": full((H,), 1.0, torch.float32),
        "norm_scale": full((di,), 0.0, dt),
        "out_proj": dense_init(gen, (di, d), dt, n_stack=n_stack),
    }


def _split_in_proj(cfg, zxbcdt):
    di = d_inner_of(cfg)
    N = cfg.ssm.d_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    assert dt.shape[-1] == n_ssm_heads(cfg)
    return z, xBC, dt


def _causal_conv(xBC, w, b, width):
    """Depthwise causal conv via shifted adds.  xBC: (B, S, Cd); w: (W, Cd)."""
    out = xBC * w[width - 1]
    for i in range(1, width):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[width - 1 - i]
    return silu(out + b)


def mamba_sublayer(cfg, p, x, *, return_state: bool = False, sp: bool = False):
    """Full Mamba2 block: in_proj -> conv -> SSD -> gate -> out_proj.

    x: (B, S, d).  Returns y, or (y, (conv_state, ssm_state)) with
    ``return_state``: conv_state (B, W-1, conv_dim) holds the last W-1 rows
    of the pre-conv input (zeros in front when S < W-1), ssm_state
    (B, H, P, N) float32 is the scan's final state.

    ``sp``: x is this rank's rows of the sequence (``models.forward``'s cut
    under ``sp_attention``).  The reference keeps the mixer's heads whole
    over the sequence (``ssm_heads: P(dp)``), so the mixer runs on the
    gathered sequence (``sharding.seq_gather``) and y is this rank's rows
    (``seq_slice``); the states are the whole row's, the same on every
    rank of a seq group."""
    if sp:
        ctx = current()
        seq = (ctx.mesh, tuple(ctx.opt("seq_axes", ("model",))))
        out = mamba_sublayer(cfg, p, seq_gather(x, *seq), return_state=return_state)
        if return_state:
            return seq_slice(out[0], *seq), out[1]
        return seq_slice(out, *seq)
    ssm = cfg.ssm
    H, P, N = n_ssm_heads(cfg), ssm.head_dim, ssm.d_state
    di = d_inner_of(cfg)
    z, xBC, dt_raw = _split_in_proj(cfg, x @ p["in_proj"])
    xBC_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], ssm.conv_width)
    Bsz, S = x.shape[:2]
    xh = xBC_conv[..., :di].reshape(Bsz, S, H, P)
    Bmat = xBC_conv[..., di:di + N]
    Cmat = xBC_conv[..., di + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a_neg = -torch.exp(p["a_log"])
    y, state = ops.ssd_scan(xh, dt, a_neg, Bmat, Cmat, chunk=ssm.chunk)
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = rmsnorm(y * silu(z), p["norm_scale"])
    out = y @ p["out_proj"]
    if not return_state:
        return out
    w = ssm.conv_width
    conv_state = F.pad(xBC, (0, 0, w - 1, 0))[:, S:S + w - 1]
    return out, (conv_state, state)


def mamba_decode_sublayer(cfg, p, x, conv_state, ssm_state):
    """One-token recurrent update.  x: (B, 1, d); conv_state:
    (B, W-1, conv_dim); ssm_state: (B, H, P, N) float32.

    The O(1) update runs as plain PyTorch on either device: the JAX package
    has no kernel for it either.  It updates ``conv_state`` and
    ``ssm_state`` IN PLACE (the JAX package returns new arrays) and returns
    (y (B, 1, d), conv_state, ssm_state)."""
    ssm = cfg.ssm
    H, P, N = n_ssm_heads(cfg), ssm.head_dim, ssm.d_state
    di = d_inner_of(cfg)
    z, xBC, dt_raw = _split_in_proj(cfg, x @ p["in_proj"])
    win = torch.cat([conv_state, xBC], dim=1)                  # (B, W, Cd)
    conv_out = silu(torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"])
    conv_state.copy_(win[:, 1:])
    xh = conv_out[:, :di].reshape(-1, H, P).float()
    Bmat = conv_out[:, di:di + N].float()
    Cmat = conv_out[:, di + N:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])      # (B, H)
    dA = torch.exp(dt * -torch.exp(p["a_log"]))
    upd = torch.einsum("bhp,bn,bh->bhpn", xh, Bmat, dt)
    ssm_state.mul_(dA[..., None, None]).add_(upd)
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cmat)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = rmsnorm(y * silu(z), p["norm_scale"])
    return y @ p["out_proj"], conv_state, ssm_state
