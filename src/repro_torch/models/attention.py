"""Attention: GQA/MQA/MHA projections, prefill attention and cached decode.

Port of the single-device path of ``repro.models.attention``, and of the
cross-attention that ``repro.models.model`` writes inline for whisper's
decoder (``cross_attn_sublayer``, ``cross_attn_decode_sublayer``).
Prefill attention, causal or not (whisper's encoder and cross-attention),
goes to ``kernels.ops.flash_attention`` and decode attention to
``kernels.ops.paged_attention`` over the identity block table of the
contiguous cache: the Hopper kernels on a CUDA tensor, their plain
versions on a CPU tensor; both take the sliding window (mixtral) and the
bidirectional prefix (paligemma's prefix-LM), which the kernels apply in
place of the JAX package's mask.  ``full_attention`` is the exact
quadratic reference, for tests.  The sequence-parallel and PICNIC
distributed-scratchpad paths, and prefill with a query offset, belong to
later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from .common import apply_rope, dense_init, dtype_of

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(cfg, gen: torch.Generator, *, n_stack: int = 0):
    dt = dtype_of(cfg)
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (d, cfg.q_dim), dt, n_stack=n_stack),
        "wk": dense_init(gen, (d, cfg.kv_dim), dt, n_stack=n_stack),
        "wv": dense_init(gen, (d, cfg.kv_dim), dt, n_stack=n_stack),
        "wo": dense_init(gen, (cfg.q_dim, d), dt, n_stack=n_stack),
    }


def qkv_project(cfg, p, x):
    """x: (B, S, d) -> q: (B, S, Hq, D), k/v: (B, S, Hkv, D)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def full_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                   kv_len=None, prefix_len=0):
    """Reference quadratic attention (small shapes / oracle)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qb = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), k.float()) * D ** -0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        cm = qpos[:, None] >= kpos[None, :]
        if prefix_len:
            cm |= (kpos < prefix_len)[None, :]
        valid &= cm
    if window is not None:
        valid &= (qpos[:, None] - kpos[None, :]) < window
    if kv_len is not None:
        valid &= (kpos < kv_len)[None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention sublayer (projections + rope + attention + output)
# ---------------------------------------------------------------------------

def attn_sublayer(cfg, p, x, *, positions, causal=True, window=None,
                  prefix_len=0):
    """Returns (out (B, S, d), (k, v)).  The JAX package picks between two
    exact paths by sequence length and prefix (``impl``); both are the
    flash kernel here.  ``window``: keys ``window`` or more positions
    before a query are masked.  ``prefix_len``: the first ``prefix_len``
    keys are visible to every query (paligemma's image prefix; causal,
    without a window)."""
    q, k, v = qkv_project(cfg, p, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=prefix_len)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p["wo"], (k, v)


def attn_decode_sublayer(cfg, p, x, cache_k, cache_v, cache_len, *,
                         block_table, context_lens, window=None):
    """One-token decode: x (B, 1, d); cache_k/v (B, max_len, Hkv, D) of one
    layer.  Appends the new K/V to the cache IN PLACE at ``cache_len - 1``
    (the JAX package returns an updated copy), then attends over the first
    ``cache_len`` rows through ``block_table``, the identity table of the
    cache viewed as a pool of ``max_len / bt`` blocks per sequence
    (``identity_block_table``), with ``context_lens`` = cache_len per
    sequence.  ``cache_len`` is a Python int, or a 0-dim integer tensor on
    the cache's device, as the JAX package takes a traced scalar: then no
    value is read on the host, so the step can be captured in a CUDA graph,
    and the caller checks ``1 <= cache_len <= max_len`` (an int is checked
    here).  Under a ``window`` only the keys from ``cache_len - window`` on
    are attended, a bound the kernel takes from ``context_lens`` on the
    device.  Returns (out (B, 1, d), cache_k, cache_v)."""
    q, k, v = qkv_project(cfg, p, x)
    B, max_len = cache_k.shape[:2]
    if isinstance(cache_len, torch.Tensor):
        idx = (cache_len - 1).reshape(1).long()
    else:
        if not 1 <= cache_len <= max_len:
            raise ValueError(f"cache_len {cache_len} outside [1, {max_len}]")
        idx = torch.full((1,), cache_len - 1, dtype=torch.long, device=x.device)
    if cfg.use_rope:
        pos = idx.to(torch.float32).reshape(1, 1)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
    bt = max_len // block_table.shape[1]
    pool_k = cache_k.view(B * max_len // bt, bt, *cache_k.shape[2:])
    pool_v = cache_v.view(B * max_len // bt, bt, *cache_v.shape[2:])
    out = ops.paged_attention(q[:, 0], pool_k, pool_v, block_table,
                              context_lens, window=window)
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# Cross-attention (whisper's decoder over the encoder output)
# ---------------------------------------------------------------------------

def cross_attn_sublayer(cfg, p, x, enc):
    """x: (B, S, d) decoder states; enc: (B, S_enc, d) encoder output.
    Queries from x, keys and values from enc, no mask: the flash kernel,
    non-causal, with S != S_enc (the JAX package takes the exact
    ``full_attention``).  Returns (out (B, S, d), (k, v)), k and v (B,
    S_enc, H_kv, D): the cross cache of this layer."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (enc @ p["wk"]).reshape(B, enc.shape[1], cfg.n_kv_heads, cfg.head_dim)
    v = (enc @ p["wv"]).reshape(B, enc.shape[1], cfg.n_kv_heads, cfg.head_dim)
    out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"], (k, v)


def cross_attn_decode_sublayer(cfg, p, x, cross_k, cross_v, *, block_table,
                               context_lens):
    """One decoder token over the cross cache of one layer: x (B, 1, d);
    cross_k/v (B, rows, H_kv, D), read through ``block_table``, the identity
    table of the cache viewed as ``rows / bt`` blocks a sequence, and masked
    at ``context_lens`` (the encoder's length; rows past it are padding).
    The cache is only read.  Returns (B, 1, d)."""
    B, rows = cross_k.shape[:2]
    q = (x @ p["wq"]).reshape(B, cfg.n_heads, cfg.head_dim)
    bt = rows // block_table.shape[1]
    pool_k = cross_k.view(B * rows // bt, bt, *cross_k.shape[2:])
    pool_v = cross_v.view(B * rows // bt, bt, *cross_v.shape[2:])
    out = ops.paged_attention(q, pool_k, pool_v, block_table, context_lens)
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"]
