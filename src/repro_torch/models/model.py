"""Model assembly, dense family: init, prefill forward and cached decode.

Port of the dense family of ``repro.models.model``.  Params and cache keep
the JAX package's nesting: every layer-group tensor has a stacked leading
axis (``params["layers"]["b0_dense"]["attn"]["wq"]`` is ``(n_layers, d,
q_dim)``), and the cache is ``(n_layers, B, max_len, H_kv, D)`` per K and
V.  The JAX ``lax.scan`` over layer groups is a Python loop here.  The
other families (MoE, SSM, hybrid, VLM, audio) belong to later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import (contiguous_block_tokens,
                                                 identity_block_table)
from . import attention as A
from . import mlp as M
from .common import apply_norm, dense_init, dtype_of, init_norm


def group_layout(cfg) -> Tuple[Tuple[str, ...], int]:
    """Returns (block kinds within a group, number of groups)."""
    if cfg.family == "dense":
        return ("dense",), cfg.n_layers
    raise NotImplementedError(
        f"the port runs the dense family; {cfg.family!r} is not ported yet")


def init_params(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Random weights drawn from ``gen`` on its device, with the JAX
    package's distributions (normal * fan_in**-0.5, 0.02 for the embedding,
    RMSNorm scales at zero).  The values are not the JAX package's; give
    both packages the same weights with ``repro_torch.params.from_jax``."""
    dt = dtype_of(cfg)
    kinds, n_groups = group_layout(cfg)
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=0.02),
        "final_norm": init_norm(cfg, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    params["layers"] = {
        f"b{i}_{kind}": {
            "ln1": init_norm(cfg, (n_groups,), device=gen.device),
            "attn": A.init_attention(cfg, gen, n_stack=n_groups),
            "ln2": init_norm(cfg, (n_groups,), device=gen.device),
            "mlp": M.init_mlp(cfg, gen, n_stack=n_groups),
        } for i, kind in enumerate(kinds)}
    return params


def _layer(tree, g: int):
    """Group ``g``'s slice of a stacked param / cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg, params, tokens, *, collect_cache: bool = False,
            kv_max: int = 0):
    """tokens: (B, S) int -> (logits (B, S, V), aux, cache | None).

    With ``collect_cache`` the cache holds the prompt's K/V in rows [0, S)
    of a ``max(kv_max, S)``-row buffer, zeros after."""
    kinds, n_groups = group_layout(cfg)
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(S, device=x.device)
    cache = None
    if collect_cache:
        shape = (n_groups, B, max(kv_max, S), cfg.n_kv_heads, cfg.head_dim)
        cache = {f"b{i}_{kind}": {
            "k": torch.zeros(shape, dtype=x.dtype, device=x.device),
            "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
            for i, kind in enumerate(kinds)}
    for g in range(n_groups):
        gp = _layer(params["layers"], g)
        for i, kind in enumerate(kinds):
            p = gp[f"b{i}_{kind}"]
            h = apply_norm(cfg, p.get("ln1"), x)
            attn_out, (k, v) = A.attn_sublayer(
                cfg, p["attn"], h, positions=positions, causal=True,
                window=cfg.sliding_window)
            x = x + attn_out
            if collect_cache:
                c = cache[f"b{i}_{kind}"]
                c["k"][g, :, :S] = k
                c["v"][g, :, :S] = v
            h = apply_norm(cfg, p["ln2"], x)
            x = x + M.mlp_sublayer(cfg, p["mlp"], h)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = x @ _head(cfg, params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, cache


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zero cache: per block, K and V of (n_layers, batch, max_len, H_kv, D)."""
    kinds, n_groups = group_layout(cfg)
    shape = (n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {f"b{i}_{kind}": {
        "k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
        "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
        for i, kind in enumerate(kinds)}


def decode_step(cfg, params, token, cache, cache_len):
    """token: (B, 1) int; cache_len: tokens valid AFTER this step.
    Writes this step's K/V into ``cache`` in place and returns
    (logits (B, 1, V), cache)."""
    kinds, n_groups = group_layout(cfg)
    cache_len = int(cache_len)
    x = F.embedding(token, params["embed"])
    B = token.shape[0]
    max_len = cache[f"b0_{kinds[0]}"]["k"].shape[2]
    # one identity table and one context-length vector for every layer
    table = identity_block_table(B, max_len, contiguous_block_tokens(max_len),
                                 device=x.device)
    context_lens = torch.full((B,), cache_len, dtype=torch.int32,
                              device=x.device)
    for g in range(n_groups):
        gp = _layer(params["layers"], g)
        for i, kind in enumerate(kinds):
            key = f"b{i}_{kind}"
            p, c = gp[key], cache[key]
            h = apply_norm(cfg, p.get("ln1"), x)
            attn_out, _, _ = A.attn_decode_sublayer(
                cfg, p["attn"], h, c["k"][g], c["v"][g], cache_len,
                window=cfg.sliding_window, block_table=table,
                context_lens=context_lens)
            x = x + attn_out
            h = apply_norm(cfg, p["ln2"], x)
            x = x + M.mlp_sublayer(cfg, p["mlp"], h)
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ _head(cfg, params), cache
