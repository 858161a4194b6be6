"""Model assembly, dense / moe / ssm / hybrid families: init, prefill
forward and cached decode.

Port of those families of ``repro.models.model``.  Params and cache keep
the JAX package's nesting: every layer-group tensor has a stacked leading
axis (``params["layers"]["b0_dense"]["attn"]["wq"]`` is ``(n_groups, d,
q_dim)``).  Groups:

  dense  : [attn+mlp]                                x n_layers
  moe    : [attn+moe]                                x n_layers (mixtral)
           [attn+mlp x (moe_every-1), attn+moe]      x n_layers / moe_every
                                                     (llama4-maverick)
  ssm    : [mamba]                                   x n_layers
  hybrid : [mamba x attn_every, shared attn+mlp]     x n_layers / attn_every

The hybrid's shared block (zamba2) is ONE unstacked param set,
``params["shared_attn"]``, applied after every group; its cache
``b{i}_shared`` has one K/V slice per application.  Attention caches are
``(n_groups, B, max_len, H_kv, D)`` per K and V; a mamba block's cache is
``conv`` ``(n_groups, B, W-1, conv_dim)`` and ``ssm`` ``(n_groups, B, H, P,
N)`` float32.  An attention block applies the config's sliding window
(mixtral) in prefill and decode.  ``forward`` returns the MoE blocks'
summed aux loss.  The JAX ``lax.scan`` over layer groups is a Python loop
here.  The other families (VLM, audio) belong to later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import (contiguous_block_tokens,
                                                 identity_block_table)
from . import attention as A
from . import mlp as M
from . import moe as X
from . import ssm as S
from .common import apply_norm, dense_init, dtype_of, init_norm


def group_layout(cfg) -> Tuple[Tuple[str, ...], int]:
    """Returns (block kinds within a group, number of groups)."""
    if cfg.family == "dense":
        return ("dense",), cfg.n_layers
    if cfg.family == "moe":
        if cfg.moe_every == 1:
            return ("moe",), cfg.n_layers
        return ("dense",) * (cfg.moe_every - 1) + ("moe",), \
            cfg.n_layers // cfg.moe_every
    if cfg.family == "ssm":
        return ("mamba",), cfg.n_layers
    if cfg.family == "hybrid":
        return ("mamba",) * cfg.attn_every + ("shared_attn",), \
            cfg.n_layers // cfg.attn_every
    raise NotImplementedError(
        f"the port runs the dense, moe, ssm and hybrid families; {cfg.family!r} "
        "is not ported yet")


def _cache_key(i: int, kind: str) -> str:
    return f"b{i}_shared" if kind == "shared_attn" else f"b{i}_{kind}"


def _init_block(cfg, kind: str, gen: torch.Generator, n_stack: int):
    lead = (n_stack,) if n_stack else ()
    if kind == "mamba":
        return {"ln1": init_norm(cfg, lead, device=gen.device),
                "mamba": S.init_mamba(cfg, gen, n_stack=n_stack)}
    block = {"ln1": init_norm(cfg, lead, device=gen.device),
             "attn": A.init_attention(cfg, gen, n_stack=n_stack),
             "ln2": init_norm(cfg, lead, device=gen.device)}
    if kind == "moe":
        block["moe"] = X.init_moe(cfg, gen, n_stack=n_stack)
    else:
        block["mlp"] = M.init_mlp(cfg, gen, n_stack=n_stack)
    return block


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
    params["layers"] = {f"b{i}_{kind}": _init_block(cfg, kind, gen, n_groups)
                        for i, kind in enumerate(kinds) if kind != "shared_attn"}
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_block(cfg, "dense", gen, 0)
    return params


def _layer(tree, g: int):
    """Group ``g``'s slice of a stacked param / cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _block_params(params, gp, i: int, kind: str):
    return params["shared_attn"] if kind == "shared_attn" else gp[f"b{i}_{kind}"]


def forward(cfg, params, tokens, *, collect_cache: bool = False,
            kv_max: int = 0):
    """tokens: (B, S) int -> (logits (B, S, V), aux, cache | None); aux is
    the float32 sum of the MoE blocks' aux losses (0 without MoE).

    With ``collect_cache`` an attention block's cache holds the prompt's
    K/V in rows [0, S) of a ``max(kv_max, S)``-row buffer, zeros after, and
    a mamba block's cache its conv window and final SSM state."""
    kinds, n_groups = group_layout(cfg)
    B, Sq = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(Sq, device=x.device)
    cache = (init_cache(cfg, B, max(kv_max, Sq), device=x.device)
             if collect_cache else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        gp = _layer(params["layers"], g)
        for i, kind in enumerate(kinds):
            p = _block_params(params, gp, i, kind)
            c = cache[_cache_key(i, kind)] if collect_cache else None
            h = apply_norm(cfg, p.get("ln1"), x)
            if kind == "mamba":
                if collect_cache:
                    y, (conv_s, ssm_s) = S.mamba_sublayer(
                        cfg, p["mamba"], h, return_state=True)
                    c["conv"][g], c["ssm"][g] = conv_s, ssm_s
                else:
                    y = S.mamba_sublayer(cfg, p["mamba"], h)
                x = x + y
                continue
            attn_out, (k, v) = A.attn_sublayer(
                cfg, p["attn"], h, positions=positions, causal=True,
                window=cfg.sliding_window)
            x = x + attn_out
            if collect_cache:
                c["k"][g, :, :Sq] = k
                c["v"][g, :, :Sq] = v
            h = apply_norm(cfg, p["ln2"], x)
            if kind == "moe":
                y, a = X.moe_sublayer(cfg, p["moe"], h)
                aux = aux + a
            else:
                y = M.mlp_sublayer(cfg, p["mlp"], h)
            x = x + y
    x = apply_norm(cfg, params["final_norm"], x)
    logits = x @ _head(cfg, params)
    return logits, aux, cache


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zero cache: per attention block K and V of (n_groups, batch, max_len,
    H_kv, D); per mamba block ``conv`` (n_groups, batch, W-1, conv_dim) and
    ``ssm`` (n_groups, batch, H, P, N) float32."""
    kinds, n_groups = group_layout(cfg)
    dt = dtype_of(cfg)
    cache = {}
    for i, kind in enumerate(kinds):
        if kind == "mamba":
            ssm = cfg.ssm
            cache[_cache_key(i, kind)] = {
                "conv": torch.zeros((n_groups, batch, ssm.conv_width - 1,
                                     S.conv_dim_of(cfg)), dtype=dt, device=device),
                "ssm": torch.zeros((n_groups, batch, S.n_ssm_heads(cfg),
                                    ssm.head_dim, ssm.d_state),
                                   dtype=torch.float32, device=device)}
        else:
            shape = (n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache[_cache_key(i, kind)] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    return cache


_TABLES: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _identity_table(batch: int, max_len: int, device) -> torch.Tensor:
    """The identity block table of a contiguous (batch, max_len) cache,
    made once per shape and device and kept, so every step reads the same
    tensor.  One made while a CUDA graph is being captured lives in that
    graph's memory pool and is not kept."""
    key = (batch, max_len, torch.device(device))
    table = _TABLES.get(key)
    if table is None:
        table = identity_block_table(batch, max_len,
                                     contiguous_block_tokens(max_len),
                                     device=device)
        if not (key[2].type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _TABLES[key] = table
    return table


def decode_step(cfg, params, token, cache, cache_len):
    """token: (B, 1) int; cache_len: tokens valid AFTER this step, a Python
    int or a 0-dim integer tensor on the cache's device (the JAX package
    takes a traced scalar).  With a tensor nothing is read on the host, so
    the step can be captured in a CUDA graph, and the caller checks that
    it lies in [1, max_len].  Writes this step's K/V and recurrent state
    into ``cache`` in place and returns (logits (B, 1, V), cache)."""
    kinds, n_groups = group_layout(cfg)
    x = F.embedding(token, params["embed"])
    B = token.shape[0]
    attn = [_cache_key(i, k) for i, k in enumerate(kinds) if k != "mamba"]
    if attn:
        # one block table and one context-length vector for every layer
        max_len = cache[attn[0]]["k"].shape[2]
        table = _identity_table(B, max_len, x.device)
        if isinstance(cache_len, torch.Tensor):
            context_lens = cache_len.to(torch.int32).expand(B).contiguous()
        else:
            context_lens = torch.full((B,), cache_len, dtype=torch.int32,
                                      device=x.device)
    for g in range(n_groups):
        gp = _layer(params["layers"], g)
        for i, kind in enumerate(kinds):
            p = _block_params(params, gp, i, kind)
            c = cache[_cache_key(i, kind)]
            h = apply_norm(cfg, p.get("ln1"), x)
            if kind == "mamba":
                y, _, _ = S.mamba_decode_sublayer(cfg, p["mamba"], h,
                                                  c["conv"][g], c["ssm"][g])
                x = x + y
                continue
            attn_out, _, _ = A.attn_decode_sublayer(
                cfg, p["attn"], h, c["k"][g], c["v"][g], cache_len,
                window=cfg.sliding_window, block_table=table,
                context_lens=context_lens)
            x = x + attn_out
            h = apply_norm(cfg, p["ln2"], x)
            if kind == "moe":
                y, _ = X.moe_sublayer(cfg, p["moe"], h)
            else:
                y = M.mlp_sublayer(cfg, p["mlp"], h)
            x = x + y
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ _head(cfg, params), cache
