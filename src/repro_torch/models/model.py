"""Model assembly, dense / moe / ssm / hybrid / audio / vlm families:
init, prefill forward and cached decode.

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
  audio  : encoder [attn+mlp] x n_encoder_layers (non-causal), then
           [self attn, cross attn, mlp]              x n_layers (whisper)
  vlm    : [attn+mlp]                                x n_layers (paligemma)

The hybrid's shared block (zamba2) is ONE unstacked param set,
``params["shared_attn"]``, applied after every group; its cache
``b{i}_shared`` has one K/V slice per application.  Attention caches are
``(n_groups, B, max_len, H_kv, D)`` per K and V; a mamba block's cache is
``conv`` ``(n_groups, B, W-1, conv_dim)`` and ``ssm`` ``(n_groups, B, H, P,
N)`` float32.  An attention block applies the config's sliding window
(mixtral) in prefill and decode.  ``forward`` returns the MoE blocks'
summed aux loss.  The JAX ``lax.scan`` over layer groups is a Python loop
here.

Whisper (audio): ``params["encoder"]`` holds the stacked encoder blocks
and their final norm, as in the JAX package; the caller passes the
frame embeddings (the conv front end is a stub in both packages).  A
decoder block's cache also holds ``cross_k`` / ``cross_v``, the encoder
output's K and V, in ``cross_rows(encoder_seq)`` rows (1536 at 1500):
rows past ``encoder_seq`` stay zero and are masked, so the paged kernel
reads the cache in 64-token blocks.  The JAX cache has ``encoder_seq``
rows; the rows that exist in both are equal.

PaliGemma (vlm) is the dense stack; ``forward(..., prefix_embeds=(B, P,
d))`` puts the patch embeddings (the SigLIP front end is a stub in both
packages) before the token embeddings, attends over them bidirectionally
(``prefix_len = P``: every query sees the prefix) and returns logits of
the text positions only.  Decode needs nothing more: every cached row is
visible to the new token.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.paged_attention import (contiguous_block_tokens,
                                                 identity_block_table)
from repro_torch.tree import tree_map
from . import attention as A
from . import mlp as M
from . import moe as X
from . import ssm as S
from .common import (apply_norm, dense_init, dtype_of, init_norm, kept,
                     sinusoidal_at, sinusoidal_positions)

# the cross cache's rows are a multiple of this: the paged kernel's block
CROSS_BLOCK = 64


def cross_rows(encoder_seq: int) -> int:
    """Rows of the port's cross cache for ``encoder_seq`` encoder frames."""
    return -(-encoder_seq // CROSS_BLOCK) * CROSS_BLOCK


def group_layout(cfg) -> Tuple[Tuple[str, ...], int]:
    """Returns (block kinds within a group, number of groups)."""
    if cfg.family in ("dense", "vlm"):
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
    if cfg.family == "audio":
        return ("dec",), cfg.n_layers
    raise ValueError(f"unknown family {cfg.family!r}")


def _cache_key(i: int, kind: str) -> str:
    return f"b{i}_shared" if kind == "shared_attn" else f"b{i}_{kind}"


def _init_block(cfg, kind: str, gen: torch.Generator, n_stack: int):
    lead = (n_stack,) if n_stack else ()
    if kind == "mamba":
        return {"ln1": init_norm(cfg, lead, device=gen.device),
                "mamba": S.init_mamba(cfg, gen, n_stack=n_stack)}
    block = {"ln1": init_norm(cfg, lead, device=gen.device),
             "attn": A.init_attention(cfg, gen, n_stack=n_stack)}
    if kind == "dec":
        block["lnx"] = init_norm(cfg, lead, device=gen.device)
        block["cross"] = A.init_attention(cfg, gen, n_stack=n_stack)
    block["ln2"] = init_norm(cfg, lead, device=gen.device)
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
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": _init_block(cfg, "enc", gen, cfg.n_encoder_layers),
            "final_norm": init_norm(cfg, device=gen.device)}
    return params


def _layer(tree, g: int):
    """Group ``g``'s slice of a stacked param / cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


def _groups(tree):
    """A stacked param tree for ``_layer``.  Under grad each stacked leaf
    is unbound once: the backward of an unbind stacks the groups'
    gradients once, where indexing group by group would give each group a
    zero-filled gradient of the whole stack to add."""
    if not torch.is_grad_enabled():
        return tree
    return tree_map(lambda t: t.unbind(0), tree)


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _block_params(params, gp, i: int, kind: str):
    return params["shared_attn"] if kind == "shared_attn" else gp[f"b{i}_{kind}"]


def encode(cfg, params, encoder_embeds):
    """Whisper's encoder: frame embeddings (B, S_enc, d) cast to the
    model's dtype, plus the sinusoidal positions, through the encoder
    blocks (non-causal flash attention) and the final norm.  Under grad
    with ``cfg.remat`` each block keeps only its input and recomputes its
    activations in the backward (the reference's
    ``jax.checkpoint(enc_body)``); without grad nothing changes."""
    e = encoder_embeds.to(dtype_of(cfg))
    e = e + sinusoidal_positions(e.shape[1], cfg.d_model,
                                 device=e.device).to(e.dtype)[None]
    positions = torch.arange(e.shape[1], device=e.device)
    enc = params["encoder"]
    layers = _groups(enc["layers"])

    def block(e, g):
        return _attn_block(cfg, _layer(layers, g), "enc", e, positions, causal=False)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_encoder_layers):
        e = checkpoint(block, e, g, use_reentrant=False) if remat else block(e, g)
    return apply_norm(cfg, enc["final_norm"], e)


def _attn_block(cfg, p, kind: str, x, positions, *, causal: bool = True, enc=None,
                prefix_len: int = 0):
    """A pre-norm attention block: self-attention (the first ``prefix_len``
    positions seen by every query), a decoder block's cross-attention over
    the encoder output ``enc``, then the MLP (or MoE).  Returns (x, the MoE
    aux loss or None, (k, v), the cross (k, v) or None)."""
    attn_out, kv = A.attn_sublayer(cfg, p["attn"], apply_norm(cfg, p.get("ln1"), x),
                                   positions=positions, causal=causal,
                                   window=cfg.sliding_window, prefix_len=prefix_len)
    x = x + attn_out
    cross_kv = None
    if kind == "dec":
        y, cross_kv = A.cross_attn_sublayer(cfg, p["cross"],
                                            apply_norm(cfg, p["lnx"], x), enc)
        x = x + y
    h = apply_norm(cfg, p["ln2"], x)
    if kind == "moe":
        y, aux = X.moe_sublayer(cfg, p["moe"], h)
        return x + y, aux, kv, cross_kv
    return x + M.mlp_sublayer(cfg, p["mlp"], h), None, kv, cross_kv


def forward(cfg, params, tokens, *, prefix_embeds=None, encoder_embeds=None,
            collect_cache: bool = False, kv_max: int = 0):
    """tokens: (B, S) int -> (logits (B, S, V), aux, cache | None); aux is
    the float32 sum of the MoE blocks' aux losses (0 without MoE).
    ``prefix_embeds`` (B, P, d): paligemma's patch embeddings, cast to the
    embedding's dtype and put before the tokens' embeddings, a prefix that
    every position attends to; the logits are those of the S text
    positions.  ``encoder_embeds`` (B, S_enc, d): whisper's frame
    embeddings, which an encoder-decoder needs and no other family takes.

    With ``collect_cache`` an attention block's cache holds the K/V of the
    P + S positions in rows [0, P + S) of a ``max(kv_max, P + S)``-row
    buffer, zeros after, a decoder block's also the encoder output's K/V in
    rows [0, S_enc) of its cross cache (S_enc must be the config's
    ``encoder_seq``, the length the decode step attends), and a mamba
    block's cache its conv window and final SSM state."""
    kinds, n_groups = group_layout(cfg)
    B = tokens.shape[0]
    x = F.embedding(tokens, params["embed"])
    prefix_len = 0
    if prefix_embeds is not None:
        if prefix_embeds.dim() != 3 or prefix_embeds.shape[0] != B \
                or prefix_embeds.shape[2] != cfg.d_model:
            raise ValueError(f"prefix_embeds must be (B={B}, P, d_model={cfg.d_model}), "
                             f"got {tuple(prefix_embeds.shape)}")
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        prefix_len = prefix_embeds.shape[1]
    Sq = x.shape[1]
    positions = torch.arange(Sq, device=x.device)
    enc = None
    if cfg.is_encoder_decoder:
        if encoder_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass encoder_embeds")
        if collect_cache and encoder_embeds.shape[1] != cfg.encoder_seq:
            raise ValueError(f"encoder_embeds has {encoder_embeds.shape[1]} frames; "
                             f"the cache holds encoder_seq = {cfg.encoder_seq}")
        enc = encode(cfg, params, encoder_embeds)
        x = x + sinusoidal_positions(Sq, cfg.d_model,
                                     device=x.device).to(x.dtype)[None]
    elif encoder_embeds is not None:
        raise ValueError(f"{cfg.name} takes no encoder_embeds")
    cache = (init_cache(cfg, B, max(kv_max, Sq), device=x.device)
             if collect_cache else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _groups(params["layers"])

    def group(x, g):
        """Layer group ``g`` on x: (x, the group's MoE aux loss or None)."""
        gp = _layer(layers, g)
        aux = None
        for i, kind in enumerate(kinds):
            p = _block_params(params, gp, i, kind)
            c = cache[_cache_key(i, kind)] if collect_cache else None
            if kind == "mamba":
                h = apply_norm(cfg, p.get("ln1"), x)
                if collect_cache:
                    y, (conv_s, ssm_s) = S.mamba_sublayer(
                        cfg, p["mamba"], h, return_state=True)
                    c["conv"][g], c["ssm"][g] = conv_s, ssm_s
                else:
                    y = S.mamba_sublayer(cfg, p["mamba"], h)
                x = x + y
                continue
            x, a, (k, v), cross_kv = _attn_block(cfg, p, kind, x, positions, enc=enc,
                                                 prefix_len=prefix_len)
            if a is not None:
                aux = a if aux is None else aux + a
            if collect_cache:
                c["k"][g, :, :Sq] = k
                c["v"][g, :, :Sq] = v
                if cross_kv is not None:
                    ek, ev = cross_kv
                    c["cross_k"][g, :, :ek.shape[1]] = ek
                    c["cross_v"][g, :, :ev.shape[1]] = ev
        return x, aux

    # remat (the reference's jax.checkpoint(group_body)): under grad each
    # group keeps only its input and recomputes its activations in the
    # backward; without grad (prefill, serve, the captured step) nothing
    # changes
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    for g in range(n_groups):
        if remat:
            x, a = checkpoint(group, x, g, use_reentrant=False)
        else:
            x, a = group(x, g)
        if a is not None:
            aux = aux + a
    # the JAX package cuts the logits at prefix_len; the rows of x are cut
    # before the head instead, the same numbers without the prefix's logits
    x = apply_norm(cfg, params["final_norm"], x[:, prefix_len:])
    logits = x @ _head(cfg, params)
    return logits, aux, cache


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zero cache: per attention block K and V of (n_groups, batch, max_len,
    H_kv, D), a decoder block (whisper) also ``cross_k`` / ``cross_v`` of
    (n_groups, batch, cross_rows(encoder_seq), H_kv, D); per mamba block
    ``conv`` (n_groups, batch, W-1, conv_dim) and ``ssm`` (n_groups, batch,
    H, P, N) float32."""
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
            c = cache[_cache_key(i, kind)] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
            if kind == "dec":
                shape = (n_groups, batch, cross_rows(cfg.encoder_seq),
                         cfg.n_kv_heads, cfg.head_dim)
                c["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
                c["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def _identity_table(batch: int, max_len: int, device) -> torch.Tensor:
    """The identity block table of a contiguous (batch, max_len) cache."""
    return kept(("table", batch, max_len), device, lambda: identity_block_table(
        batch, max_len, contiguous_block_tokens(max_len), device=device))


def _constant_lens(batch: int, n: int, device) -> torch.Tensor:
    """``context_lens`` of ``n`` for every sequence (the cross cache's)."""
    return kept(("lens", batch, n), device, lambda: torch.full(
        (batch,), n, dtype=torch.int32, device=device))


def decode_step(cfg, params, token, cache, cache_len):
    """token: (B, 1) int; cache_len: tokens valid AFTER this step, a Python
    int or a 0-dim integer tensor on the cache's device (the JAX package
    takes a traced scalar).  With a tensor nothing is read on the host, so
    the step can be captured in a CUDA graph, and the caller checks that
    it lies in [1, max_len].  Writes this step's K/V and recurrent state
    into ``cache`` in place and returns (logits (B, 1, V), cache).  A
    decoder block (whisper) adds the sinusoidal position ``cache_len - 1``
    and attends over its cross cache's first ``encoder_seq`` rows.

    Under a PICNIC context (``attention.picnic_active``: ``picnic_decode``
    with seq axes of more than one rank) ``cache`` is this rank's shard
    (``sharding.local_cache``): every attention cache ``(n_groups, B /
    n_dp, max_len / n_seq, H_kv, D)``, the cross cache and the recurrent
    state of SSM / hybrid models cut in the batch only (the state is the
    same on every rank of a seq group).  ``token`` holds the rank's batch
    rows.  Every attention block gets the global ``context_lens`` and the
    identity table of the shard; ``attention.picnic_decode_attention``
    takes the rank's key offset, its index over the seq axes times the
    shard's rows, from the mesh."""
    kinds, n_groups = group_layout(cfg)
    x = F.embedding(token, params["embed"])
    B = token.shape[0]
    if cfg.is_encoder_decoder:          # whisper: absolute sinusoidal positions
        x = x + sinusoidal_at(cache_len - 1, cfg.d_model,
                              device=x.device).to(x.dtype)[None, None]
        cross_table = _identity_table(B, cross_rows(cfg.encoder_seq), x.device)
        cross_lens = _constant_lens(B, cfg.encoder_seq, x.device)
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
            if kind == "dec":
                x = x + A.cross_attn_decode_sublayer(
                    cfg, p["cross"], apply_norm(cfg, p["lnx"], x),
                    c["cross_k"][g], c["cross_v"][g], block_table=cross_table,
                    context_lens=cross_lens)
            h = apply_norm(cfg, p["ln2"], x)
            if kind == "moe":
                y, _ = X.moe_sublayer(cfg, p["moe"], h, with_aux=False)
            else:
                y = M.mlp_sublayer(cfg, p["mlp"], h)
            x = x + y
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ _head(cfg, params), cache
