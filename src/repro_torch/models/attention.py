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
quadratic reference, for tests.

PICNIC's distributed-scratchpad decode (``picnic_decode_attention``): under
a ``ShardingCtx`` with ``picnic_decode`` whose ``seq_axes`` span more than
one rank, each rank holds its shard of every self-attention cache's rows,
the owning rank appends the new K/V, each rank takes the float32 partial
of its shard (``decode_attention_partial``, the paged kernel's partial
mode) and ``combine_partials`` reduces the partials over the seq axes'
process groups: the paper's in-network reduction (§III).  The
sequence-parallel prefill and prefill with a query offset belong to later
slices of the port.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.layout import axes_groups, axes_index, axes_size
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


# ---------------------------------------------------------------------------
# PICNIC sequence-sharded decode
# ---------------------------------------------------------------------------

def decode_attention_partial(q, k_pool, v_pool, block_table, context_lens, *,
                             key_offset: int, window=None):
    """Local partial softmax terms of one shard of a sequence-sharded KV
    cache: q (B, Hq, D); the shard's pool (N, bt, Hkv, D) through
    ``block_table``, local key j at global position ``key_offset + j``;
    ``context_lens`` (B,) global.  Returns float32 (o (B, Hq, D), m (B,
    Hq), l (B, Hq)): o = sum_j exp(s_j - m) v_j, m the local max, l the
    local denominator (the reference takes a boolean ``valid`` instead of
    the offset and lengths; a shard with no kept key gives (0, NEG_INF, 0)
    here, (sum v, NEG_INF, S_local) there, equal after the combine)."""
    return ops.paged_attention_partial(q, k_pool, v_pool, block_table, context_lens,
                                       key_offset=key_offset, window=window)


def combine_partials(o, m, l, group):
    """The in-network reduction of partial softmax terms: over ``group``, a
    process group or a sequence of them (then one after the other, the
    hierarchical reduction of the reference's seq axes), M = max m (an
    all-reduce MAX), then the sums of o e^(m - M) and l e^(m - M) (all-reduce
    SUM).  Returns o / max(l, 1e-30), float32 (B, Hq, D)."""
    for g in (group if isinstance(group, (tuple, list)) else (group,)):
        M = m.clone()
        dist.all_reduce(M, dist.ReduceOp.MAX, group=g)
        scale = torch.exp(m - M)
        o = o * scale[..., None]
        l = l * scale
        dist.all_reduce(o, dist.ReduceOp.SUM, group=g)
        dist.all_reduce(l, dist.ReduceOp.SUM, group=g)
        m = M
    return o / l.clamp_min(1e-30)[..., None]


def picnic_decode_attention(q, k_new, v_new, k_cache, v_cache, cache_len, *, mesh,
                            block_table, context_lens, seq_axes=("model",), window=None):
    """PICNIC distributed-scratchpad decode over a sequence-sharded cache:
    this rank holds rows [base, base + S_local) of every sequence, base its
    index over ``seq_axes`` times S_local.  The new token's K/V is
    appended by the OWNING rank only (the paper's cyclic scratchpad
    write): every rank writes ``where(owns, new, current)`` at its clamped
    local index, IN PLACE, so a 0-dim tensor ``cache_len`` is never read on
    the host.  Then each rank's partial and the combine over the seq axes'
    groups.  q, k_new, v_new: (B, 1, H, D); k/v_cache: (B, S_local, Hkv,
    D); ``block_table`` the identity table of the local cache as a pool;
    ``context_lens`` (B,) global.  Returns (out (B, 1, Hq, D), k_cache,
    v_cache)."""
    B, S_local = k_cache.shape[:2]
    base = axes_index(mesh, seq_axes) * S_local
    if isinstance(cache_len, torch.Tensor):
        gpos = (cache_len - 1).reshape(1).long()
    else:
        n_rows = S_local * axes_size(mesh, seq_axes)
        if not 1 <= cache_len <= n_rows:
            raise ValueError(f"cache_len {cache_len} outside [1, {n_rows}]")
        gpos = torch.full((1,), cache_len - 1, dtype=torch.long, device=q.device)
    li = (gpos - base).clamp(0, S_local - 1)
    owns = (gpos >= base) & (gpos < base + S_local)
    for buf, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = buf.index_select(1, li)
        buf.index_copy_(1, li, torch.where(owns, new.to(buf.dtype), cur))
    bt = S_local // block_table.shape[1]
    pool_k = k_cache.view(B * S_local // bt, bt, *k_cache.shape[2:])
    pool_v = v_cache.view(B * S_local // bt, bt, *v_cache.shape[2:])
    o, m, l = decode_attention_partial(q[:, 0], pool_k, pool_v, block_table, context_lens,
                                       key_offset=base, window=window)
    out = combine_partials(o, m, l, axes_groups(mesh, seq_axes))
    return out[:, None].to(q.dtype), k_cache, v_cache


def picnic_active(ctx=None) -> bool:
    """Whether decode runs PICNIC's sharded path: a context with
    ``picnic_decode`` whose ``seq_axes`` span more than one rank."""
    ctx = shctx.current() if ctx is None else ctx
    return bool(ctx is not None and ctx.opt("picnic_decode")
                and axes_size(ctx.mesh, ctx.opt("seq_axes", ("model",))) > 1)


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
    device.  Returns (out (B, 1, d), cache_k, cache_v).

    Under a PICNIC context (``picnic_active``) cache_k/v are this rank's
    shard of the rows, ``block_table`` the identity table of that shard,
    ``context_lens`` global, and ``picnic_decode_attention`` appends and
    attends."""
    q, k, v = qkv_project(cfg, p, x)
    B, max_len = cache_k.shape[:2]
    ctx = shctx.current()
    picnic = picnic_active(ctx)
    seq_axes = tuple(ctx.opt("seq_axes", ("model",))) if picnic else ()
    rows = max_len * axes_size(ctx.mesh, seq_axes) if picnic else max_len   # global
    if isinstance(cache_len, torch.Tensor):
        idx = (cache_len - 1).reshape(1).long()
    else:
        if not 1 <= cache_len <= rows:
            raise ValueError(f"cache_len {cache_len} outside [1, {rows}]")
        idx = torch.full((1,), cache_len - 1, dtype=torch.long, device=x.device)
    if cfg.use_rope:
        pos = idx.to(torch.float32).reshape(1, 1)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if picnic:
        out, cache_k, cache_v = picnic_decode_attention(
            q, k, v, cache_k, cache_v, cache_len, mesh=ctx.mesh, block_table=block_table,
            context_lens=context_lens, seq_axes=seq_axes, window=window)
        return out.reshape(B, 1, cfg.q_dim) @ p["wo"], cache_k, cache_v
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
