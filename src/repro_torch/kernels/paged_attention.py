"""Decode attention through a KV block table: the Hopper kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention`` / ``_paged_kernel``).  Same function: one query token
per sequence; K/V gathered from the pool ``(N_blocks, block_tokens, H_kv,
D)`` through ``block_tables (B, max_blocks)``; KV head ``h // (H //
H_kv)``; the last block masked at ``context_lens``; a context of 0 gives
0; an online softmax that steps one pool block at a time, in float32,
output in q's dtype.  With ``use_pwl`` the rescale composes PWL segments
across blocks, so the block size is part of the result, as in the Pallas
kernel.

The kernel splits a sequence's pool blocks into ``n_splits`` contiguous
ranges, one CTA each, and merges their float32 partials (max, denominator,
unnormalised output) in a second kernel: the same function in another
summation order.  ``split_plan`` alone chooses the split; with ``use_pwl``
it takes one, so the PWL result composes block by block in order.

``window`` (the JAX model's sliding window, which the Pallas kernel does
not take) also masks the keys below ``context_lens - window``, as
``repro.models.attention.decode_attention`` does: each sequence's first
key is ``max(ctx - window, 0)``, computed from ``context_lens`` where it
lies (on the card, in the kernel), and blocks wholly below it are skipped.
Blocks stay aligned to absolute positions, so the PWL result composes as
without a window.

The partial mode (``paged_attention_plain(..., partial=True)`` /
``paged_attention_partial_cuda``, the same kernels under one flag) serves
PICNIC's sequence-sharded decode: the pool holds one shard of each
sequence, whose local key ``j`` is global position ``key_offset + j``,
``context_lens`` stay global, and the result is the shard's float32
partial of ``repro.models.attention.decode_attention_partial``: ``o =
sum exp(s - m) v`` (not normalised), ``m`` the max scaled score (natural
exp) and ``l = sum exp(s - m)``.  A head with no kept key gives (0,
NEG_INF, 0); the reference gives (sum v, NEG_INF, S_local), which the
combine weighs by exp(NEG_INF - M) = 0 all the same.  PWL is refused:
the reference's partial takes the exact exp.

Head dims 32, 64, 80, 128 and 256.  Where two stages of a split's pool
blocks do not fit in shared memory (float32 at D 256, or 128-token
blocks) the kernel runs one; a shape whose one stage does not fit either
is refused by the C entry.

A contiguous cache ``(B, max_len, H_kv, D)`` is the pool
``(B * max_len / bt, bt, H_kv, D)`` under the identity table
(``identity_block_table``): a view, no copy.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import window_arg
from .pwl import PWL_COEFFS, pwl_exp

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128, 256)
MAX_BLOCK_TOKENS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# split-KV: about WAVES CTAs per SM, and at least MIN_SPLIT_TOKENS context
# tokens a split, so a split's loads outweigh its share of the combine
WAVES = 2
MIN_SPLIT_TOKENS = 64


def split_plan(n_seq_heads: int, max_blocks: int, block_tokens: int,
               sm_count: int, *, use_pwl: bool = False):
    """``(n_splits, blocks_per_split)`` of the kernel's grid ``(B * H_kv,
    n_splits)``: split ``s`` of a sequence takes its pool blocks ``[s * bps,
    (s + 1) * bps)``.  ``n_seq_heads`` is ``B * H_kv``, one CTA each before
    the split.  Aims at ``WAVES`` CTAs per SM; one split under PWL, whose
    exp does not compose across a split."""
    if use_pwl or max_blocks <= 1:
        return 1, max(max_blocks, 1)
    want = -(-WAVES * sm_count // max(n_seq_heads, 1))
    bps = max(-(-max_blocks // want), -(-MIN_SPLIT_TOKENS // block_tokens))
    return -(-max_blocks // bps), bps


def contiguous_block_tokens(max_len: int) -> int:
    """Largest of 64, 32, ..., 1 that divides ``max_len``."""
    return next(bt for bt in (64, 32, 16, 8, 4, 2, 1) if max_len % bt == 0)


def identity_block_table(batch: int, max_len: int, block_tokens: int,
                         device=None) -> torch.Tensor:
    """``table[b, i] = b * (max_len // bt) + i`` (int32)."""
    nb = max_len // block_tokens
    return torch.arange(batch * nb, dtype=torch.int32,
                        device=device).reshape(batch, nb)


def offset_arg(key_offset, *, partial: bool, use_pwl: bool) -> int:
    """The kernels' key_offset argument, a non-negative int; raises for
    PWL in the partial mode, which takes the exact exp as the JAX model's
    ``decode_attention_partial`` does."""
    if partial and use_pwl:
        raise ValueError("paged attention's partial mode takes the exact exp, as "
                         "the JAX model's decode_attention_partial: no PWL")
    if int(key_offset) < 0:
        raise ValueError(f"key_offset must be >= 0, got {key_offset}")
    return int(key_offset)


def paged_attention_plain(q, k_cache, v_cache, block_tables, context_lens, *,
                          use_pwl: bool = False, window=None, key_offset: int = 0,
                          partial: bool = False):
    """q: (B, H, D); k/v_cache: (N_blocks, bt, H_kv, D); block_tables:
    (B, max_blocks) int; context_lens: (B,) int.  Returns (B, H, D); with
    ``partial``, the float32 (o (B, H, D), m (B, H), l (B, H)) of the
    keys this pool holds, local key j at global position ``key_offset +
    j`` (the module's docstring)."""
    window = window_arg(window)
    key_offset = offset_arg(key_offset, partial=partial, use_pwl=use_pwl)
    B, H, D = q.shape
    _, bt, Hkv, _ = k_cache.shape
    G = H // Hkv
    exp_fn = pwl_exp if use_pwl else torch.exp
    qf = q.float().reshape(B, Hkv, G, D) * D ** -0.5
    ctx = context_lens.to(device=q.device, dtype=torch.long)
    lo = (ctx - window - key_offset).clamp_min(0) if window else torch.zeros_like(ctx)
    ctx = (ctx - key_offset).clamp_min(0)           # local keys [lo, ctx)
    tables = block_tables.to(device=q.device, dtype=torch.long)
    n_steps = min(-(-int(ctx.max()) // bt), tables.shape[1]) if B else 0
    m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G), device=q.device)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for i in range(n_steps):
        live = (ctx > i * bt) & (lo < (i + 1) * bt)          # (B,) rows this step
        phys = torch.where(live, tables[:, i], torch.zeros_like(tables[:, i]))
        pos = i * bt + torch.arange(bt, device=q.device)
        valid = (pos[None, :] < ctx[:, None]) & (pos[None, :] >= lo[:, None])  # (B, bt)
        kb = k_cache[phys].float()                           # (B, bt, Hkv, D)
        vb = v_cache[phys].float()
        # rows outside [lo, ctx) are never read: zero them, as the kernel does
        kb = torch.where(valid[:, :, None, None], kb, torch.zeros_like(kb))
        vb = torch.where(valid[:, :, None, None], vb, torch.zeros_like(vb))
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kb)
        vmask = valid[:, None, None, :]
        s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
        seen = live[:, None, None]
        m_new = torch.where(seen, torch.maximum(m, s.amax(dim=-1)), m)
        p = torch.where(vmask, exp_fn(s - m_new[..., None]), torch.zeros_like(s))
        alpha = torch.where(seen, exp_fn(m - m_new), torch.ones_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
        m = m_new
    if partial:
        return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def paged_work(q, k_cache, block_tables, ctx_tokens: int, *, partial: bool = False):
    """Bytes (q, the kept keys' K and V, the table and the lengths read
    once; the output, or with ``partial`` the float32 (o, m, l), written
    once) and FLOPs (two products of 2 * D a kept key and head) of one
    call that keeps ``ctx_tokens`` keys over the batch."""
    B, H, D = q.shape
    hkv = k_cache.shape[2]
    esize = q.element_size()
    out = B * H * (D + 2) * 4 if partial else q.numel() * esize
    nbytes = (q.numel() * esize + out + 2 * ctx_tokens * hkv * D * esize
              + block_tables.numel() * 4 + B * 4)
    return nbytes, 4 * ctx_tokens * H * D


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_key(q, k_cache, block_tables, *, use_pwl: bool = False,
               window=None, partial: bool = False) -> str:
    """The shape under which ``paged_attention_cuda`` counts a launch in
    ``_build.LAUNCHES_BY_SHAPE`` (the context lengths live on the device
    and are not part of it; nor is a partial launch's key_offset, which
    differs from shard to shard)."""
    B, H, D = q.shape
    _, bt, Hkv, _ = k_cache.shape
    return (f"B{B} H{H} Hkv{Hkv} D{D} bt{bt} blocks{block_tables.shape[1]} "
            f"{str(q.dtype).removeprefix('torch.')} window={window or 0} "
            f"pwl={int(use_pwl)}" + (" mode=partial" if partial else ""))


def paged_attention_cuda(q, k_cache, v_cache, block_tables, context_lens, *,
                         use_pwl: bool = False, window=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on PyTorch's current stream."""
    return _launch(q, k_cache, v_cache, block_tables, context_lens, use_pwl=use_pwl,
                   window=window, key_offset=0, partial=False)


def paged_attention_partial_cuda(q, k_cache, v_cache, block_tables, context_lens, *,
                                 key_offset: int = 0, window=None):
    """The partial mode of ``csrc/paged_attention.cu``: (o (B, H, D), m (B,
    H), l (B, H)) float32, views of one buffer the kernel writes."""
    return _launch(q, k_cache, v_cache, block_tables, context_lens, use_pwl=False,
                   window=window, key_offset=key_offset, partial=True)


def _launch(q, k_cache, v_cache, block_tables, context_lens, *, use_pwl, window,
            key_offset, partial):
    _build.refuse_grad("paged_attention", "ROADMAP §B2: decode attention, no training "
                       "path and no backward", q, k_cache, v_cache)
    window = window_arg(window)
    key_offset = offset_arg(key_offset, partial=partial, use_pwl=use_pwl)
    B, H, D = q.shape
    n_blocks, bt, Hkv, Dk = k_cache.shape
    dev = q.device
    for t in (k_cache, v_cache, block_tables, context_lens):
        if t.device != dev:
            raise ValueError("paged_attention_cuda takes tensors on one device")
    if not q.is_cuda:
        raise ValueError("paged_attention_cuda takes CUDA tensors")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"paged_attention_cuda takes float32 or bfloat16 "
                        f"q and pool of one dtype, got {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype}")
    if D not in HEAD_DIMS or Dk != D or v_cache.shape != k_cache.shape:
        raise ValueError(f"unsupported shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_cache.shape)}")
    if H % Hkv or not 1 <= bt <= MAX_BLOCK_TOKENS:
        raise ValueError(f"need H % H_kv == 0 and 1 <= block_tokens <= "
                         f"{MAX_BLOCK_TOKENS}, got H={H} H_kv={Hkv} bt={bt}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("block_tables (B, max_blocks) and context_lens (B,)")
    q, k_cache, v_cache = (_build.aligned(t) for t in (q, k_cache, v_cache))
    block_tables = block_tables.contiguous()
    if partial:
        # o (B, H, D), then m (B, H), then l (B, H)
        buf = torch.empty(B * H * (D + 2), dtype=torch.float32, device=dev)
        m, l = buf[B * H * D:].view(2, B, H).unbind(0)
        result, out = (buf[:B * H * D].view(B, H, D), m, l), buf
    else:
        out = result = torch.empty_like(q)
    if q.numel() == 0:                      # no sequence: no launch
        return result
    max_blocks = block_tables.shape[1]
    n_splits, bps = split_plan(B * Hkv, max_blocks, bt, _sm_count(dev),
                               use_pwl=use_pwl)
    scratch = (torch.empty(B * H * n_splits * (D + 2), dtype=torch.float32,
                           device=dev) if n_splits > 1 else None)
    lib = _build.library("paged_attention")
    _build.check(lib.paged_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, H, Hkv, D, bt, max_blocks, n_splits, bps, window, key_offset, int(partial),
        _DTYPE_CODES[q.dtype], int(use_pwl), ctypes.addressof(PWL_COEFFS),
        torch.cuda.current_stream(dev).cuda_stream), "paged_attention",
        launch_key(q, k_cache, block_tables, use_pwl=use_pwl, window=window, partial=partial))
    return result
