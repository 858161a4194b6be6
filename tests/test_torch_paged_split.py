"""Split-KV decode attention on the CPU: the plan of
``repro_torch.kernels.paged_attention.split_plan`` and a plain emulation of
the kernel's split-and-combine, held to ``paged_attention_plain``.

The CUDA kernel cuts a sequence's pool blocks into ``n_splits`` ranges of
``blocks_per_split``, runs the online softmax over each range in its own
CTA, and merges the float32 partials ``(m, l, acc)``.  The emulation does
the same in PyTorch, driven by the wrapper's own plan, so the plan and the
combine rule are tested here; tests/test_torch_gpu.py holds the kernel to
the plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (NEG_INF, paged_attention_plain,
                                                 split_plan)
from repro_torch.kernels.pwl import pwl_exp

H100_SMS = 132
# float32 on both sides; the emulation sums the same terms in another order
ATOL = 1e-6


def _scattered(ctx, bt, h=8, hkv=2, d=32, seed=0):
    """q and a pool whose blocks the table scatters at random; table
    entries past a sequence's blocks point at a block of other data."""
    rng = np.random.default_rng(seed)
    nb = [-(-c // bt) for c in ctx]
    n_pool = sum(nb) + 2
    perm = rng.permutation(n_pool).astype(np.int32)
    table = np.full((len(ctx), max(max(nb), 1)), n_pool - 1, np.int32)
    off = 0
    for r, n in enumerate(nb):
        table[r, :n] = perm[off:off + n]
        off += n
    q = rng.standard_normal((len(ctx), h, d)).astype(np.float32)
    pool_k = rng.standard_normal((n_pool, bt, hkv, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_pool, bt, hkv, d)).astype(np.float32)
    return (torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
            torch.from_numpy(table), torch.tensor(ctx, dtype=torch.int32))


def _partial(q, k_pool, v_pool, table, ctx, use_pwl, lo=None):
    """One CTA's work: the online softmax over the blocks of ``table``,
    the tokens [lo, ctx) (lo: a window's first kept token, else 0); returns
    the unnormalised (m, l, acc)."""
    B, H, D = q.shape
    bt, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = H // Hkv
    exp_fn = pwl_exp if use_pwl else torch.exp
    qf = q.float().reshape(B, Hkv, G, D) * D ** -0.5
    m = torch.full((B, Hkv, G), NEG_INF)
    l = torch.zeros((B, Hkv, G))
    acc = torch.zeros((B, Hkv, G, D))
    lo = torch.zeros_like(ctx) if lo is None else lo
    for i in range(table.shape[1]):
        n_valid = (ctx - i * bt).clamp(0, bt)                 # (B,)
        j_lo = (lo - i * bt).clamp(0, bt)
        live = n_valid > j_lo
        if not (n_valid > 0).any():
            break
        j = torch.arange(bt)[None, :]
        valid = (j < n_valid[:, None]) & (j >= j_lo[:, None])  # (B, bt)
        kb = torch.where(valid[:, :, None, None], k_pool[table[:, i].long()], 0.0)
        vb = torch.where(valid[:, :, None, None], v_pool[table[:, i].long()], 0.0)
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
    return m.reshape(B, H), l.reshape(B, H), acc.reshape(B, H, D)


def split_and_combine(q, k_pool, v_pool, table, ctx, use_pwl, sm_count=H100_SMS,
                      window=None):
    """The kernel's split-KV path in PyTorch, planned by ``split_plan``;
    under a ``window`` each split keeps the tokens from ``ctx - window`` on
    (a split wholly below them is empty: l = 0)."""
    B, H, D = q.shape
    bt, Hkv = k_pool.shape[1], k_pool.shape[2]
    n_splits, bps = split_plan(B * Hkv, table.shape[1], bt, sm_count, use_pwl=use_pwl)
    lo = (ctx.long() - window).clamp_min(0) if window else torch.zeros_like(ctx.long())
    parts = []
    for s in range(n_splits):
        sub = table[:, s * bps:(s + 1) * bps]
        ctx_s = (ctx.long() - s * bps * bt).clamp(0, sub.shape[1] * bt)
        lo_s = (lo - s * bps * bt).clamp(0, sub.shape[1] * bt)
        parts.append(_partial(q, k_pool, v_pool, sub, ctx_s, use_pwl, lo_s))
    if n_splits == 1:
        m, l, acc = parts[0]
        return acc / l.clamp_min(1e-30)[..., None], n_splits
    ms = torch.stack([p[0] for p in parts])                  # (n_splits, B, H)
    ls = torch.stack([p[1] for p in parts])
    accs = torch.stack([p[2] for p in parts])
    used = ls > 0                                            # a split past the context: skipped
    m = torch.where(used, ms, torch.full_like(ms, NEG_INF)).amax(dim=0)
    w = torch.where(used, torch.exp(ms - m), torch.zeros_like(ms))
    l = (w * ls).sum(dim=0)
    out = (w[..., None] * torch.where(used[..., None], accs, 0.0)).sum(dim=0)
    return out / l.clamp_min(1e-30)[..., None], n_splits


def _covering_splits(n_splits, bps, n_blocks):
    """For each pool block index below ``n_blocks``, the splits whose range
    holds it."""
    return [[s for s in range(n_splits) if s * bps <= i < (s + 1) * bps]
            for i in range(n_blocks)]


@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("bt", [1, 8, 16, 64])
def test_split_and_combine_matches_plain_on_ragged_contexts(bt, use_pwl):
    ctx = [0, 1, bt - 1, 3 * bt + 5, 200]
    args = _scattered(ctx, bt, seed=bt)
    got, n_splits = split_and_combine(*args, use_pwl)
    want = paged_attention_plain(*args, use_pwl=use_pwl)
    assert (n_splits == 1) if use_pwl else (n_splits > 1)
    assert not got[args[4] == 0].any()                       # context 0 -> 0
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pwl", [False, True])
def test_split_and_combine_long_context_several_blocks_a_split(use_pwl):
    args = _scattered([4000], 16, h=8, hkv=8, d=64, seed=7)
    got, n_splits = split_and_combine(*args, use_pwl)
    want = paged_attention_plain(*args, use_pwl=use_pwl)
    if use_pwl:
        assert n_splits == 1
    else:
        n, bps = split_plan(8, 250, 16, H100_SMS)
        assert (n, bps) == (n_splits, 8) and n > 1 and bps > 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("window", [5, 64, 1000])
def test_split_and_combine_under_a_window_matches_plain(window, use_pwl):
    """A window over contexts that are below it, at it and far past it:
    whole splits below a sequence's first kept token give l = 0 and the
    combine skips them."""
    ctx = [0, 3, window, window + 1, 4000]
    args = _scattered(ctx, 16, seed=window)
    got, n_splits = split_and_combine(*args, use_pwl, window=window)
    want = paged_attention_plain(*args, use_pwl=use_pwl, window=window)
    assert (n_splits == 1) if use_pwl else (n_splits > 1)
    assert not got[0].any()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_seq_heads,max_blocks,bt", [
    (32, 9, 64),        # llama3-8b decode: B 4 x H_kv 8, 576 / 64 blocks
    (128, 9, 64),       # zamba2 decode: B 4 x H_kv 32
    (8, 250, 16),       # one sequence of 4000 tokens
    (10, 200, 1), (10, 25, 8), (10, 13, 16), (10, 4, 64), (1, 1, 64), (3, 0, 16),
    (1000, 9, 64),      # more CTAs than two waves before any split
])
@pytest.mark.parametrize("use_pwl", [False, True])
def test_split_plan_covers_every_block_once(n_seq_heads, max_blocks, bt, use_pwl):
    n_splits, bps = split_plan(n_seq_heads, max_blocks, bt, H100_SMS, use_pwl=use_pwl)
    assert n_splits >= 1 and bps >= 1
    if use_pwl:
        assert n_splits == 1
    # every block of every sequence (a sequence has at most max_blocks) in
    # exactly one split, and no split without a block of the table
    assert all(len(c) == 1 for c in _covering_splits(n_splits, bps, max_blocks))
    assert (n_splits - 1) * bps < max(max_blocks, 1)
    # a split holds at least 64 context tokens, or the whole table
    assert bps * bt >= 64 or n_splits == 1


def test_split_plan_at_the_main_decode_shape():
    """llama3-8b decode, batch 4: one pool block a split, 9 splits, 288 CTAs
    on 132 SMs (~2 waves)."""
    assert split_plan(4 * 8, 576 // 64, 64, H100_SMS) == (9, 1)
    assert split_plan(4 * 8, 576 // 64, 64, H100_SMS, use_pwl=True) == (1, 9)
    assert split_plan(4 * 32, 576 // 64, 64, H100_SMS) == (3, 3)
