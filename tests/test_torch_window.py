"""The sliding window (mixtral) in the port's attention: the plain versions
of the flash and paged kernels against the JAX model-path attention, on
the CPU in float32.

The Pallas kernels take no window, so a windowed case is held to
``repro.models.attention`` (``full_attention`` / ``flash_attention`` for
prefill, ``decode_attention`` for decode), which masks with ``(qpos -
kpos) < window`` and ``kpos >= cache_len - window``.  The kernels are held
to these plain versions on the card (tests/test_torch_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (KV_STEP, NEG_INF, flash_attention_plain,
                                                 window_arg)
from repro_torch.kernels.paged_attention import (identity_block_table,
                                                 paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.pwl import pwl_exp
from repro_torch.models import attention as tattn
from test_kernels import _SHARED_PROMPTS, _alloc_shared_case

# float32 on both sides, outputs of order 1 from unit-normal inputs: sums
# in another order
ATOL = 1e-5


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("S", [100, 300])
@pytest.mark.parametrize("window", [1, 64, 100, 130, 512])
def test_flash_plain_window_matches_the_jax_model_attention(S, window):
    """GQA, causal, ragged S (the last 128-key step is partial); windows
    from one key to wider than the sequence, and ones whose lower edge
    falls inside a 128-key step."""
    q, k, v = _qkv(2, S, 8, 2, 32, S + window)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(jattn.full_attention(q, k, v, window=window)),
                               atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jattn.flash_attention(q, k, v, window=window, q_chunk=64,
                                              kv_chunk=64)), atol=ATOL)


def test_flash_plain_window_non_causal_matches_full_attention():
    q, k, v = _qkv(1, 200, 4, 4, 32, 7)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False, window=50)
    want = jattn.full_attention(q, k, v, causal=False, window=50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _pwl_steps(q, k, v, window):
    """The PWL online softmax transcribed step by step at absolute 128-key
    steps, one (batch, head) row at a time, with the window's mask; a row
    skips a step in which it sees no key.  A step's scores are one matmul
    of the pre-scaled queries by the step's keys, as the plain version
    takes them (a score within rounding of a PWL segment edge would move a
    row)."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    out = np.zeros_like(q)
    for b in range(B):
        for h in range(Hq):
            qh = torch.from_numpy(q[b, :, h]) * D ** -0.5
            kh, vh = (torch.from_numpy(t[b, :, h // G]) for t in (k, v))
            steps = [(k0, qh @ kh[k0:k0 + KV_STEP].T) for k0 in range(0, S, KV_STEP)]
            for i in range(S):
                m, l, acc = torch.tensor(NEG_INF), torch.tensor(0.0), torch.zeros(D)
                for k0, scores in steps:
                    kpos = torch.arange(k0, k0 + scores.shape[1])
                    valid = (kpos <= i) & (i - kpos < window)
                    if not valid.any():
                        continue
                    s = torch.where(valid, scores[i], torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max())
                    p = torch.where(valid, pwl_exp(s - m_new), torch.tensor(0.0))
                    alpha = pwl_exp(m - m_new)
                    l = l * alpha + p.sum()
                    acc = acc * alpha + p @ vh[kpos]
                    m = m_new
                out[b, i, h] = (acc / l.clamp_min(1e-30)).numpy()
    return out


@pytest.mark.parametrize("window", [60, 130])
def test_flash_plain_pwl_window_equals_a_step_by_step_transcription(window):
    """PWL exp is not multiplicative: under a window the plain version still
    steps over keys [0, 128), [128, 256), ... and skips the steps a row does
    not see, as the kernel does."""
    q, k, v = _qkv(1, 260, 2, 1, 32, window)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), use_pwl=True,
                                window=window)
    np.testing.assert_allclose(got.numpy(), _pwl_steps(q, k, v, window), atol=1e-6)


def test_window_argument_is_a_positive_int_or_none():
    assert window_arg(None) == 0 and window_arg(4096) == 4096
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            window_arg(bad)
    x = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(x, x, x, window=0)


def _decode_case(ctx, max_len, H=8, Hkv=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(ctx), H, D)).astype(np.float32)
    k, v = (rng.standard_normal((len(ctx), max_len, Hkv, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _jax_decode(q, k, v, ctx, window):
    """decode_attention with a per-sequence length: one call a sequence
    (the JAX package takes one scalar cache_len)."""
    return np.concatenate([np.asarray(jattn.decode_attention(
        q[b:b + 1, None], k[b:b + 1], v[b:b + 1], jnp.int32(c), window=window))[:, 0]
        for b, c in enumerate(ctx)])


@pytest.mark.parametrize("bt", [8, 16, 64])
def test_paged_plain_window_matches_jax_decode_attention(bt):
    """Contexts below the window, at it, one past it and far past it (the
    first kept key mid-block; many blocks skipped), over the identity
    table of a contiguous cache."""
    window, max_len = 40, 512
    ctx = [7, window, window + 1, 300, max_len]
    q, k, v = _decode_case(ctx, max_len, seed=bt)
    table = identity_block_table(len(ctx), max_len, bt)
    got = paged_attention_plain(torch.from_numpy(q),
                                torch.from_numpy(k).view(-1, bt, 2, 32),
                                torch.from_numpy(v).view(-1, bt, 2, 32), table,
                                torch.tensor(ctx, dtype=torch.int32), window=window)
    np.testing.assert_allclose(got.numpy(), _jax_decode(q, k, v, ctx, window), atol=ATOL)


@pytest.mark.parametrize("window", [3, 9, 17])
def test_paged_plain_window_over_allocator_tables(window):
    """Block tables that ``runtime.kv_cache.BlockAllocator`` builds, with
    prefix blocks shared and forked (tests/test_kernels.py's case): each
    sequence's result equals the JAX decode attention over its own
    contiguous copy of the blocks."""
    _, q, kc, vc, tables, ctx = _alloc_shared_case(_SHARED_PROMPTS)
    q, kc, vc = (np.array(t, np.float32) for t in (q, kc, vc))
    got = paged_attention_plain(*map(torch.from_numpy, (q, kc, vc)),
                                torch.from_numpy(tables), torch.from_numpy(ctx),
                                window=window).numpy()
    bt, hkv, d = kc.shape[1:]
    for b, c in enumerate(ctx):
        kb, vb = (t[tables[b]].reshape(1, -1, hkv, d) for t in (kc, vc))
        want = jattn.decode_attention(q[b:b + 1, None], kb, vb, jnp.int32(c), window=window)
        np.testing.assert_allclose(got[b], np.asarray(want)[0, 0], atol=ATOL)


def test_paged_plain_window_skips_blocks_below_it_and_keeps_pwl_steps():
    """Keys below ``ctx - window`` are never read (NaN there changes
    nothing), and under PWL the windowed result equals the unwindowed one
    over a cache whose rows below the bound were never written, block for
    block, when the bound falls on a block edge."""
    window, bt, max_len = 64, 16, 256
    ctx = [200, 256]
    q, k, v = _decode_case(ctx, max_len, seed=3)
    lens = torch.tensor(ctx, dtype=torch.int32)
    table = identity_block_table(2, max_len, bt)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    want = paged_attention_plain(torch.from_numpy(q), kt.view(-1, bt, 2, 32),
                                 vt.view(-1, bt, 2, 32), table, lens, window=window)
    for b, c in enumerate(ctx):
        kt[b, :c - window] = float("nan")
        vt[b, :c - window] = float("nan")
    for use_pwl in (False, True):
        got = paged_attention_plain(torch.from_numpy(q), kt.view(-1, bt, 2, 32),
                                    vt.view(-1, bt, 2, 32), table, lens, window=window,
                                    use_pwl=use_pwl)
        assert torch.isfinite(got).all()
        if not use_pwl:
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    # with the bound on a block edge (256 - 64 = 192 = 12 blocks of 16), the
    # PWL steps are the unwindowed steps over the kept blocks alone
    kept = torch.from_numpy(k[1:, 192:].copy()), torch.from_numpy(v[1:, 192:].copy())
    alone = paged_attention_plain(torch.from_numpy(q[1:]), kept[0].view(-1, bt, 2, 32),
                                  kept[1].view(-1, bt, 2, 32), identity_block_table(1, 64, bt),
                                  torch.tensor([64], dtype=torch.int32), use_pwl=True)
    windowed = paged_attention_plain(torch.from_numpy(q[1:]),
                                     torch.from_numpy(k[1:]).view(-1, bt, 2, 32),
                                     torch.from_numpy(v[1:]).view(-1, bt, 2, 32),
                                     identity_block_table(1, max_len, bt),
                                     torch.tensor([256], dtype=torch.int32), use_pwl=True,
                                     window=window)
    torch.testing.assert_close(windowed, alone, atol=0, rtol=0)


def test_paged_cuda_wrapper_checks_a_forced_plan_before_the_device():
    x = torch.zeros((1, 4, 32))
    pool = torch.zeros((4, 16, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(x, pool, pool, identity_block_table(1, 64, 16),
                             torch.tensor([3], dtype=torch.int32), window=8)


def test_attention_sublayers_pass_the_window_and_refuse_a_prefix():
    import dataclasses
    import repro_torch.configs as tconfigs
    cfg = dataclasses.replace(tconfigs.get_smoke_config("mixtral-8x7b"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = tattn.init_attention(cfg, gen)
    x = torch.randn((1, 90, cfg.d_model), generator=gen)
    pos = torch.arange(90)
    out, _ = tattn.attn_sublayer(cfg, p, x, positions=pos, window=cfg.sliding_window)
    full, _ = tattn.attn_sublayer(cfg, p, x, positions=pos)
    assert torch.equal(out[:, :cfg.sliding_window], full[:, :cfg.sliding_window])
    assert not torch.allclose(out[:, cfg.sliding_window:], full[:, cfg.sliding_window:])
    # a prefix and a window together (no config has both) are refused
    with pytest.raises(ValueError, match="prefix"):
        tattn.attn_sublayer(cfg, p, x, positions=pos, window=cfg.sliding_window,
                            prefix_len=16)
