"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; it is held
to the Pallas kernel in interpret mode and to the oracle in
``repro.kernels.ref``, on the same numpy inputs.  The CUDA kernels
themselves are held to the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scu
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.pwl_softmax import _pwl_exp_vec
from repro_torch.kernels import ops, pwl
from repro_torch.kernels.flash_attention import (KV_STEP, NEG_INF, agreement,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (contiguous_block_tokens,
                                                 identity_block_table,
                                                 paged_attention_cuda,
                                                 paged_attention_plain)
from test_kernels import (_SHARED_PROMPTS, _alloc_shared_case,
                          _private_copy_case)

# float32 on both sides; the sums run in another order (einsum vs the
# kernel's dot) over <= 128 terms of order 1
ATOL = 1e-5


def _np(x):
    return np.array(x, np.float32)          # a writable copy


def _qkv(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


# ---------------------------------------------------------------------------
# PWL exp
# ---------------------------------------------------------------------------

def test_pwl_coefficients_equal_scu_bit_for_bit():
    assert pwl.N_SEGMENTS == scu.N_SEGMENTS
    assert (pwl.X_MIN, pwl.X_MAX) == (scu.X_MIN, scu.X_MAX)
    assert np.array_equal(pwl.SEG_EDGES, scu.SEG_EDGES)
    assert pwl.SEG_SLOPE.tobytes() == scu.SEG_SLOPE.tobytes()
    assert pwl.SEG_INTERCEPT.tobytes() == scu.SEG_INTERCEPT.tobytes()
    launch = np.ctypeslib.as_array(pwl.PWL_COEFFS)
    want = np.concatenate([scu.SEG_SLOPE, scu.SEG_INTERCEPT,
                           [scu.X_MIN, scu.X_MAX]]).astype(np.float32)
    assert launch.dtype == np.float32 and launch.tobytes() == want.tobytes()
    assert ctypes.sizeof(pwl.PWL_COEFFS) == 4 * (2 * scu.N_SEGMENTS + 2)


def test_pwl_exp_matches_pallas_select_chain():
    x = np.linspace(-10.0, 0.5, 20001).astype(np.float32)
    got = pwl.pwl_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _np(_pwl_exp_vec(jnp.asarray(x))))
    np.testing.assert_allclose(got, scu.pwl_exp(x), atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,D,causal,use_pwl", [
    (2, 128, 4, 4, 32, True, False),
    (1, 200, 4, 2, 32, True, False),      # ragged S, GQA
    (2, 200, 4, 2, 32, True, True),       # ragged S, GQA, PWL over 2 steps
    (1, 300, 8, 2, 64, True, True),       # 3 KV steps
    (1, 256, 4, 1, 32, False, False),     # non-causal, block-multiple Skv
    (1, 256, 2, 2, 64, False, True),
])
def test_flash_plain_matches_pallas_interpret(B, S, H, Hkv, D, causal, use_pwl):
    q, k, v = _qkv(S + H, B, S, H, Hkv, D)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, use_pwl=use_pwl).numpy()
    want = _np(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    use_pwl=use_pwl))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("S,causal", [(77, True), (200, True), (333, False)])
def test_flash_plain_matches_exact_oracle(S, causal):
    """Keys are masked at their true length, so ragged non-causal Skv
    matches the oracle too (the Pallas wrapper's zero padding does not,
    hazard 2)."""
    q, k, v = _qkv(S, 2, S, 4, 2, 32)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal).numpy()
    want = _np(ref.ref_flash_attention(jnp.asarray(q),
                                       jnp.repeat(jnp.asarray(k), 2, 2),
                                       jnp.repeat(jnp.asarray(v), 2, 2),
                                       causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flash_plain_pwl_single_step_equals_dense_pwl_oracle():
    """One KV step per row: the online PWL softmax is the SCU's one-pass
    softmax."""
    q, k, v = _qkv(7, 1, 128, 2, 2, 32)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                use_pwl=True).numpy()
    want = _np(ref.ref_pwl_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flash_plain_bf16_computes_in_float32():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(3, 1, 130, 4, 2, 32))
    got = flash_attention_plain(q, k, v)
    want = flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def _flash_emulation(q, k, v, *, causal=True, p_terms=2, mask_shift=0,
                     drop_alpha=False):
    """The bf16 kernel's arithmetic in PyTorch: Q K^T of the bf16 inputs in
    float32, the scale applied to the scores, p in float32 for the
    denominator, and P V with P as ``p_terms`` bf16 terms (2: hi + lo, the
    kernel's; 1: a single bf16 P).  ``mask_shift`` and ``drop_alpha`` plant
    faults: a causal mask that lets a row see ``mask_shift`` keys too many,
    and an accumulator that is never rescaled."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    m = torch.full((B, Hkv, G, Sq), NEG_INF)
    l = torch.zeros((B, Hkv, G, Sq))
    acc = torch.zeros((B, Hkv, G, Sq, D))
    qpos = torch.arange(Sq)
    for k0 in range(0, Skv, KV_STEP):
        kb, vb = kf[:, :, k0:k0 + KV_STEP], vf[:, :, k0:k0 + KV_STEP]
        kpos = torch.arange(k0, k0 + kb.shape[2])
        valid = (qpos[:, None] + mask_shift >= kpos[None, :] if causal
                 else torch.ones((Sq, kb.shape[2]), dtype=torch.bool))
        seen = valid.any(dim=-1)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * D ** -0.5
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.where(seen, torch.maximum(m, s.amax(dim=-1)), m)
        p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        alpha = torch.where(seen, torch.exp(m - m_new), torch.ones_like(m))
        if drop_alpha:
            alpha = torch.ones_like(alpha)
        p_mul, rest = torch.zeros_like(p), p
        for _ in range(p_terms):
            term = rest.to(torch.bfloat16).float()
            p_mul, rest = p_mul + term, rest - term
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p_mul, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_agreement_rule_passes_the_kernels_arithmetic_and_fails_faults(causal):
    """The bf16 rule of ``flash_attention.agreement`` holds the tensor-core
    kernel's arithmetic (emulated) to the plain version, and fails a causal
    mask one key off, a dropped alpha rescale, and a single bf16 P."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(21, 2, 200, 8, 2, 64))
    want = flash_attention_plain(q, k, v, causal=causal)
    err, ratio, rows_off, ok = agreement(_flash_emulation(q, k, v, causal=causal), want)
    assert ok and ratio <= 1.0 and rows_off == 0 and err <= 2 ** -6, (err, ratio)
    faults = {"single bf16 P": dict(p_terms=1), "no alpha": dict(drop_alpha=True)}
    if causal:
        faults["mask off by one"] = dict(mask_shift=1)
    for what, kw in faults.items():
        err, ratio, rows_off, ok = agreement(
            _flash_emulation(q, k, v, causal=causal, **kw), want)
        assert not ok and ratio > 1.5, (what, err, ratio)


def test_flash_agreement_pwl_allows_a_few_rows_off_a_segment_edge():
    """With PWL exp a score within rounding of a segment edge moves its
    output row (the PWL exp jumps there): a few such rows pass, each within
    2**-6; a fault in many rows, or a row further off, does not."""
    edge = pwl.pwl_exp(torch.tensor([-1.0 - 1e-6, -1.0]))
    assert 0.024 < (edge[0] - edge[1]).item() < 0.025     # the jump at x = -1
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(21, 2, 200, 8, 2, 64))
    want = flash_attention_plain(q, k, v, use_pwl=True)
    flipped = want.clone()
    flipped[1, 37, 5] += 4e-3                   # one of 3200 rows moved
    assert not agreement(flipped, want)[3]
    err, ratio, rows_off, ok = agreement(flipped, want, pwl=True)
    assert ok and ratio > 1 and rows_off == pytest.approx(1 / 3200)
    far = want.clone()
    far[1, 37, 5] += 2 ** -5
    assert not agreement(far, want, pwl=True)[3]
    many = want.clone()
    many[:, :8] += 4e-3                         # 128 of 3200 rows moved
    assert not agreement(many, want, pwl=True)[3]


def test_flash_agreement_float32_and_shapes():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 130, 4, 2, 32))
    want = flash_attention_plain(q, k, v)
    assert agreement(want + 1.9e-5, want)[3]
    assert not agreement(want + 2.1e-5, want)[3]
    assert not agreement(want + 2.1e-5, want, pwl=True)[3]    # float32: no allowance
    assert not agreement(want.clone().fill_(float("nan")), want)[3]
    with pytest.raises(ValueError):
        agreement(want.to(torch.bfloat16), want)


# ---------------------------------------------------------------------------
# paged attention (decode)
# ---------------------------------------------------------------------------

def _paged_both(q, kc, vc, tables, ctx, use_pwl, oracle=True):
    got = paged_attention_plain(
        *(torch.from_numpy(_np(a)) for a in (q, kc, vc)),
        torch.from_numpy(np.asarray(tables, np.int32)),
        torch.from_numpy(np.asarray(ctx, np.int32)), use_pwl=use_pwl).numpy()
    want = _np(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables, jnp.int32), jnp.asarray(ctx, jnp.int32),
        use_pwl=use_pwl))
    np.testing.assert_allclose(got, want, atol=ATOL)
    if oracle and not use_pwl:   # PWL rescaling only approximates the oracle
        oracle = _np(ref.ref_paged_attention(jnp.asarray(q), jnp.asarray(kc),
                                             jnp.asarray(vc), np.asarray(tables),
                                             np.asarray(ctx)))
        np.testing.assert_allclose(got, oracle, atol=ATOL)
    return got


@pytest.mark.parametrize("use_pwl", [False, True])
def test_paged_plain_identity_table_over_contiguous_cache(use_pwl):
    rng = np.random.default_rng(11)
    B, max_len, H, Hkv, D = 3, 40, 8, 2, 32
    bt = contiguous_block_tokens(max_len)
    assert bt == 8
    cache_k = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    cache_v = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    table = identity_block_table(B, max_len, bt).numpy()
    ctx = np.asarray([0, 17, 40], np.int32)
    got = _paged_both(q, cache_k.reshape(-1, bt, Hkv, D),
                      cache_v.reshape(-1, bt, Hkv, D), table, ctx, use_pwl)
    assert not got[0].any()                              # context 0 -> 0


@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("case", ["shared", "spilled", "gqa"])
def test_paged_plain_over_allocator_tables(case, use_pwl):
    kw = {"shared": {}, "spilled": dict(n_blocks=4, dram=8, seed=5),
          "gqa": dict(h=8, hkv=1, d=16, seed=3)}[case]
    a, q, kc, vc, tables, ctx = _alloc_shared_case(_SHARED_PROMPTS, **kw)
    assert a.prefix_hits > 0 and a.cow_forks > 0
    if case == "spilled":
        assert tables.max() >= 4                         # DRAM ids in tables
    _paged_both(q, kc, vc, tables, ctx, use_pwl, oracle=case != "gqa")


def test_paged_plain_shared_equals_private_copy():
    a, q, kc, vc, tables, ctx = _alloc_shared_case(_SHARED_PROMPTS)
    kp, vp, priv = _private_copy_case(_SHARED_PROMPTS, tables, ctx,
                                      bt=8, hkv=2, d=32)
    run = [paged_attention_plain(
        *(torch.from_numpy(_np(x)) for x in (q, kk, vv)),
        torch.from_numpy(np.asarray(t, np.int32)),
        torch.from_numpy(ctx)) for kk, vv, t in ((kc, vc, tables),
                                                  (kp, vp, priv))]
    torch.testing.assert_close(run[0], run[1], atol=ATOL, rtol=0)


def test_paged_plain_ignores_rows_past_the_context():
    """Rows of the last block past the context are never read: NaN there
    changes nothing."""
    rng = np.random.default_rng(2)
    kc = torch.from_numpy(rng.standard_normal((4, 8, 2, 32)).astype(np.float32))
    vc = kc.flip(0).clone()
    q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    ctx = torch.tensor([11], dtype=torch.int32)
    before = paged_attention_plain(q, kc, vc, table, ctx)
    kc[0, 3:], vc[0, 3:] = float("nan"), float("nan")
    kc[1], vc[1] = float("nan"), float("nan")
    after = paged_attention_plain(q, kc, vc, table, ctx)
    assert torch.equal(before, after)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pwl", [False, True])
def test_attention_plain_versions_keep_a_nan_score_as_pallas(use_pwl):
    """One NaN in a key: the (query, head) rows that see it are NaN in the
    Pallas kernels (interpret mode) and in the plain versions alike (246
    of 512 flash rows, 2 of 4 decode heads).  tests/test_torch_gpu.py
    holds the card's kernels to the plain versions' NaN rows."""
    q, k, v = _qkv(19, 1, 128, 4, 2, 64)
    k[0, 5, 0, 0] = np.nan
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), use_pwl=use_pwl)
    want = _np(jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), use_pwl=use_pwl))
    nan = np.isnan(want).any(-1)
    assert np.array_equal(torch.isnan(got).any(-1).numpy(), nan) and nan.sum() == 246
    kc, vc = (a.reshape(2, 64, 2, 64) for a in (k, v))
    table, lens = np.arange(2, dtype=np.int32).reshape(1, 2), np.array([128], np.int32)
    got = paged_attention_plain(torch.from_numpy(q[:, -1]), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(table),
                                torch.from_numpy(lens), use_pwl=use_pwl)
    want = _np(jops.paged_attention(jnp.asarray(q[:, -1]), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(table), jnp.asarray(lens), use_pwl=use_pwl))
    nan = np.isnan(want).any(-1)
    assert np.array_equal(torch.isnan(got).any(-1).numpy(), nan) and nan.sum() == 2


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 20, 4, 2, 32))
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               flash_attention_plain(q, k, v), atol=0, rtol=0)
    table = identity_block_table(1, 20, 4)
    ctx = torch.tensor([20], dtype=torch.int32)
    pool_k, pool_v = k.reshape(5, 4, 2, 32), v.reshape(5, 4, 2, 32)
    torch.testing.assert_close(
        ops.paged_attention(q[:, -1], pool_k, pool_v, table, ctx),
        paged_attention_plain(q[:, -1], pool_k, pool_v, table, ctx),
        atol=0, rtol=0)
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
                            "pwl_softmax": 0, "cim_matmul": 0}


def test_other_devices_raise():
    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention_cuda(*(torch.zeros((1, 4, 2, 32)),) * 3)
    with pytest.raises(ValueError):
        paged_attention_cuda(torch.zeros((1, 2, 32)),
                             *(torch.zeros((2, 4, 2, 32)),) * 2,
                             torch.zeros((1, 2), dtype=torch.int32),
                             torch.zeros((1,), dtype=torch.int32))
