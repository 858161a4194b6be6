"""The backward of flash attention with a bidirectional prefix (paligemma's
prefix-LM: a key below ``prefix_len`` is seen by every query of a causal
call) and at head dim 256: the port's plain version
(``flash_attention_bwd_plain``, the reference for the Hopper kernel
``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of the JAX model's
attention (``repro.models.attention.flash_attention`` and
``full_attention``, ``prefix_len=``), against autograd of the port's plain
forward, and against float64 pair-by-pair sums where a NaN is about; the
wrappers' refusals under grad.  CPU, float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jflash
from repro.models.attention import full_attention as jfull
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (HEAD_DIMS, FlashAttentionFn, backward_refusal,
                                                 bwd_agreement, flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda, flash_attention_plain)

# float32 on both sides: the same gradients summed in another order over at
# most 300 keys / rows of terms of order 1 and 256 columns; the largest gap
# measured on these cases is 3.6e-6 (D 256, against full_attention)
ATOL = 1e-5
# (S, prefix_len, D, Hq, Hkv): a prefix that is no multiple of 16 (100),
# one past a 64-row chunk boundary (256 at S 300: the chunks of 64 and the
# kernel's tiles cut it), one past S (wholly bidirectional), a short one at
# a ragged S, at D 32 and paligemma's 256, GQA 8:1 (paligemma's MQA) and 4:1
CASES = [(129, 100, 32, 8, 1), (300, 256, 32, 8, 2), (129, 200, 32, 8, 1), (37, 16, 32, 4, 1),
         (300, 100, 256, 8, 1), (129, 256, 256, 8, 1), (300, 256, 256, 8, 1)]


def _inputs(s, p, d, hq, hkv, b=2):
    rng = np.random.default_rng(s + p + d)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, g


def _plain(q, k, v, g, prefix_len):
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_plain(tq, tk, tv, prefix_len=prefix_len, return_lse=True)
    return out, lse, flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, prefix_len=prefix_len)


@pytest.mark.parametrize("jfn", ["flash", "full"])
@pytest.mark.parametrize("s,prefix_len,d,hq,hkv", CASES)
def test_prefix_plain_backward_matches_jax_vjp(s, prefix_len, d, hq, hkv, jfn):
    """Causal with a prefix: dQ, dK, dV of the plain backward against
    jax.vjp of the JAX model's blockwise flash_attention (chunks of 64) and
    of its full_attention, both with ``prefix_len``, jitted as one
    function."""
    q, k, v, g = _inputs(s, prefix_len, d, hq, hkv)
    if jfn == "flash":
        fn = lambda q, k, v: jflash(q, k, v, causal=True, q_chunk=64, kv_chunk=64,
                                    prefix_len=prefix_len)
    else:
        fn = lambda q, k, v: jfull(q, k, v, causal=True, prefix_len=prefix_len)

    def both(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)
    out_j, want = jax.jit(both)(q, k, v, jnp.asarray(g))
    out, _, got = _plain(q, k, v, g, prefix_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("s,prefix_len,d,hq,hkv", CASES)
def test_prefix_plain_backward_matches_autograd_of_the_plain_forward(s, prefix_len, d, hq, hkv):
    """The plain backward against autograd of ``ops.flash_attention`` with
    the prefix on CPU tensors (the plain forward), within ATOL and by
    ``bwd_agreement``; and the prefix moved the gradients of the prefix's
    keys (those rows see more than their causal keys)."""
    q, k, v, g = _inputs(s, prefix_len, d, hq, hkv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = torch.autograd.grad(ops.flash_attention(tq, tk, tv, prefix_len=prefix_len),
                               (tq, tk, tv), torch.from_numpy(g))
    _, _, got = _plain(q, k, v, g, prefix_len)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=name)
        assert bwd_agreement(a, b)[2], name
    _, _, causal = _plain(q, k, v, g, 0)
    assert not torch.allclose(causal[1], got[1], atol=ATOL)


def _pairwise_grads(q, k, v, out, lse, g, prefix_len):
    """dQ, dK, dV pair by pair in float64 over the kept pairs only (key j
    of query i when j <= i or j < prefix_len), GQA by h // G: the rule the
    plain version and the kernel keep, written out as loops."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    scale = D ** -0.5
    q, k, v, out, g = (np.asarray(a, np.float64) for a in (q, k, v, out, g))
    lse = np.asarray(lse, np.float64)
    dq, dk, dv = np.zeros(q.shape), np.zeros(k.shape), np.zeros(v.shape)
    for b in range(B):
        for h in range(Hq):
            hk = h // G
            for i in range(S):
                delta = float(np.dot(g[b, i, h], out[b, i, h]))
                for j in range(max(i + 1, min(prefix_len, S))):
                    p = np.exp(scale * np.dot(q[b, i, h], k[b, j, hk]) - lse[b, h, i])
                    ds = p * (np.dot(g[b, i, h], v[b, j, hk]) - delta)
                    dv[b, j, hk] += p * g[b, i, h]
                    dk[b, j, hk] += scale * ds * q[b, i, h]
                    dq[b, i, h] += scale * ds * k[b, j, hk]
    return dq, dk, dv


@pytest.mark.parametrize("prefix_len", [3, 7, 20])
@pytest.mark.parametrize("where", ["none", "dout", "q", "k", "v"])
def test_prefix_plain_backward_nan_rule_matches_pair_by_pair_sums(where, prefix_len):
    """S 12 with a prefix of 3, 7 or 20 (past S: every pair kept), a NaN at
    row / key 5, inside the prefix of 7 and outside that of 3: the plain
    backward is non-finite exactly where the float64 pair-by-pair sums over
    the kept pairs are, and equal to them elsewhere.  A NaN key outside the
    prefix reaches only the rows at or after it; inside, every row."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 12, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 12, 2, 8)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((1, 12, 4, 8)).astype(np.float32)
    if where in ("q", "k", "v"):
        {"q": q, "k": k, "v": v}[where][0, 5, 1, 2] = np.nan
    if where == "dout":
        g[0, 5, 3, 2] = np.nan
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, prefix_len=prefix_len, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(g),
                                    prefix_len=prefix_len)
    want = _pairwise_grads(q, k, v, out.numpy(), lse.numpy(), g, prefix_len)
    for name, a, w in zip("qkv", got, want):
        a = a.numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(a[fin], w[fin], atol=ATOL, err_msg=name)
    n_bad = [int((~np.isfinite(w)).sum()) for w in want]
    assert (sum(n_bad) > 0) == (where != "none")
    if where == "k":
        # the rows of KV head 1's query heads (2, 3) that see key 5
        rows = np.flatnonzero(~np.isfinite(want[0][0, :, 2]).all(-1))
        assert rows.tolist() == (list(range(12)) if prefix_len > 5 else list(range(5, 12)))
    if where == "dout":
        # row 5 of head 3: the keys it sees, up to 5 and the prefix's
        keys = np.flatnonzero(~np.isfinite(want[2][0, :, 1]).all(-1))
        assert keys.tolist() == list(range(max(6, min(prefix_len, 12))))


def test_backward_refusal_takes_the_prefix_and_d256():
    """Only PWL exp and a head dim outside the forward's (32 / 64 / 80 / 128
    / 256) are refused, each naming its ROADMAP item."""
    assert HEAD_DIMS == (32, 64, 80, 128, 256)
    for d in HEAD_DIMS:
        assert backward_refusal(torch.zeros((1, 4, 2, d)), use_pwl=False) is None
    assert "ROADMAP §B1, no PWL backward" in backward_refusal(torch.zeros((1, 4, 2, 64)),
                                                              use_pwl=True)
    assert "head dim 48: ROADMAP §B1" in backward_refusal(torch.zeros((1, 4, 2, 48)),
                                                          use_pwl=False)


@pytest.mark.parametrize("d", [32, 256])
def test_prefix_under_grad_goes_through_flash_attention_fn(d):
    """Under grad a prefix (and D 256) goes through FlashAttentionFn, which
    takes CUDA tensors: on CPU tensors it reaches the device check; the
    backward wrapper takes the prefix too, and a prefix without the causal
    mask or with a window is refused as the forward refuses it."""
    q = torch.zeros((1, 4, 2, d), requires_grad=True)
    k = torch.zeros((1, 4, 1, d))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k, prefix_len=3)
    with pytest.raises(ValueError, match="CUDA"):
        FlashAttentionFn.apply(q, k, k, True, None, 3)
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q.detach(), k, k, q.detach(), lse, q.detach(), prefix_len=3)
    for kw in (dict(causal=False), dict(window=2)):
        with pytest.raises(ValueError, match="prefix"):
            FlashAttentionFn.apply(q, k, k, kw.get("causal", True), kw.get("window"), 3)
        with pytest.raises(ValueError, match="prefix"):
            flash_attention_bwd_plain(q.detach(), k, k, q.detach(), lse, q.detach(),
                                      prefix_len=3, **kw)
