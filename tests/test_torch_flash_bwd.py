"""The backward of flash attention: the port's plain version
(``flash_attention_bwd_plain``, the reference for the Hopper kernel
``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of the JAX model's
attention (``repro.models.attention.flash_attention`` and
``full_attention``) and against autograd of the port's plain forward,
causal or not, under a sliding window, at D 32 to 128; the forward's
lse; and the refusal of every CUDA wrapper to hand autograd an output
without a gradient.  CPU, float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jflash
from repro.models.attention import full_attention as jfull
from repro_torch.kernels import ops
from repro_torch.kernels.cim_matmul import cim_matmul_cuda, quantize_weights
from repro_torch.kernels.flash_attention import (FlashAttentionFn, bwd_agreement,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.paged_attention import identity_block_table, paged_attention_cuda
from repro_torch.kernels.pwl_softmax import pwl_softmax_cuda
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan_cuda

# float32 on both sides: the same gradients summed in another order over
# at most 300 keys / rows of terms of order 1 (~1e-6 apart)
ATOL = 1e-5
CASES = [(s, d) for d in (32, 64) for s in (1, 37, 129, 300)]


def _inputs(s, d, seed=0, hq=8, hkv=2, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, g


def _plain_grads(q, k, v, g):
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    return out, lse, flash_attention_bwd_plain(tq, tk, tv, out, lse, tg)


@pytest.mark.parametrize("jfn", ["flash", "full"])
@pytest.mark.parametrize("s,d", CASES)
def test_plain_backward_matches_jax_vjp(s, d, jfn):
    """GQA 4:1, causal: dQ, dK, dV of the plain backward against jax.vjp
    of the JAX model's blockwise flash_attention (chunks of 64, so S 129 and
    300 cross blocks) and of its full_attention."""
    q, k, v, g = _inputs(s, d)
    if jfn == "flash":
        fn = lambda q, k, v: jflash(q, k, v, causal=True, q_chunk=64, kv_chunk=64)
    else:
        fn = lambda q, k, v: jfull(q, k, v, causal=True)
    out_j, vjp = jax.vjp(fn, q, k, v)
    want = vjp(jnp.asarray(g))
    out, _, got = _plain_grads(q, k, v, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("s,d", CASES)
def test_plain_backward_matches_autograd_of_the_plain_forward(s, d):
    q, k, v, g = _inputs(s, d, seed=1)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv)            # CPU: the plain forward
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    _, _, got = _plain_grads(q, k, v, g)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=name)
        assert bwd_agreement(a, b)[2], name


@pytest.mark.parametrize("s,d", [(1, 32), (37, 64), (300, 32)])
def test_lse_is_the_rows_logsumexp(s, d):
    q, k, v, _ = _inputs(s, d, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    G = q.shape[2] // k.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, tk.repeat_interleave(G, 2)) * d ** -0.5
    scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), atol=1e-5, rtol=0)
    # a row that sees no key (non-causal against no key is not a shape;
    # causal rows always see key 0): +inf, so exp(s - lse) = 0
    out, lse = flash_attention_plain(tq, tk[:, :0], tv[:, :0], causal=False, return_lse=True)
    assert torch.isinf(lse).all() and (lse > 0).all() and not out.any()


def test_plain_backward_leaves_masked_pairs_out_of_a_nan():
    """A NaN in dO at (b, q*, h, d*) makes NaN dQ's row q*, dK's keys <= q*
    and dV's keys <= q* in column d* of the KV head, nothing else: the
    keys after q* do not see that row."""
    q, k, v, g = _inputs(70, 32, seed=3, hq=2, hkv=1, b=1)
    g[0, 40, 1, 5] = np.nan
    _, _, (dq, dk, dv) = _plain_grads(q, k, v, g)
    assert torch.isnan(dq).any(-1)[0, :, 1].nonzero().flatten().tolist() == [40]
    assert not torch.isnan(dq[:, :, 0]).any()
    assert torch.isnan(dk[0, :, 0]).any(-1).nonzero().flatten().tolist() == list(range(41))
    assert torch.isnan(dv[0, :, 0]).nonzero().tolist() == [[i, 5] for i in range(41)]
    assert bwd_agreement(dv, dv.clone())[2]
    fake = dv.clone()
    fake[0, 50, 0, 5] = float("nan")
    assert not bwd_agreement(fake, dv)[2]


def _pairwise_grads(q, k, v, out, lse, g, causal=True, window=None):
    """dQ, dK, dV pair by pair in float64 over the kept pairs only (every
    key below Skv, under the causal mask kpos <= qpos, under a window
    qpos - kpos < window), GQA by h // G: the rule the plain version and
    the kernel keep, written out as loops (small shapes only)."""
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
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
                for j in range(min(i + 1, Skv) if causal else Skv):
                    if window is not None and i - j >= window:
                        continue
                    p = np.exp(scale * np.dot(q[b, i, h], k[b, j, hk]) - lse[b, h, i])
                    ds = p * (np.dot(g[b, i, h], v[b, j, hk]) - delta)
                    dv[b, j, hk] += p * g[b, i, h]
                    dk[b, j, hk] += scale * ds * q[b, i, h]
                    dq[b, i, h] += scale * ds * k[b, j, hk]
    return dq, dk, dv


@pytest.mark.parametrize("where", ["none", "dout", "q", "k", "v"])
def test_plain_backward_nan_rule_matches_pair_by_pair_sums(where):
    """A NaN in dout, q, k or v: the plain backward is non-finite exactly
    where the pair-by-pair sums over the kept pairs are, and equal to them
    elsewhere."""
    q, k, v, g = _inputs(12, 8, seed=4, hq=4, hkv=2, b=1)
    if where in ("q", "k", "v"):
        {"q": q, "k": k, "v": v}[where][0, 5, 1, 2] = np.nan
    if where == "dout":
        g[0, 5, 3, 2] = np.nan
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(g))
    want = _pairwise_grads(q, k, v, out.numpy(), lse.numpy(), g)
    for name, a, w in zip("qkv", got, want):
        a = a.numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(a[fin], w[fin], atol=ATOL, err_msg=name)
    # the NaN reaches some gradient, and never all of one (the masked pairs)
    n_bad = [int((~np.isfinite(w)).sum()) for w in want]
    assert (sum(n_bad) > 0) == (where != "none")
    assert all(n < w.size for n, w in zip(n_bad, want)), n_bad


NONCAUSAL_CASES = [(1, 300, 32), (37, 129, 64), (200, 64, 32), (129, 129, 64)]


@pytest.mark.parametrize("jfn", ["flash", "full"])
@pytest.mark.parametrize("sq,skv,d", NONCAUSAL_CASES)
def test_noncausal_plain_backward_matches_jax_vjp(sq, skv, d, jfn):
    """Without the causal mask, Sq != Skv (whisper's cross-attention; Sq ==
    Skv its encoder), GQA 4:1: dQ, dK, dV of the plain backward against
    jax.vjp of the JAX model's blockwise flash_attention (chunks of 64, so
    129 and 300 rows or keys cross blocks and end ragged) and of its
    full_attention, both causal=False."""
    rng = np.random.default_rng(sq + skv + d)
    q = rng.standard_normal((2, sq, 8, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((2, sq, 8, d)).astype(np.float32)
    if jfn == "flash":
        fn = lambda q, k, v: jflash(q, k, v, causal=False, q_chunk=64, kv_chunk=64)
    else:
        fn = lambda q, k, v: jfull(q, k, v, causal=False)
    out_j, vjp = jax.vjp(fn, q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_plain(tq, tk, tv, causal=False, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)
    # and autograd of the plain forward on the same inputs
    tq, tk, tv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    auto = torch.autograd.grad(ops.flash_attention(tq, tk, tv, causal=False), (tq, tk, tv), tg)
    for name, a, b in zip("qkv", got, auto):
        assert bwd_agreement(a, b)[2], name


@pytest.mark.parametrize("where", ["none", "dout", "q", "k", "v"])
def test_noncausal_plain_backward_nan_rule_matches_pair_by_pair_sums(where):
    """Without the causal mask, Sq 12 against Skv 17: a NaN in dout, q, k
    or v makes the plain backward non-finite exactly where the pair-by-pair
    float64 sums over every pair are, and equal to them elsewhere; then a
    NaN reaches the gradient of every pair that sees it."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 12, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 17, 2, 8)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((1, 12, 4, 8)).astype(np.float32)
    if where in ("q", "k", "v"):
        {"q": q, "k": k, "v": v}[where][0, 5, 1, 2] = np.nan
    if where == "dout":
        g[0, 5, 3, 2] = np.nan
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, causal=False, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(g), causal=False)
    want = _pairwise_grads(q, k, v, out.numpy(), lse.numpy(), g, causal=False)
    for name, a, w in zip("qkv", got, want):
        a = a.numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(a[fin], w[fin], atol=ATOL, err_msg=name)
    n_bad = [int((~np.isfinite(w)).sum()) for w in want]
    assert (sum(n_bad) > 0) == (where != "none")


# (window, S): windows that bind inside a 64-row chunk (1, 17), at a chunk
# (64) and across chunks (100), at S that end ragged
WINDOW_CASES = [(w, s) for w in (1, 17, 64, 100) for s in (37, 129, 300)]


def _jax_vjp(jfn, q, k, v, g, **kw):
    """The JAX model's output and (dq, dk, dv) by jax.vjp, jitted as one
    function (the same numbers as op by op, in a fraction of the time)."""
    if jfn == "flash":
        fn = lambda q, k, v: jflash(q, k, v, q_chunk=64, kv_chunk=64, **kw)
    else:
        fn = lambda q, k, v: jfull(q, k, v, **kw)

    def both(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)
    return jax.jit(both)(q, k, v, g)


@pytest.mark.parametrize("jfn", ["flash", "full"])
@pytest.mark.parametrize("window,s", WINDOW_CASES)
def test_windowed_plain_backward_matches_jax_vjp(window, s, jfn):
    """Causal under a sliding window (mixtral's), GQA 4:1, D 32: dQ, dK, dV
    of the plain backward against jax.vjp of the JAX model's blockwise
    flash_attention (chunks of 64) and of its full_attention, both with
    ``window``; and against autograd of the port's plain forward."""
    q, k, v, g = _inputs(s, 32, seed=window + s)
    out_j, want = _jax_vjp(jfn, q, k, v, g, causal=True, window=window)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_plain(tq, tk, tv, window=window, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)
    tq, tk, tv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    auto = torch.autograd.grad(ops.flash_attention(tq, tk, tv, window=window), (tq, tk, tv), tg)
    for name, a, b in zip("qkv", got, auto):
        assert bwd_agreement(a, b)[2], name
    if window < s:                        # the window binds: it moved the gradients
        _, _, (dq, _, _) = _plain_grads(q, k, v, g)
        assert not torch.allclose(dq, got[0], atol=ATOL)


@pytest.mark.parametrize("jfn", ["flash", "full"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 128])
def test_plain_backward_matches_jax_vjp_at_d80_and_d128(d, causal, jfn):
    """zamba2's head dim 80 and mixtral's 128, causal and not (Sq 100
    against Skv 129 without the mask), GQA 4:1: dQ, dK, dV against
    jax.vjp of the JAX model's attention."""
    rng = np.random.default_rng(d + causal)
    sq, skv = (129, 129) if causal else (100, 129)
    q = rng.standard_normal((2, sq, 8, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((2, sq, 8, d)).astype(np.float32)
    out_j, want = _jax_vjp(jfn, q, k, v, g, causal=causal)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("window", [1, 3, 7])
@pytest.mark.parametrize("where", ["none", "dout", "q", "k", "v"])
def test_windowed_plain_backward_nan_rule_matches_pair_by_pair_sums(where, window):
    """Under a window (causal, S 12): a NaN in dout, q, k or v makes the
    plain backward non-finite exactly where the float64 pair-by-pair sums
    over the kept pairs are, and equal to them elsewhere; the keys past a
    row's window do not see its NaN."""
    q, k, v, g = _inputs(12, 8, seed=6, hq=4, hkv=2, b=1)
    if where in ("q", "k", "v"):
        {"q": q, "k": k, "v": v}[where][0, 5, 1, 2] = np.nan
    if where == "dout":
        g[0, 5, 3, 2] = np.nan
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, window=window, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(g), window=window)
    want = _pairwise_grads(q, k, v, out.numpy(), lse.numpy(), g, window=window)
    for name, a, w in zip("qkv", got, want):
        a = a.numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(a[fin], w[fin], atol=ATOL, err_msg=name)
    n_bad = [int((~np.isfinite(w)).sum()) for w in want]
    assert (sum(n_bad) > 0) == (where != "none")
    if where == "dout":
        # row 5 sees keys 5 - window + 1 .. 5 of its KV head: only their dK
        # and dV rows go NaN
        bad_keys = np.flatnonzero(~np.isfinite(want[2][0, :, 1]).all(-1))
        assert bad_keys.tolist() == list(range(max(0, 6 - window), 6))


def test_cuda_wrappers_refuse_grad_without_a_backward():
    """Under grad, an input that requires grad: the wrapper raises
    NotImplementedError naming the ROADMAP item before it looks at the
    device, so none can return an output without a gradient (flash: PWL
    exp, a head dim outside 32 / 64 / 80 / 128 / 256).  A mode that has a
    backward kernel (flash with or without the causal mask, with or
    without a window or a prefix, D 32 / 64 / 80 / 128 / 256; the SSD scan)
    goes through its autograd Function, which reaches the device check."""
    q = torch.zeros((1, 4, 2, 32), requires_grad=True)
    k = torch.zeros((1, 4, 2, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP §B1, no PWL backward"):
        flash_attention_cuda(q, k, k, use_pwl=True)
    q48 = torch.zeros((1, 4, 2, 48), requires_grad=True)
    with pytest.raises(NotImplementedError, match="head dim 48: ROADMAP §B1"):
        flash_attention_cuda(q48, q48.detach(), q48.detach())
    # the prefix (paligemma) and D 256 have a backward: FlashAttentionFn
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k, prefix_len=1)
    q256 = torch.zeros((1, 4, 2, 256), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q256, q256.detach(), q256.detach())
    with pytest.raises(NotImplementedError, match="ROADMAP §B2"):
        paged_attention_cuda(torch.zeros((1, 2, 32), requires_grad=True),
                             torch.zeros((1, 4, 2, 32)), torch.zeros((1, 4, 2, 32)),
                             identity_block_table(1, 4, 4), torch.tensor([4]))
    x = torch.zeros((1, 8, 2, 32), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, torch.zeros((1, 8, 2)), torch.zeros(2), torch.zeros((1, 8, 16)),
                      torch.zeros((1, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        SSDScanFn.apply(x, torch.zeros((1, 8, 2)), torch.zeros(2), torch.zeros((1, 8, 16)),
                        torch.zeros((1, 8, 16)))
    with pytest.raises(NotImplementedError, match="ROADMAP §B3"):
        pwl_softmax_cuda(torch.zeros((2, 8), requires_grad=True))
    w = torch.zeros((256, 64))
    wq, ws = quantize_weights(w)
    with pytest.raises(NotImplementedError, match="ROADMAP §B4"):
        cim_matmul_cuda(torch.zeros((4, 256), requires_grad=True), wq, ws)
    # a supported mode goes through FlashAttentionFn, which takes CUDA tensors:
    # the causal mask on or off, a window (mixtral), D 80 (zamba2)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k[:, :3], k[:, :3], causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k, window=2)
    q80 = torch.zeros((1, 4, 2, 80), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q80, q80.detach(), q80.detach(), window=3)
    with pytest.raises(ValueError, match="CUDA"):
        FlashAttentionFn.apply(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        FlashAttentionFn.apply(q, k, k, True, 2)
    # without grad (or with no input that requires grad) the refusal is off:
    # the device check is reached
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k, prefix_len=1)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q256, q256, q256)
    with pytest.raises(ValueError, match="CUDA"):
        pwl_softmax_cuda(torch.zeros((2, 8)))
