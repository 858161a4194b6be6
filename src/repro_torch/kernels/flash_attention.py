"""Prefill attention: the Hopper kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``) together with its GQA/padding
wrapper ``repro/kernels/ops.py:flash_attention``.  Same function:
attention forward over ``(B, S, H, D)`` with scale ``D**-0.5`` and an
online softmax over KV steps of 128 keys, output in q's dtype; ``use_pwl``
swaps exp for the SCU's PWL exp.  Two departures from the wrapper, both
fixes of its layout and not of the function: the KV head is indexed as
``h // (Hq // Hkv)`` instead of repeating K/V in memory, and keys are
masked at their true length instead of zero-padded and left to the causal
mask.

The plain version computes in float32 throughout.  The kernel does so for
float32 inputs (SIMT FMAs, no TF32); for bfloat16 inputs it multiplies on
the tensor cores: Q K^T of the bf16 inputs accumulated in float32, the
scale applied to the float32 scores, and P V with P split into two bf16
terms (``hi + lo``, ~2^-17 of p) against bf16 V, so the two agree to the
float32 summation order before the output is rounded to bf16.
``agreement`` states how far they may lie apart.

``window`` (the JAX model's sliding window, which the Pallas kernel does
not take) also masks a key ``window`` or more positions before its query
(``qpos - kpos >= window``), as ``repro.models.attention`` does; ``None``
is no window.

``prefix_len`` (the JAX model's prefix-LM, paligemma's image prefix, which
the Pallas kernel does not take either) makes the keys below it visible to
every query of a causal call: key ``kpos`` is valid for query ``qpos`` when
``kpos <= qpos or kpos < prefix_len``, as
``repro.models.attention.full_attention`` and its blockwise
``flash_attention`` mask it.  Both versions refuse a prefix without the
causal mask (where it means nothing), with a window (no config has both)
and with PWL exp (the JAX model never uses PWL in attention, so nothing
defines it over a prefix).

Head dims 32, 64, 80, 128 and 256.  At D 256 the bf16 kernel keeps Q in
shared memory and K and V in one stage each (``csrc/flash_attention.cu``);
it stays on the tensor cores, and float32 on the SIMT path, at every D.

Training: ``FlashAttentionFn`` (which ``flash_attention_cuda`` takes under
grad) launches the forward with its optional lse output, each row's
log-sum-exp ``m + log l`` of its scaled scores, and differentiates it by
``csrc/flash_attention_bwd.cu`` (causal or not, Sq may differ from Skv,
with or without a window or a prefix, exact exp, every head dim above;
``flash_attention_bwd_plain`` is its plain version, held by
``bwd_agreement``).  The reference has no backward kernel: XLA
differentiates its model's attention.  Under PWL exp the wrapper raises
under grad rather than return an output without a gradient.

In PWL mode the result depends on how the keys are cut into online-softmax
steps (PWL exp is not multiplicative), so both versions step over keys
``[0, 128), [128, 256), ...`` as the Pallas kernel does, also under a
window, and a row skips a step in which it sees no key, as the kernel's
causal loop stops at the diagonal and its windowed loop starts at the
window's first step.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .pwl import PWL_COEFFS, pwl_exp

NEG_INF = -1e30
KV_STEP = 128
HEAD_DIMS = (32, 64, 80, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# How far the kernel's output may lie from the plain version's on the same
# inputs.  float32: within F32_ATOL, sums of <= 128 terms of order 1 in
# another order.  bfloat16: each element within BF16_REL * |want| +
# BF16_FLOOR: two bf16 steps of the value (both round a float32 result to
# bf16 once, and the float32 results differ by the summation order and
# the lo term of P, far below a step), and a floor for outputs near 0.  A
# single bf16 P would not meet it: it rounds each term of sum_j p_j v_j by
# up to 2^-9, an absolute error of ~2^-9 * sum_j |p_j v_j| / l on an output
# that cancels to near 0 (tests/test_torch_kernels.py shows it fail).
# bfloat16 with PWL exp: the SCU's PWL exp jumps at its segment edges (by
# 0.0245 at x = -1), so a score within rounding of an edge takes the
# neighbouring segment in one version and not in the other, whatever the
# two compute in; that moves a whole output row.  There the per-element
# bound may fail in at most PWL_ROWS_OFF of the rows (the vectors over the
# last dim), and by at most BF16_PWL_ATOL each; a fault of the kernel moves
# far more rows.
F32_ATOL = 2e-5
BF16_REL = 2.0 ** -7
BF16_FLOOR = 2.0 ** -12
PWL_ROWS_OFF = 1e-3
BF16_PWL_ATOL = 2.0 ** -6


def window_arg(window) -> int:
    """The kernels' window argument: a positive int, or 0 for ``None``
    (no window)."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")
    return int(window)


def prefix_arg(prefix_len, *, causal: bool, window: int, use_pwl: bool) -> int:
    """The kernels' prefix argument, a non-negative int; raises
    ``ValueError`` for a prefix that is not defined: without the causal
    mask, with a window or with PWL exp."""
    prefix_len = int(prefix_len)
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if prefix_len and (not causal or window or use_pwl):
        raise ValueError("a bidirectional prefix (prefix_len > 0) is taken only with "
                         "the causal mask, no window and exact exp")
    return prefix_len


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          use_pwl: bool = False, window=None,
                          prefix_len: int = 0, return_lse: bool = False):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), Hq % Hkv == 0.
    Returns (B, Sq, Hq, D) in q.dtype, computed in float32; with
    ``return_lse`` also each row's log-sum-exp of its scaled scores, (B,
    Hq, Sq) float32, ``m + log l`` (+inf for a row that sees no key), what
    the kernel hands its backward."""
    window = window_arg(window)
    prefix_len = prefix_arg(prefix_len, causal=causal, window=window, use_pwl=use_pwl)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    exp_fn = pwl_exp if use_pwl else torch.exp
    # (B, Hkv, G, Sq, D) queries, pre-scaled as the kernel does
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4) * D ** -0.5
    kf = k.float().permute(0, 2, 1, 3)                     # (B, Hkv, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    qpos = torch.arange(Sq, device=q.device)
    for k0 in range(0, Skv, KV_STEP):
        kb = kf[:, :, k0:k0 + KV_STEP]
        vb = vf[:, :, k0:k0 + KV_STEP]
        kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        if causal:
            valid = qpos[:, None] >= kpos[None, :]          # (Sq, bk)
            valid |= (kpos < prefix_len)[None, :]
        else:
            valid = torch.ones((Sq, kb.shape[2]), dtype=torch.bool,
                               device=q.device)
        if window:
            valid &= (qpos[:, None] - kpos[None, :]) < window
        seen = valid.any(dim=-1)                           # rows this step
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.where(seen, torch.maximum(m, s.amax(dim=-1)), m)
        p = exp_fn(s - m_new[..., None])
        p = torch.where(valid, p, torch.zeros_like(p))
        alpha = torch.where(seen, exp_fn(m - m_new), torch.ones_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]               # (B,Hkv,G,Sq,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, torch.full_like(l, float("inf")), m + torch.log(l))
    return out, lse.reshape(B, Hq, Sq)


def agreement(got: torch.Tensor, want: torch.Tensor, *, pwl: bool = False):
    """``(max |got - want|, max of |got - want| / its bound, share of the
    rows holding an element past its bound, ok)`` for two attention outputs
    of one shape and dtype, under the rule above (``pwl``: computed with the
    PWL exp)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"compare like with like: {got.dtype}{tuple(got.shape)} "
                         f"against {want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if diff.numel() == 0:
        return 0.0, 0.0, 0.0, True
    if got.dtype == torch.bfloat16:
        bound = BF16_REL * w.abs() + BF16_FLOOR
    else:
        bound = torch.full_like(w, F32_ATOL)
    off = diff > bound
    rows_off = off.reshape(-1, off.shape[-1]).any(dim=-1).float().mean().item()
    ratio = (diff / bound).max().item()
    ok = bool(torch.isfinite(g).all())
    if pwl and got.dtype == torch.bfloat16:
        ok = ok and rows_off <= PWL_ROWS_OFF and bool((diff[off] <= BF16_PWL_ATOL).all())
    else:
        ok = ok and ratio <= 1.0
    return diff.max().item(), ratio, rows_off, ok


def launch_key(q, k, *, causal: bool = True, use_pwl: bool = False,
               window=None, prefix_len: int = 0) -> str:
    """The shape under which ``flash_attention_cuda`` counts a launch in
    ``_build.LAUNCHES_BY_SHAPE``."""
    B, Sq, Hq, D = q.shape
    return (f"B{B} Sq{Sq} Skv{k.shape[1]} Hq{Hq} Hkv{k.shape[2]} D{D} "
            f"{str(q.dtype).removeprefix('torch.')} causal={int(causal)} "
            f"window={window or 0} prefix={prefix_len} pwl={int(use_pwl)}")


def backward_refusal(q, *, use_pwl: bool):
    """Why ``csrc/flash_attention_bwd.cu`` cannot differentiate this call,
    naming the ROADMAP item that would add it, or None where it can (the
    causal mask on or off, a window, a prefix, it takes)."""
    if use_pwl:
        return "PWL exp: ROADMAP §B1, no PWL backward (the JAX model trains with exact exp)"
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        return f"head dim {d}: ROADMAP §B1, flash_attention_bwd takes D in {HEAD_DIMS}"
    return None


def _check_inputs(name, q, k, v):
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS or Dk != D or v.shape != k.shape or k.shape[0] != B:
        raise ValueError(f"unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError("GQA requires Hq % Hkv == 0")


def _flash_fwd(q, k, v, *, causal: bool, use_pwl: bool, window: int,
               prefix_len: int, with_lse: bool):
    """One launch of ``csrc/flash_attention.cu`` on PyTorch's current
    stream: (out, the (B, Hq, Sq) float32 lse or None)."""
    _check_inputs("flash_attention_cuda", q, k, v)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0 or Skv == 0:          # nothing to attend: no launch
        if lse is not None:
            lse.fill_(float("inf"))
        return torch.zeros_like(q), lse
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODES[q.dtype], int(causal), window,
        prefix_len, int(use_pwl), ctypes.addressof(PWL_COEFFS),
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention",
        launch_key(q, k, causal=causal, use_pwl=use_pwl, window=window,
                   prefix_len=prefix_len))
    return out, lse


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         use_pwl: bool = False, window=None,
                         prefix_len: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream.
    Where autograd needs the gradient (grad enabled, an input that
    requires grad) the call goes through ``FlashAttentionFn``, whose
    backward is ``csrc/flash_attention_bwd.cu``, or raises
    ``NotImplementedError`` in a mode that backward lacks; it never returns
    an output without a gradient."""
    window = window_arg(window)
    prefix_len = prefix_arg(prefix_len, causal=causal, window=window, use_pwl=use_pwl)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        why = backward_refusal(q, use_pwl=use_pwl)
        if why is not None:
            raise NotImplementedError(f"flash_attention has no backward kernel for {why}; "
                                      "its output would carry no gradient")
        return FlashAttentionFn.apply(q, k, v, causal, window, prefix_len)
    return _flash_fwd(q, k, v, causal=causal, use_pwl=use_pwl, window=window,
                      prefix_len=prefix_len, with_lse=False)[0]


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool = True, window=None,
                             prefix_len: int = 0):
    """dQ, dK, dV of ``flash_attention`` (exact exp; causal or not, with or
    without a window or a prefix) by ``csrc/flash_attention_bwd.cu``, from
    the forward's inputs, output and lse and the output's gradient; in q's
    dtype.  Its three launches (Delta, dK/dV, dQ) count as one."""
    _check_inputs("flash_attention_bwd_cuda", q, k, v)
    window = window_arg(window)
    prefix_len = prefix_arg(prefix_len, causal=causal, window=window, use_pwl=False)
    why = backward_refusal(q, use_pwl=False)
    if why is not None:
        raise ValueError(f"flash_attention_bwd_cuda: {why}")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype or lse.shape != (B, Hq, Sq) \
            or lse.dtype != torch.float32:
        raise ValueError(f"out / dout must be q's shape and dtype and lse (B, Hq, Sq) "
                         f"float32, got out{tuple(out.shape)} dout{tuple(dout.shape)} "
                         f"lse{tuple(lse.shape)} {lse.dtype}")
    q, k, v, out, dout, lse = (_build.aligned(t) for t in (q, k, v, out, dout, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or Skv == 0:          # nothing attended: no launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd")
    _build.check(lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODES[q.dtype], int(causal), window, prefix_len, 0,
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention_bwd",
        launch_key(q, k, causal=causal, window=window, prefix_len=prefix_len))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention, causal or not, with or without a window or a
    prefix (exact exp), with its gradient: the forward launches
    ``csrc/flash_attention.cu`` with the lse output and keeps q, k, v, out
    and lse; the backward launches ``csrc/flash_attention_bwd.cu``.
    ``FlashAttentionFn.apply(q, k, v, causal, window, prefix_len)`` on CUDA
    tensors (window an int > 0, or 0 / None for none; prefix_len >= 0)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, prefix_len=0):
        q, k, v = (_build.aligned(t) for t in (q, k, v))
        window = window_arg(window or None)
        prefix_len = prefix_arg(prefix_len, causal=bool(causal), window=window, use_pwl=False)
        out, lse = _flash_fwd(q, k, v, causal=bool(causal), use_pwl=False, window=window,
                              prefix_len=prefix_len, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.prefix_len = bool(causal), window, prefix_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=ctx.causal,
                                          window=ctx.window or None,
                                          prefix_len=ctx.prefix_len), None, None, None)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = True, window=None,
                              prefix_len: int = 0):
    """The backward of exact flash attention in plain PyTorch, with P made
    explicit: dQ, dK, dV (q's, k's and v's shapes, in q's dtype, computed in
    float32) from the forward's inputs, output ``out`` and ``lse`` (B, Hq,
    Sq) and the output's gradient ``dout``.  P = exp(scale Q K^T - lse) and
    dS = P (dO V^T - rowsum(dO O)) on the valid (query, key) pairs (under
    the causal mask kpos <= qpos or kpos < prefix_len, under a window qpos
    - kpos < window, as ``flash_attention_plain`` masks them), 0 elsewhere;
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.  A gradient
    depends on the valid pairs only: a masked pair's term is left out, so
    a non-finite element of dO, Q or K makes NaN only the gradients of the
    pairs that see it (a dense product would spread it over the masked
    ones too, as 0 * NaN)."""
    window = window_arg(window)
    prefix_len = prefix_arg(prefix_len, causal=causal, window=window, use_pwl=False)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5

    def heads(t, n):                                     # (B, Hkv, G, n, D)
        return t.float().reshape(B, n, Hkv, G, D).permute(0, 2, 3, 1, 4)
    qf, of, gf = heads(q, Sq), heads(out, Sq), heads(dout, Sq)
    kf = k.float().permute(0, 2, 1, 3)                   # (B, Hkv, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    if causal:
        valid = (qpos[:, None] >= kpos[None, :]) | (kpos < prefix_len)[None, :]
    else:
        valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if window:
        valid &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    lse_f = lse.reshape(B, Hkv, G, Sq)[..., None]
    p = torch.where(valid, torch.exp(s - lse_f), torch.zeros_like(s))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gf, vf)
    delta = (gf * of).sum(-1, keepdim=True)
    ds = torch.where(valid, p * (dp - delta), torch.zeros_like(s))
    validf = valid.float()
    dv = _masked_contract("bhgqk,bhgqd->bhkd", "qk,bhgqd->bhkd", p, gf, validf)
    dk = _masked_contract("bhgqk,bhgqd->bhkd", "qk,bhgqd->bhkd", ds, qf, validf) * scale
    dq = _masked_contract("bhgqk,bhkd->bhgqd", "qk,bhkd->bhqd", ds, kf, validf,
                          lambda hit: hit[:, :, None]) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _masked_contract(eq, eq_mask, w, y, validf, to_out=lambda hit: hit):
    """``einsum(eq, w, y)`` for w zero on the masked pairs, leaving a
    masked pair's term out also where y is not finite: NaN wherever a valid
    pair meets a non-finite element of y (``eq_mask`` contracts the valid
    mask with y's non-finite elements the same way; ``to_out`` shapes the
    result to broadcast against the product's)."""
    bad = ~torch.isfinite(y)
    if not bad.any():
        return torch.einsum(eq, w, y)
    out = torch.einsum(eq, w, torch.where(bad, torch.zeros_like(y), y))
    hit = to_out(torch.einsum(eq_mask, validf, bad.float()) > 0)
    return torch.where(hit, torch.full_like(out, float("nan")), out)


# How far the backward kernel's gradients may lie from the plain version's
# on the same inputs, each gradient against the largest |value| of its
# plain version, at least 1 (inputs of order 1: a gradient that cancels to
# 0, as dQ and dK do at S 1, where P = 1 and dS = dP - Delta = 0, keeps
# the float32 rounding of its terms of order 1).  float32: both sum in
# float32 in another order (dS K over up to Skv keys, dS^T Q and P^T dO
# over up to Sq rows of Hq / Hkv heads, dP - Delta cancelling), within
# BWD_F32_REL of the largest value.  bfloat16: both round a float32 result
# to bf16 once (the kernel's P and dS are hi + lo bf16 terms, ~2^-17 of
# their value), so each element within BF16_REL * |want| (two steps) +
# BWD_BF16_FLOOR * max |want| (the float32 sums near 0 by cancellation,
# in another order).
BWD_F32_REL = 1e-4
BWD_BF16_FLOOR = 2.0 ** -12


def bwd_agreement(got: torch.Tensor, want: torch.Tensor):
    """``(max |got - want|, max of |got - want| / its bound, ok)`` for one
    gradient of the backward under the rule above; non-finite elements
    must be non-finite in both, and only finite ones are compared."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"compare like with like: {got.dtype}{tuple(got.shape)} "
                         f"against {want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    fin = torch.isfinite(w)
    same = bool((torch.isfinite(g) == fin).all())
    g, w = g[fin], w[fin]
    if w.numel() == 0:
        return 0.0, 0.0, same
    diff = (g - w).abs()
    top = max(w.abs().max().item(), 1.0)
    if got.dtype == torch.bfloat16:
        bound = BF16_REL * w.abs() + BWD_BF16_FLOOR * top
    else:
        bound = torch.full_like(w, BWD_F32_REL * top)
    ratio = (diff / bound).max().item()
    return diff.max().item(), ratio, same and ratio <= 1.0
