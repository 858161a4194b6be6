"""SCU row softmax: the Hopper kernel ``csrc/pwl_softmax.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/pwl_softmax.py``
(``pwl_softmax`` / ``_softmax_kernel``).  Same function, over the last
dimension of ``x (..., n)``, in float32 inside, output in x's dtype: the row
max, the SCU's 8-segment PWL exp of ``x - max``, the row sum, the
reciprocal ``1 / max(sum, 1e-30)`` and the scale ``e * r`` — a reciprocal
and then a multiply, as the SCU computes, not the division of
``repro.kernels.ref.ref_pwl_softmax``.  The Pallas wrapper pads rows to
blocks of 256, which does not change the numbers; neither version pads.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .pwl import PWL_COEFFS, pwl_exp

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# How far two softmax outputs of one input may lie apart (the kernel against
# its plain version, the port against the JAX package).  float32 outputs
# (<= 1): within F32_ATOL, the row sum taken in another order.  bfloat16
# outputs: each element within one bfloat16 step of the expected one, and
# fewer than BF16_MAX_DIFFERING of the elements that are not 0 on both sides
# (masked keys, exps below the PWL range) differ at all.  The same
# float32 values rounded to nearest even differ only where the other sum
# order moves one across a rounding boundary; a truncating store, or wrong
# small probabilities, differ in far more.
F32_ATOL = 1e-6
BF16_MAX_DIFFERING = 0.01


def pwl_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of ``x (..., n)`` with the PWL exp, step by step as
    ``_softmax_kernel``."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    e = pwl_exp(xf - m)
    s = e.sum(dim=-1, keepdim=True)
    r = 1.0 / s.clamp_min(1e-30)
    return (e * r).to(x.dtype)


def agreement(got: torch.Tensor, want: torch.Tensor):
    """``(max |got - want|, share of the elements not 0 on both sides that
    differ, ok)`` for two softmax outputs of one shape and dtype, under the
    rule above."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"compare like with like: {got.dtype}{tuple(got.shape)} "
                         f"against {want.dtype}{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    if diff.numel() == 0:
        return 0.0, 0.0, True
    err = diff.max().item()
    nonzero = int(((got != 0) | (want != 0)).sum())
    share = int((diff > 0).sum()) / max(nonzero, 1)
    ok = bool(torch.isfinite(got.float()).all())
    if got.dtype == torch.bfloat16:
        # bfloat16 steps between two values of one sign: the difference of
        # their bit patterns (0 and -0 count as equal)
        steps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        steps = torch.where(diff == 0, torch.zeros_like(steps), steps)
        return err, share, ok and steps.max().item() <= 1 and share < BF16_MAX_DIFFERING
    return err, share, ok and err <= F32_ATOL


def pwl_softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/pwl_softmax.cu`` on PyTorch's current stream."""
    if not x.is_cuda:
        raise ValueError("pwl_softmax_cuda takes a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"pwl_softmax_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0:
        raise ValueError("pwl_softmax_cuda takes a tensor of at least one dim")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    x = x.contiguous()
    out = torch.empty_like(x)
    if rows == 0 or n == 0:                 # nothing to normalise: no launch
        return out
    if rows >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"pwl_softmax_cuda takes fewer than 2**31 rows and "
                         f"columns, got {rows} x {n}")
    lib = _build.library("pwl_softmax")
    _build.check(lib.pwl_softmax_fwd(
        x.data_ptr(), out.data_ptr(), rows, n, _DTYPE_CODES[x.dtype],
        ctypes.addressof(PWL_COEFFS),
        torch.cuda.current_stream(x.device).cuda_stream), "pwl_softmax")
    return out
