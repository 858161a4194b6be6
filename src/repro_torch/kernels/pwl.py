"""The SCU's 8-segment piecewise-linear exp: the port's one source of its
coefficients.

The coefficients come from the formula of ``repro.core.scu`` (secant line
through each segment's endpoints, shifted by half its midpoint gap), so
they equal the JAX package's bit for bit.  The CUDA kernels receive them
as a launch argument (``PWL_COEFFS``), and ``pwl_exp`` is the plain
PyTorch counterpart of the Pallas select chain ``_pwl_exp_vec``
(``repro/kernels/pwl_softmax.py``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# 8 segments over [-8, 0] (softmax inputs are max-subtracted, so x <= 0).
N_SEGMENTS = 8
X_MIN, X_MAX = -8.0, 0.0
SEG_EDGES = np.linspace(X_MIN, X_MAX, N_SEGMENTS + 1)


def _segment_coeffs():
    x0, x1 = SEG_EDGES[:-1], SEG_EDGES[1:]
    y0, y1 = np.exp(x0), np.exp(x1)
    slope = (y1 - y0) / (x1 - x0)
    xm = (x0 + x1) / 2
    gap = np.exp(xm) - (y0 + slope * (xm - x0))
    intercept = y0 - slope * x0 + gap / 2
    return slope, intercept


SEG_SLOPE, SEG_INTERCEPT = _segment_coeffs()

# Launch argument of the CUDA kernels (``struct PwlCoeffs`` in
# csrc/pwl.cuh): 8 slopes, 8 intercepts, x_min, x_max, as float32.
PWL_COEFFS = (ctypes.c_float * (2 * N_SEGMENTS + 2))(
    *np.concatenate([SEG_SLOPE, SEG_INTERCEPT, [X_MIN, X_MAX]])
    .astype(np.float32))


def pwl_exp(x: torch.Tensor) -> torch.Tensor:
    """8-segment PWL exp of a float32 tensor, as the Pallas select chain
    computes it: clip to [X_MIN, X_MAX], the last segment whose lower edge
    is <= x wins, and 0 below X_MIN."""
    xc = x.clamp(X_MIN, X_MAX)
    seg_w = (X_MAX - X_MIN) / N_SEGMENTS
    y = torch.zeros_like(xc)
    for i in range(N_SEGMENTS):
        slope = np.float32(SEG_SLOPE[i]).item()
        icept = np.float32(SEG_INTERCEPT[i]).item()
        seg = xc * slope + icept
        y = seg if i == 0 else torch.where(xc >= X_MIN + i * seg_w, seg, y)
    return torch.where(x < X_MIN, torch.zeros_like(y), y)
