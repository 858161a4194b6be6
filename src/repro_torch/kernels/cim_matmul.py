"""RRAM crossbar (CIM) matmul: the Hopper kernel ``csrc/cim_matmul.cu`` and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/cim_matmul.py``
(``cim_matmul`` / ``_cim_kernel``) and keeps its ``quantize_weights``.  The
arithmetic of the paper's 256 x 256 crossbar, on the same
``(M / bm, N / bn, K / 256)`` grid:

  * weights int8 per 256-row tile with per-column scales (``quantize_weights``);
  * the DAC: activations quantised per row and 256-wide K slice,
    ``xs = (max|x| + 1e-9) / qmax_a``, ``xq = clip(round(x / xs))``;
  * the analog MAC: the integer dot ``psum = xq @ wq`` of each K tile;
  * the ADC, calibrated to the swing of the whole ``(bm, bn)`` output tile:
    ``cal = max(max|psum|, 1)``, ``code = clip(round(psum / cal * adc_max))``;
  * float32 recombination ``acc += code * (cal / adc_max) * xs * wscale``.

The calibration tile ``(bm, bn)`` is part of the result (ROADMAP hazard 3):
``bm = min(block_m, M)``, ``bn = min(block_n, N)``, and ``M``, ``N`` must be
multiples of them, as the Pallas wrapper asserts.  Rounding is half to
even (``torch.round``, as ``jnp.round``).  The output is float32.
"""
from __future__ import annotations

import torch

from . import _build

TILE_K = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c``, rounded as an IEEE float32 division on every device.  On
    a CUDA tensor PyTorch computes ``t / python_scalar`` as ``t * (1 / c)``,
    which differs by an ulp in a few percent of cases and then flips
    roundings of ``x / xs`` against the reference; a 0-dim tensor on t's
    device divides."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def quantize_weights(w: torch.Tensor, bits: int = 8):
    """Symmetric int8 quantisation per (crossbar tile, column).
    w: (K, N) -> (wq int8 (K, N), scales float32 (K // 256, N)).  Plain
    PyTorch on any device, as the JAX package runs it outside the kernel."""
    K, N = w.shape
    kt = K // TILE_K
    wt = w.reshape(kt, TILE_K, N).float()
    qmax = 2.0 ** (bits - 1) - 1
    scale = _div(wt.abs().amax(dim=1) + 1e-9, qmax)              # (kt, N)
    wq = torch.clamp(torch.round(wt / scale[:, None, :]), -qmax, qmax)
    return wq.reshape(K, N).to(torch.int8), scale


def calibration_tile(M: int, N: int, K: int, block_m: int, block_n: int):
    """``(bm, bn)`` as the Pallas wrapper clips and asserts them."""
    assert K % TILE_K == 0, "K must be a multiple of the crossbar rows"
    bm, bn = min(block_m, M), min(block_n, N)
    assert M % bm == 0 and N % bn == 0
    return bm, bn


def cim_matmul_plain(x, wq, wscale, *, block_m: int = 128, block_n: int = 256,
                     adc_bits: int = 12, act_bits: int = 8) -> torch.Tensor:
    """x: (M, K) float; wq: (K, N) int8; wscale: (K // 256, N) float32.
    Returns (M, N) float32.  The float32 operations of ``_cim_kernel``, in
    its order, over all ``(bm, bn)`` tiles of a K step at once."""
    M, K = x.shape
    N = wq.shape[1]
    bm, bn = calibration_tile(M, N, K, block_m, block_n)
    qmax_a = 2.0 ** (act_bits - 1) - 1
    adc_max = 2.0 ** (adc_bits - 1) - 1
    wq32 = wq.float()
    ws = wscale.float()
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for ki in range(K // TILE_K):
        xk = x[:, ki * TILE_K:(ki + 1) * TILE_K].float()
        xs = _div(xk.abs().amax(dim=1, keepdim=True) + 1e-9, qmax_a)
        xq = torch.clamp(torch.round(xk / xs), -qmax_a, qmax_a)
        psum = (xq @ wq32[ki * TILE_K:(ki + 1) * TILE_K]).reshape(M // bm, bm, N // bn, bn)
        cal = psum.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1.0)
        code = torch.clamp(torch.round(psum / cal * adc_max), -adc_max, adc_max)
        psum_q = (code * _div(cal, adc_max)).reshape(M, N)
        acc = acc + psum_q * xs * ws[ki]
    return acc


def cim_matmul_cuda(x, wq, wscale, *, block_m: int = 128, block_n: int = 256,
                    adc_bits: int = 12, act_bits: int = 8) -> torch.Tensor:
    """Launch ``csrc/cim_matmul.cu`` on PyTorch's current stream: wq
    transposed to k-contiguous rows, the DAC, then the integer dot for each
    (calibration tile, K tile)'s max, then the dot again with the ADC and
    the recombination (one count)."""
    if not 2 <= act_bits <= 8:
        raise ValueError(f"the kernel's integer dot is exact only for "
                         f"act_bits <= 8 (int8 x int8 -> int32), got {act_bits}")
    if not 2 <= adc_bits <= 24:
        raise ValueError(f"the kernel takes adc_bits in [2, 24], got {adc_bits}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"cim_matmul_cuda takes float32 or bfloat16 x, got {x.dtype}")
    if wq.dtype != torch.int8 or wscale.dtype != torch.float32:
        raise TypeError(f"cim_matmul_cuda takes int8 wq and float32 wscale, "
                        f"got {wq.dtype}/{wscale.dtype}")
    M, K = x.shape
    N = wq.shape[1]
    if wq.shape[0] != K or tuple(wscale.shape) != (K // TILE_K, N):
        raise ValueError(f"unsupported shapes x{tuple(x.shape)} "
                         f"wq{tuple(wq.shape)} wscale{tuple(wscale.shape)}")
    bm, bn = calibration_tile(M, N, K, block_m, block_n)
    if max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError("cim_matmul_cuda takes operands below 2**31 elements")
    dev = x.device
    if not x.is_cuda or wq.device != dev or wscale.device != dev:
        raise ValueError("cim_matmul_cuda takes CUDA tensors on one device")
    lib = _build.library("cim_matmul")
    if not lib.cim_matmul_tile_fits(M, N, bm, bn):
        raise ValueError(f"calibration tile ({bm}, {bn}) too small for the kernel: "
                         f"a CTA tile meets more of them than it can hold")
    kt = K // TILE_K
    x, wq, wscale = x.contiguous(), wq.contiguous(), wscale.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    wqt = torch.empty((N, K), dtype=torch.int8, device=dev)
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M, kt), dtype=torch.float32, device=dev)
    cal = torch.empty(((M // bm) * (N // bn) * kt,), dtype=torch.int32, device=dev)
    _build.check(lib.cim_matmul_fwd(
        x.data_ptr(), wq.data_ptr(), wscale.data_ptr(), out.data_ptr(),
        wqt.data_ptr(), xq.data_ptr(), xs.data_ptr(), cal.data_ptr(), M, K, N, bm, bn,
        _DTYPE_CODES[x.dtype], 2 ** (act_bits - 1) - 1, 2 ** (adc_bits - 1) - 1,
        torch.cuda.current_stream(dev).cuda_stream), "cim_matmul")
    return out
