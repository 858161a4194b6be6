"""Mamba2 SSD chunked scan: the Hopper kernel ``csrc/ssd_scan.cu`` and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_ssd_kernel``) on the path where the JAX model runs the same function
as ``repro.models.ssm.ssd_chunked``.  Same function: per (batch, head) a
``(P, N)`` state carried across chunks; within a chunk the dual quadratic
form ``(C Bᵀ) ⊙ exp(segsum(dt·A))`` masked to the lower triangle, times
``x·dt``, plus ``exp(cumsum(dt·A)) · C · stateᵀ``, then the state update.
B and C have one group, shared by all heads.  Returns ``y`` and the final
state, both float32.

SSD is exactly associative across chunks, so the chunk length is not part
of the result (up to rounding): the plain version steps over ``chunk`` rows
as ``ssd_chunked`` does, and the kernel over sub-chunks of its own length.
A ragged ``S`` is zero-padded (plain) or masked (kernel); a padded row has
dt = 0 and adds nothing to ``y`` or to the state.

What bounds the scan on an H100, and what each path does about it: the
work is ~100 FLOPs per byte moved, below the bf16 tensor cores' balance
point, so the card's bound is the bytes; but the (batch, head) chains of
sub-chunks give only ~2.4 CTAs per SM at the main shape, so latency and
the rate of the products decide the time.  bf16 x/B/C (the served models)
go to a tensor-core kernel whose float32 operands (Att, x·w, the state)
are each multiplied as two bf16 terms, ``hi + lo``, so the result keeps
float32 accuracy; it reads x, B and C where they lie (the mamba layer
passes strided views of its conv output) and keeps the state in
registers.  float32 x/B/C go to the first, SIMT kernel, float32 FMAs
throughout, so float32 parity checks see no TF32.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (32, 64)                 # P
STATE_DIMS = (16, 32, 64, 128)       # N
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(x, dt, a_neg, B, C, chunk: int):
    """x: (b, S, H, P), not yet multiplied by dt; dt: (b, S, H) > 0;
    a_neg: (H,) < 0; B, C: (b, S, N).  Returns y (b, S, H, P) float32 and
    the final state (b, H, P, N) float32.  A transcription of
    ``repro.models.ssm.ssd_chunked``."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    xc = x.reshape(b, nc, L, H, P).float()
    dtc = dt.reshape(b, nc, L, H).float()
    Bc = B.reshape(b, nc, L, N).float()
    Cc = C.reshape(b, nc, L, N).float()
    a_neg = a_neg.float()
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dtk * a_neg                                     # (b, L, H)
        cs = torch.cumsum(dA, dim=1)
        seg = cs[:, :, None, :] - cs[:, None, :, :]          # (b, L, L, H)
        Lmat = torch.where(tri[None, :, :, None], torch.exp(seg),
                           torch.zeros_like(seg))
        att = torch.einsum("bln,bmn->blm", Ck, Bk)
        xdt = xk * dtk[..., None]
        y_diag = torch.einsum("blm,blmh,bmhp->blhp", att, Lmat, xdt)
        y_off = torch.einsum("bln,bhpn,blh->blhp", Ck, state, torch.exp(cs))
        decay_states = torch.exp(cs[:, -1:, :] - cs)
        new_state = torch.einsum("bln,blh,blhp->bhpn", Bk,
                                 decay_states * dtk, xk)
        state = state * torch.exp(cs[:, -1, :])[:, :, None, None] + new_state
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, nc * L, H, P)
    return y[:, :S], state


def kernel_layout(x, B, C):
    """x, B and C as the kernel reads them, with the elements between their
    rows: ``(x, B, C, x_stride, bc_stride)``.  The last dim of each must be
    contiguous, or this raises.  bf16 tensors are read where they lie when
    a row (one time step: x's ``H·P`` elements, B's and C's ``N``) is
    contiguous and row s of batch i starts at ``(i·S + s)·stride`` on a
    16-byte boundary, as in the mamba layer's views of its conv output;
    anything else, and float32 (whose kernel takes contiguous rows only),
    is copied to contiguous tensors first."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd_scan_cuda takes x, B and C with a contiguous last dim, "
                         f"got strides x{x.stride()} B{B.stride()} C{C.stride()}")

    def row_stride(t, width):
        if S == 1:
            return t.stride(0) if b > 1 else width
        return t.stride(1)

    xs, bs, cs = row_stride(x, H * P), row_stride(B, N), row_stride(C, N)

    def readable(t, stride):
        return ((b == 1 or t.stride(0) == S * stride) and stride % 8 == 0
                and t.data_ptr() % 16 == 0)

    if x.dtype != torch.bfloat16 or (H > 1 and x.stride(2) != P) or not readable(x, xs):
        x, xs = _build.aligned(x), H * P
    if x.dtype != torch.bfloat16 or bs != cs or not (readable(B, bs) and readable(C, cs)):
        B, C, bs = _build.aligned(B), _build.aligned(C), N
    return x, B, C, xs, bs


def ssd_scan_cuda(x, dt, a_neg, B, C):
    """Launch ``csrc/ssd_scan.cu`` on PyTorch's current stream.  It takes
    no chunk length: the kernel steps over sub-chunks of its own, and the
    result does not depend on it."""
    _build.refuse_grad("ssd_scan", "ROADMAP §A5: SSM / hybrid training with an ssd_scan "
                       "backward kernel", x, dt, a_neg, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    if not x.is_cuda or any(t.device != dev for t in (dt, a_neg, B, C)):
        raise ValueError("ssd_scan_cuda takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan_cuda takes float32 or bfloat16 x/B/C of "
                        f"one dtype, got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or a_neg.dtype != torch.float32:
        raise TypeError("ssd_scan_cuda takes float32 dt and a_neg")
    if (P not in HEAD_DIMS or N not in STATE_DIMS
            or tuple(dt.shape) != (b, S, H) or tuple(a_neg.shape) != (H,)
            or tuple(B.shape) != (b, S, N) or C.shape != B.shape):
        raise ValueError(f"unsupported shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} a{tuple(a_neg.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    x, B, C, x_stride, bc_stride = kernel_layout(x, B, C)
    dt, a_neg = dt.contiguous(), a_neg.contiguous()
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, S, H, P, N,
        x_stride, bc_stride, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream), "ssd_scan")
    return y, state


def resident_ctas(P: int, N: int, dtype) -> int:
    """CTAs of the kernel for (P, N, dtype) that reside on one SM of the
    current card at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = _build.library("ssd_scan").ssd_scan_resident_ctas
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(P, N, _DTYPE_CODES[dtype], ctypes.byref(out))
    if err:
        raise RuntimeError(f"ssd_scan occupancy query failed: CUDA error {err}")
    return out.value
