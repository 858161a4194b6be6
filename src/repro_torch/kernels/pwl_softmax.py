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
A NaN goes through both versions as through the Pallas kernel: a row that
holds a NaN or +inf, or only -inf, comes out all NaN.

``route`` picks the kernel's route by shape (``csrc/pwl_softmax.cu``):
``warp`` (n <= 1024, the row in registers), ``row`` (one CTA a row, the
row in shared memory), ``cluster`` (few rows: a row split over a thread
block cluster of 2-16 CTAs) or ``three_pass`` (rows that 16 slices of
shared memory cannot hold).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .pwl import PWL_COEFFS, pwl_exp

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}

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


# The kernel's routes (csrc/pwl_softmax.cu), in the order of the codes of
# pwl_softmax_fwd's route, and the limits that route() mirrors.
ROUTES = ("warp", "row", "cluster", "three_pass")
CHUNK = 16                     # bytes a lane moves a load or a store
WARP_MAX_N = 1024              # warp: the row in registers
SLICE_MAX_BYTES = 224 * 1024   # a CTA's slice of a row in shared memory
MAX_CLUSTER = 16               # CTAs a cluster (non-portable: more than 8)
MIN_SLICE_BYTES = 8 * 1024     # no finer split: 512 threads x 16 bytes
SMS = 132                      # the H100's SMs, which few rows are spread over


def _esize(dtype) -> int:
    if dtype not in _ESIZE:
        raise TypeError(f"pwl_softmax_cuda takes float32 or bfloat16, got {dtype}")
    return _ESIZE[dtype]


def slice_bytes(n: int, dtype, cs: int) -> int:
    """Shared memory of one CTA when rows of n are split over cs CTAs: a
    row spans at most ceil(n * esize / 16) + 1 chunks of 16 bytes, whatever
    its alignment (``slice_chunks`` in the source)."""
    chunks = -(-n * _esize(dtype) // CHUNK) + 1
    return CHUNK * -(-chunks // cs)


def vector_rows(n: int, dtype) -> bool:
    """Whether the warp route moves 16 bytes a lane (rows of a multiple of
    16 bytes) or one element (the others, such as the decode scores' 513)."""
    return n * _esize(dtype) % CHUNK == 0


def takes(way: str, cs: int, rows: int, n: int, dtype) -> bool:
    """Whether route ``way`` with ``cs`` CTAs a row runs rows x n of dtype
    (``route_takes`` in ``csrc/pwl_softmax.cu``)."""
    fits = slice_bytes(n, dtype, cs) <= SLICE_MAX_BYTES
    if way == "warp":
        return cs == 1 and n <= WARP_MAX_N
    if way == "row":
        return cs == 1 and fits
    if way == "cluster":
        return 2 <= cs <= MAX_CLUSTER and fits and rows * cs < 2 ** 31
    if way == "three_pass":
        return cs == 1
    raise ValueError(f"no route {way!r}: the routes are {ROUTES}")


@functools.lru_cache(maxsize=256)
def route(rows: int, n: int, dtype):
    """``(route, cs)`` of the kernel for rows x n of dtype, by shape alone:
    ``warp`` for n <= 1024; else the fewest CTAs a row (a power of two) whose
    slices fit shared memory, doubled while rows x cs leaves SMs idle and a
    slice keeps 8 KB, ``row`` at one, ``cluster`` at 2-16; ``three_pass``
    past 16.  Raises TypeError for another dtype, ValueError for an empty
    shape or one of 2**31 rows or columns."""
    _esize(dtype)
    if not (0 < rows < 2 ** 31 and 0 < n < 2 ** 31):
        raise ValueError(f"pwl_softmax_cuda takes 1 to 2**31 - 1 rows and columns, "
                         f"got {rows} x {n}")
    if n <= WARP_MAX_N:
        return "warp", 1
    cs = 1
    while slice_bytes(n, dtype, cs) > SLICE_MAX_BYTES:
        cs *= 2
        if cs > MAX_CLUSTER:
            return "three_pass", 1
    while (cs < MAX_CLUSTER and rows * cs < SMS
           and slice_bytes(n, dtype, 2 * cs) >= MIN_SLICE_BYTES):
        cs *= 2
    if cs == 1:
        return "row", 1
    return ("cluster", cs) if takes("cluster", cs, rows, n, dtype) else ("three_pass", 1)


def softmax_work(x):
    """Bytes (x read once, the output written once) and float32 operations
    of the SCU softmax: per element the max, the subtraction, the segment's
    multiply and add, the sum and the scale (the segment select not
    counted)."""
    return 2 * x.numel() * x.element_size(), 6 * x.numel()


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


def agreement_nan(got: torch.Tensor, want: torch.Tensor):
    """``agreement`` for outputs that may hold NaN rows: ``(max |got -
    want|, share differing, ok)`` over the elements that are NaN on neither
    side; ok also needs NaN in exactly the same places."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"compare like with like: {got.dtype}{tuple(got.shape)} "
                         f"against {want.dtype}{tuple(want.shape)}")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    keep = ~(nan_g | nan_w)
    err, share, ok = agreement(got[keep], want[keep])
    return err, share, ok and torch.equal(nan_g, nan_w)


def edge_rows(n: int) -> torch.Tensor:
    """float32 rows ``[0, -inf, ..., -inf, t]`` of n >= 2 for every float32
    t within 64 ulps of each segment edge -8, -7, ..., 0, and for t = -inf,
    NaN and 0 (on the CPU).  The sum of such a row is pwl(-m) + pwl(t - m)
    plus zeros, in any order the same, so the kernel must give the plain
    version's bits on it."""
    ts = [np.float32(-np.inf), np.float32(np.nan), np.float32(0)]
    for edge in range(-8, 1):
        t = np.float32(edge)
        lo = hi = t
        for _ in range(64):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            ts += [lo, hi]
        ts.append(t)
    x = torch.full((len(ts), n), float("-inf"))
    x[:, 0] = 0.0
    x[:, -1] = torch.from_numpy(np.array(ts, np.float32))
    return x


def pwl_softmax_cuda(x: torch.Tensor, plan=None) -> torch.Tensor:
    """Launch ``csrc/pwl_softmax.cu`` on PyTorch's current stream (one
    launch, one count).  ``plan``: ``(route, cs)`` that ``takes`` the shape,
    to hold every route to the plain version; default ``route``."""
    _build.refuse_grad("pwl_softmax", "ROADMAP §B3: the SCU softmax is on no model "
                       "or training path", x)
    if not x.is_cuda:
        raise ValueError("pwl_softmax_cuda takes a CUDA tensor")
    _esize(x.dtype)
    if x.dim() == 0:
        raise ValueError("pwl_softmax_cuda takes a tensor of at least one dim")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    x = _build.aligned(x)
    out = torch.empty_like(x)
    if rows == 0 or n == 0:                 # nothing to normalise: no launch
        return out
    if plan is None:
        plan = route(rows, n, x.dtype)
    else:
        route(rows, n, x.dtype)             # the same checks of the shape
        if not takes(*plan, rows, n, x.dtype):
            raise ValueError(f"plan {plan} does not take {rows} x {n} {x.dtype}")
    way, cs = plan
    lib = _build.library("pwl_softmax")
    _build.check(lib.pwl_softmax_fwd(
        x.data_ptr(), out.data_ptr(), rows, n, _DTYPE_CODES[x.dtype], ROUTES.index(way), cs,
        ctypes.addressof(PWL_COEFFS),
        torch.cuda.current_stream(x.device).cuda_stream), "pwl_softmax")
    return out


def occupancy(way: str, cs: int, n: int, dtype):
    """``(CTAs resident per SM, clusters the card holds at once)`` of the
    route's kernel for rows of n on the current card (clusters 0 but for
    ``cluster``)."""
    fn = _build.library("pwl_softmax").pwl_softmax_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(ROUTES.index(way), cs, n, _DTYPE_CODES[dtype], ctypes.byref(ctas),
             ctypes.byref(clusters))
    if err:
        raise RuntimeError(f"pwl_softmax occupancy query failed: CUDA error {err}")
    return ctas.value, clusters.value


def exp_mismatches(device="cuda") -> int:
    """Over all 2**32 float32 inputs on the card: the inputs on which the
    kernel's indexed PWL exp differs in any bit from the attention kernels'
    select chain ``pwl_exp`` (its clip keeps NaN); two NaNs count as
    equal."""
    fn = _build.library("pwl_softmax").pwl_softmax_exp_mismatches
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    err = fn(ctypes.addressof(PWL_COEFFS), bad.data_ptr(),
             torch.cuda.current_stream(bad.device).cuda_stream)
    if err:
        raise RuntimeError(f"pwl_softmax exp check failed: CUDA error {err}")
    return int(bad.item())
