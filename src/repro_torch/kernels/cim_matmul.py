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

The kernel takes the weight as ``wqt (N, K)`` int8, k contiguous
(``weight_layout``); a caller that makes it once per weight passes it on
every call, else the kernel transposes ``wq`` on each call.  ``route``
picks the kernel's route by shape (``csrc/cim_matmul.cu``).
"""
from __future__ import annotations

import ctypes

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


# Output blocks of the kernel's routes (csrc/cim_matmul.cu), which the
# route chooser below mirrors.
PAIR_M, PAIR_N = 128, 256        # cluster: two CTAs of 128 x 128 along N
DECODE_M, DECODE_N = 16, 256     # decode: one CTA per (256 columns, K tile)
TWO_PASS_M, TWO_PASS_N = 64, 128  # two_pass: the two-pass kernels' CTA tile
MAX_SLOTS = 512                  # calibration tiles a two-pass CTA tile may meet
DECODE_MAX_SLOTS = 64            # the same for a decode CTA
ROUTES = ("cluster", "decode", "two_pass")   # the codes of cim_matmul_fwd's route


def _held(size: int, block: int, b: int) -> bool:
    """Calibration tiles of ``b`` along a dimension of ``size`` lie in
    blocks of ``block``: the dimension fits one block, or b divides it."""
    return size <= block or block % b == 0


def _one_tile(size: int, block: int, b: int) -> bool:
    """A block of ``block`` along a dimension of ``size`` is one
    calibration tile of ``b``: the dimension fits one block and b is all
    of it, or b is the block."""
    return b == size if size <= block else b == block


def _two_pass_slots(M: int, N: int, bm: int, bn: int) -> int:
    """Calibration tiles a 64 x 128 CTA tile can meet, at most."""
    rows = min(M // bm, (TWO_PASS_M + bm - 2) // bm + 1)
    cols = min(N // bn, (TWO_PASS_N + bn - 2) // bn + 1)
    return rows * cols


def takes(way: str, M: int, N: int, K: int, bm: int, bn: int) -> bool:
    """Whether route ``way`` holds every calibration tile (bm, bn) of an
    (M, K) x (K, N) product (``route_takes`` in ``csrc/cim_matmul.cu``):

      * ``decode``: M <= 16 and each calibration tile inside a 256-column
        block, at most 64 a block (split-K: at M <= 16 the cluster route
        runs only N / 128 CTAs, each over every K tile);
      * ``cluster``: each 128 x 256 output block is one calibration tile
        (M <= 128 and bm = M, or bm = 128; N <= 256 and bn = N, or
        bn = 256): one pass, wgmma, a pair of CTAs sharing the max;
      * ``two_pass``: a 64 x 128 tile meets at most 512 of them."""
    if way == "decode":
        return (M <= DECODE_M and _held(N, DECODE_N, bn)
                and (M // bm) * (min(N, DECODE_N) // bn) <= DECODE_MAX_SLOTS)
    if way == "cluster":
        return _one_tile(M, PAIR_M, bm) and _one_tile(N, PAIR_N, bn)
    if way == "two_pass":
        return _two_pass_slots(M, N, bm, bn) <= MAX_SLOTS
    raise ValueError(f"no route {way!r}: the routes are {ROUTES}")


def route(M: int, N: int, K: int, bm: int, bn: int) -> str:
    """The kernel's route for an (M, K) x (K, N) product with calibration
    tiles (bm, bn), by shape alone: the first of decode, cluster, two_pass
    that ``takes`` it.  Raises ValueError for a tile that no route takes."""
    for way in ("decode", "cluster", "two_pass"):
        if takes(way, M, N, K, bm, bn):
            return way
    raise ValueError(f"calibration tile ({bm}, {bn}) too small for the kernel: "
                     f"a block meets more of them than it can hold")


def weight_layout(wq: torch.Tensor) -> torch.Tensor:
    """wq (K, N) int8 as the kernel reads it: wqt (N, K), k contiguous.
    Made once per weight, on wq's device, and passed to every call."""
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise TypeError(f"weight_layout takes a 2-d int8 wq, "
                        f"got {wq.dtype} {tuple(wq.shape)}")
    return wq.t().contiguous()


def check_layout(wqt, wq) -> None:
    """Raise unless ``wqt`` is None or wq's (N, K) int8 layout on wq's
    device."""
    if wqt is None:
        return
    K, N = wq.shape
    if wqt.dtype != torch.int8 or tuple(wqt.shape) != (N, K) or wqt.device != wq.device:
        raise ValueError(f"wqt must be int8 ({N}, {K}) on {wq.device} (weight_layout(wq)), "
                         f"got {wqt.dtype} {tuple(wqt.shape)} on {wqt.device}")


def cim_work(x, wq, wscale):
    """Bytes (x, wq and wscale read once, the float32 output written once),
    the integer dot's 2 M K N int8 operations, and the M N K / 256 float32
    ADC steps at 9 operations each: abs and max for the calibration; the
    division, the multiply and the round; three multiplies and the add.
    The reference's two clamps of the code are not counted: |psum| <= cal,
    so |rint(psum / cal * adc_max)| <= adc_max and they never bind."""
    (M, K), N = x.shape, wq.shape[1]
    nbytes = (x.numel() * x.element_size() + wq.numel() + wscale.numel() * 4
              + M * N * 4)
    return nbytes, 2 * M * K * N, 9 * M * N * (K // 256)


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


def cim_matmul_cuda(x, wq, wscale, *, wqt=None, block_m: int = 128, block_n: int = 256,
                    adc_bits: int = 12, act_bits: int = 8, way=None) -> torch.Tensor:
    """Launch ``csrc/cim_matmul.cu`` on PyTorch's current stream (one
    count): the DAC, then the route's kernels.  ``wqt``: the weight as
    ``weight_layout(wq)`` gives it, read in place of wq; only its dtype,
    shape and device are checked, so it must be made from this wq.
    Without it the kernel transposes wq first.  ``way``: a route that
    ``takes`` the shape, to compare routes; default ``route``."""
    _build.refuse_grad("cim_matmul", "ROADMAP §B4: the CIM product is on no model or "
                       "training path", x, wscale)
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
    check_layout(wqt, wq)
    bm, bn = calibration_tile(M, N, K, block_m, block_n)
    if max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError("cim_matmul_cuda takes operands below 2**31 elements")
    if way is None:
        way = route(M, N, K, bm, bn)
    elif not takes(way, M, N, K, bm, bn):
        raise ValueError(f"route {way} does not take calibration tiles ({bm}, {bn}) "
                         f"of M{M} K{K} N{N}")
    dev = x.device
    if not x.is_cuda or wq.device != dev or wscale.device != dev:
        raise ValueError("cim_matmul_cuda takes CUDA tensors on one device")
    lib = _build.library("cim_matmul")
    kt = K // TILE_K
    x, wq, wscale = _build.aligned(x), _build.aligned(wq), _build.aligned(wscale)
    ready = wqt is not None
    wqt = _build.aligned(wqt) if ready else torch.empty((N, K), dtype=torch.int8, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M, kt), dtype=torch.float32, device=dev)
    if way == "two_pass":
        scratch = torch.empty(((M // bm) * (N // bn) * kt,), dtype=torch.int32, device=dev)
    elif way == "decode":
        scratch = torch.empty((kt, M, N), dtype=torch.float32, device=dev)
    else:
        scratch = out                      # not read
    _build.check(lib.cim_matmul_fwd(
        x.data_ptr(), wq.data_ptr(), wscale.data_ptr(), out.data_ptr(),
        wqt.data_ptr(), xq.data_ptr(), xs.data_ptr(), scratch.data_ptr(), M, K, N, bm, bn,
        _DTYPE_CODES[x.dtype], 2 ** (act_bits - 1) - 1, 2 ** (adc_bits - 1) - 1,
        ROUTES.index(way), int(ready),
        torch.cuda.current_stream(dev).cuda_stream), "cim_matmul")
    return out


def resident_ctas(way: str) -> int:
    """CTAs of the route's main kernel that reside on one SM of the current
    card at once."""
    fn = _build.library("cim_matmul").cim_matmul_resident_ctas
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(ROUTES.index(way), ctypes.byref(out))
    if err:
        raise RuntimeError(f"cim_matmul occupancy query failed: CUDA error {err}")
    return out.value


def adc_div_mismatches(*, max_cal: int = 0, n: int = 0, seed: int = 0,
                       device="cuda") -> int:
    """Pairs (p, cal) on which the kernels' ADC division differs in any bit
    from IEEE division (``__fdiv_rn``) on the card: every pair with
    1 <= cal <= max_cal and |p| <= cal if max_cal, else n random pairs
    with cal < 2^24 from seed."""
    fn = _build.library("cim_matmul").cim_adc_div_mismatches
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    mode = 0 if max_cal else 1
    err = fn(mode, max_cal, n, seed, bad.data_ptr(),
             torch.cuda.current_stream(bad.device).cuda_stream)
    if err:
        raise RuntimeError(f"cim_matmul division check failed: CUDA error {err}")
    return int(bad.item())
