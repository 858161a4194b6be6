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

Training: under grad ``ssd_scan_cuda`` goes through ``SSDScanFn``, whose
forward launches ``csrc/ssd_scan.cu`` and keeps its inputs, y and the
final state, and whose backward launches ``csrc/ssd_scan_bwd.cu`` (dx,
ddt, da_neg, dB, dC from the gradients of y and of the state; its plain
version is ``ssd_scan_bwd_plain``, the same reverse-chunk recursion in
float32).  The reference has no backward kernel: XLA differentiates
``ssd_chunked``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (32, 64)                 # P
STATE_DIMS = (16, 32, 64, 128)       # N
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lower_exp(seg, tri):
    """exp(seg) on the lower triangle (m <= l, where seg <= 0), 0 above;
    exp is taken of 0 above, so neither the value nor its gradient sees
    the overflow of a large positive exponent."""
    low = tri[None, :, :, None]
    zero = torch.zeros_like(seg)
    return torch.where(low, torch.exp(torch.where(low, seg, zero)), zero)


def ssd_scan_plain(x, dt, a_neg, B, C, chunk: int):
    """x: (b, S, H, P), not yet multiplied by dt; dt: (b, S, H) > 0;
    a_neg: (H,) < 0; B, C: (b, S, N).  Returns y (b, S, H, P) float32 and
    the final state (b, H, P, N) float32.  A transcription of
    ``repro.models.ssm.ssd_chunked``, with one repair of its gradient: the
    decays above the diagonal (cs_l - cs_m > 0 for m > l) are masked before
    ``exp``, not after, so autograd's exp' there is exp(0) times a zero
    gradient.  ``ssd_chunked`` takes ``exp`` of them first; past ~88 (a
    256-row chunk at dt ~ 0.7 and A = -1 reaches ~180) that is inf, and its
    VJP multiplies the masked zero by it: NaN in dt's and A's gradients
    (ROADMAP hazard 11).  The values are the same bit for bit."""
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
        Lmat = _lower_exp(seg, tri)
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


def ssd_scan_bwd_plain(x, dt, a_neg, B, C, dy, dstate=None, chunk: int = 256, *,
                       y=None, state=None):
    """The backward of ``ssd_scan_plain`` as an explicit recursion over
    chunks of ``chunk`` rows in float32: (dx in x's dtype, ddt (b, S, H)
    float32, da_neg (H,) float32, dB and dC in B's dtype) from the
    gradients ``dy`` (b, S, H, P) of y and ``dstate`` (b, H, P, N) of the
    final state (None: no gradient there).  ``y`` and ``state``: the
    forward's outputs where the caller has them, as the kernel reads its
    forward's (None: the ones the sweep below computes).  A forward sweep
    gives each chunk's starting state h0 and y; a reverse sweep carries G, the
    gradient of the state at the chunk's end, and the running sum of
    dcs_t = dy_t . y_t - u_t . du_t (u = dt x; plus <dstate, h_last> from
    the last row on), whose suffix sums are the gradients of dt_t A:
      du = M^T dy + exp(cs_last - cs) (B G^T),   M = (C B^T) o exp(cs_l - cs_m)
      dB = W^T C + exp(cs_last - cs) (u G),      W = (dy u^T) o exp(cs_l - cs_m)
      dC = W B + exp(cs) (dy h0),                G <- exp(cs_last) G + (exp(cs) dy)^T C
    (M and W on m <= l, where the exponent is <= 0, zero above), dx = dt
    du, ddt = x . du + A da, da_neg = sum dt da; dB and dC summed over the
    heads.  ``csrc/ssd_scan_bwd.cu`` runs the same recursion over its own
    32-row sub-chunks.  float64 inputs are differentiated in float64 (a
    reference for the float32 sums)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32

    def chunks(t, *tail):
        t = t.to(acc)
        if pad:
            t = F.pad(t, (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, L, *tail)

    xc, dtc, dyc = chunks(x, H, P), chunks(dt, H), chunks(dy, H, P)
    Bc, Cc = chunks(B, N), chunks(C, N)
    a_neg = a_neg.to(acc)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()

    def decays(c):
        cs = torch.cumsum(dtc[:, c] * a_neg, dim=1)              # (b, L, H)
        seg = cs[:, :, None, :] - cs[:, None, :, :]              # (b, L, L, H)
        return cs, _lower_exp(seg, tri)

    h = torch.zeros((b, H, P, N), dtype=acc, device=x.device)
    h0s, ys = [], []
    for c in range(nc):                                          # forward: h0 and y
        cs, lmat = decays(c)
        u = xc[:, c] * dtc[:, c, ..., None]
        att = torch.einsum("bln,bmn->blm", Cc[:, c], Bc[:, c])
        ys.append(torch.einsum("blm,blmh,bmhp->blhp", att, lmat, u)
                  + torch.einsum("bln,bhpn,blh->blhp", Cc[:, c], h, torch.exp(cs)))
        h0s.append(h)
        h = (h * torch.exp(cs[:, -1])[:, :, None, None]
             + torch.einsum("bln,blh,blhp->bhpn", Bc[:, c], torch.exp(cs[:, -1:] - cs), u))
    if y is not None:
        ys = list(chunks(y, H, P).unbind(1))
    if state is not None:
        h = state.to(acc)
    G = torch.zeros_like(h) if dstate is None else dstate.to(acc)
    carry = (G * h).sum((-1, -2))                                # (b, H)
    dx, ddt, dB, dC = ([None] * nc for _ in range(4))
    da_neg = torch.zeros((H,), dtype=acc, device=x.device)
    for c in reversed(range(nc)):
        cs, lmat = decays(c)
        ews, ecs = torch.exp(cs[:, -1:] - cs), torch.exp(cs)
        xk, dtk, dyk, Bk, Ck = xc[:, c], dtc[:, c], dyc[:, c], Bc[:, c], Cc[:, c]
        u = xk * dtk[..., None]
        M = torch.einsum("bln,bmn->blm", Ck, Bk)[..., None] * lmat
        W = torch.einsum("blhp,bmhp->blmh", dyk, u) * lmat
        du = (torch.einsum("blmh,blhp->bmhp", M, dyk)
              + ews[..., None] * torch.einsum("bmn,bhpn->bmhp", Bk, G))
        dB[c] = (torch.einsum("blmh,bln->bmn", W, Ck)
                 + torch.einsum("bmh,bmhp,bhpn->bmn", ews, u, G))
        dC[c] = (torch.einsum("blmh,bmn->bln", W, Bk)
                 + torch.einsum("blh,blhp,bhpn->bln", ecs, dyk, h0s[c]))
        dx[c] = dtk[..., None] * du
        xdu = (xk * du).sum(-1)                                  # (b, L, H)
        dcs = (dyk * ys[c]).sum(-1) - dtk * xdu
        da = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1), (1,)) + carry[:, None]
        carry = carry + dcs.sum(1)
        ddt[c] = xdu + a_neg * da
        da_neg = da_neg + (dtk * da).sum((0, 1))
        G = (G * torch.exp(cs[:, -1])[:, :, None, None]
             + torch.einsum("blh,blhp,bln->bhpn", ecs, dyk, Ck))

    def whole(parts, dtype):
        return torch.stack(parts, 1).reshape(b, nc * L, *parts[0].shape[2:])[:, :S].to(dtype)

    return (whole(dx, x.dtype), whole(ddt, acc), da_neg,
            whole(dB, B.dtype), whole(dC, C.dtype))


# How far the backward kernel's gradients may lie from the plain version's
# on the same inputs and the same forward outputs y and state (the kernel
# reads its forward's; a bf16 forward's y is ~1e-5 of max |y| from the
# float32 one, and dy . y summed over S rows carries that into ddt and
# da_neg).  Each gradient is held against the largest |value| of its plain
# version: both sum in float32, the plain version over chunks of 256 rows,
# the kernel over 32, so the decays' exponents and the sums are rounded
# differently; on the CPU the plain version's float32 lies within ~6e-6 of
# its own float64 on dx, ddt, dB and dC, so SSD_BWD_REL.  da_neg = sum_t
# dcs_t T_t, with T_t = sum_{s <= t} dt_s (up to ~700 at S 1024) and dcs_t
# = dy_t . y_t - u_t . du_t, two terms of order P that cancel: float32
# rounds each dcs_t by ~1e-7 of its terms and the weights T_t carry that
# into da_neg, ~1.2e-4 of max |da_neg| from float64 at b2 S512, more at
# larger b and S.  So da_neg is held within SSD_BWD_DA_REL of max |da_neg|,
# or, given the float64 value (``exact``), within twice the plain float32
# version's own distance from it, of it.  bf16 gradients (dx, dB, dC of
# bf16 inputs) are rounded to bf16 once by each, so an element may differ
# by BF16_REL of its value besides.
SSD_BWD_REL = 1e-4
SSD_BWD_DA_REL = 1e-3
BF16_REL = 2.0 ** -7
BWD_NAMES = ("dx", "ddt", "da_neg", "dB", "dC")


def bwd_agreement(got, want, name: str, exact=None):
    """``(max |got - ref|, max of |got - ref| / its bound, ok)`` for the
    gradient ``name`` (one of ``BWD_NAMES``) under the rule above: ref is
    ``want``, or for da_neg with ``exact`` (its float64 value) ``exact``;
    both must be finite."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"compare like with like: {got.dtype}{tuple(got.shape)} "
                         f"against {want.dtype}{tuple(want.shape)}")
    g, w = got.double(), want.double()
    if w.numel() == 0:
        return 0.0, 0.0, True
    ok = bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())
    top = w.abs().max().item()
    if name == "da_neg":
        bound = torch.full_like(w, SSD_BWD_DA_REL * top)
        if exact is not None:
            x = exact.double()
            bound = bound.clamp_min(2 * (w - x).abs().max().item())
            w = x
    else:
        bound = torch.full_like(w, SSD_BWD_REL * top)
    if got.dtype == torch.bfloat16:
        bound = bound + BF16_REL * w.abs()
    diff = (g - w).abs()
    ratio = (diff / bound.clamp_min(1e-30)).max().item()
    return diff.max().item(), ratio, ok and ratio <= 1.0


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


def _check_inputs(name, x, dt, a_neg, B, C):
    b, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    if not x.is_cuda or any(t.device != dev for t in (dt, a_neg, B, C)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x/B/C of "
                        f"one dtype, got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or a_neg.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 dt and a_neg")
    if (P not in HEAD_DIMS or N not in STATE_DIMS
            or tuple(dt.shape) != (b, S, H) or tuple(a_neg.shape) != (H,)
            or tuple(B.shape) != (b, S, N) or C.shape != B.shape):
        raise ValueError(f"unsupported shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} a{tuple(a_neg.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")


def ssd_scan_cuda(x, dt, a_neg, B, C):
    """Launch ``csrc/ssd_scan.cu`` on PyTorch's current stream.  It takes
    no chunk length: the kernel steps over sub-chunks of its own, and the
    result does not depend on it.  Where autograd needs the gradient (grad
    enabled, an input that requires grad) the call goes through
    ``SSDScanFn``, whose backward is ``csrc/ssd_scan_bwd.cu``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a_neg, B, C)):
        return SSDScanFn.apply(x, dt, a_neg, B, C)
    return _ssd_fwd(x, dt, a_neg, B, C)


def _ssd_fwd(x, dt, a_neg, B, C):
    """One launch of ``csrc/ssd_scan.cu``: (y, final state)."""
    _check_inputs("ssd_scan_cuda", x, dt, a_neg, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    key = launch_key(x, B)
    x, B, C, x_stride, bc_stride = kernel_layout(x, B, C)
    dt, a_neg = dt.contiguous(), a_neg.contiguous()
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, S, H, P, N,
        x_stride, bc_stride, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream), "ssd_scan", key)
    return y, state


def launch_key(x, B) -> str:
    """The shape under which ``ssd_scan_cuda`` and ``ssd_scan_bwd_cuda``
    count a launch in ``_build.LAUNCHES_BY_SHAPE``."""
    b, S, H, P = x.shape
    return f"b{b} S{S} H{H} P{P} N{B.shape[-1]} {str(x.dtype).removeprefix('torch.')}"


def ssd_scan_bwd_cuda(x, dt, a_neg, B, C, y, state, dy, dstate=None):
    """dx, ddt, da_neg, dB, dC of ``ssd_scan`` by ``csrc/ssd_scan_bwd.cu``
    from the forward's inputs (x, B, C read where they lie, as the forward
    reads them), its outputs y and the final state, and their gradients
    ``dy`` (float32) and ``dstate`` (float32, or None for none); dx, dB and
    dC in their inputs' dtype, ddt and da_neg float32.  Its two launches
    (the walks, the fixed-order sums of dB, dC and da_neg over heads and
    batch) count as one."""
    _check_inputs("ssd_scan_bwd_cuda", x, dt, a_neg, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if (tuple(y.shape) != (b, S, H, P) or tuple(dy.shape) != (b, S, H, P)
            or tuple(state.shape) != (b, H, P, N)
            or (dstate is not None and dstate.shape != state.shape)):
        raise ValueError(f"y / dy must be (b, S, H, P) = {(b, S, H, P)} and state / dstate "
                         f"(b, H, P, N), got y{tuple(y.shape)} dy{tuple(dy.shape)} "
                         f"state{tuple(state.shape)}")
    x, B, C, x_stride, bc_stride = kernel_layout(x, B, C)
    dt, a_neg, y, state, dy = (t.float().contiguous() for t in (dt, a_neg, y, state, dy))
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dx = torch.empty((b, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, S, H), **f32)
    da_neg = torch.empty((H,), **f32)
    dB, dC = (torch.empty((b, S, N), dtype=B.dtype, device=dev) for _ in range(2))
    workspace = torch.empty((2 * b * H * S * N + b * H,), **f32)
    lib = _build.library("ssd_scan_bwd")
    _build.check(lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), dy.data_ptr(),
        dstate.data_ptr() if dstate is not None else None,
        dx.data_ptr(), ddt.data_ptr(), da_neg.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        workspace.data_ptr(), b, S, H, P, N, x_stride, bc_stride, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream), "ssd_scan_bwd", launch_key(x, B))
    return dx, ddt, da_neg, dB, dC


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with its gradient: the forward launches
    ``csrc/ssd_scan.cu`` and keeps x, dt, a_neg, B, C, y and the final
    state; the backward launches ``csrc/ssd_scan_bwd.cu`` with the
    gradients of y and of the state (an unused output's is None).
    ``SSDScanFn.apply(x, dt, a_neg, B, C)`` on CUDA tensors returns (y,
    state)."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, B, C):
        y, state = _ssd_fwd(x, dt, a_neg, B, C)
        ctx.save_for_backward(x, dt, a_neg, B, C, y, state)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_neg, B, C, y, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        return ssd_scan_bwd_cuda(x, dt, a_neg, B, C, y, state, dy, dstate)


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
