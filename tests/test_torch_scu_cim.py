"""The port's SCU softmax and CIM matmul (repro_torch.kernels) against the
JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; it is held
to the Pallas kernel in interpret mode (``repro.kernels.ops``), to the
oracles of ``repro.kernels.ref`` and to ``repro.core.scu``, on the same
numpy inputs.  The CUDA kernels themselves are held to the plain versions
on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scu
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.cim_matmul import cim_matmul as jcim_quantized
from repro.kernels.cim_matmul import quantize_weights as jquantize
from repro.kernels.pwl_softmax import _pwl_exp_vec
from repro_torch.kernels import ops
from repro_torch.kernels import _build
from repro_torch.kernels.cim_matmul import (ROUTES, calibration_tile, cim_matmul_cuda,
                                            cim_matmul_plain, quantize_weights, route, takes,
                                            weight_layout)
from repro_torch.kernels.pwl import SEG_INTERCEPT, SEG_SLOPE, pwl_exp
from repro_torch.kernels.pwl_softmax import (F32_ATOL, MAX_CLUSTER, MIN_SLICE_BYTES, SLICE_MAX_BYTES,
                                             agreement, agreement_nan, edge_rows,
                                             pwl_softmax_cuda, pwl_softmax_plain,
                                             slice_bytes, vector_rows)
from repro_torch.kernels import pwl_softmax as psm

# softmax: float32 on both sides, the row sum taken in another order, within
# F32_ATOL; bfloat16 outputs by pwl_softmax.agreement: one bfloat16 step of
# each value at most, and fewer than 1% of the nonzero ones differ at all
# CIM: the integer dots are exact and the float32 steps the same; the
# remainder is float32 ordering in the accumulator (~1e-7 of max |out|).
# One flipped 12-bit ADC code moves an output by ~1/2047 of its tile's
# swing, far above this bar.
CIM_REL = 1e-6


def _np(x):
    return np.array(x, np.float32)


def _rows(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# SCU softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 512, 1000])
@pytest.mark.parametrize("rows", [1, 7, 256, 300])
def test_pwl_softmax_plain_matches_jax(rows, n):
    x = _rows(rows * 1000 + n, (rows, n))
    got = pwl_softmax_plain(torch.from_numpy(x)).numpy()
    for want in (jops.pwl_softmax(jnp.asarray(x)),
                 ref.ref_pwl_softmax(jnp.asarray(x)),
                 scu.pwl_softmax(x)):
        np.testing.assert_allclose(got, _np(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(7, 512), (300, 1000), (2, 3, 40)])
def test_pwl_softmax_plain_bf16_within_one_ulp_of_pallas(shape):
    x = _rows(len(shape), shape)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = pwl_softmax_plain(xt)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    want = jops.pwl_softmax(jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    # bfloat16 values carried across exactly, through float32
    err, share, ok = agreement(got, torch.from_numpy(_np(want.astype(jnp.float32)))
                               .to(torch.bfloat16))
    assert ok, (err, share)


def test_softmax_agreement_catches_truncation_and_two_step_errors():
    f = pwl_softmax_plain(torch.from_numpy(_rows(9, (64, 1000), scale=4.0)))
    want = f.to(torch.bfloat16)                            # nearest even
    truncated = (f.view(torch.int32) & ~0xFFFF).view(torch.float32).to(torch.bfloat16)
    assert agreement(want, want) == (0.0, 0.0, True)
    assert not agreement(truncated, want)[2]               # one step, in ~half
    one, two = want.clone(), want.clone()
    i = int(torch.argmax(want.float()))
    one.view(-1).view(torch.int16)[i] += 1
    two.view(-1).view(torch.int16)[i] += 2
    assert agreement(one, want)[2] and not agreement(two, want)[2]
    assert agreement(f + 0.5 * F32_ATOL, f)[2] and not agreement(f + 2 * F32_ATOL, f)[2]
    assert not agreement(torch.full_like(f, float("nan")), f)[2]


def test_pwl_softmax_plain_3d_and_causal_mask_match_jax():
    x = _rows(5, (2, 3, 64, 64))
    q = np.arange(64)
    x = np.where(q[None, :] > q[:, None], np.float32(-1e30), x).astype(np.float32)
    got = pwl_softmax_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jops.pwl_softmax(jnp.asarray(x))),
                               atol=F32_ATOL, rtol=0)
    assert not got[..., 0, 1:].any()              # masked keys get exactly 0
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


# rows on which the reference gives NaN (x - max is NaN somewhere: a NaN,
# a +inf, or only -inf), a masked causal row and a plain one
_NONFINITE = [[np.nan, 0, 1, 2], [-np.inf] * 4, [np.inf, 0, 1, 2],
              [0.7, -1e30, -1e30, -1e30], [-1.5, 0.25, 3, -9]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pwl_softmax_plain_nonfinite_rows_match_pallas_and_ref(dtype):
    x = np.array(_NONFINITE, np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = pwl_softmax_plain(xt)
    assert torch.isnan(got[:3]).all() and not torch.isnan(got[3:]).any()
    for want in (jops.pwl_softmax(xj), ref.ref_pwl_softmax(xj)):
        want = torch.from_numpy(_np(want.astype(jnp.float32))).to(got.dtype)
        if dtype == "float32":
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            keep = ~torch.isnan(want)
            np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(),
                                       atol=F32_ATOL, rtol=0)
        else:
            err, share, ok = agreement_nan(got, want)
            assert ok, (err, share)
    assert abs(float(got[3, 0]) - 1) <= 2 ** -8 and not got[3, 1:].float().any()


def test_pwl_softmax_plain_edge_rows_match_pallas():
    """The rows the card holds bit-equal ([0, t] for t at the segment
    edges, -inf, NaN, 0): the plain version against the Pallas kernel."""
    x = edge_rows(2)
    got = pwl_softmax_plain(x)
    want = torch.from_numpy(_np(jops.pwl_softmax(jnp.asarray(x.numpy()))))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).any(-1).sum()) == 1
    keep = ~torch.isnan(want)
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), atol=F32_ATOL, rtol=0)


def test_softmax_agreement_nan_needs_the_same_nan_places():
    f = pwl_softmax_plain(torch.from_numpy(_rows(3, (8, 64))))
    g = f.clone()
    g[2] = float("nan")
    assert agreement_nan(g, g)[2] and not agreement_nan(g, f)[2]
    assert not agreement_nan(f, g)[2]
    h = g.clone()
    h[0, 0] += 2 * F32_ATOL
    assert not agreement_nan(h, g)[2]


def _indexed_pwl_exp(x):
    """csrc/pwl_softmax.cu's pwl_exp_indexed transcribed in numpy float32:
    a 16-entry table (segments 0-7, then copies of 7), xc = x clipped above
    at 0 keeping NaN, index floor(xc) + 8 (what the rounding-down add onto
    the 1.5 * 2^23 grid gives on [-8, 0]) masked to 4 bits, one multiply
    and one add rounded separately, 0 below -8."""
    f = np.float32
    slope = np.array([SEG_SLOPE[min(i, 7)] for i in range(16)], f)
    icept = np.array([SEG_INTERCEPT[min(i, 7)] for i in range(16)], f)
    xc = np.where(x > 0, f(0), x).astype(f)
    with np.errstate(invalid="ignore", over="ignore"):
        fl = np.floor(xc)
        idx = np.where(np.isfinite(fl) & (fl >= -8), fl + 8, 15).astype(np.int64) & 15
        y = (slope[idx] * xc).astype(f) + icept[idx]
    return np.where(x < f(-8), f(0), y).astype(f)


def test_indexed_pwl_exp_transcription_bit_equal_to_the_select_chain():
    """Every float32 within 64 ulps of a segment edge, the special values,
    10^6 random bit patterns and 10^6 values in [-10, 1]: the indexed exp
    gives the port's select chain's bits (NaN where it is NaN), and the
    Pallas select chain's values."""
    f = np.float32
    rng = np.random.default_rng(19)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3.4e38, -3.4e38, -1e30]
    x = np.concatenate([edge_rows(2)[:, 1].numpy(), np.array(special, f),
                        rng.integers(0, 2 ** 32, 10 ** 6, dtype=np.uint64)
                        .astype(np.uint32).view(f),
                        rng.uniform(-10, 1, 10 ** 6).astype(f)])
    got = _indexed_pwl_exp(x)
    want = pwl_exp(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    pallas = _np(_pwl_exp_vec(jnp.asarray(x)))
    assert np.array_equal(np.isnan(pallas), nan)
    np.testing.assert_allclose(got[~nan], pallas[~nan], atol=1e-6, rtol=0)


# every shape of chip_smoke.py's phase_kernels_softmax, and the route and
# cluster size that csrc/pwl_softmax.cu's header names for it
@pytest.mark.parametrize("rows,n,dtype,want", [
    (65536, 512, torch.bfloat16, ("warp", 1)),       # llama3-8b prefill scores
    (65536, 512, torch.float32, ("warp", 1)),
    (128, 513, torch.bfloat16, ("warp", 1)),         # decode scores: one element a lane
    (4, 128256, torch.float32, ("cluster", 16)),     # vocab: 16 slices of 32 KB
    (128, 513, torch.float32, ("warp", 1)),
    (256, 512, torch.float32, ("warp", 1)),
    (300, 1000, torch.float32, ("warp", 1)),
    (4096, 128, torch.float32, ("warp", 1)),
    (37, 5000, torch.float32, ("cluster", 2)),       # slices of 8 KB at least
    (16, 32768, torch.bfloat16, ("cluster", 8)),
    (5, 1025, torch.float32, ("row", 1)),            # too short to split
    (7, 1, torch.float32, ("warp", 1)),
    (1, 128256, torch.float32, ("cluster", 16)),
    (4, 128256, torch.bfloat16, ("cluster", 16)),
    (512, 4096, torch.bfloat16, ("row", 1)),         # rows enough for the SMs
    (300, 5000, torch.float32, ("row", 1)),
    (1000, 16, torch.bfloat16, ("warp", 1)),
    (4096, 64, torch.float32, ("warp", 1)),
    (1, 917000, torch.float32, ("cluster", 16)),     # the largest slices of 16
    (1, 918000, torch.float32, ("three_pass", 1)),   # past 16 slices
    (2, 1 << 20, torch.float32, ("three_pass", 1)),
    (1000, 50000, torch.float32, ("row", 1)),        # 195 KB rows, rows enough
    (1000, 60000, torch.float32, ("cluster", 2)),    # 234 KB rows: two slices
])
def test_softmax_route_takes_the_documented_route(rows, n, dtype, want):
    assert psm.route(rows, n, dtype) == want
    assert psm.takes(*want, rows, n, dtype)
    if want[0] != "warp":
        assert not psm.takes("warp", 1, rows, n, dtype)
    if want[0] == "three_pass":
        assert not any(psm.takes("cluster", cs, rows, n, dtype)
                       for cs in range(2, MAX_CLUSTER + 1))
    if want[0] == "cluster":
        assert slice_bytes(n, dtype, want[1]) <= SLICE_MAX_BYTES
        assert slice_bytes(n, dtype, want[1]) >= MIN_SLICE_BYTES or want[1] == 2


def test_softmax_route_refuses_what_no_route_takes():
    with pytest.raises(TypeError):
        psm.route(4, 8, torch.float16)
    for rows, n in ((0, 8), (4, 0), (4, 2 ** 31), (2 ** 31, 4)):
        with pytest.raises(ValueError):
            psm.route(rows, n, torch.float32)
    with pytest.raises(ValueError, match="no route"):
        psm.takes("one_pass", 1, 4, 8, torch.float32)
    assert not psm.takes("cluster", 1, 4, 4096, torch.float32)       # a cluster of one
    assert not psm.takes("cluster", 32, 4, 4096, torch.float32)      # past 16
    assert not psm.takes("row", 2, 4, 4096, torch.float32)
    assert not psm.takes("warp", 1, 4, 1025, torch.float32)
    assert vector_rows(512, torch.bfloat16) and not vector_rows(513, torch.bfloat16)
    assert vector_rows(4, torch.float32) and not vector_rows(2, torch.float32)


# ---------------------------------------------------------------------------
# CIM matmul
# ---------------------------------------------------------------------------

def _cim_inputs(seed, M, K, N, w_scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (w_scale * rng.standard_normal((K, N))).astype(np.float32)
    return x, w


def _assert_cim_close(got, want):
    want = _np(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= CIM_REL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_bit_equal_to_jax(dtype):
    _, w = _cim_inputs(1, 1, 768, 96, w_scale=0.2)
    wt = torch.from_numpy(w)
    wj = jnp.asarray(w)
    if dtype == "bfloat16":
        wt, wj = wt.to(torch.bfloat16), wj.astype(jnp.bfloat16)
    wq, scale = quantize_weights(wt)
    jwq, jscale = jquantize(wj)
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(wq.numpy(), np.asarray(jwq))
    assert scale.numpy().tobytes() == np.asarray(jscale, np.float32).tobytes()


@pytest.mark.parametrize("M,K,N,block_m,block_n", [
    (64, 256, 128, 64, 128),      # one tile per K step
    (128, 512, 256, 128, 256),    # the defaults
    (64, 1024, 128, 32, 64),      # 2 x 2 calibration tiles, 4 K steps
    (128, 512, 256, 64, 128),
    (96, 512, 192, 128, 256),     # blocks clipped to (M, N)
])
def test_cim_plain_matches_pallas_interpret(M, K, N, block_m, block_n):
    x, w = _cim_inputs(M + K + N, M, K, N)
    kw = dict(block_m=block_m, block_n=block_n)
    got = ops.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()
    _assert_cim_close(got, jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), **kw))


@pytest.mark.parametrize("adc_bits", [6, 8, 10, 12, 14, 16])
def test_cim_plain_matches_pallas_across_adc_bits(adc_bits):
    x, w = _cim_inputs(adc_bits, 64, 512, 128)
    kw = dict(block_m=32, block_n=64, adc_bits=adc_bits)
    got = ops.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()
    _assert_cim_close(got, jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), **kw))


def test_cim_plain_unblocked_matches_oracle():
    x, w = _cim_inputs(7, 64, 768, 96)
    wq, ws = jquantize(jnp.asarray(w))
    got = cim_matmul_plain(torch.from_numpy(x), torch.from_numpy(np.array(wq)),
                           torch.from_numpy(_np(ws)), block_m=64, block_n=96).numpy()
    _assert_cim_close(got, ref.ref_cim_matmul(jnp.asarray(x), wq, ws))


@pytest.mark.parametrize("act_bits,adc_bits", [(8, 12), (6, 10), (4, 8)])
def test_cim_quantized_takes_jax_quantized_weights(act_bits, adc_bits):
    x, w = _cim_inputs(act_bits, 64, 512, 128)
    wq, ws = jquantize(jnp.asarray(w))
    kw = dict(block_m=64, block_n=64, adc_bits=adc_bits, act_bits=act_bits)
    got = ops.cim_matmul_quantized(torch.from_numpy(x), torch.from_numpy(np.array(wq)),
                                   torch.from_numpy(_np(ws)), **kw).numpy()
    _assert_cim_close(got, jcim_quantized(jnp.asarray(x), wq, ws, interpret=True, **kw))


def _numpy_cim(x, wq, ws, bm, bn, adc_bits=12, act_bits=8):
    """``_cim_kernel`` transcribed in numpy float32, tile by tile, with
    IEEE division (XLA on the CPU divides by multiplying by a reciprocal,
    ROADMAP hazard 8)."""
    f = np.float32
    M, K = x.shape
    N = wq.shape[1]
    qa, am = f(2.0 ** (act_bits - 1) - 1), f(2.0 ** (adc_bits - 1) - 1)
    out = np.zeros((M, N), f)
    for k in range(0, K, 256):
        xk = x[:, k:k + 256].astype(f)
        xs = (np.abs(xk).max(1, keepdims=True) + f(1e-9)) / qa
        psum = np.clip(np.round(xk / xs), -qa, qa) @ wq[k:k + 256].astype(f)
        for i in range(0, M, bm):
            for j in range(0, N, bn):
                p = psum[i:i + bm, j:j + bn]
                cal = max(np.abs(p).max(), f(1))
                code = np.clip(np.round(p / cal * am), -am, am)
                out[i:i + bm, j:j + bn] += code * (cal / am) * xs[i:i + bm] * ws[k // 256, j:j + bn]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cim_plain_matches_ieee_numpy_transcription(dtype):
    """bfloat16 activations put x / xs on exact rounding ties (x = max / 2
    gives 63.5 - 1e-9 relative), where the last bit of the division decides
    the DAC code; the port divides as IEEE float32, as the transcription."""
    x, w = _cim_inputs(3, 64, 512, 128)
    xt = torch.from_numpy(x).to(dtype)
    wq, ws = quantize_weights(torch.from_numpy(w))
    for adc in (8, 12):
        got = cim_matmul_plain(xt, wq, ws, block_m=32, block_n=64, adc_bits=adc).numpy()
        _assert_cim_close(got, _numpy_cim(xt.float().numpy(), wq.numpy(), ws.numpy(),
                                          32, 64, adc_bits=adc))


@pytest.mark.parametrize("M,K,N,block_m", [(64, 300, 128, 64),    # K % 256
                                           (96, 256, 128, 64)])   # M % bm
def test_cim_asserts_as_jax(M, K, N, block_m):
    x = np.zeros((M, K), np.float32)
    wq = np.zeros((K, N), np.int8)
    ws = np.ones((max(K // 256, 1), N), np.float32)
    with pytest.raises(AssertionError):
        jcim_quantized(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
                       block_m=block_m, interpret=True)
    with pytest.raises(AssertionError):
        cim_matmul_plain(torch.from_numpy(x), torch.from_numpy(wq),
                         torch.from_numpy(ws), block_m=block_m)


def test_weight_layout_is_the_transpose_of_jax_quantized_weights():
    _, w = _cim_inputs(11, 1, 768, 130, w_scale=0.2)
    jwq, _ = jquantize(jnp.asarray(w))
    wq = torch.from_numpy(np.array(jwq))
    wqt = weight_layout(wq)
    assert wqt.dtype == torch.int8 and tuple(wqt.shape) == (130, 768)
    assert wqt.is_contiguous()
    assert wqt.numpy().tobytes() == np.ascontiguousarray(np.array(jwq).T).tobytes()
    with pytest.raises(TypeError):
        weight_layout(wq.float())


def test_quantized_cpu_path_takes_the_laid_out_weight_and_checks_its_shape():
    x, w = (torch.from_numpy(a) for a in _cim_inputs(12, 64, 512, 130))
    wq, ws = quantize_weights(w)
    kw = dict(block_m=32, block_n=26, adc_bits=10)
    want = ops.cim_matmul_quantized(x, wq, ws, **kw)
    got = ops.cim_matmul_quantized(x, wq, ws, wqt=weight_layout(wq), **kw)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    for bad in (wq, weight_layout(wq)[:, :256], weight_layout(wq).to(torch.int16)):
        with pytest.raises(ValueError, match="wqt"):
            ops.cim_matmul_quantized(x, wq, ws, wqt=bad, **kw)


# every shape of chip_smoke.py's phase_kernels_cim, and the route that
# csrc/cim_matmul.cu's header names for it
@pytest.mark.parametrize("M,K,N,blocks,want", [
    (2048, 4096, 14336, (128, 256), "cluster"),   # llama3-8b up proj
    (4, 4096, 14336, (128, 256), "decode"),       # decode up proj, bm 4
    (2048, 14336, 4096, (128, 256), "cluster"),   # down proj
    (2048, 4096, 1024, (128, 256), "cluster"),    # k proj
    (64, 512, 128, (64, 128), "cluster"),         # bench: the second CTA past N
    (128, 1024, 512, (128, 512), "two_pass"),     # unblocked: bn > 256
    (128, 512, 256, (32, 64), "two_pass"),        # 16 tiles a block
    (96, 256, 192, (128, 256), "cluster"),        # clipped to (96, 192)
    (64, 768, 130, (16, 26), "two_pass"),         # 20 tiles a block
    (100, 512, 200, (128, 256), "cluster"),       # one tile over both CTAs
    (320, 768, 200, (64, 200), "two_pass"),       # 2 tiles a block, ragged M
    (256, 512, 384, (256, 384), "two_pass"),      # bm > 128
    (2048, 4096, 14336, (64, 128), "two_pass"),   # 4 tiles a block
    (16, 512, 4096, (16, 256), "decode"),         # M 16, the decode limit
    (32, 512, 4096, (32, 256), "cluster"),        # M 32: past decode
    (32, 512, 4096, (16, 256), "two_pass"),       # 2 tiles a block along M
    (4, 512, 4096, (1, 4), "two_pass"),           # 256 tiles a decode CTA
    (128, 512, 1024, (4, 8), "two_pass"),         # 1024 tiles a block
])
def test_route_chooser_takes_the_documented_route(M, K, N, blocks, want):
    tile = calibration_tile(M, N, K, *blocks)
    assert route(M, N, K, *tile) == want
    assert takes(want, M, N, K, *tile)
    if want == "two_pass":
        assert not takes("decode", M, N, K, *tile) and not takes("cluster", M, N, K, *tile)
    if want == "cluster":
        assert not takes("decode", M, N, K, *tile)


def test_forced_route_must_take_the_shape():
    x = torch.zeros((2048, 256))
    wq, ws = torch.zeros((256, 512), dtype=torch.int8), torch.ones((1, 512))
    assert ROUTES == ("cluster", "decode", "two_pass")
    with pytest.raises(ValueError, match="does not take"):
        cim_matmul_cuda(x, wq, ws, block_m=64, way="cluster")
    with pytest.raises(ValueError, match="does not take"):
        cim_matmul_cuda(x, wq, ws, way="decode")
    with pytest.raises(ValueError, match="no route"):
        cim_matmul_cuda(x, wq, ws, way="one_pass")


_FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done
: > "$out"
echo "ptxas info    : Used 168 registers"
"""


@pytest.mark.parametrize("serialized", [False, True])
def test_build_refuses_a_library_whose_wgmma_ptxas_serialized(tmp_path, monkeypatch,
                                                              serialized):
    """ptxas's C7514 warning (wgmma.mma_async serialized) fails the build
    like a compiler error: no library is kept."""
    fake = tmp_path / "nvcc"
    warn = 'echo "ptxas warning : (C7514) wgmma.mma_async instructions are serialized"\n'
    fake.write_text(_FAKE_NVCC + (warn if serialized else ""))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    if serialized:
        with pytest.raises(RuntimeError, match="C7514"):
            _build.build_all(["cim_matmul"])
        assert not list((tmp_path / "build").glob("*.so"))
    else:
        so = _build.build_all(["cim_matmul"])["cim_matmul"]
        assert so.exists() and "C7514" not in _build.BUILD_LOGS["cim_matmul"]


def test_route_chooser_raises_where_no_route_holds_the_tiles():
    with pytest.raises(ValueError, match="too small"):
        route(64, 128, 256, 1, 1)
    with pytest.raises(ValueError, match="too small"):
        cim_matmul_cuda(torch.zeros((64, 256)), torch.zeros((256, 128), dtype=torch.int8),
                        torch.ones((1, 128)), block_m=1, block_n=1)


# ---------------------------------------------------------------------------
# the slice: what benchmarks/run.py's ablations compute, through both
# packages' kernel surfaces
# ---------------------------------------------------------------------------

def test_adc_sweep_and_pwl_agreement_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 1024)).astype(np.float32)
    w = (0.03 * rng.standard_normal((1024, 256))).astype(np.float32)
    exact = x @ w
    rels = []
    for adc in (6, 8, 10, 12, 14):
        kw = dict(adc_bits=adc, block_m=64, block_n=256)
        got = ops.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()
        want = _np(jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), **kw))
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel == pytest.approx(np.linalg.norm(want - exact) / np.linalg.norm(exact),
                                    rel=1e-5)
        rels.append(rel)
    assert all(np.isfinite(rels)) and rels == sorted(rels, reverse=True)
    s = (4 * rng.standard_normal((1024, 128))).astype(np.float32)
    got = pwl_softmax_plain(torch.from_numpy(s)).numpy()
    want = _np(jops.pwl_softmax(jnp.asarray(s)))
    exact_sm = torch.softmax(torch.from_numpy(s), -1).numpy()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    agree = (got.argmax(-1) == exact_sm.argmax(-1)).mean()
    assert agree == (want.argmax(-1) == exact_sm.argmax(-1)).mean() and agree > 0.9
    assert np.abs(got - exact_sm).max() == pytest.approx(np.abs(want - exact_sm).max(),
                                                          abs=1e-6)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    s = torch.from_numpy(_rows(1, (9, 70)))
    assert torch.equal(ops.pwl_softmax(s), pwl_softmax_plain(s))
    x, w = (torch.from_numpy(a) for a in _cim_inputs(2, 32, 256, 64))
    wq, ws = quantize_weights(w)
    assert torch.equal(ops.cim_matmul(x, w), cim_matmul_plain(x, wq, ws))
    assert torch.equal(ops.cim_matmul_quantized(x, wq, ws, adc_bits=8),
                       cim_matmul_plain(x, wq, ws, adc_bits=8))
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
                            "pwl_softmax": 0, "cim_matmul": 0}


def test_other_devices_and_unsupported_kernel_args_raise():
    meta = torch.zeros((4, 256), device="meta")
    with pytest.raises(ValueError):
        ops.pwl_softmax(meta)
    with pytest.raises(ValueError):
        ops.cim_matmul_quantized(meta, torch.zeros((256, 8), dtype=torch.int8, device="meta"),
                                 torch.ones((1, 8), device="meta"))
    with pytest.raises(ValueError):
        pwl_softmax_cuda(torch.zeros((4, 8)))
    x = torch.zeros((4, 256))
    wq, ws = quantize_weights(torch.ones((256, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        cim_matmul_cuda(x, wq, ws)
    with pytest.raises(ValueError, match="act_bits"):
        cim_matmul_cuda(x, wq, ws, act_bits=9)
    with pytest.raises(TypeError):
        cim_matmul_cuda(x.double(), wq, ws)
    # the plain version follows JAX for act_bits > 8
    assert torch.isfinite(ops.cim_matmul_quantized(x + 1, wq, ws, act_bits=12)).all()
