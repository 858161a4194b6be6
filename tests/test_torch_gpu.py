"""The port's CUDA kernels and model on the card (marker ``gpu``).

Each CUDA kernel is held to its plain PyTorch version on the same card
tensors, and the smoke model on the card to the same model on the CPU.
Without a CUDA device every test here skips.  The file imports no JAX, so
it runs where JAX is not installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import agreement as flash_agreement
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.cim_matmul import (ROUTES, adc_div_mismatches, calibration_tile,
                                           cim_matmul_cuda, cim_matmul_plain,
                                           quantize_weights, route, takes, weight_layout)
from repro_torch.kernels.paged_attention import (contiguous_block_tokens, identity_block_table,
                                                 paged_attention_cuda, paged_attention_plain,
                                                 split_plan)
from repro_torch.kernels import pwl_softmax as psm
from repro_torch.kernels.pwl import PWL_COEFFS
from repro_torch.kernels.pwl_softmax import (agreement, agreement_nan, edge_rows,
                                             exp_mismatches, pwl_softmax_cuda, pwl_softmax_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch.serve import Server
from repro_torch.launch.steps import CompiledServeStep, make_prefill_step, make_serve_step

pytestmark = pytest.mark.gpu

# kernel vs plain version on unit-normal inputs: float32 sums in another
# order; bfloat16 outputs may differ by one bfloat16 ulp (2**-6 below 4).
# bf16 flash is held besides to repro_torch.kernels.flash_attention.agreement
# (each element within 2**-7 of its value + 2**-12; with PWL exp, a few rows
# may take another segment at an edge): the tensor-core kernel multiplies P
# as two bf16 terms, the plain version keeps P in float32
TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -6}
# SSD scan: y and state are float32 in both versions from the same inputs;
# the plain version steps over 256-row chunks, the kernel over sub-chunks
# of 64 (float32) or 32 rows (bf16), so the decay exponents are rounded
# differently, and bf16 multiplies float32 operands as hi + lo terms (see
# chip_smoke.py TOL_SSD)
TOL_SSD = 1e-3
# long-memory SSD (dt ~ 0.01): y and state each to 1e-4 of their own max
# |value|, which a dropped or mis-scaled carry between sub-chunks exceeds
# (see chip_smoke.py TOL_SSD_REL)
TOL_SSD_REL = 1e-4
# SCU softmax: the same float32 steps in both versions, sums in another
# order; held by repro_torch.kernels.pwl_softmax.agreement (float32 within
# 1e-6; bfloat16 within one step of each value, < 1% of nonzero ones differ)
# CIM matmul: integer dots (exact) and the same float32 steps in the same
# order; one flipped ADC code would move an output by ~1/2047 of its tile's
# swing, far above this bar
TOL_CIM_REL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, seed, device):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("D", [32, 64, 80, 128, 256])
def test_flash_kernel_matches_plain(cuda, D, use_pwl, dtype):
    q, k, v = (_randn((2, 200, h, D), dtype, D + h, cuda) for h in (8, 2, 2))
    for causal in (True, False):
        before = ops.LAUNCHES["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=causal, use_pwl=use_pwl)
        assert ops.LAUNCHES["flash_attention"] == before + 1
        want = flash_attention_plain(q, k, v, causal=causal, use_pwl=use_pwl)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        err, ratio, rows_off, ok = flash_agreement(got, want, pwl=use_pwl)
        assert ok, (causal, err, ratio, rows_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("S,window", [(300, 1), (300, 64), (300, 100), (300, 130), (300, 4096),
                                      (600, 130), (1100, 256)])
def test_flash_kernel_window_matches_plain(cuda, S, window, D, use_pwl, dtype):
    """A sliding window, causal and not: rows whose window starts inside a
    128-key step, tiles that start past step 0, a window of 1 (each row
    sees itself) and one wider than the sequence."""
    q, k, v = (_randn((2, S, h, D), dtype, S + window + h, cuda) for h in (8, 2, 2))
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal, use_pwl=use_pwl, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, use_pwl=use_pwl, window=window)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        err, ratio, rows_off, ok = flash_agreement(got, want, pwl=use_pwl)
        assert ok, (causal, err, ratio, rows_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window_rows_that_see_no_key_give_zeros(cuda, dtype):
    """Non-causal, 400 queries against 100 keys under a window of 64: the
    queries from 164 on see no key; both versions give them zeros (each
    tile still runs one fully masked step)."""
    q = _randn((1, 400, 4, 64), dtype, 31, cuda)
    k, v = (_randn((1, 100, 2, 64), dtype, s, cuda) for s in (32, 33))
    got = ops.flash_attention(q, k, v, causal=False, window=64)
    want = flash_attention_plain(q, k, v, causal=False, window=64)
    torch.cuda.synchronize()
    assert not got[:, 164:].any() and not want[:, 164:].any()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pwl,repeat", [(False, 1), (False, 30), (True, 1)])
def test_paged_kernel_window_matches_plain(cuda, repeat, use_pwl, dtype):
    """A window of 64 over 16-token blocks: contexts of 0, below the window,
    the window, one past it and far past it (its first live block starts
    mid-block), once (split_plan gives 8 splits of 4 blocks; splits wholly
    below the window give l = 0) and 30 times over (B * H_kv 360 >= 2 CTAs
    an SM: one split); PWL takes one split."""
    window, bt, H, Hkv, D, max_len = 64, 16, 8, 2, 64, 512
    ctx = [0, 40, window, window + 1, 3 * window + 5, max_len] * repeat
    B = len(ctx)
    cache_k, cache_v = (_randn((B, max_len, Hkv, D), dtype, s, cuda) for s in (41, 42))
    args = (_randn((B, H, D), dtype, 43, cuda), cache_k.view(-1, bt, Hkv, D),
            cache_v.view(-1, bt, Hkv, D), identity_block_table(B, max_len, bt, device=cuda),
            torch.tensor(ctx, dtype=torch.int32, device=cuda))
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_splits, _ = split_plan(B * Hkv, max_len // bt, bt, n_sms, use_pwl=use_pwl)
    assert (n_splits > 1) == (repeat == 1 and not use_pwl)
    before = ops.LAUNCHES["paged_attention"]
    got = paged_attention_cuda(*args, use_pwl=use_pwl, window=window)
    assert ops.LAUNCHES["paged_attention"] == before + 1
    want = paged_attention_plain(*args, use_pwl=use_pwl, window=window)
    torch.cuda.synchronize()
    assert not got[0].any()                                  # context 0 -> 0
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    # bf16 outputs here are of order 0.1: each element also within
    # 2**-7 |want| + 2**-12, which a window shifted by one block breaks
    err, ratio, rows_off, ok = flash_agreement(got, want, pwl=use_pwl)
    assert ok, (err, ratio, rows_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("bt,H,Hkv,D", [(8, 4, 2, 32), (16, 32, 8, 128),
                                        (64, 8, 8, 64), (32, 32, 32, 80),
                                        (64, 8, 1, 256)])
def test_paged_kernel_matches_plain_on_scattered_tables(cuda, bt, H, Hkv, D,
                                                       use_pwl, dtype):
    ctx = [0, 1, bt - 1, 3 * bt + 5, 200]
    nb = [-(-c // bt) for c in ctx]
    n_pool = sum(nb) + 2
    perm = np.random.default_rng(bt).permutation(n_pool).astype(np.int32)
    table = np.full((len(ctx), max(nb)), n_pool - 1, np.int32)
    off = 0
    for r, n in enumerate(nb):
        table[r, :n] = perm[off:off + n]
        off += n
    q = _randn((len(ctx), H, D), dtype, 1, cuda)
    pool_k = _randn((n_pool, bt, Hkv, D), dtype, 2, cuda)
    pool_v = _randn((n_pool, bt, Hkv, D), dtype, 3, cuda)
    args = (q, pool_k, pool_v, torch.from_numpy(table).to(cuda),
            torch.tensor(ctx, dtype=torch.int32, device=cuda))
    got = ops.paged_attention(*args, use_pwl=use_pwl)
    want = paged_attention_plain(*args, use_pwl=use_pwl)
    torch.cuda.synchronize()
    assert not got[0].any()                                  # context 0 -> 0
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype,use_pwl", [(torch.bfloat16, False),
                                           (torch.float32, False),
                                           (torch.bfloat16, True)])
def test_paged_kernel_long_context_splits(cuda, dtype, use_pwl):
    """One sequence of 4000 tokens in 16-token blocks: the exact path runs
    several pool blocks in each of n_splits > 1 CTAs and combines them; PWL
    runs one split over all 250 blocks in order."""
    ctx, bt, H, Hkv, D = 4000, 16, 32, 8, 128
    n_blocks = ctx // bt
    n_splits, bps = split_plan(Hkv, n_blocks, bt,
                               torch.cuda.get_device_properties(cuda).multi_processor_count,
                               use_pwl=use_pwl)
    assert (n_splits == 1) if use_pwl else (n_splits > 1 and bps > 1)
    perm = np.random.default_rng(4).permutation(n_blocks + 1).astype(np.int32)
    table = torch.from_numpy(perm[None, :n_blocks]).to(cuda)
    q = _randn((1, H, D), dtype, 5, cuda)
    pool_k = _randn((n_blocks + 1, bt, Hkv, D), dtype, 6, cuda)
    pool_v = _randn((n_blocks + 1, bt, Hkv, D), dtype, 7, cuda)
    lens = torch.tensor([ctx], dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, pool_k, pool_v, table, lens, use_pwl=use_pwl)
    assert ops.LAUNCHES["paged_attention"] == before + 1      # split + combine count once
    want = paged_attention_plain(q, pool_k, pool_v, table, lens, use_pwl=use_pwl)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,H,P,N", [(4, 512, 80, 64, 128),   # mamba2 prefill
                                       (4, 512, 80, 64, 64),    # zamba2 prefill
                                       (2, 300, 16, 64, 128),   # ragged S
                                       (1, 100, 8, 32, 16),     # S < chunk, b 1
                                       (2, 77, 8, 32, 32),
                                       (1, 2048, 8, 64, 128)])  # a long carry chain
def test_ssd_kernel_matches_plain(cuda, b, S, H, P, N, dtype):
    x = _randn((b, S, H, P), dtype, 1, cuda)
    dt = torch.nn.functional.softplus(_randn((b, S, H), torch.float32, 2, cuda))
    a_neg = -torch.exp(0.2 * _randn((H,), torch.float32, 3, cuda))
    B = (0.3 * _randn((b, S, N), torch.float32, 4, cuda)).to(dtype)
    C = (0.3 * _randn((b, S, N), torch.float32, 5, cuda)).to(dtype)
    before = ops.LAUNCHES["ssd_scan"]
    y, state = ops.ssd_scan(x, dt, a_neg, B, C, chunk=256)
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    want_y, want_state = ssd_scan_plain(x, dt, a_neg, B, C, 256)
    torch.cuda.synchronize()
    assert y.dtype == state.dtype == torch.float32
    assert (y - want_y).abs().max().item() <= TOL_SSD
    assert (state - want_state).abs().max().item() <= TOL_SSD


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,H,P,N", [(4, 512, 80, 64, 128),   # mamba2 prefill
                                       (4, 512, 80, 64, 64),    # zamba2 prefill
                                       (2, 300, 16, 64, 128),   # ragged S
                                       (1, 100, 8, 32, 16),     # S < chunk, b 1
                                       (1, 2048, 8, 64, 128)])  # a long carry chain
def test_ssd_kernel_carries_long_memory(cuda, b, S, H, P, N, dtype):
    """dt ~ softplus(N(0,1) - 5) ~ 0.01, the regime of trained weights:
    the state carries across every sub-chunk of the kernel (64 rows in
    float32, 32 in bf16)."""
    x = _randn((b, S, H, P), dtype, 6, cuda)
    dt = torch.nn.functional.softplus(_randn((b, S, H), torch.float32, 7, cuda) - 5)
    a_neg = -torch.exp(0.2 * _randn((H,), torch.float32, 8, cuda))
    B = (0.3 * _randn((b, S, N), torch.float32, 9, cuda)).to(dtype)
    C = (0.3 * _randn((b, S, N), torch.float32, 10, cuda)).to(dtype)
    y, state = ops.ssd_scan(x, dt, a_neg, B, C, chunk=256)
    want_y, want_state = ssd_scan_plain(x, dt, a_neg, B, C, 256)
    torch.cuda.synchronize()
    for got, want in ((y, want_y), (state, want_state)):
        assert (got - want).abs().max().item() <= TOL_SSD_REL * want.abs().max().item()


@pytest.mark.parametrize("b,S,H,P,N", [(4, 512, 80, 64, 128), (2, 300, 16, 64, 64)])
def test_ssd_kernel_reads_strided_views_in_place(cuda, b, S, H, P, N):
    """x, B and C as the mamba layer passes them: bf16 views of its conv
    output, rows H*P + 2N apart.  The kernel reads them where they lie and
    gives what it gives on contiguous copies, bit for bit."""
    conv = _randn((b, S, H * P + 2 * N), torch.float32, 11, cuda)
    conv[..., H * P:] *= 0.3
    conv = conv.to(torch.bfloat16)
    x = conv[..., :H * P].reshape(b, S, H, P)
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt = torch.nn.functional.softplus(_randn((b, S, H), torch.float32, 12, cuda) - 5)
    a_neg = -torch.exp(0.2 * _randn((H,), torch.float32, 13, cuda))
    y, state = ops.ssd_scan(x, dt, a_neg, B, C, chunk=256)
    yc, statec = ops.ssd_scan(x.contiguous(), dt, a_neg, B.contiguous(), C.contiguous(),
                              chunk=256)
    want_y, want_state = ssd_scan_plain(x, dt, a_neg, B, C, 256)
    torch.cuda.synchronize()
    assert torch.equal(y, yc) and torch.equal(state, statec)
    for got, want in ((y, want_y), (state, want_state)):
        assert (got - want).abs().max().item() <= TOL_SSD_REL * want.abs().max().item()


@pytest.mark.parametrize("shape,dtype,causal", [
    ((4, 32, 512, 512), torch.bfloat16, True),    # llama3-8b prefill scores: warp
    ((256, 512), torch.float32, False),
    ((300, 1000), torch.float32, False),          # ragged
    ((4, 128256), torch.float32, False),          # vocab rows: a cluster of 16
    ((4096, 128), torch.float32, False),
    ((128, 513), torch.bfloat16, False),          # decode scores: one element a lane
    ((128, 513), torch.float32, False),
    ((37, 5000), torch.float32, False),           # a cluster of 2
    ((5, 1025), torch.bfloat16, False),           # row, rows not on 16 bytes
    ((7, 1), torch.float32, False),
    ((3, 7, 8), torch.float32, False),            # two lanes a row
    ((1, 128256), torch.float32, False),          # one vocab row
    ((4, 128256), torch.bfloat16, False),
    ((512, 4096), torch.bfloat16, False),         # row
    ((16, 32768), torch.bfloat16, False),         # a cluster of 8
    ((1, 917000), torch.float32, False),          # the largest slices of 16
    ((2, 1 << 20), torch.float32, False)])        # three passes
def test_pwl_softmax_kernel_matches_plain(cuda, shape, dtype, causal):
    x = 4 * _randn(shape, torch.float32, shape[-1], cuda)
    if causal:
        q = torch.arange(shape[-2], device=cuda)
        x = x.masked_fill(q[None, :] > q[:, None], -1e30)
    x = x.to(dtype)
    before = ops.LAUNCHES["pwl_softmax"]
    got = ops.pwl_softmax(x)
    assert ops.LAUNCHES["pwl_softmax"] == before + 1
    want = pwl_softmax_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    err, share, ok = agreement(got, want)
    assert ok, (err, share)


# one plan of each route, at a row length it takes
_SOFTMAX_PLANS = [("warp", 1, 2), ("warp", 1, 4), ("warp", 1, 512), ("row", 1, 2048),
                  ("cluster", 4, 8192), ("cluster", 16, 8192), ("three_pass", 1, 2048)]


def _bit_equal(got, want):
    """NaN in the same places, and the same bits elsewhere."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    return torch.equal(nan_g, nan_w) and torch.equal(
        got[~nan_w].view(torch.int32), want[~nan_w].view(torch.int32))


def test_pwl_exp_by_index_equals_the_select_chain_on_every_float(cuda):
    """The softmax's indexed PWL exp against the attention kernels' select
    chain pwl_exp (a clip that keeps NaN) on all 2**32 float32 inputs: no
    bit differs, and a NaN gives NaN in both."""
    assert exp_mismatches() == 0


@pytest.mark.parametrize("way,cs,n", _SOFTMAX_PLANS)
def test_pwl_softmax_edge_rows_bit_equal_to_plain(cuda, way, cs, n):
    """Rows [0, -inf, ..., t] for every t within 64 ulps of a segment edge,
    and -inf, NaN, 0: a sum of two terms and zeros has one result, so the
    kernel gives the plain version's bits, on every route."""
    x = edge_rows(n).to(cuda)
    got = pwl_softmax_cuda(x, (way, cs))
    assert _bit_equal(got, pwl_softmax_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("way,cs,n", _SOFTMAX_PLANS)
def test_pwl_softmax_nonfinite_rows_nan_where_plain(cuda, way, cs, n, dtype):
    """Rows with a NaN, a +inf or only -inf come out all NaN, as in the
    plain version (and the JAX package); the other rows agree."""
    x = 4 * _randn((64, n), torch.float32, n, cuda)
    x[0, n // 3] = float("nan")
    x[1, n - 1] = float("inf")
    x[2] = float("-inf")
    x[3, 1:] = -1e30
    x[4, 1:] = float("-inf")
    x = x.to(dtype)
    got = pwl_softmax_cuda(x, (way, cs))
    want = pwl_softmax_plain(x)
    err, share, ok = agreement_nan(got, want)
    assert ok, (err, share)
    assert torch.isnan(got[:3]).all() and not torch.isnan(got[3:]).any()


@pytest.mark.parametrize("rows,n,dtype", [(65536, 512, torch.bfloat16), (128, 513, torch.bfloat16),
                                          (4, 128256, torch.float32)])
def test_pwl_softmax_every_route_that_takes_a_shape_agrees(cuda, rows, n, dtype):
    x = (4 * _randn((rows, n), torch.float32, rows + n, cuda)).to(dtype)
    want = pwl_softmax_plain(x)
    plans = {psm.route(rows, n, dtype)} | {(w, c) for w, c in (
        ("warp", 1), ("row", 1), ("cluster", 2), ("cluster", 16), ("three_pass", 1))
        if psm.takes(w, c, rows, n, dtype)}
    for plan in sorted(plans):
        err, share, ok = agreement(pwl_softmax_cuda(x, plan), want)
        assert ok, (plan, err, share)


def test_pwl_softmax_largest_cluster_fits_the_card(cuda):
    """A cluster of 16 CTAs with the largest slice that route() gives it
    is resident on the card (the launch refuses one that is not)."""
    n = 917000
    assert psm.route(1, n, torch.float32) == ("cluster", 16)
    ctas, clusters = psm.occupancy("cluster", 16, n, torch.float32)
    assert ctas >= 1 and clusters >= 1


@pytest.mark.parametrize("M,K,N,blocks,adc,dtype", [
    (2048, 4096, 14336, (128, 256), 12, torch.bfloat16),   # llama3-8b up proj
    (4, 4096, 14336, (128, 256), 12, torch.bfloat16),      # decode, bm 4
    (2048, 14336, 4096, (128, 256), 12, torch.bfloat16),   # down proj, 56 tiles
    (64, 512, 128, (64, 128), 12, torch.float32),          # the bench's
    (128, 1024, 512, (128, 512), 12, torch.float32),       # unblocked
    (128, 512, 256, (32, 64), 6, torch.float32),           # small tiles
    (96, 256, 192, (128, 256), 16, torch.bfloat16),        # ragged CTA tiles
    (64, 768, 130, (16, 26), 8, torch.float32)])           # N % 4 != 0
def test_cim_kernel_matches_plain(cuda, M, K, N, blocks, adc, dtype):
    x = _randn((M, K), dtype, M + K, cuda)
    wq, ws = quantize_weights(0.05 * _randn((K, N), torch.float32, N, cuda))
    kw = dict(block_m=blocks[0], block_n=blocks[1], adc_bits=adc)
    before = ops.LAUNCHES["cim_matmul"]
    got = ops.cim_matmul_quantized(x, wq, ws, **kw)
    assert ops.LAUNCHES["cim_matmul"] == before + 1
    want = cim_matmul_plain(x, wq, ws, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL_CIM_REL * want.abs().max().item()


@pytest.mark.parametrize("M,K,N,blocks,adc,dtype,laid,way", [
    (100, 512, 200, (128, 256), 12, torch.float32, True, "cluster"),     # a tile over both CTAs
    (320, 768, 200, (64, 200), 12, torch.bfloat16, False, "two_pass"),   # 2 a block, ragged M
    (256, 512, 384, (256, 384), 12, torch.float32, True, "two_pass"),    # bm > 128
    (4, 4096, 14336, (128, 256), 12, torch.bfloat16, True, "decode"),    # weight pre-laid
    (4, 4096, 14336, (128, 256), 12, torch.bfloat16, False, "decode"),   # transposed per call
    (2048, 4096, 14336, (128, 256), 6, torch.bfloat16, True, "cluster"),
    (2048, 4096, 14336, (128, 256), 16, torch.bfloat16, True, "cluster")])
def test_cim_kernel_routes_are_bit_equal_to_plain(cuda, M, K, N, blocks, adc, dtype, laid,
                                                  way):
    """Every route sums the K tiles in K order with the plain version's
    float32 steps, so the outputs are equal bit for bit."""
    x = _randn((M, K), dtype, M + K + 1, cuda)
    wq, ws = quantize_weights(0.05 * _randn((K, N), torch.float32, N + 1, cuda))
    wqt = weight_layout(wq) if laid else None
    kw = dict(block_m=blocks[0], block_n=blocks[1], adc_bits=adc)
    assert route(M, N, K, *calibration_tile(M, N, K, *blocks)) == way
    before = ops.LAUNCHES["cim_matmul"]
    got = ops.cim_matmul_quantized(x, wq, ws, wqt=wqt, **kw)
    assert ops.LAUNCHES["cim_matmul"] == before + 1
    want = cim_matmul_plain(x, wq, ws, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL_CIM_REL * want.abs().max().item()
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N,blocks,n_routes", [
    (100, 512, 200, (128, 256), 2), (4, 4096, 1024, (128, 256), 3),
    (2048, 1024, 512, (128, 256), 2)])
def test_cim_every_route_that_takes_a_shape_is_bit_equal(cuda, M, K, N, blocks, n_routes):
    """Each route forced onto a shape it takes gives the plain version's
    bits."""
    x = _randn((M, K), torch.bfloat16, M + K + 2, cuda)
    wq, ws = quantize_weights(0.05 * _randn((K, N), torch.float32, N + 2, cuda))
    kw = dict(block_m=blocks[0], block_n=blocks[1])
    want = cim_matmul_plain(x, wq, ws, **kw)
    tile = calibration_tile(M, N, K, *blocks)
    ways = [w for w in ROUTES if takes(w, M, N, K, *tile)]
    assert len(ways) == n_routes
    for way in ways:
        assert torch.equal(cim_matmul_cuda(x, wq, ws, wqt=weight_layout(wq), way=way, **kw),
                           want)


def test_adc_division_equals_fdiv_rn(cuda):
    """The kernels' ADC division (reciprocal, product, one FMA correction)
    gives IEEE division's bits on every (p, cal) with cal <= 2^16 and
    |p| <= cal, and on 10^8 random pairs with cal < 2^24."""
    assert adc_div_mismatches(max_cal=1 << 16) == 0
    assert adc_div_mismatches(n=10 ** 8, seed=7) == 0


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)               # D = 48
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    h = q.half()                                             # float16
    with pytest.raises(TypeError):
        ops.flash_attention(h[..., :32], h[..., :32], h[..., :32])
    x = torch.zeros((1, 8, 2, 48), device=cuda)               # P = 48
    dt, a = torch.ones((1, 8, 2), device=cuda), -torch.ones(2, device=cuda)
    B = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a, B, B, chunk=8)
    with pytest.raises(TypeError):
        ops.ssd_scan(x[..., :32], dt.double(), a, B, B, chunk=8)
    with pytest.raises(TypeError):
        ops.pwl_softmax(torch.zeros((4, 8), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="does not take"):
        pwl_softmax_cuda(torch.zeros((4, 2048), device=cuda), ("warp", 1))
    xm = torch.zeros((4, 256), device=cuda)
    wq, ws = quantize_weights(torch.ones((256, 8), device=cuda))
    with pytest.raises(ValueError):
        cim_matmul_cuda(xm, wq, ws, act_bits=9)
    with pytest.raises(ValueError, match="too small"):
        cim_matmul_cuda(torch.zeros((64, 256), device=cuda),
                        *quantize_weights(torch.ones((256, 128), device=cuda)),
                        block_m=1, block_n=1)
    with pytest.raises(TypeError):
        ops.cim_matmul_quantized(xm.half(), wq, ws)
    with pytest.raises(ValueError, match="wqt"):
        ops.cim_matmul_quantized(xm, wq, ws, wqt=wq)
    qa = torch.zeros((2, 8, 64), device=cuda)
    pool = torch.zeros((8, 16, 2, 64), device=cuda)
    table = identity_block_table(2, 64, 16, device=cuda)
    lens = torch.tensor([3, 64], dtype=torch.int32, device=cuda)
    # the C entry refuses splits that leave a block out, or split a PWL context
    out = torch.empty_like(qa)
    scratch = torch.empty(2 * 8 * 2 * 66, device=cuda)
    lib = _build.library("paged_attention")
    for n_splits, bps, use_pwl in ((1, 3, 0), (2, 2, 1)):
        assert lib.paged_attention_fwd(
            qa.data_ptr(), pool.data_ptr(), pool.data_ptr(), table.data_ptr(), lens.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), 2, 8, 2, 64, 16, 4, n_splits, bps, 0, 0, 0, 0,
            use_pwl, ctypes.addressof(PWL_COEFFS),
            torch.cuda.current_stream(cuda).cuda_stream) != 0
    with pytest.raises(ValueError, match="window"):
        paged_attention_cuda(qa, pool, pool, table, lens, window=0)


def _binding(cfg):
    """A smoke config whose sliding window (mixtral's is 64) binds within
    the tests' 20-40 tokens."""
    return dataclasses.replace(cfg, sliding_window=16) if cfg.sliding_window else cfg


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b",
                                  "llama4-maverick-400b-a17b", "paligemma-3b"])
def test_smoke_model_on_card_matches_cpu(cuda, arch):
    """Prefill and 4 decode steps of a float32 smoke model: the card
    (kernels) against the CPU (plain versions), same weights."""
    cfg = _binding(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 41)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, _, cache = models.forward(cfg, p, toks[:, :37].to(dev),
                                          collect_cache=True, kv_max=48)
        steps = [logits.cpu()]
        for i in range(37, 41):
            lg, cache = models.decode_step(cfg, p, toks[:, i:i + 1].to(dev),
                                           cache, i + 1)
            steps.append(lg.cpu())
        out[dev] = torch.cat(steps, 1)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# A NaN score, kept as the plain versions and the Pallas kernels keep it
# ---------------------------------------------------------------------------

def _nan_rows(t):
    return torch.isnan(t.float()).any(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(1, 128, 4, 2, 64), (2, 300, 8, 2, 128)])
def test_flash_kernel_keeps_a_nan_score_where_plain(cuda, B, S, Hq, Hkv, D, causal, use_pwl,
                                                    dtype):
    """A NaN at key 5 of sequence 0 and at the last key of the last
    sequence (which, causal, only the last query sees), both in KV head 0:
    the (query, head) rows with a NaN are exactly the plain version's, and
    the other rows agree within the usual bar."""
    q, k, v = (_randn((B, S, h, D), dtype, 11 + h, cuda) for h in (Hq, Hkv, Hkv))
    k[0, 5, 0, 0] = float("nan")
    k[B - 1, S - 1, 0, 1] = float("nan")
    got = ops.flash_attention(q, k, v, causal=causal, use_pwl=use_pwl)
    want = flash_attention_plain(q, k, v, causal=causal, use_pwl=use_pwl)
    torch.cuda.synchronize()
    nan = _nan_rows(want)
    assert nan.any() and not nan.all()
    assert torch.equal(_nan_rows(got), nan)
    keep = ~nan[..., None].expand_as(want)
    assert (got.float() - want.float())[keep].abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pwl", [False, True])
@pytest.mark.parametrize("max_len,ctx", [(64, [50, 64, 0]), (128, [128, 100, 7]),
                                         (1024, [1000, 300, 700])])
def test_paged_kernel_keeps_a_nan_score_where_plain(cuda, max_len, ctx, use_pwl, dtype):
    """One NaN in a key inside the context of sequence 0, one past the
    context of sequence 1 (never read): the heads with a NaN are exactly
    the plain version's, with one split (64 rows, or PWL) and with
    several (128 and 1024 rows, exact), split + combine."""
    B, H, Hkv, D = len(ctx), 8, 2, 64
    cache_k, cache_v = (_randn((B, max_len, Hkv, D), dtype, s, cuda) for s in (21, 22))
    cache_k[0, ctx[0] // 2, 0, 3] = float("nan")
    cache_k[1, ctx[1]:, 1, 0] = float("nan")
    bt = contiguous_block_tokens(max_len)
    n_splits, _ = split_plan(B * Hkv, max_len // bt, bt,
                             torch.cuda.get_device_properties(cuda).multi_processor_count,
                             use_pwl=use_pwl)
    assert (n_splits == 1) == (use_pwl or max_len == 64)
    args = (_randn((B, H, D), dtype, 23, cuda), cache_k.view(-1, bt, Hkv, D),
            cache_v.view(-1, bt, Hkv, D), identity_block_table(B, max_len, bt, device=cuda),
            torch.tensor(ctx, dtype=torch.int32, device=cuda))
    got = ops.paged_attention(*args, use_pwl=use_pwl)
    want = paged_attention_plain(*args, use_pwl=use_pwl)
    torch.cuda.synchronize()
    nan = _nan_rows(want)
    assert nan.sum().item() == H // Hkv
    assert torch.equal(_nan_rows(got), nan)
    assert (got.float() - want.float())[~nan].abs().max().item() <= TOL[dtype]


# ---------------------------------------------------------------------------
# The compiled serve step (CUDA graph) against the eager step
# ---------------------------------------------------------------------------

def _copy(cache):
    return {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}


def _n_attn(cfg):
    kinds, n_groups = models.group_layout(cfg)
    return sum(k != "mamba" for k in kinds) * n_groups


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b",
                                  "llama4-maverick-400b-a17b", "paligemma-3b"])
def test_compiled_step_matches_the_eager_step(cuda, arch, dtype):
    """Prefill, then 8 greedy steps eager and 8 through the captured graph
    from copies of the prefill's cache: equal ids at every step and equal
    caches after, bit for bit; the logits' bit-equality is printed.
    Building the step leaves the cache as it was, and the launch counters
    count the graph's kernels once a replay."""
    cfg = _binding(dataclasses.replace(get_smoke_config(arch), dtype=dtype))
    params = models.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 21)))
    tok0, cache0 = make_prefill_step(cfg, kv_max=40)(params, {"tokens": toks.to(cuda)})
    eager_cache, graph_cache = _copy(cache0), _copy(cache0)
    step = CompiledServeStep(cfg, params, graph_cache, 3)
    for key, entry in graph_cache.items():
        for name, t in entry.items():
            assert torch.equal(t, cache0[key][name]), "building the step wrote the cache"
    tok_e, tok_g = tok0, tok0.clone()
    bit_equal = True
    ops.reset_launch_counts()
    for i in range(8):
        n = 21 + i + 1
        logits, _ = models.decode_step(cfg, params, tok_e, eager_cache, n)
        tok_e = torch.argmax(logits[:, -1:], dim=-1)
        nxt, _ = step(params, graph_cache, tok_g, n)
        tok_g = nxt.clone()
        assert torch.equal(tok_g, tok_e), f"step {i}"
        bit_equal &= torch.equal(step.logits, logits)
        assert (step.logits - logits).abs().max().item() <= TOL[logits.dtype]
    for key, entry in graph_cache.items():
        for name, t in entry.items():
            assert torch.equal(t, eager_cache[key][name]), f"{key}/{name}"
    assert ops.LAUNCHES["paged_attention"] == 2 * 8 * _n_attn(cfg)
    print(f"{arch} {dtype}: graph logits bit-equal to eager: {bit_equal}")


def test_compiled_step_refuses_tensors_it_was_not_captured_on(cuda):
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), dtype="float32")
    params = models.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cache = models.init_cache(cfg, 2, 16, device=cuda)
    step = CompiledServeStep(cfg, params, cache, 2)
    tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
    step(params, cache, tok, 1)
    with pytest.raises(ValueError, match="captured"):
        step(params, _copy(cache), tok, 2)
    with pytest.raises(ValueError, match="captured"):
        step(dict(params, embed=params["embed"].clone()), cache, tok, 2)
    with pytest.raises(ValueError, match="outside"):
        step(params, cache, tok, 17)
    step(params, cache, tok, 2)


def _serve(srv, prompts, rounds):
    for rid, p in enumerate(prompts):
        assert srv.admit(rid, p)
    for _ in range(rounds):
        srv.decode_round()
    return [s.generated for s in srv.slots[:len(prompts)]], srv.tokens[:, 0].tolist()


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b",
                                  "whisper-large-v3", "paligemma-3b"])
def test_server_graph_matches_an_eager_step_loop(cuda, arch):
    """The card's Server (a captured graph) against the same Server driven
    by the eager step, same seed and prompts; then new params: the graph is
    captured anew over them, never run on the old ones."""
    cfg = _binding(get_smoke_config(arch))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in (6, 3, 9)]
    graph = Server(cfg, max_batch=4, max_len=48, seed=0)
    assert isinstance(graph.step_fn, CompiledServeStep)
    eager = Server(cfg, max_batch=4, max_len=48, seed=0)
    eager.step_fn = make_serve_step(cfg)
    assert _serve(graph, prompts, 6) == _serve(eager, prompts, 6)
    assert graph.cur_len == eager.cur_len

    new = models.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    fresh = [Server(cfg, max_batch=4, max_len=48, seed=0) for _ in range(2)]
    fresh[0].params = new
    assert isinstance(fresh[0].step_fn, CompiledServeStep)
    fresh[1].params = new
    fresh[1].step_fn = make_serve_step(cfg)
    assert _serve(fresh[0], prompts, 6) == _serve(fresh[1], prompts, 6)


# ---------------------------------------------------------------------------
# Whisper: the encoder and cross-attention through flash and paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(4, 1500), (1500, 1500), (1, 100), (130, 333),
                                    (300, 64)])
def test_flash_kernel_noncausal_cross_shapes_match_plain(cuda, Sq, Skv, dtype):
    """Non-causal, MHA at whisper's D 64 and 20 heads: the encoder (1500
    frames, ragged against the 128-key step), cross prefill (4 queries
    against 1500 keys) and other Sq != Skv, both ways."""
    B, H, D = 2, 20, 64
    q = _randn((B, Sq, H, D), dtype, Sq, cuda)
    k, v = (_randn((B, Skv, H, D), dtype, Skv + s, cuda) for s in (1, 2))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    err, ratio, rows_off, ok = flash_agreement(got, want)
    assert ok, (err, ratio, rows_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,encoder_seq", [(4, 1500), (3, 100), (2, 64)])
def test_paged_kernel_over_the_cross_layout_matches_plain(cuda, B, encoder_seq, dtype):
    """Cross decode: one query per sequence against a cross cache of
    models.model.cross_rows(encoder_seq) rows (1536 at 1500) read in
    64-token blocks through the identity table, masked at encoder_seq.  The
    rows past encoder_seq hold NaN here, which neither version may read."""
    from repro_torch.models.model import cross_rows
    H, D, bt = 20, 64, 64
    rows = cross_rows(encoder_seq)
    assert rows % bt == 0 and contiguous_block_tokens(rows) == bt
    cache_k, cache_v = (_randn((B, rows, H, D), dtype, s, cuda) for s in (51, 52))
    cache_k[:, encoder_seq:] = float("nan")
    cache_v[:, encoder_seq:] = float("nan")
    args = (_randn((B, H, D), dtype, 53, cuda), cache_k.view(-1, bt, H, D),
            cache_v.view(-1, bt, H, D), identity_block_table(B, rows, bt, device=cuda),
            torch.full((B,), encoder_seq, dtype=torch.int32, device=cuda))
    got = ops.paged_attention(*args)
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    err, ratio, rows_off, ok = flash_agreement(got, want)
    assert ok, (err, ratio, rows_off)


def _frames(cfg, B, seed, device):
    return _randn((B, cfg.encoder_seq, cfg.d_model), torch.float32, seed, device)


def test_whisper_smoke_on_card_matches_cpu(cuda):
    """Prefill and 4 decode steps of a float32 whisper smoke model with a
    ragged encoder (100 frames): the card (kernels) against the CPU (plain
    versions), same weights and frames."""
    cfg = dataclasses.replace(get_smoke_config("whisper-large-v3"), dtype="float32",
                              encoder_seq=100)
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    frames = _frames(cfg, 2, 3, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, _, cache = models.forward(cfg, p, toks[:, :8].to(dev),
                                          encoder_embeds=frames.to(dev),
                                          collect_cache=True, kv_max=16)
        steps = [logits.cpu()]
        for i in range(8, 12):
            lg, cache = models.decode_step(cfg, p, toks[:, i:i + 1].to(dev), cache, i + 1)
            steps.append(lg.cpu())
        out[dev] = torch.cat(steps, 1)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_compiled_step_matches_the_eager_step(cuda, dtype):
    """whisper cut to 2 + 2 layers at its published widths (d_model 1280,
    20 heads of 64, vocab 51866; 1500 frames, a cross cache of 1536 rows):
    prefill, then 8 greedy steps eager and 8 through the captured graph
    from copies of the prefill's cache: equal ids at every step and equal
    caches after, bit for bit; each replay counts 2 paged launches a layer
    (self, cross)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("whisper-large-v3"), dtype=dtype, n_layers=2,
                              n_encoder_layers=2)
    params = models.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 4)))
    batch = {"tokens": toks.to(cuda), "encoder_embeds": _frames(cfg, 4, 1, cuda)}
    tok0, cache0 = make_prefill_step(cfg, kv_max=448)(params, batch)
    assert cache0["b0_dec"]["cross_k"].shape[2] == 1536
    eager_cache, graph_cache = _copy(cache0), _copy(cache0)
    step = CompiledServeStep(cfg, params, graph_cache, 4)
    assert step.max_len == 448
    tok_e, tok_g = tok0, tok0.clone()
    ops.reset_launch_counts()
    for i in range(8):
        n = 4 + i + 1
        logits, _ = models.decode_step(cfg, params, tok_e, eager_cache, n)
        tok_e = torch.argmax(logits[:, -1:], dim=-1)
        nxt, _ = step(params, graph_cache, tok_g, n)
        tok_g = nxt.clone()
        assert torch.equal(tok_g, tok_e), f"step {i}"
    for key, entry in graph_cache.items():
        for name, t in entry.items():
            assert torch.equal(t, eager_cache[key][name]), f"{key}/{name}"
    assert torch.equal(graph_cache["b0_dec"]["cross_k"], cache0["b0_dec"]["cross_k"])
    assert ops.LAUNCHES["paged_attention"] == 2 * 8 * 2 * cfg.n_layers
    # the self (7 blocks of 64) and cross (24) caches counted apart, the
    # graph's replays as the eager step's launches
    by_shape = {k: n for k, n in ops.LAUNCHES_BY_SHAPE.items() if k[0] == "paged_attention"}
    assert sorted(k[1].split()[5] for k in by_shape) == ["blocks24", "blocks7"]
    assert list(by_shape.values()) == [2 * 8 * cfg.n_layers] * 2


# ---------------------------------------------------------------------------
# PaliGemma: the bidirectional prefix in flash, head_dim 256 in both kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("S,prefix_len", [(288, 256), (300, 16), (300, 130), (100, 256)])
def test_flash_kernel_prefix_matches_plain(cuda, S, prefix_len, D, dtype):
    """Causal with a bidirectional prefix, MQA (8 query heads on one KV
    head): paligemma's prefill (256 image rows + 32 text rows), a prefix
    inside the first 128-key step, one whose edge lies in the second step
    past the rows of the first, and one longer than the sequence."""
    q = _randn((2, S, 8, D), dtype, S + prefix_len, cuda)
    k, v = (_randn((2, S, 1, D), dtype, S + s, cuda) for s in (1, 2))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, prefix_len=prefix_len)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    err, ratio, rows_off, ok = flash_agreement(got, want)
    assert ok, (err, ratio, rows_off)


def test_flash_kernel_refuses_a_prefix_with_no_meaning(cuda):
    """The wrapper raises ValueError, and the C entry refuses, a prefix
    without the causal mask, with a window or with PWL exp."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    x = _randn((1, 64, 2, 64), torch.bfloat16, 0, cuda)
    for kw in ({"causal": False}, {"window": 8}, {"use_pwl": True}):
        with pytest.raises(ValueError, match="prefix"):
            flash_attention_cuda(x, x, x, prefix_len=16, **kw)
    lib = _build.library("flash_attention")
    out = torch.empty_like(x)
    for causal, window, use_pwl in ((0, 0, 0), (1, 8, 0), (1, 0, 1)):
        assert lib.flash_attention_fwd(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), None, 1, 64, 64, 2, 2, 64, 1,
            causal, window, 16, 0, use_pwl, ctypes.addressof(PWL_COEFFS),
            torch.cuda.current_stream(cuda).cuda_stream) != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,use_pwl", [(4, False), (264, False), (4, True)])
def test_paged_kernel_d256_matches_plain(cuda, batch, use_pwl, dtype):
    """paligemma's decode: 8 query heads on one KV head of 256, a 448-row
    cache in 64-token blocks, contexts up to 416; at batch 4 split_plan
    gives one block a split (7 splits, combined), at batch 264 (2 CTAs an
    SM) and under PWL one split; float32 then runs one stage (two do not
    fit in shared memory at D 256)."""
    H, Hkv, D, bt, max_len = 8, 1, 256, 64, 448
    ctx = ([416, 289, 64, 0] * (batch // 4))[:batch]
    cache_k, cache_v = (_randn((batch, max_len, Hkv, D), dtype, s, cuda) for s in (61, 62))
    args = (_randn((batch, H, D), dtype, 63, cuda), cache_k.view(-1, bt, Hkv, D),
            cache_v.view(-1, bt, Hkv, D), identity_block_table(batch, max_len, bt, device=cuda),
            torch.tensor(ctx, dtype=torch.int32, device=cuda))
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_splits, _ = split_plan(batch * Hkv, max_len // bt, bt, n_sms, use_pwl=use_pwl)
    assert (n_splits > 1) == (batch == 4 and not use_pwl)
    got = ops.paged_attention(*args, use_pwl=use_pwl)
    want = paged_attention_plain(*args, use_pwl=use_pwl)
    torch.cuda.synchronize()
    assert not got[3].any()                                  # context 0 -> 0
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    err, ratio, rows_off, ok = flash_agreement(got, want, pwl=use_pwl)
    assert ok, (err, ratio, rows_off)


@pytest.mark.parametrize("kw", [{}, {"n_layers": 1, "head_dim": 256}],
                         ids=["smoke", "one_layer_d256"])
def test_paligemma_prefix_on_card_matches_cpu(cuda, kw):
    """Prefill with a 16-row image prefix and 4 decode steps of a float32
    smoke paligemma (and one layer at head_dim 256): the card (kernels)
    against the CPU (plain versions), same weights and prefix."""
    cfg = dataclasses.replace(get_smoke_config("paligemma-3b"), dtype="float32", **kw)
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 14)))
    prefix = _randn((2, cfg.n_prefix_tokens, cfg.d_model), torch.float32, 4, "cpu")
    P = cfg.n_prefix_tokens
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, _, cache = models.forward(cfg, p, toks[:, :10].to(dev),
                                          prefix_embeds=prefix.to(dev),
                                          collect_cache=True, kv_max=P + 16)
        steps = [logits.cpu()]
        for i in range(10, 14):
            lg, cache = models.decode_step(cfg, p, toks[:, i:i + 1].to(dev), cache, P + i + 1)
            steps.append(lg.cpu())
        out[dev] = torch.cat(steps, 1)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paligemma_compiled_step_after_a_prefix_matches_the_eager_step(cuda, dtype):
    """paligemma cut to 2 layers at its published widths (d_model 2048, 8
    heads of 256 on one KV head, vocab 257216): a prefill of 256 image rows
    and a 32-token prompt, then 8 greedy steps eager and 8 through the
    captured graph: equal ids and caches, bit for bit; a prefill launches
    one flash a layer (its prefix shape), a step one paged a layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    cfg = dataclasses.replace(get_config("paligemma-3b"), dtype=dtype, n_layers=2)
    params = models.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))
    prefix = _randn((4, 256, cfg.d_model), getattr(torch, dtype), 5, cuda)
    ops.reset_launch_counts()
    tok0, cache0 = make_prefill_step(cfg, kv_max=448)(
        params, {"tokens": toks.to(cuda), "prefix_embeds": prefix})
    q = torch.empty((4, 288, 8, 256), dtype=getattr(torch, dtype))
    assert ops.LAUNCHES_BY_SHAPE == {
        ("flash_attention", fa.launch_key(q, q[:, :, :1], prefix_len=256)): cfg.n_layers}
    eager_cache, graph_cache = _copy(cache0), _copy(cache0)
    step = CompiledServeStep(cfg, params, graph_cache, 4)
    tok_e, tok_g = tok0, tok0.clone()
    ops.reset_launch_counts()
    for i in range(8):
        n = 288 + i + 1
        logits, _ = models.decode_step(cfg, params, tok_e, eager_cache, n)
        tok_e = torch.argmax(logits[:, -1:], dim=-1)
        nxt, _ = step(params, graph_cache, tok_g, n)
        tok_g = nxt.clone()
        assert torch.equal(tok_g, tok_e), f"step {i}"
    for key, entry in graph_cache.items():
        for name, t in entry.items():
            assert torch.equal(t, eager_cache[key][name]), f"{key}/{name}"
    assert ops.LAUNCHES["paged_attention"] == 2 * 8 * cfg.n_layers


# ---- flash attention backward (training) --------------------------------
# held by repro_torch.kernels.flash_attention.bwd_agreement: float32 within
# 1e-4 of max(|want|, 1) (sums of up to S keys / rows in another order);
# bf16 each element within 2**-7 |want| + 2**-12 max(|want|, 1)

def _bwd_case(shape_q, hkv, dtype, seed, device, window=0, prefix_len=0):
    from repro_torch.kernels import flash_attention as fa
    b, s, hq, d = shape_q
    q = _randn(shape_q, dtype, seed, device)
    k, v = (_randn((b, s, hkv, d), dtype, seed + i + 1, device) for i in range(2))
    out, lse = fa._flash_fwd(q, k, v, causal=True, use_pwl=False, window=window,
                             prefix_len=prefix_len, with_lse=True)
    g = _randn(shape_q, dtype, seed + 3, device)
    return q, k, v, out, lse, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 129, 300])
def test_flash_bwd_kernel_matches_plain(cuda, S, D, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((2, S, 8, D), 2, dtype, S + D, cuda)
    _, lse_plain = fa.flash_attention_plain(q, k, v, return_lse=True)
    assert (lse - lse_plain).abs().max().item() <= 1e-5
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1     # three launches count once
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape
        err, ratio, ok = fa.bwd_agreement(a, w)
        assert ok, (name, err, ratio)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic_and_lse_leaves_the_forward_as_it_was(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((2, 1000, 8, 64), 2, dtype, 7, cuda)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    for _ in range(2):
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(out, ops.flash_attention(q, k, v))


@pytest.mark.parametrize("where", ["dout", "q", "k", "v"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_keeps_a_nan_where_plain(cuda, dtype, where):
    """Non-finite exactly where the plain version is: a masked pair's 0
    times a NaN row adds nothing (the mma path's diagonal blocks too)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((1, 300, 4, 64), 1, dtype, 11, cuda)
    if where == "dout":
        g[0, 140, 3, 5] = float("nan")
    else:
        t = {"q": q, "k": k, "v": v}[where]
        t[0, 140, 0, 5] = float("nan")
        out, lse = fa._flash_fwd(q, k, v, causal=True, use_pwl=False, window=0, prefix_len=0,
                                 with_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    assert not all(bool(torch.isfinite(w.float()).all()) for w in want)
    for a, w in zip(got, want):
        assert fa.bwd_agreement(a, w)[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_matches_autograd_of_the_plain_version(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _, _, g = _bwd_case((2, 200, 8, 64), 2, dtype, 5, cuda)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v), (q, k, v), g)
    out_, lse = fa._flash_fwd(q.detach(), k.detach(), v.detach(), causal=True, use_pwl=False,
                              window=0, prefix_len=0, with_lse=True)
    plain = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out_, lse, g)
    for name, a, w, p in zip("qkv", got, want, plain):
        assert fa.bwd_agreement(a, p)[2], name
        if dtype == torch.float32:
            assert fa.bwd_agreement(a, w)[2], name
        else:
            # autograd of the plain forward differentiates its float32
            # output; the backward reads the bf16 output the forward
            # returned (Delta = rowsum(dO O)), ~2**-9 of a term apart
            assert float((a.float() - w.float()).norm()) <= 2 ** -6 * float(w.float().norm())
    # a prefix (paligemma's) goes through FlashAttentionFn too: one forward
    # and one backward launch, the plain backward's gradients under the prefix
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, prefix_len=8)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    out_, lse = fa._flash_fwd(q.detach(), k.detach(), v.detach(), causal=True, use_pwl=False,
                              window=0, prefix_len=8, with_lse=True)
    assert torch.equal(out.detach(), out_)
    plain = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out_, lse, g,
                                         prefix_len=8)
    for name, a, p in zip("qkv", got, plain):
        assert fa.bwd_agreement(a, p)[2], name
    with torch.no_grad():                          # no grad: the forward alone
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_flash_bwd_entry_refuses_what_it_does_not_implement(cuda):
    """The C entry refuses PWL exp, a negative window, D 48, and a prefix
    with a window or without the causal mask without a launch; it takes
    the causal mask on or off, a window, a prefix, and D 64, 80 and 256."""
    from repro_torch.kernels import _build
    lib = _build.library("flash_attention_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    for D in (64, 80):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, out, lse, g = _bwd_case((1, 64, 4, D), 2, dtype, 3, cuda)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            delta = torch.empty((1, 4, 64), device=cuda)
            ptrs = [t.data_ptr() for t in (q, k, v, out, lse, g, dq, dk, dv, delta)]
            code = 0 if dtype == torch.float32 else 1
            for d, causal, window, prefix, pwl in ((D, 1, 16, 8, 0), (D, 0, 0, 8, 0),
                                                   (D, 1, 0, 0, 1), (D, 0, 0, 0, 1),
                                                   (D, 1, -1, 0, 0), (D, 1, 0, -1, 0),
                                                   (48, 0, 0, 0, 0)):
                err = lib.flash_attention_bwd(*ptrs, 1, 64, 64, 4, 2, d, code, causal, window,
                                              prefix, 0, pwl, stream)
                assert err != 0, (d, causal, window, prefix, pwl)
            for causal, window, prefix in ((1, 0, 0), (0, 0, 0), (1, 16, 0), (0, 16, 0),
                                           (1, 1, 0), (1, 0, 8), (1, 0, 100)):
                assert lib.flash_attention_bwd(*ptrs, 1, 64, 64, 4, 2, D, code, causal, window,
                                               prefix, 0, 0, stream) == 0, (D, dtype, causal,
                                                                            window, prefix)
    for dtype in (torch.float32, torch.bfloat16):       # D 256 (paligemma)
        q, k, v, out, lse, g = _bwd_case((1, 64, 4, 256), 2, dtype, 3, cuda)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((1, 4, 64), device=cuda)
        ptrs = [t.data_ptr() for t in (q, k, v, out, lse, g, dq, dk, dv, delta)]
        code = 0 if dtype == torch.float32 else 1
        for prefix in (0, 16):
            assert lib.flash_attention_bwd(*ptrs, 1, 64, 64, 4, 2, 256, code, 1, 0, prefix, 0,
                                           0, stream) == 0, (dtype, prefix)
    torch.cuda.synchronize()


def _train_run(cfg, device, steps=3, seed=0):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map, tree_paths
    from repro_torch.data import PackedStream
    params = models.init_params(cfg, torch.Generator().manual_seed(seed))
    p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
    state = adamw_init(p)
    step = make_train_step(cfg, warmup=1, total_steps=10)
    stream = PackedStream(cfg.vocab_size, 64, seed=seed)
    metrics, updates = [], []
    for i in range(steps):
        b = stream.next_batch(2)
        if cfg.is_encoder_decoder:       # the same numpy frames on either device
            b["encoder_embeds"] = np.random.default_rng(i).normal(
                size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.n_prefix_tokens:          # and the same patch embeddings
            b["prefix_embeds"] = np.random.default_rng(100 + i).normal(
                size=(2, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32) * 0.02
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
        before = {k: t.detach().cpu() for k, t in tree_paths(p)}
        p, state, m = step(p, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        updates.append({k: t.detach().cpu() - before[k] for k, t in tree_paths(p)})
    return metrics, updates


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_the_card_matches_the_cpu(cuda, remat):
    """Smoke llama3.2-1b, float32, 3 AdamW steps: metrics within 1e-5
    relative, each leaf's update within 1e-2 in relative L2 norm (AdamW's
    first steps move by about lr * sign(g); see chip_smoke.py
    TRAIN_UPDATE_REL); launches: 2 forward (remat) or 1, and 1 backward,
    a layer and step."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32", remat=remat)
    cpu = _train_run(cfg, "cpu")
    before = dict(ops.LAUNCHES)
    card = _train_run(cfg, cuda)
    fwd = ops.LAUNCHES["flash_attention"] - before["flash_attention"]
    bwd = ops.LAUNCHES["flash_attention_bwd"] - before["flash_attention_bwd"]
    assert (fwd, bwd) == ((2 if remat else 1) * cfg.n_layers * 3, cfg.n_layers * 3)
    for cm, pm in zip(card[0], cpu[0]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(cm[k] - pm[k]) <= 1e-5 * max(abs(pm[k]), 1e-30), (k, cm[k], pm[k])
    for cu, pu in zip(card[1], cpu[1]):
        for k in pu:
            scale = max(float(pu[k].norm()), 1e-30)
            assert float((cu[k] - pu[k]).norm()) <= 1e-2 * scale or not pu[k].any(), k


def test_train_step_bf16_on_the_card_lowers_the_loss(cuda):
    cfg = get_smoke_config("llama3.2-1b")
    metrics, updates = _train_run(cfg, cuda, steps=12)
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    assert all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0 for m in metrics)


@pytest.mark.parametrize("arch", ["paligemma-3b"])
def test_training_a_family_without_backward_kernels_fails_loudly(cuda, arch):
    """A train step at a head dim the flash backward lacks (48; every
    family's config has one it takes) raises NotImplementedError naming
    the ROADMAP item on the card, before any launch."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=48)
    params = models.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    params = {k: v for k, v in params.items()}
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.requires_grad_(True), params)
    tokens = torch.zeros((1, 16), dtype=torch.long, device=cuda)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.n_prefix_tokens:
        batch["prefix_embeds"] = torch.zeros((1, cfg.n_prefix_tokens, cfg.d_model), device=cuda)
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model), device=cuda)
    before = dict(ops.LAUNCHES)
    with pytest.raises(NotImplementedError, match="head dim 48: ROADMAP"):
        make_train_step(cfg)(params, adamw_init(params), batch)
    assert dict(ops.LAUNCHES) == before


# ---- the non-causal flash backward and the SSD backward (training of
# whisper and mamba2) ------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D", [(300, 300, 8, 2, 64), (130, 333, 8, 2, 128),
                                             (448, 1500, 20, 20, 64), (1, 100, 4, 1, 32),
                                             (333, 1, 4, 4, 64)])
def test_flash_bwd_kernel_noncausal_matches_plain(cuda, Sq, Skv, Hq, Hkv, D, dtype):
    """No causal mask, Sq != Skv (whisper's cross-attention, 448 rows over
    1500 frames; its encoder at Sq == Skv), ragged, GQA: dQ, dK, dV by
    bwd_agreement, two runs bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    q = _randn((2, Sq, Hq, D), dtype, Sq, cuda)
    k, v = (_randn((2, Skv, Hkv, D), dtype, Skv + i, cuda) for i in range(2))
    g = _randn((2, Sq, Hq, D), dtype, 9, cuda)
    out, lse = fa._flash_fwd(q, k, v, causal=False, use_pwl=False, window=0, prefix_len=0,
                             with_lse=True)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=False)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=False)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=False)
    torch.cuda.synchronize()
    for name, a, w, c in zip("qkv", got, want, again):
        assert fa.bwd_agreement(a, w)[2], (name, fa.bwd_agreement(a, w))
        assert torch.equal(a, c), name


@pytest.mark.parametrize("where", ["dout", "q", "k", "v"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_noncausal_keeps_a_nan_where_plain(cuda, dtype, where):
    """Non-finite exactly where the plain version is, Sq 200 over Skv 300:
    rows and keys past the true lengths add nothing."""
    from repro_torch.kernels import flash_attention as fa
    q = _randn((1, 200, 4, 64), dtype, 21, cuda)
    k, v = (_randn((1, 300, 1, 64), dtype, 22 + i, cuda) for i in range(2))
    g = _randn((1, 200, 4, 64), dtype, 24, cuda)
    if where == "dout":
        g[0, 140, 3, 5] = float("nan")
    else:
        {"q": q, "k": k, "v": v}[where][0, 140, 0, 5] = float("nan")
    out, lse = fa._flash_fwd(q, k, v, causal=False, use_pwl=False, window=0, prefix_len=0,
                             with_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=False)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=False)
    assert not all(bool(torch.isfinite(w.float()).all()) for w in want)
    for a, w in zip(got, want):
        assert fa.bwd_agreement(a, w)[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_noncausal_matches_autograd_of_the_plain_version(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    q = _randn((2, 100, 8, 64), dtype, 31, cuda).requires_grad_(True)
    k, v = (_randn((2, 257, 2, 64), dtype, 32 + i, cuda).requires_grad_(True) for i in range(2))
    g = _randn((2, 100, 8, 64), dtype, 34, cuda)
    before = dict(ops.LAUNCHES)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False), (q, k, v), g)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    out, lse = fa._flash_fwd(q.detach(), k.detach(), v.detach(), causal=False, use_pwl=False,
                             window=0, prefix_len=0, with_lse=True)
    plain = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out, lse, g,
                                         causal=False)
    for name, a, p in zip("qkv", got, plain):
        assert fa.bwd_agreement(a, p)[2], name


# ---- the flash backward at D 80 and under a sliding window (training of
# zamba2 and mixtral) ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hq,Hkv,D,window", [
    (1024, 8, 8, 80, None),       # zamba2's shared block (MHA, D 80)
    (300, 8, 2, 80, 100),         # D 80 under a window
    (512, 8, 2, 128, 1),          # each row sees itself
    (512, 8, 2, 128, 100),        # windows that cut tiles off the diagonal
    (512, 8, 2, 128, 130),
    (1000, 4, 1, 64, 130),        # ragged S
    (129, 4, 2, 32, 17),
    (600, 8, 2, 128, 64),         # a window of one tile
])
def test_flash_bwd_kernel_windowed_and_d80_match_plain(cuda, S, Hq, Hkv, D, window, dtype):
    """dQ, dK, dV by bwd_agreement against the plain version under the same
    window, two runs bit-equal, one counted launch; the forward with the
    lse output bit-equal to the forward without it under the window."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((2, S, Hq, D), Hkv, dtype, S + D, cuda, window or 0)
    assert torch.equal(out, ops.flash_attention(q, k, v, window=window))
    _, lse_plain = fa.flash_attention_plain(q, k, v, window=window, return_lse=True)
    assert (lse - lse_plain).abs().max().item() <= 1e-5
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, window=window)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, window=window)
    torch.cuda.synchronize()
    for name, a, w, c in zip("qkv", got, want, again):
        assert a.dtype == dtype and a.shape == w.shape
        assert fa.bwd_agreement(a, w)[2], (name, fa.bwd_agreement(a, w))
        assert torch.equal(a, c), name
    if window is not None and window < S:     # the window moved the gradients
        full = fa.flash_attention_bwd_plain(q, k, v, *fa._flash_fwd(
            q, k, v, causal=True, use_pwl=False, window=0, prefix_len=0, with_lse=True), g)
        assert not torch.equal(full[1], want[1])


@pytest.mark.parametrize("where", ["dout", "q", "k", "v"])
@pytest.mark.parametrize("window", [100, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_windowed_keeps_a_nan_where_plain(cuda, dtype, window, where):
    """Under a window that is no multiple of 16 or 64: non-finite exactly
    where the plain version is, so a key past a row's window, in a tile
    the window's edge cuts, does not take that row's NaN."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((1, 512, 4, 128), 2, dtype, 13, cuda, window)
    if where == "dout":
        g[0, 300, 3, 5] = float("nan")
    else:
        {"q": q, "k": k, "v": v}[where][0, 300, 0, 5] = float("nan")
        out, lse = fa._flash_fwd(q, k, v, causal=True, use_pwl=False, window=window,
                                 prefix_len=0, with_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, window=window)
    assert not all(bool(torch.isfinite(w.float()).all()) for w in want)
    assert all(bool(torch.isfinite(w.float()).any()) for w in want)
    for a, w in zip(got, want):
        assert fa.bwd_agreement(a, w)[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,window", [(80, None), (128, 100), (80, 37)])
def test_flash_attention_fn_windowed_and_d80_match_autograd_of_the_plain_version(cuda, D,
                                                                               window, dtype):
    """A grad through ops.flash_attention on the card at D 80 or under a
    window: FlashAttentionFn launches the forward and the backward kernel
    once each, and gives the plain backward's gradients."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _, _, g = _bwd_case((2, 300, 8, D), 2, dtype, 51, cuda)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    key = fa.launch_key(q, k, window=window)
    assert ops.LAUNCHES_BY_SHAPE[("flash_attention_bwd", key)] >= 1
    out_, lse = fa._flash_fwd(q.detach(), k.detach(), v.detach(), causal=True, use_pwl=False,
                              window=window or 0, prefix_len=0, with_lse=True)
    assert torch.equal(out.detach(), out_)
    plain = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out_, lse, g,
                                         window=window)
    for name, a, p in zip("qkv", got, plain):
        assert fa.bwd_agreement(a, p)[2], name


# ---- the prefix and D 256 in the flash backward (training of paligemma) --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,prefix_len", [
    (4, 1280, 8, 1, 256, 256),    # paligemma's train shape
    (1, 300, 8, 1, 256, 100),     # a prefix that is no multiple of 16
    (1, 129, 8, 1, 256, 200),     # a prefix past S: every pair kept
    (2, 300, 8, 2, 256, 0),       # D 256 without a prefix
    (2, 512, 8, 2, 64, 256),
    (2, 512, 8, 2, 128, 256),
    (2, 300, 4, 1, 32, 100),
    (1, 77, 4, 2, 80, 16),
])
def test_flash_bwd_kernel_prefix_and_d256_match_plain(cuda, B, S, Hq, Hkv, D, prefix_len,
                                                      dtype):
    """dQ, dK, dV by bwd_agreement against the plain version with the same
    prefix, two runs bit-equal, one launch counted under the prefix's
    launch_key; the forward's lse against the plain version's; the prefix
    moved the gradients."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((B, S, Hq, D), Hkv, dtype, S + D + prefix_len, cuda,
                                     prefix_len=prefix_len)
    _, lse_plain = fa.flash_attention_plain(q, k, v, prefix_len=prefix_len, return_lse=True)
    assert (lse - lse_plain).abs().max().item() <= 1e-5
    key = ("flash_attention_bwd", fa.launch_key(q, k, prefix_len=prefix_len))
    before = ops.LAUNCHES_BY_SHAPE.get(key, 0)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, prefix_len=prefix_len)
    assert ops.LAUNCHES_BY_SHAPE[key] == before + 1
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, prefix_len=prefix_len)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, prefix_len=prefix_len)
    torch.cuda.synchronize()
    for name, a, w, c in zip("qkv", got, want, again):
        assert a.dtype == dtype and a.shape == w.shape
        assert fa.bwd_agreement(a, w)[2], (name, fa.bwd_agreement(a, w))
        assert torch.equal(a, c), name
    if prefix_len:                            # the prefix moved the gradients
        causal = fa.flash_attention_bwd_plain(q, k, v, *fa._flash_fwd(
            q, k, v, causal=True, use_pwl=False, window=0, prefix_len=0, with_lse=True), g)
        assert not torch.equal(causal[1], want[1])


@pytest.mark.parametrize("at", [50, 200])    # inside, outside the prefix of 100
@pytest.mark.parametrize("where", ["dout", "q", "k", "v"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_prefix_keeps_a_nan_where_plain(cuda, dtype, where, at):
    """D 256 with a prefix of 100 (no multiple of 16): non-finite exactly
    where the plain version is, a NaN at row / key 50 (inside the prefix:
    a key every row sees) or 200 (outside: a key only the rows from 200
    see, and a row that sees the prefix and the keys up to it)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, g = _bwd_case((1, 300, 8, 256), 1, dtype, 17, cuda, prefix_len=100)
    if where == "dout":
        g[0, at, 7, 5] = float("nan")
    else:
        {"q": q, "k": k, "v": v}[where][0, at, 0, 5] = float("nan")
        out, lse = fa._flash_fwd(q, k, v, causal=True, use_pwl=False, window=0,
                                 prefix_len=100, with_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, prefix_len=100)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, prefix_len=100)
    assert not all(bool(torch.isfinite(w.float()).all()) for w in want)
    for a, w in zip(got, want):
        assert fa.bwd_agreement(a, w)[2]


@pytest.mark.parametrize("remat", [False, True])
def test_paligemma_d256_train_step_on_the_card_matches_the_cpu(cuda, remat):
    """One layer of smoke paligemma at head_dim 256 (4 query heads on one KV
    head, 16 prefix rows before 64 tokens), float32, 3 AdamW steps: metrics
    within 1e-5 relative and each leaf's update within 1e-2 in relative L2
    norm, as the other families' test; launches exact, at the prefix's
    shape."""
    from repro_torch.kernels import flash_attention as fa
    cfg = dataclasses.replace(get_smoke_config("paligemma-3b"), dtype="float32", remat=remat,
                              n_layers=1, head_dim=256)
    cpu = _train_run(cfg, "cpu")
    before, before_shape = dict(ops.LAUNCHES), dict(ops.LAUNCHES_BY_SHAPE)
    card = _train_run(cfg, cuda)
    q = torch.empty((2, cfg.n_prefix_tokens + 64, cfg.n_heads, 256), device="meta")
    key = fa.launch_key(q, q[:, :, :1], prefix_len=cfg.n_prefix_tokens)
    fwd, bwd = (ops.LAUNCHES_BY_SHAPE.get((n, key), 0) - before_shape.get((n, key), 0)
                for n in ("flash_attention", "flash_attention_bwd"))
    assert (fwd, bwd) == ((2 if remat else 1) * 3, 3)
    assert ops.LAUNCHES["flash_attention_bwd"] - before["flash_attention_bwd"] == 3
    for cm, pm in zip(card[0], cpu[0]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(cm[k] - pm[k]) <= 1e-5 * max(abs(pm[k]), 1e-30), (k, cm[k], pm[k])
    for cu, pu in zip(card[1], cpu[1]):
        for k in pu:
            scale = max(float(pu[k].norm()), 1e-30)
            assert float((cu[k] - pu[k]).norm()) <= 1e-2 * scale or not pu[k].any(), k


def _ssd_bwd_case(b, S, H, P, N, dtype, seed, device, *, long=False, strided=False):
    if strided:             # as the mamba layer slices its conv output
        conv = _randn((b, S, H * P + 2 * N), torch.float32, seed, device)
        conv[..., H * P:] *= 0.3
        conv = conv.to(dtype)
        x = conv[..., :H * P].reshape(b, S, H, P)
        B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    else:
        x = _randn((b, S, H, P), dtype, seed, device)
        B, C = ((0.3 * _randn((b, S, N), torch.float32, seed + i, device)).to(dtype)
                for i in (1, 2))
    dt = torch.nn.functional.softplus(_randn((b, S, H), torch.float32, seed + 3, device)
                                      - (5.0 if long else 0.0))
    a_neg = -torch.exp(0.2 * _randn((H,), torch.float32, seed + 4, device))
    return x, dt, a_neg, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,H,P,N,long,with_dstate,strided", [
    (2, 1024, 80, 64, 128, False, False, True),    # mamba2 train
    (2, 300, 16, 64, 64, True, True, True),        # zamba2's N, ragged, long memory
    (1, 2048, 8, 64, 128, True, False, False),     # long memory over 64 sub-chunks
    (2, 77, 8, 32, 16, False, True, False),        # smoke widths
    (3, 130, 4, 32, 32, True, False, False),
])
def test_ssd_bwd_kernel_matches_plain(cuda, b, S, H, P, N, long, with_dstate, strided, dtype):
    """dx, ddt, da_neg, dB, dC against the plain version fed the forward
    kernel's y and state, by ssd_scan.bwd_agreement (da_neg, which cancels,
    against the plain version's float64 value); two runs bit-equal."""
    from repro_torch.kernels import ssd_scan as ss
    args = _ssd_bwd_case(b, S, H, P, N, dtype, b + S + N, cuda, long=long, strided=strided)
    y, state = ss.ssd_scan_cuda(*args)
    dy = _randn((b, S, H, P), torch.float32, 5, cuda)
    dstate = _randn((b, H, P, N), torch.float32, 6, cuda) if with_dstate else None
    before = ops.LAUNCHES["ssd_scan_bwd"]
    got = ss.ssd_scan_bwd_cuda(*args, y, state, dy, dstate)
    assert ops.LAUNCHES["ssd_scan_bwd"] == before + 1            # two launches count once
    again = ss.ssd_scan_bwd_cuda(*args, y, state, dy, dstate)
    want = ss.ssd_scan_bwd_plain(*args, dy, dstate, 256, y=y, state=state)
    f64 = [t.double() if t is not None else None for t in (*args, dy, dstate, y, state)]
    exact = ss.ssd_scan_bwd_plain(*f64[:7], 256, y=f64[7], state=f64[8])
    torch.cuda.synchronize()
    for name, a, w, c, x in zip(ss.BWD_NAMES, got, want, again, exact):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        agree = ss.bwd_agreement(a, w, name, exact=x)
        assert agree[2], (name, agree)
        assert torch.equal(a, c), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_fn_matches_autograd_of_the_plain_version(cuda, dtype):
    """A grad through ops.ssd_scan on the card: SSDScanFn launches the
    forward and the backward kernel once each and gives the gradients of
    y and of the final state that autograd of the plain scan gives."""
    from repro_torch.kernels import ssd_scan as ss
    args = [t.requires_grad_(True) for t in
            _ssd_bwd_case(2, 300, 8, 64, 64, dtype, 40, cuda, long=True)]
    dy = _randn((2, 300, 8, 64), torch.float32, 41, cuda)
    ds = _randn((2, 8, 64, 64), torch.float32, 42, cuda)
    before = dict(ops.LAUNCHES)
    y, state = ops.ssd_scan(*args, chunk=256)
    got = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), args)
    assert ops.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert ops.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    yp, sp = ss.ssd_scan_plain(*args, 256)
    want = torch.autograd.grad((yp * dy).sum() + (sp * ds).sum(), args)
    for name, a, w in zip(ss.BWD_NAMES, got, want):
        # autograd of the plain scan recomputes y in float32; the kernel's
        # backward reads the forward kernel's y (bf16: hi + lo products)
        top = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= 1e-2 * top, name
    with torch.no_grad():                          # no grad: the forward alone
        assert ops.ssd_scan(*args, chunk=256)[0].grad_fn is None


def _fwd_a_step(cfg):
    """{forward kernel: its launches a train step without remat}; the
    backward kernel ``<name>_bwd`` launches as often (remat doubles the
    forwards)."""
    if cfg.is_encoder_decoder:
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers}
    if cfg.family in ("ssm", "hybrid"):
        out = {"ssd_scan": cfg.n_layers}
        if cfg.attn_every:              # the shared block, once a group
            out["flash_attention"] = cfg.n_layers // cfg.attn_every
        return out
    return {"flash_attention": cfg.n_layers}


FAMILIES = ["whisper-large-v3", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b", "paligemma-3b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_bf16_on_the_card_lowers_the_loss(cuda, arch):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map
    from repro_torch.data import PackedStream
    cfg = get_smoke_config(arch)
    params = tree_map(lambda t: t.requires_grad_(True),
                      models.init_params(cfg, torch.Generator(device=cuda).manual_seed(0)))
    state = adamw_init(params)
    step = make_train_step(cfg, warmup=1, total_steps=20)
    stream = PackedStream(cfg.vocab_size, 64, seed=0)
    frames = _randn((2, cfg.encoder_seq, cfg.d_model), torch.float32, 3, cuda) * 0.02 \
        if cfg.is_encoder_decoder else None
    patches = _randn((2, cfg.n_prefix_tokens, cfg.d_model), torch.float32, 4, cuda) * 0.02 \
        if cfg.n_prefix_tokens else None
    before = dict(ops.LAUNCHES)
    losses = []
    for _ in range(12):
        b = stream.next_batch(2)
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
        batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
        if frames is not None:
            batch["encoder_embeds"] = frames
        if patches is not None:
            batch["prefix_embeds"] = patches
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(m["grad_norm"].item()) and m["grad_norm"].item() > 0
    assert losses[-1] < losses[0], losses
    for kern, n in _fwd_a_step(cfg).items():
        bwd = f"{kern}_bwd"
        assert ops.LAUNCHES[bwd] - before[bwd] == 12 * n, bwd


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_on_the_card_matches_the_cpu(cuda, arch, remat):
    """Smoke whisper / mamba2 / zamba2 (one group: 6 mambas and the shared
    block, head dim 32) / mixtral (window 64, which S 64 does not reach;
    the MoE dispatch) / paligemma (16 prefix rows before 64 tokens),
    float32, 3 AdamW steps: metrics within 1e-5
    relative and each leaf's update within 1e-2 in relative L2 norm, as the
    dense family's test; whisper's launches count encode's remat."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=remat)
    cpu = _train_run(cfg, "cpu")
    before = dict(ops.LAUNCHES)
    card = _train_run(cfg, cuda)
    for kern, n in _fwd_a_step(cfg).items():
        fwd = ops.LAUNCHES[kern] - before[kern]
        bwd = ops.LAUNCHES[f"{kern}_bwd"] - before[f"{kern}_bwd"]
        assert (fwd, bwd) == ((2 if remat else 1) * n * 3, n * 3), kern
    for cm, pm in zip(card[0], cpu[0]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(cm[k] - pm[k]) <= 1e-5 * max(abs(pm[k]), 1e-30), (k, cm[k], pm[k])
    for cu, pu in zip(card[1], cpu[1]):
        for k in pu:
            scale = max(float(pu[k].norm()), 1e-30)
            assert float((cu[k] - pu[k]).norm()) <= 1e-2 * scale or not pu[k].any(), k


# ---------------------------------------------------------------------------
# The train step captured as one CUDA graph (launch.steps.CompiledTrainStep)
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["llama3.2-1b", *FAMILIES]


def _graph_batches(cfg, device, n=3, seq=64):
    """``n`` batches of PackedStream(0) on ``device``, with random frame /
    patch embeddings where the family takes them."""
    from repro_torch.data import PackedStream
    stream = PackedStream(cfg.vocab_size, seq, seed=0)
    out = []
    for i in range(n):
        b = {k: torch.from_numpy(v).to(device) for k, v in stream.next_batch(2).items()}
        b["tokens"], b["labels"] = b["tokens"].long(), b["labels"].long()
        if cfg.is_encoder_decoder:
            b["encoder_embeds"] = _randn((2, cfg.encoder_seq, cfg.d_model), torch.float32,
                                         10 + i, device) * 0.02
        if cfg.n_prefix_tokens:
            b["prefix_embeds"] = _randn((2, cfg.n_prefix_tokens, cfg.d_model), torch.float32,
                                        20 + i, device) * 0.02
        out.append(b)
    return out


def _start(cfg, device, seed=0):
    """Params (leaves that require grad) from a seed, and a fresh state of
    the config's optimizer, on ``device``."""
    from repro_torch.launch.steps import init_train_state
    params, state = init_train_state(cfg, torch.Generator().manual_seed(seed))
    return (_on(params, device, grad=True), _on(state, device))


def _on(tree, device, grad=False):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(grad), tree)


def _flat_cpu(params, state, metrics):
    from repro_torch.tree import tree_paths
    out = {("m",) + (k,): v.detach().cpu().clone() for k, v in metrics.items()}
    out.update({("p",) + k: v.detach().cpu().clone() for k, v in tree_paths(params)})
    out.update({("s",) + k: v.detach().cpu().clone() for k, v in tree_paths(state)})
    return out


def _eager_run(cfg, batches, device, noise=0.0):
    """Each step's {metric / param / state leaf: CPU copy} of the eager
    step from ``_start``, and the launches it made."""
    from repro_torch.launch.steps import make_train_step
    params, state = _start(cfg, device)
    step = make_train_step(cfg, warmup=1, total_steps=10, weight_noise_std=noise)
    before = dict(ops.LAUNCHES)
    out = []
    for b in batches:
        params, state, m = step(params, state, b)
        out.append(_flat_cpu(params, state, m))
    return out, {k: ops.LAUNCHES[k] - before[k] for k in before}


def _graph_run(cfg, batches, device, noise=0.0):
    """The same steps through ``CompiledTrainStep``: one eager warm-up step
    (the step's first call), the start state loaded back into the captured
    tensors, then a replay a batch (the first also captures)."""
    from repro_torch.launch.steps import CompiledTrainStep, tensor_addresses
    params, state = _start(cfg, device)
    step = CompiledTrainStep(cfg, params, state, warmup=1, total_steps=10,
                             weight_noise_std=noise)
    step(params, state, batches[0])
    assert step.graph is None and int(state["step"]) == 1
    step.load(*_start(cfg, "cpu"))
    addresses = tensor_addresses(params, state)
    before = dict(ops.LAUNCHES)
    out = []
    for b in batches:
        p, s, m = step(params, state, b)
        assert p is params and s is state
        out.append(_flat_cpu(params, state, m))
    assert step.graph is not None and tensor_addresses(params, state) == addresses
    return out, {k: ops.LAUNCHES[k] - before[k] for k in before}, step


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_compiled_train_step_matches_the_eager_step(cuda, arch, remat):
    """Smoke float32, 3 steps of the captured step against two eager runs
    from the same state (``checks.graph_vs_eager``: bit-equal where
    eager is equal to itself, else within twice its spread): metrics,
    params and AdamW state after each step; the same launches a step as
    eager."""
    from repro_torch.checks import graph_vs_eager
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=remat)
    batches = _graph_batches(cfg, cuda)
    eager_a, launches = _eager_run(cfg, batches, cuda)
    eager_b, _ = _eager_run(cfg, batches, cuda)
    graph, graph_launches, _ = _graph_run(cfg, batches, cuda)
    assert graph_launches == launches and sum(launches.values()) > 0
    spread, _, bad = graph_vs_eager(graph, eager_a, eager_b)
    assert not bad, (sorted(spread)[:8], bad[:8])


def test_compiled_train_step_draws_weight_noise_of_the_step(cuda, monkeypatch):
    """With the RRAM weight noise on, the factors a call draws are
    bit-equal to ``weight_noise(params, std, s)``: at step 0 (the eager
    warm-up call), then, after a state whose step is 5 is loaded, at steps
    5, 6, 7 (replays); the loss of each replay equals the eager step's on
    the same state, batch and factors within float32 rounding.  The step's
    factors are read through the tree its ``weight_noise`` call returned:
    for a replay, the captured tensors the graph draws into."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import CompiledTrainStep, make_loss_fn
    from repro_torch.tree import tree_paths
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
    std = 0.05
    batches = _graph_batches(cfg, cuda)
    params, state = _start(cfg, cuda)
    weight_noise, drawn = steps_mod.weight_noise, []

    def recorded(*args, **kw):
        drawn.append(weight_noise(*args, **kw))
        return drawn[-1]

    monkeypatch.setattr(steps_mod, "weight_noise", recorded)
    step = CompiledTrainStep(cfg, params, state, warmup=1, total_steps=10,
                             weight_noise_std=std)

    def same(s):
        want = weight_noise(params, std, s)
        for (path, got), (_, w) in zip(tree_paths(drawn[-1]), tree_paths(want)):
            assert (got is None and w is None) or torch.equal(got, w), (s, path)

    step(params, state, batches[0])
    same(0)
    start_p, start_s = _start(cfg, "cpu", seed=3)
    start_s["step"].fill_(5)
    step.load(start_p, start_s)
    loss_fn = make_loss_fn(cfg, weight_noise_std=std)
    for i, b in enumerate(batches):
        with torch.no_grad():
            want = float(loss_fn(params, b, noise=weight_noise(params, std, 5 + i))[0])
        _, _, m = step(params, state, b)
        same(5 + i)
        assert abs(float(m["loss"]) - want) <= 1e-6 * abs(want), (i, float(m["loss"]), want)
    assert int(state["step"]) == 8 and step.host_step == 8


def test_compiled_train_step_refuses_other_tensors_and_batches(cuda):
    from repro_torch.launch.steps import CompiledTrainStep
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
    batches = _graph_batches(cfg, cuda, n=2)
    params, state = _start(cfg, cuda)
    step = CompiledTrainStep(cfg, params, state, warmup=1, total_steps=10)
    for b in batches:
        step(params, state, b)
    assert step.graph is not None
    other = dict(params, embed=params["embed"].detach().clone().requires_grad_(True))
    with pytest.raises(ValueError, match="not the tensors"):
        step(other, state, batches[0])
    with pytest.raises(ValueError, match="not the tensors"):
        step(params, dict(state, step=state["step"].clone()), batches[0])
    short = {k: v[:, :32] for k, v in batches[0].items()}
    with pytest.raises(ValueError, match="batch"):
        step(params, state, short)
    with pytest.raises(ValueError, match="batch"):
        step(params, state, dict(batches[0], mask=batches[0]["mask"].double()))
    with pytest.raises(ValueError, match="shape"):
        step.load({**params, "embed": params["embed"][:1]}, state)
    n = int(state["step"])
    step(params, state, batches[1])                         # still serves
    assert int(state["step"]) == n + 1


def test_train_driver_restores_into_the_captured_tensors(cuda, tmp_path, capsys):
    """``launch.train.main`` on the card steps through CompiledTrainStep,
    which refuses any tensors but its own: a run that restarts from scratch
    after an injected failure (no checkpoint yet: a fresh state copied in),
    then one that restores a checkpoint at start and again after a failure
    (copied in), each ends with the loss down."""
    from repro_torch.launch import train
    fresh = ["--arch", "llama3.2-1b", "--smoke", "--ckpt-dir", str(tmp_path / "a"),
             "--steps", "12", "--save-every", "100", "--simulate-failures", "1"]
    losses = train.main(fresh)
    out = capsys.readouterr().out
    assert "step=captured" in out and "no checkpoint; restarted from scratch" in out
    assert losses[-1] < losses[0]
    base = ["--arch", "llama3.2-1b", "--smoke", "--ckpt-dir", str(tmp_path / "b")]
    train.main(base + ["--steps", "10", "--save-every", "10"])
    losses = train.main(base + ["--steps", "30", "--save-every", "10",
                                "--simulate-failures", "1"])
    out = capsys.readouterr().out
    assert "restored from checkpoint at step 10" in out and "restarted from step 10" in out
    assert losses[-1] < losses[0]
