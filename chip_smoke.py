#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py                 # every phase, one card
  python3 chip_smoke.py --phases kernels

Phases, each of which fails the run if it fails:
  build         compile every ``csrc/*.cu`` with nvcc (one process per
                source, started together) and print ptxas' register / spill
                report.
  kernels       hold each CUDA kernel against its plain PyTorch version on
                the card, at the main paths' shapes and at ragged ones
                (attention: exact and PWL, D 32/64/80/128; SSD scan: y and
                final state, float32 and bfloat16, N 128 and 64, short and
                long memory); time
                kernel, plain version and one PyTorch library call where
                there is one, with CUDA events.
  serve         llama3-8b at full width and depth in bf16, random weights
                from a seed: prefill of 4 x 512 tokens, then 32 greedy
                decode steps through the user-facing step functions; the
                kernels' launch counters are zeroed just before and read
                just after.
  ssm_serve     the same for mamba2-2.7b (64 mamba layers): 64 SSD-scan
                launches in the prefill, no attention.
  hybrid_serve  the same for zamba2-2.7b (54 mamba layers, 9 applications
                of the shared attention block).
  parity        llama3-8b widths, 2 layers, float32: the card (kernels)
                against the CPU (plain versions) on the same weights,
                logits and greedy ids.
  ssm_parity    the same for mamba2 widths (1 layer) and zamba2 widths (one
                group: 6 mambas + the shared block), and prefill(S-1) +
                decode(1) against forward(S) on the card.
  server        requests through ``Server.admit`` / ``decode_round``, for
                llama3-8b and mamba2-2.7b.
  profile       (only when named) device time by kernel under torch.profiler
                for one full-width prefill and 8 decode steps of each of
                the three served models, and the device's busy share of the
                host-clock window.

The line before the last two is a JSON object ``{"kernels": [...]}``, then
the card's name and power limit as nvidia-smi reports them, and the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the ``repro_torch`` package beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "serve", "ssm_serve", "hybrid_serve", "parity",
          "ssm_parity", "server")
EXTRA_PHASES = ("profile",)          # run only when named in --phases
SERVE_ARCH = {"serve": "llama3-8b", "ssm_serve": "mamba2-2.7b",
              "hybrid_serve": "zamba2-2.7b"}
# the serve phase whose launch counts each kernel's JSON entry reports
MAIN_PATH_OF = {"flash_attention": "serve", "paged_attention": "serve",
                "ssd_scan": "ssm_serve"}

# H100 SXM data-sheet peaks (dense): memory, bf16 tensor cores, float32 SIMT
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances of kernel vs plain version, max |difference| on outputs of
# order 1 (unit-normal q/k/v).  float32: both sum in float32, in another
# order (dot products of <= 128 terms, online-softmax steps of 128 keys).
# bfloat16: both compute in float32 and round the output to bfloat16 at
# the end, so they may differ by one bfloat16 ulp, 2**-7 at |x| in [1, 2)
# and 2**-6 up to 4.
TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}
# SSD scan: y and state are float32 in both versions, from the same
# (rounded) inputs, so the input dtype does not matter.  The plain version
# steps over 256-row chunks, the kernel over 64-row sub-chunks: the decay
# exponents are differences of cumulative sums that reach ~-180 over a
# chunk, where a float32 ulp is ~1.5e-5, on y and states of order 1-10;
# the bar of tests/test_kernels.py for the chunked scan against the
# step-by-step recurrence.
TOL_SSD = 1e-3
# Long-memory SSD cases: dt ~ softplus(N(0,1) - 5) ~ 0.01, the regime of
# trained Mamba2 weights, so exp(cs) over a 64-row sub-chunk is ~0.5 and the
# state carries across every sub-chunk of the sequence (at dt ~ 0.7 it
# decays by e^-45 per sub-chunk and the carry is invisible).  y and state
# are each held to 1e-4 of their own max |value|: float32 sums in another
# order differ by ~1e-6 of it, a dropped or mis-scaled carry by percents.
TOL_SSD_REL = 1e-4

# main-path shapes of llama3-8b: 32 query heads, 8 KV heads, head_dim 128
B_MAIN, PROMPT, NEW, HQ, HKV, D = 4, 512, 32, 32, 8, 128
MAX_LEN = 576                       # >= PROMPT + NEW, a multiple of 64
# mamba2-2.7b / zamba2-2.7b: d_inner 5120 = 80 SSD heads of 64, d_state
# 128 / 64, chunk 256; zamba2's shared attention: 32 heads, kv 32, D 80
SSM_H, SSM_P, SSM_CHUNK = 80, 64, 256
ZH, ZD = 32, 80


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch, as a caller that just ran other layers would find it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def ms(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_work(b, s, h, p, n, esize):
    """Bytes (x, dt, A, B, C read once; y and state written once) and
    FLOPs of the recurrent form, the least the function needs whatever its
    chunking: per row and head the decay of the (P, N) state (P·N), the
    rank-1 update dt·x ⊗ B (2·P·N) and y = C·stateᵀ (2·P·N)."""
    flops = 5 * b * s * h * p * n
    nbytes = ((b * s * h * p + 2 * b * s * n) * esize + (b * s * h + h) * 4
              + b * s * h * p * 4 + b * h * p * n * 4)
    return nbytes, flops


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    targets = _build.build_all()
    log(f"[build] {len(targets)} libraries in {time.time() - t0:.1f}s: "
        + ", ".join(p.name for p in targets.values()))
    for name, text in sorted(_build.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {line.strip()}")


def _check(torch, name, got, want, dtype, case, tol=None):
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    tol = TOL[dtype] if tol is None else tol
    log(f"[kernels] {name} {case}: max_abs_err={err:.3e} tol={tol:.1e}")
    if not finite or not err <= tol:
        raise AssertionError(f"{name} {case}: kernel disagrees with its plain "
                             f"version (max_abs_err {err}, tol {tol})")
    return err


def phase_kernels(torch, timer, results):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import (
        contiguous_block_tokens, identity_block_table, paged_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(1234)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dts[dtype])

    # ---- flash attention (prefill) ------------------------------------
    def flash_entry(q, k, v, err, dt):
        b, s, hq, d = q.shape
        hkv = k.shape[2]
        esize = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
        flops = 4 * b * hq * d * s * (s + 1) / 2
        bms, by = bound(nbytes, flops, dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "shape": f"B{b} S{s} Hq{hq} Hkv{hkv} D{d} {dt} causal",
            "max_abs_err": err,
            "ms": timer.ms(lambda: ops.flash_attention(q, k, v), 20),
            "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v), 5),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20),
            "bound_ms": bms, "bound_by": by,
        }

    cases = [  # B, S, Hq, Hkv, D, dtype, causal, pwl
        (B_MAIN, PROMPT, HQ, HKV, D, "bfloat16", True, False),   # main path
        (B_MAIN, PROMPT, HQ, HKV, D, "float32", True, False),
        (B_MAIN, PROMPT, HQ, HKV, D, "bfloat16", True, True),
        (B_MAIN, PROMPT, HQ, HKV, D, "float32", True, True),
        (B_MAIN, PROMPT, ZH, ZH, ZD, "bfloat16", True, False),   # zamba2 prefill
        (B_MAIN, PROMPT, ZH, ZH, ZD, "float32", True, False),
        (2, 300, 8, 2, ZD, "float32", True, True),
        (1, 333, 4, 4, ZD, "bfloat16", False, False),
        (2, 300, HQ, HKV, 64, "float32", True, False),
        (2, 300, HQ, HKV, 64, "bfloat16", True, True),
        (2, 200, 4, 2, 32, "float32", True, True),
        (1, 333, 8, 2, 128, "float32", False, False),
        (1, 333, 8, 2, 32, "float32", False, True),
        (3, 77, 8, 8, 64, "float32", True, False),
    ]
    extra = []
    flash = None
    for i, (b, s, hq, hkv, d, dt, causal, pwl) in enumerate(cases):
        q, k, v = (randn((b, s, h, d), dt) for h in (hq, hkv, hkv))
        got = ops.flash_attention(q, k, v, causal=causal, use_pwl=pwl)
        want = flash_attention_plain(q, k, v, causal=causal, use_pwl=pwl)
        torch.cuda.synchronize()
        err = _check(torch, "flash_attention", got, want, dt,
                     f"B{b} S{s} Hq{hq} Hkv{hkv} D{d} {dt} causal={causal} pwl={pwl}")
        if i == 0:
            flash = flash_entry(q, k, v, err, dt)
        elif i == 4:
            extra.append(flash_entry(q, k, v, err, dt))
    torch.cuda.synchronize()

    # ---- paged attention (decode) -------------------------------------
    def contiguous_case(b, max_len, ctx, dt, hq=HQ, hkv=HKV, d=D):
        cache_k = randn((b, max_len, hkv, d), dt)
        cache_v = randn((b, max_len, hkv, d), dt)
        bt = contiguous_block_tokens(max_len)
        pool_k = cache_k.view(b * max_len // bt, bt, hkv, d)
        pool_v = cache_v.view(b * max_len // bt, bt, hkv, d)
        table = identity_block_table(b, max_len, bt, device="cuda")
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        return randn((b, hq, d), dt), pool_k, pool_v, table, lens, (cache_k, cache_v)

    def scattered_case(ctx, bt, dt, hq, hkv, d):
        b = len(ctx)
        nb = [-(-c // bt) for c in ctx]
        max_blocks = max(max(nb), 1)
        n_pool = sum(nb) + 3
        perm = torch.randperm(n_pool, generator=gen, device="cuda").to(torch.int32)
        table = torch.full((b, max_blocks), n_pool - 1, dtype=torch.int32, device="cuda")
        off = 0
        for r, n in enumerate(nb):
            table[r, :n] = perm[off:off + n]
            off += n
        pool_k = randn((n_pool, bt, hkv, d), dt)
        pool_v = randn((n_pool, bt, hkv, d), dt)
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        return randn((b, hq, d), dt), pool_k, pool_v, table, lens

    def paged_entry(case, err, dt):
        q, pk, pv, table, lens, (cache_k, cache_v) = case
        b, hq, d = q.shape
        hkv = pk.shape[2]
        esize = q.element_size()
        ctx_tokens = int(lens.sum())
        nbytes = (2 * q.numel() * esize + 2 * ctx_tokens * hkv * d * esize
                  + table.numel() * 4 + lens.numel() * 4)
        flops = 4 * ctx_tokens * hq * d
        bms, by = bound(nbytes, flops, dt)
        ql = q[:, :, None]                                   # (B, H, 1, D)
        kl, vl = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        return {
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:86",
            "shape": f"B{b} H{hq} Hkv{hkv} D{d} ctx{PROMPT + NEW} bt{pk.shape[1]} {dt}",
            "max_abs_err": err,
            "ms": timer.ms(lambda: ops.paged_attention(q, pk, pv, table, lens), 50),
            "plain_ms": timer.ms(lambda: paged_attention_plain(q, pk, pv, table, lens), 5),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True), 50),
            "bound_ms": bms, "bound_by": by,
        }

    main_ctx = [PROMPT + NEW] * B_MAIN
    pcases = []
    for dt in ("bfloat16", "float32"):
        for pwl in (False, True):
            pcases.append(("identity", dt, pwl, contiguous_case(B_MAIN, MAX_LEN, main_ctx, dt)))
    pcases.append(("identity zamba2", "bfloat16", False,              # zamba2 decode
                   contiguous_case(B_MAIN, MAX_LEN, main_ctx, "bfloat16", ZH, ZH, ZD)))
    pcases.append(("identity zamba2", "float32", True,
                   contiguous_case(B_MAIN, MAX_LEN, main_ctx, "float32", ZH, ZH, ZD)))
    pcases.append(("identity ragged", "float32", False,
                   contiguous_case(3, 200, [1, 100, 200], "float32", 8, 2, 64)))
    ragged = [0, 1, 63, 200, PROMPT + NEW]
    for (bt, dt, pwl, hq, hkv, d) in [(16, "float32", False, HQ, HKV, D),
                                      (64, "bfloat16", True, HQ, HKV, D),
                                      (16, "float32", True, 8, 8, 64),
                                      (32, "bfloat16", False, 8, 2, ZD),
                                      (8, "float32", False, 4, 2, 32),
                                      (1, "bfloat16", False, 4, 1, 32)]:
        pcases.append((f"scattered bt{bt} H{hq} Hkv{hkv} D{d}", dt, pwl,
                       scattered_case(ragged, bt, dt, hq, hkv, d)))
    paged = None
    for i, (what, dt, pwl, case) in enumerate(pcases):
        q, pk, pv, table, lens = case[:5]
        got = ops.paged_attention(q, pk, pv, table, lens, use_pwl=pwl)
        want = paged_attention_plain(q, pk, pv, table, lens, use_pwl=pwl)
        torch.cuda.synchronize()
        err = _check(torch, "paged_attention", got, want, dt,
                     f"{what} B{q.shape[0]} ctx={lens.tolist()} {dt} pwl={pwl}")
        if (lens == 0).any():
            zero = got[lens == 0].float().abs().max().item()
            if zero != 0.0:
                raise AssertionError(f"paged_attention: context 0 gave {zero}, not 0")
        if i == 0:
            paged = paged_entry(case, err, dt)
        elif i == 4:
            extra.append(paged_entry(case, err, dt))
    torch.cuda.synchronize()

    # ---- SSD scan (mamba prefill) -------------------------------------
    def ssd_case(b, s, h, p, n, dt, memory):
        x = randn((b, s, h, p), dt)
        shift = {"short": 0.0, "long": -5.0}[memory]
        delta = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda") + shift)
        a_neg = -torch.exp(0.2 * torch.randn((h,), generator=gen, device="cuda"))
        return x, delta, a_neg, randn((b, s, n), dt, 0.3), randn((b, s, n), dt, 0.3)

    def ssd_entry(args, err, dt):
        x, _, _, Bm, _ = args
        b, s, h, p = x.shape
        n = Bm.shape[-1]
        nbytes, flops = ssd_work(b, s, h, p, n, x.element_size())
        bms, by = bound(nbytes, flops, dt)
        return {
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:53",
            "shape": f"b{b} S{s} H{h} P{p} N{n} {dt} chunk{SSM_CHUNK}",
            "max_abs_err": err,
            "ms": timer.ms(lambda: ops.ssd_scan(*args, chunk=SSM_CHUNK), 20),
            "plain_ms": timer.ms(lambda: ssd_scan_plain(*args, SSM_CHUNK), 5),
            "library_ms": None,       # no single PyTorch call computes it
            "bound_ms": bms, "bound_by": by,
        }

    scases = [  # b, S, H, P, N, dtype, memory
        (B_MAIN, PROMPT, SSM_H, SSM_P, 128, "bfloat16", "short"),  # mamba2 main path
        (B_MAIN, PROMPT, SSM_H, SSM_P, 128, "float32", "short"),
        (B_MAIN, PROMPT, SSM_H, SSM_P, 64, "bfloat16", "short"),   # zamba2
        (B_MAIN, PROMPT, SSM_H, SSM_P, 64, "float32", "short"),
        (2, 300, SSM_H, SSM_P, 128, "float32", "short"),           # ragged S
        (2, 300, 16, SSM_P, 64, "bfloat16", "short"),
        (1, 100, 8, SSM_P, 128, "float32", "short"),               # S < chunk, b 1
        (1, PROMPT, SSM_H, SSM_P, 128, "bfloat16", "short"),       # b 1
        (2, 77, 8, 32, 16, "float32", "short"),                    # smoke widths
        (3, 130, 4, 32, 32, "bfloat16", "short"),
        (B_MAIN, PROMPT, SSM_H, SSM_P, 128, "bfloat16", "long"),   # state carried
        (B_MAIN, PROMPT, SSM_H, SSM_P, 128, "float32", "long"),
        (B_MAIN, PROMPT, SSM_H, SSM_P, 64, "bfloat16", "long"),
        (B_MAIN, PROMPT, SSM_H, SSM_P, 64, "float32", "long"),
        (2, 300, SSM_H, SSM_P, 128, "float32", "long"),
        (2, 300, 16, SSM_P, 64, "bfloat16", "long"),
        (1, 100, 8, SSM_P, 128, "float32", "long"),
    ]
    ssd = None
    for i, (b, s, h, p, n, dt, memory) in enumerate(scases):
        args = ssd_case(b, s, h, p, n, dt, memory)
        y, state = ops.ssd_scan(*args, chunk=SSM_CHUNK)
        want_y, want_state = ssd_scan_plain(*args, SSM_CHUNK)
        torch.cuda.synchronize()
        what = f"b{b} S{s} H{h} P{p} N{n} {dt} {memory} memory"
        errs = []
        for name, got, want in (("y", y, want_y), ("state", state, want_state)):
            tol = (TOL_SSD if memory == "short"
                   else TOL_SSD_REL * want.abs().max().item())
            errs.append(_check(torch, "ssd_scan", got, want, dt, f"{what} {name}", tol))
        if i == 0:
            ssd = ssd_entry(args, max(errs), dt)
        elif i == 2:
            extra.append(ssd_entry(args, max(errs), dt))
    torch.cuda.synchronize()

    results["kernels"] = [flash, paged, ssd]
    results["kernels_other_shapes"] = extra
    for kern in results["kernels"] + extra:
        lib = kern["library_ms"]
        log(f"[kernels] {kern['name']} at {kern['shape']}: kernel {kern['ms']:.4f} ms, "
            f"plain {kern['plain_ms']:.4f} ms, library "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + f", bound {kern['bound_ms']:.5f} ms ({kern['bound_by']})")


def expected_launches(cfg, new: int):
    """Kernel launches of one prefill and ``new`` decode steps: one flash
    per attention block application in the prefill, one paged per
    attention block application and step, one SSD scan per mamba layer in
    the prefill."""
    from repro_torch import models
    kinds, n_groups = models.group_layout(cfg)
    n_mamba = kinds.count("mamba") * n_groups
    n_attn = len(kinds) * n_groups - n_mamba
    return {"flash_attention": n_attn, "paged_attention": n_attn * new,
            "ssd_scan": n_mamba}


def phase_serve(torch, results, phase):
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    import numpy as np

    tag = f"[{phase}]"
    cfg = get_config(SERVE_ARCH[phase])
    t0 = time.time()
    params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in {cfg.dtype}, init {time.time() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B_MAIN, PROMPT))).cuda()
    prefill = make_prefill_step(cfg, kv_max=MAX_LEN)
    serve = make_serve_step(cfg)

    # warm-up outside the counted window (cuBLAS heuristics, allocator)
    prefill(params, {"tokens": prompt[:, :64]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.time()
    tok, cache = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.time() - t0
    ids = [tok]
    t0 = time.time()
    for step in range(NEW):
        tok, cache = serve(params, cache, tok, PROMPT + step + 1)
        ids.append(tok)
    torch.cuda.synchronize()
    t_decode = time.time() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    want = expected_launches(cfg, NEW)
    log(f"{tag} launches on the main path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    ids = torch.cat(ids, dim=1)
    if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError("token id out of range")
    # logits check, outside the counted window: the prefill's logits are
    # finite and their last-position argmax is the prefill step's token
    with torch.no_grad():
        logits, _, _ = models.forward(cfg, params, prompt)
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("prefill logits are not finite")
    if not torch.equal(logits[:, -1:].float().argmax(-1), ids[:, :1]):
        raise AssertionError("prefill argmax differs from the prefill step's token")
    for key, entry in cache.items():
        for name, t in entry.items():
            if name in ("k", "v"):
                t = t[:, :, :PROMPT + NEW]
            if not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"cache {key}/{name} is not finite")
    decode_ms = t_decode / NEW * 1e3
    res = {"arch": cfg.name, "dtype": cfg.dtype, "batch": B_MAIN, "prompt": PROMPT,
           "new_tokens": NEW, "prefill_ms": t_prefill * 1e3,
           "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": B_MAIN * NEW / t_decode,
           "prefill_tokens_per_s": B_MAIN * PROMPT / t_prefill,
           "peak_mem_gib": peak, "launches": launches}
    results[phase] = res
    log(f"{tag} prefill {res['prefill_ms']:.2f} ms ({res['prefill_tokens_per_s']:.0f} tok/s), "
        f"decode {decode_ms:.3f} ms/step ({res['decode_tokens_per_s']:.1f} tok/s), "
        f"peak {peak:.2f} GiB")
    log(f"{tag} first ids per sequence: {ids[:, :8].tolist()}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _parity(torch, cfg, *, b, s, steps, max_len, seed):
    """float32 weights from a seed on the card, copied to the CPU: prefill
    logits, ``steps`` decode-step logits and the greedy ids of both."""
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    import numpy as np

    # float32 sums of up to 14336 products (d_ff) taken in another order on
    # the two devices: ~1e-6 relative on logits of order 1
    tol = 1e-3
    params = {"cuda": models.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))}
    params["cpu"] = _tree_to(params["cuda"], "cpu")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    out = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        t0 = time.time()
        with torch.no_grad():
            logits, _, _ = models.forward(cfg, params[dev], prompt.to(dev))
        tok, cache = make_prefill_step(cfg, kv_max=max_len)(params[dev], {"tokens": prompt.to(dev)})
        serve = make_serve_step(cfg)
        ids, step_logits = [tok.cpu()], []
        for i in range(steps):
            with torch.no_grad():
                lg, _ = models.decode_step(cfg, params[dev], tok,
                                           {k: {kk: vv.clone() for kk, vv in c.items()}
                                            for k, c in cache.items()}, s + i + 1)
            step_logits.append(lg.float().cpu())
            tok, cache = serve(params[dev], cache, tok, s + i + 1)
            ids.append(tok.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            want = expected_launches(cfg, steps)
            missing = [k for k, n in want.items() if n and not ops.LAUNCHES[k]]
            if missing:
                raise AssertionError(f"card run launched {ops.LAUNCHES}")
        elif any(ops.LAUNCHES.values()):
            raise AssertionError(f"CPU run launched kernels {ops.LAUNCHES}")
        out[dev] = (logits.float().cpu(), torch.cat(step_logits, 1), torch.cat(ids, 1))
        log(f"[parity] {cfg.name} {dev}: {time.time() - t0:.1f}s")
    err_prefill = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    err_decode = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    same_ids = torch.equal(out["cuda"][2], out["cpu"][2])
    log(f"[parity] {cfg.name} widths x {cfg.n_layers} layers fp32, B{b} S{s} +{steps} "
        f"steps: prefill logits max_abs_err={err_prefill:.3e}, decode logits "
        f"max_abs_err={err_decode:.3e} (tol {tol:.0e}), greedy ids equal: {same_ids}")
    if not (err_prefill <= tol and err_decode <= tol and same_ids):
        raise AssertionError(f"{cfg.name}: card and CPU disagree")
    return params["cuda"], prompt, {"prefill_max_abs_err": err_prefill,
                                    "decode_max_abs_err": err_decode, "tolerance": tol,
                                    "greedy_ids_equal": same_ids}


def phase_parity(torch, results):
    """Full widths, 2 layers, float32: card (kernels) vs CPU (plain)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2, dtype="float32")
    results["parity"] = _parity(torch, cfg, b=2, s=160, steps=8, max_len=200, seed=1)[2]


def phase_ssm_parity(torch, results):
    """mamba2 widths x 1 layer and zamba2 widths x one group, float32: the
    card against the CPU, and prefill(S-1) + decode(1) against forward(S)
    at the last token on the card, which ties the kernel's final state to
    the recurrent decode."""
    from repro_torch import models
    from repro_torch.configs import get_config
    out = {}
    for arch, n_layers in (("mamba2-2.7b", 1), ("zamba2-2.7b", 6)):
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
        params, prompt, res = _parity(torch, cfg, b=2, s=300, steps=8, max_len=320, seed=2)
        toks = prompt.cuda()
        with torch.no_grad():
            full, _, _ = models.forward(cfg, params, toks)
            _, _, cache = models.forward(cfg, params, toks[:, :-1], collect_cache=True,
                                         kv_max=320)
            lg, _ = models.decode_step(cfg, params, toks[:, -1:], cache, toks.shape[1])
        rel = ((lg[:, 0] - full[:, -1]).abs().max() / full[:, -1].abs().max()).item()
        log(f"[ssm_parity] {cfg.name}: prefill(S-1) + decode(1) vs forward(S) on the "
            f"card, rel err {rel:.3e} (tol 1e-3)")
        if not rel < 1e-3:
            raise AssertionError(f"{cfg.name}: decode does not continue the prefill")
        out[arch] = {**res, "decode_vs_forward_rel_err": rel}
        del params, cache
        torch.cuda.empty_cache()
    results["ssm_parity"] = out


def phase_server(torch, results):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Server
    import numpy as np

    out = {}
    for arch in ("llama3-8b", "mamba2-2.7b"):
        cfg = get_config(arch)
        srv = Server(cfg, max_batch=4, max_len=64, seed=0)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in (8, 5, 11)]
        rounds = 8
        ops.reset_launch_counts()
        t0 = time.time()
        for rid, p in enumerate(prompts):
            if not srv.admit(rid, p):
                raise AssertionError("admission refused with a free slot")
        for _ in range(rounds):
            srv.decode_round()
        torch.cuda.synchronize()
        dt = time.time() - t0
        steps = sum(len(p) for p in prompts) + rounds
        want = {"flash_attention": 0,
                "paged_attention": expected_launches(cfg, steps)["paged_attention"],
                "ssd_scan": 0}
        if dict(ops.LAUNCHES) != want:
            raise AssertionError(f"Server launches {ops.LAUNCHES}, expected {want}")
        for s in srv.slots[:len(prompts)]:
            if len(s.generated) != rounds:
                raise AssertionError("a slot missed a decode round")
            if not all(0 <= t < cfg.vocab_size for t in s.generated):
                raise AssertionError("token id out of range")
        if srv.active() != len(prompts):
            raise AssertionError("wrong number of active slots")
        log(f"[server] {arch}: {len(prompts)} requests, {steps} decode steps in {dt:.2f}s, "
            f"launches {dict(ops.LAUNCHES)}")
        out[arch] = {"requests": len(prompts), "steps": steps, "seconds": dt}
        del srv
        torch.cuda.empty_cache()
    results["server"] = out


def _kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if "paged_fwd_kernel" in name:
        return "paged_attention"
    if "ssd_fwd_kernel" in name:
        return "ssd_scan"
    if any(t in name for t in ("gemm", "gemv", "sm90_xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def phase_profile(torch, results, arch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    import numpy as np

    cfg = get_config(arch)
    params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B_MAIN, PROMPT))).cuda()
    prefill = make_prefill_step(cfg, kv_max=MAX_LEN)
    serve = make_serve_step(cfg)
    tok, cache = prefill(params, {"tokens": prompt})            # warm-up
    tok, cache = serve(params, cache, tok, PROMPT + 1)
    state = {"tok": tok, "cache": cache}

    def do_prefill():
        state["tok"], state["cache"] = prefill(params, {"tokens": prompt})

    def do_decode():
        for i in range(8):
            state["tok"], state["cache"] = serve(params, state["cache"],
                                                 state["tok"], PROMPT + i + 1)

    out = {}
    for what, fn in (("prefill", do_prefill), ("decode_x8", do_decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.time() - t0) * 1e6
        by_class, top = {}, []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.self_device_time_total
            by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + us
            top.append((us, e.count, e.key[:90]))
        busy = sum(by_class.values())
        out[what] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                     "busy_share": busy / wall_us,
                     "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()}}
        log(f"[profile] {arch} {what}: wall {wall_us / 1e3:.2f} ms, device busy "
            f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), by class "
            + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in sorted(by_class.items())))
        for us, n, key in sorted(top, reverse=True)[:8]:
            log(f"[profile]   {us / 1e3:9.3f} ms  x{n:<5d} {key}")
    results.setdefault("profile", {})[arch] = out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[env] {smi}")

    results = {"card": smi}
    launches_of = {}
    t_start = time.time()
    timer = Timer(torch)
    for phase in PHASES + EXTRA_PHASES:
        if phase not in phases:
            continue
        t0 = time.time()
        if phase == "build":
            phase_build()
        elif phase == "kernels":
            phase_kernels(torch, timer, results)
        elif phase in SERVE_ARCH:
            launches_of[phase] = phase_serve(torch, results, phase)
        elif phase == "parity":
            phase_parity(torch, results)
        elif phase == "ssm_parity":
            phase_ssm_parity(torch, results)
        elif phase == "server":
            phase_server(torch, results)
        elif phase == "profile":
            for arch in SERVE_ARCH.values():
                phase_profile(torch, results, arch)
                torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[{phase}] ok in {time.time() - t0:.1f}s")
    log(f"[all] ok in {time.time() - t_start:.1f}s")
    for kern in results.get("kernels", []):
        path = launches_of.get(MAIN_PATH_OF[kern["name"]])
        kern["launches"] = None if path is None else path[kern["name"]]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    if "kernels" in results:
        print(json.dumps({"kernels": results["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
