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
                (attention: exact and PWL, D 32/64/80/128, bf16 flash also
                by the per-element rule of ``flash_attention.agreement``;
                paged over scattered tables, bt 1-64, and one 4000-token
                context split over many CTAs; both under mixtral's sliding
                window: flash at B1 S4160 and B4 S512 with windows of
                4096, 100 and 130, paged at ctx 4224 with window 4096
                (33 splits at B1, one at B33 and under PWL), contexts
                below the window; bf16 paged also per element, float32
                PWL rows past 2e-5 only at a segment edge; whisper's
                shapes: flash non-causal B4 S1500 H20 D64 (the encoder)
                and Sq 4 against 1500 keys (cross prefill), paged at ctx
                1500 over the 1536-row cross cache and at ctx 132 over the
                448-row self cache; paligemma's shapes at D 256 (8 query
                heads on one KV head): flash B4 S288 with the 256-row
                bidirectional image prefix, bf16 and float32, and without
                a prefix under PWL, paged at ctx 416 of 448 rows, bf16 with
                7 splits, float32 and PWL; SSD scan: y and
                final state, float32 and bfloat16, N 128 and 64, short and
                long memory, S 2048 over 64 sub-chunks, mamba2's and
                zamba2's train shapes b8 S1024 on the mamba layer's strided
                x / B / C (bit-equal to contiguous copies), and the CTAs
                resident per SM; SCU softmax: its indexed PWL exp against
                the select chain on all 2**32 float32 inputs, float32 and
                bfloat16 on each of its four routes (warp, row, cluster,
                three_pass) with the route and CTAs per SM logged, the
                other routes that take a main-path shape held and timed,
                edge rows bit-equal and non-finite rows NaN where the plain
                version is on every route, and the attention kernels' NaN
                rows on a NaN score held to the plain versions'; CIM
                matmul: bfloat16 and float32 x, calibration tiles from
                16 x 26 to unblocked, adc_bits 6 to 16, each of its three routes
                with the route and the CTAs resident per SM logged, every
                route that takes a case's shape held and timed beside the
                route taken, the weight pre-laid or transposed per call;
                the flash backward against its plain version on dQ, dK, dV
                at llama3.2-1b's train shape, D 128, the smoke D 32, ragged
                S, float32 and a NaN in dout and in k, bit-equal across two
                runs, the forward with its lse output bit-equal to the
                forward without it; without the causal mask at whisper's
                train shapes (the encoder B8 S1500 H20 D64, bf16 and
                float32; the cross-attention, 448 rows over 1500 frames),
                ragged GQA with Sq != Skv and a NaN in dout and in k; at
                D 80 zamba2's train shape B8 S1024 H32, bf16 and float32;
                under a sliding window mixtral's train shape B2 S4160
                Hq32 Hkv8 D128 with window 4096, bf16, and
                moe_train_parity's B2 S384 window 128, float32, windows 1,
                100 and 130 at B4 S512, ragged S under a window, a NaN in
                dout and in k under windows 100 and 130; with paligemma's
                bidirectional prefix and at D 256: its train shape B4 S1280
                Hq8 Hkv1 D256 with a prefix of 256, bf16, and
                vlm_train_parity's B2 S384, float32, D 256 without a
                prefix, prefixes of 100, past S, and 256 at D 64 and 128,
                ragged S, a NaN in dout and in k inside and outside the
                prefix; every case twice, bit-equal); the
                SSD backward against its plain version (fed the forward
                kernel's y and state) on dx, ddt, da_neg, dB and dC, da_neg
                also against the float64 plain version: mamba2's train
                shape b8 S1024 H80 P64 N128 on the mamba layer's strided
                bf16 views (bit-equal to contiguous copies) and float32,
                zamba2's N 64, ragged S, long memory at S 2048, the smoke
                widths, with and without the final state's gradient,
                bit-equal across two runs; paged attention's partial mode
                (PICNIC's shard partials, ``ops.paged_attention_partial``)
                on (o, m, l) at llama3-8b's decode shape cut into 2 and 4
                shards by ``key_offset``, bf16 and float32, windows that
                bind across a shard boundary, shards with no kept key,
                several splits and one; both flash kernels with
                ``q_offset`` (sequence-parallel attention's rows: offsets
                0, 1, 250 and 1024, causal, window 100, prefix 300, non-
                causal, Sq < Skv, bf16 and float32; sp_train's B4 Sq1024
                Skv2048 D64 at offsets 0 and 1024, bf16 and float32, and
                picnic_decode's prefill rank, B4 Sq250 Skv500 D128 at 250;
                the forward with lse bit-equal to without, the backward
                twice bit-equal), rank 1's sp_train shape timed; time
                kernel, plain version and one PyTorch library call where
                there is one, with CUDA events.
  serve         llama3-8b at full width and depth in bf16, random weights
                from a seed: prefill of 4 x 512 tokens, then 32 greedy
                decode steps through the user-facing step functions, first
                eager (the yardstick), then through the serve step captured
                as a CUDA graph (``launch.steps.CompiledServeStep``) from
                the same prompt, greedy ids held equal; the main path is
                the prefill and the graph's decode: the kernels' launch
                counters are zeroed just before and read just after.
  ssm_serve     the same for mamba2-2.7b (64 mamba layers): 64 SSD-scan
                launches in the prefill, no attention.
  hybrid_serve  the same for zamba2-2.7b (54 mamba layers, 9 applications
                of the shared attention block).
  moe_serve     the same for mixtral-8x7b (MoE, sliding window 4096) at its
                published widths, depth cut to 16 of 32 layers (the bf16
                weights of 32 exceed the card): run 1 B4 x 512 with 32
                steps, run 2 B1 x 4160 with 64 steps (the window binds in
                prefill and in every step); 16 flash launches a prefill,
                16 paged a step.
  audio_serve   the same for whisper-large-v3 (encoder-decoder) at published
                widths and full depth (32 + 32 layers), frame embeddings of
                B4 x 1500 x 1280 from a seed: a 4-token start-of-transcript
                prompt, 128 steps over a 448-row self cache; 96 flash
                launches a prefill (32 encoder, 32 decoder self, 32 cross),
                64 paged a step (32 self, 32 cross over a 1536-row cross
                cache); graph caches held bit-equal to the eager ones.
  vlm_serve     the same for paligemma-3b (prefix-LM) at published widths
                and full depth (18 layers, head_dim 256, MQA), 256 image
                rows from a seed (the SigLIP stub's patch embeddings)
                before a 32-token prompt: a prefill of B4 x 288 positions
                with a bidirectional prefix of 256, 128 steps over a
                448-row cache; 18 flash launches a prefill, 18 paged a
                step; graph caches held bit-equal to the eager ones.
  cim_scu       one llama3-8b layer at full width in bf16 with its seven
                projections on the RRAM crossbar (``ops.cim_matmul_quantized``,
                weights quantised once) and its softmax on the SCU
                (``ops.pwl_softmax``), each weight also laid out once in the
                kernel's (N, K) layout: a 4 x 512 prefill, the vocab softmax
                of its last logits and a batch-4 decode step, 14 + 3 counted
                launches; each output held to the plain version; then the
                ablations of the JAX package's benches (ADC bits against the
                exact product, PWL against the exact softmax).
  parity        llama3-8b widths, 2 layers, float32: the card (kernels)
                against the CPU (plain versions) on the same weights,
                logits and greedy ids.
  ssm_parity    the same for mamba2 widths (1 layer) and zamba2 widths (one
                group: 6 mambas + the shared block), and prefill(S-1) +
                decode(1) against forward(S) on the card.
  moe_parity    the same for mixtral widths (1 layer) with the window cut to
                128 so that it binds at S 300, and on the card at window
                4096 and S 4160 prefill(S-1) + decode(1) against forward(S).
  audio_parity  the same for whisper widths, 4 + 4 layers, 1500 frames.
  vlm_parity    the same for paligemma widths, 2 layers, a 256-row image
                prefix before 16 tokens (the float32 SIMT flash with the
                prefix, float32 paged, both at D 256).
  server        requests through ``Server.admit`` / ``decode_round``, for
                llama3-8b, mamba2-2.7b, zamba2-2.7b, mixtral-8x7b (16
                layers), whisper-large-v3 (no encoder run, as the JAX
                Server) and paligemma-3b (no image prefix, as the JAX
                Server); on the card the Server replays its captured graph.
  picnic_decode PICNIC's sequence-sharded decode: two ranks spawned on the
                one card (gloo; NCCL refuses two ranks on one GPU), a (1,
                2) ("data", "model") mesh; llama3-8b at full width and
                depth in bf16, B4, a 500-token prompt prefilled
                sequence-parallel (``ShardingCtx(sp_attention=True,
                picnic_decode=True)``: each rank its 250 rows, rank 1's
                flash at q_offset 250) into a 1024-row cache of which the
                prefill returns each rank's 512 rows, then 32 greedy steps
                across the shard boundary at row 512 under the same
                context, eager; the launch counters zeroed before each
                rank's prefill and read after its decode; rank 0 also runs
                the single-rank prefill and decode fed the same tokens,
                held per row (PICNIC_BF16_ROW_REL) with the share of equal
                greedy ids printed; then a float32 cut of 2 layers: greedy
                ids equal, logits within 1e-5 relative.  Its ms a step is
                printed as correctness-only: the two ranks share one
                card's SMs.
  train         llama3.2-1b at full width and depth (16 layers) in bf16
                under remat, random weights from a seed: 20 + 2 AdamW steps
                of B8 x S1024 from the port's PackedStream, the first half
                (and one profiled) through the eager
                ``launch.steps.make_train_step``, the rest (and one
                profiled replay) through ``CompiledTrainStep`` (the step
                captured as one CUDA graph, params and state updated in
                place) built on the state the eager half leaves; the loss
                must fall, every leaf's first gradient be finite and
                non-zero, and each step launch 32 flash forwards and 16
                backwards; eager and graph ms a step, tokens/s, the
                capture's seconds, the graph pool, peak memory, each
                profiled step's busy share and the kernels' device time.
  dp_train      data-parallel training: two ranks spawned on the one card
                (gloo, a (2, 1) ("data", "model") mesh), llama3.2-1b's
                params and AdamW state cut by ``sharding.param_specs`` /
                ``opt_state_specs``, each rank its B4 of PackedStream's
                global B8 x S1024, ``launch.steps.make_sharded_train_step``
                eager; rank 0 first runs the single-rank steps on the full
                batches.  float32 cut to 2 layers, 3 steps: metrics within
                1e-5 relative of the single-rank steps, every leaf's update
                within 1e-3, both ranks' gathered params bit-equal after
                every step; bf16 at 4 of 16 layers (remat), 3 steps: both
                ranks' losses bit-equal and falling, loss and gradient
                norm within the DP_BF16_* bars of the single-rank steps;
                launch counts a rank as ``train``'s; the int8 compressed
                all-reduce on CUDA tensors of the embed gradient's shape
                bit-equal to the same call on the CPU.  Its ms a step and
                peak GiB a rank are printed, the time correctness-only.
  sp_train      sequence-parallel training: two ranks spawned on the one
                card (gloo, a (1, 2) ("data", "model") mesh under
                ``ShardingCtx(sp_attention=True)``), llama3.2-1b at full
                width, PackedStream(0)'s global B4 x S2048 on both ranks,
                each forward keeping its 1024 rows (K/V gathered, rank 1's
                flash forward and backward at q_offset 1024), as
                ``dp_train`` otherwise: float32 at 2 layers and bf16 at 16
                (remat), 3 steps each, against rank 0's single-rank steps
                on the whole batch, with exact launch counts a rank at its
                rows' shape and offset.
  train_parity  llama3.2-1b widths, 2 layers, float32: 3 AdamW steps on the
                card (remat on, then off) against the CPU from the same
                weights and batches: metrics, first gradients, updates;
                beside each card run 3 captured steps, held to the CPU and
                to eager: bit-equal, or, if not, by a second eager run
                (bit-equal where eager is equal to itself, else within
                twice its spread).
  train_driver  ``launch.train.main`` at smoke size through the captured
                step: a checkpoint at step 10, a failure injected at step
                15, the restart from the checkpoint (copied into the
                captured tensors), the loss down.
  train_100m_torch  ``examples/train_100m_torch.py`` (smollm-100m, remat
                off, B2 x S256): 40 steps with the eager step on the card,
                then 40 through the captured step; both ms a step, busy
                shares, peak memory, 10 flash forwards and backwards a
                step.
  audio_train   whisper-large-v3 at published widths and full depth (32 +
                32 layers) in bf16 under remat (each encoder layer and each
                decoder layer checkpointed): 10 + 2 AdamW steps of B8 x S448
                text over 1500 random frame embeddings a sequence, as
                ``train`` (and its profiled step); each step launches 192
                flash forwards (64 encoder non-causal S1500, 64 decoder
                causal S448, 64 cross non-causal 448 x 1500) and 96
                backwards, counted per shape.
  audio_train_parity  whisper widths, 2 + 2 layers over 1500 frames,
                float32, B2 x S256: as ``train_parity``.
  ssm_train     mamba2-2.7b at full width and depth (64 layers) in bf16
                under remat: 10 + 2 AdamW steps of B8 x S1024, as ``train``;
                each step launches 128 SSD scans and 64 SSD backwards.
  ssm_train_parity  mamba2 widths, 2 layers, float32, B2 x S512: as
                ``train_parity``.
  hybrid_train  zamba2-2.7b at full width and depth (54 mamba layers, the
                shared attention block of 32 heads of 80 applied 9 times)
                in bf16 under remat: 10 + 2 AdamW steps of B8 x S1024, as
                ``train``; each step launches 108 SSD scans, 54 SSD
                backwards, 18 flash forwards and 9 flash backwards at D 80,
                counted per shape.
  hybrid_train_parity  zamba2 widths, two groups (12 mamba layers, 2
                applications of the shared block), float32, B2 x S512: as
                ``train_parity``, each card step from the CPU's params and
                AdamW moments, and a run that pins nothing held beside.
  moe_train     mixtral-8x7b at published widths, depth cut to 2 of 32
                layers (the state of 32 is 521.9 GiB, of 2 35.4 GiB) in bf16
                under remat: 10 + 2 AdamW steps of B2 x S4160 (the window of
                4096 binds on the last 64 rows), as ``train``; each step
                launches 4 windowed flash forwards and 2 backwards.
  moe_train_parity  mixtral's attention widths, 8 experts of width 2048
                (cut from 14336), 1 layer, the window cut to 128, float32,
                B2 x S384 (the MoE dispatch and its drops): as
                ``train_parity``.
  vlm_train     paligemma-3b at published widths and full depth (18
                layers, 8 query heads on one KV head of 256) in bf16 under
                remat: 10 + 2 AdamW steps of B4 x 1024 text tokens after 256
                rows of seeded random patch embeddings (S 1280 through
                attention, the prefix seen bidirectionally), as ``train``;
                each step launches 36 flash forwards and 18 backwards with
                the prefix, counted per shape.
  vlm_train_parity  paligemma widths, 2 layers, float32, B2 x (256 prefix
                rows + 128 text tokens): as ``train_parity`` (the float32
                SIMT backward with the prefix at D 256).
  profile       (only when named) device time by kernel under torch.profiler
                for one full-width prefill and 8 decode steps (eager, and
                through the graph) of each of the six served models
                (whisper's prefill with its encoder, paligemma's with its
                image prefix), for the cim_scu layer's prefill and decode
                step and for one train step each of llama3.2-1b,
                zamba2-2.7b, mixtral-8x7b (2 layers) and paligemma-3b at
                their train phases' shapes, and the device's busy share of
                the host-clock window.

The line before the last two is a JSON object ``{"kernels": [...]}``, then
the card's name and power limit as nvidia-smi reports them, and the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the ``repro_torch`` package beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "serve", "ssm_serve", "hybrid_serve", "moe_serve", "audio_serve",
          "vlm_serve", "cim_scu", "parity", "ssm_parity", "moe_parity", "audio_parity",
          "vlm_parity", "server", "picnic_decode", "train", "dp_train", "sp_train",
          "train_parity",
          "train_driver",
          "audio_train", "audio_train_parity", "ssm_train", "ssm_train_parity", "hybrid_train",
          "hybrid_train_parity", "moe_train", "moe_train_parity", "vlm_train",
          "vlm_train_parity", "train_100m_torch")
EXTRA_PHASES = ("profile",)          # run only when named in --phases
SERVE_ARCH = {"serve": "llama3-8b", "ssm_serve": "mamba2-2.7b",
              "hybrid_serve": "zamba2-2.7b"}
# the serve phase whose launch counts each kernel's JSON entry reports;
# mixtral's window cases, whisper's and paligemma's shapes (in
# "kernels_other_shapes") name their own "path": run 1 of moe_serve, or
# run 2, "moe_serve_run2", "audio_serve" or "vlm_serve"
MAIN_PATH_OF = {"flash_attention": "serve", "paged_attention": "serve",
                "ssd_scan": "ssm_serve", "pwl_softmax": "cim_scu",
                "cim_matmul": "cim_scu", "flash_attention_bwd": "train",
                "ssd_scan_bwd": "ssm_train"}

# H100 SXM data-sheet peaks (dense): memory, bf16 and int8 tensor cores,
# float32 SIMT
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}

# Tolerances of kernel vs plain version, max |difference| on outputs of
# order 1 (unit-normal q/k/v).  float32: both sum in float32, in another
# order (dot products of <= 128 terms, online-softmax steps of 128 keys).
# bfloat16: both round a float32 result to bfloat16 at the end, so they
# may differ by one bfloat16 ulp, 2**-7 at |x| in [1, 2) and 2**-6 up to 4.
# bf16 flash attention is held besides to
# repro_torch.kernels.flash_attention.agreement (each element within
# 2**-7 * |want| + 2**-12; with PWL exp at most 0.1% of rows past it, a
# score within rounding of a segment edge): its tensor-core kernel
# multiplies P as two bf16 terms, the plain version keeps P in float32.
TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}
# SSD scan: y and state are float32 in both versions, from the same
# (rounded) inputs, so the input dtype does not matter.  The plain version
# steps over 256-row chunks, the kernel over 64-row (float32) or 32-row
# (bf16, which multiplies float32 operands as hi + lo bf16 terms,
# tests/test_torch_ssd_mma.py) sub-chunks: the decay
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
# SCU softmax: the same float32 steps in both versions (PWL exp, IEEE
# reciprocal, separate multiply), the row sum in another order; held by
# repro_torch.kernels.pwl_softmax.agreement: float32 outputs (<= 1) within
# 1e-6; bfloat16 outputs within one bfloat16 step of each expected value,
# and fewer than 1% of the nonzero ones differ at all.
# CIM matmul: integer dots (exact in both) and the same float32 steps in the
# same order, so kernel and plain version agree to float32 ordering at most;
# max |difference| <= 1e-6 of max |out|.  One flipped 12-bit ADC code moves
# an output by ~1/2047 of its tile's swing, far above the bar.
TOL_CIM_REL = 1e-6

# main-path shapes of llama3-8b: 32 query heads, 8 KV heads, head_dim 128
B_MAIN, PROMPT, NEW, HQ, HKV, D = 4, 512, 32, 32, 8, 128
MAX_LEN = 576                       # >= PROMPT + NEW, a multiple of 64
# prefills timed before each serve run's counted one (a host-clock spread,
# and the cudaMalloc calls each makes)
PREFILL_REPEATS = 3
# mamba2-2.7b / zamba2-2.7b: d_inner 5120 = 80 SSD heads of 64, d_state
# 128 / 64, chunk 256; zamba2's shared attention: 32 heads, kv 32, D 80
SSM_H, SSM_P, SSM_CHUNK = 80, 64, 256
ZH, ZD = 32, 80
# mixtral-8x7b: llama3-8b's attention widths, a sliding window of 4096; the
# long run's prompt is 64 tokens past the window, its cache 4224 rows (a
# multiple of 64) for 64 decode steps
MIX_WINDOW, MIX_LONG, MIX_LONG_MAX = 4096, 4160, 4224
MIX_LAYERS = 16                     # of 32: the bf16 weights of all 32 exceed 80 GB
# whisper-large-v3: 20 heads of 64 (MHA), 1500 encoder frames, a cross
# cache of 1536 rows (models.model.cross_rows: a multiple of 64); the
# decoder prompt is Whisper's start-of-transcript sequence
# <|startoftranscript|><|en|><|transcribe|><|notimestamps|> in large-v3's
# vocabulary, then 128 steps over a 448-row self cache (the published
# max_target_positions)
WH, WD, W_FRAMES, W_CROSS = 20, 64, 1500, 1536
W_SOT = (50258, 50259, 50360, 50364)
W_NEW, W_MAX_LEN = 128, 448
# paligemma-3b: 8 query heads on one KV head of 256 (MQA); 256 image rows
# (the SigLIP stub's patch embeddings, n_prefix_tokens) before a 32-token
# prompt, so the prefill runs 288 positions with a bidirectional prefix of
# 256; then 128 steps over a 448-row cache (contexts up to 416)
VH, VD, V_PREFIX, V_PROMPT = 8, 256, 256, 32
V_NEW, V_MAX_LEN = 128, 448
# training (llama3.2-1b, 16 layers of 32 query heads on 8 KV heads of 64,
# vocab 128256, tied embeddings, remat): B8 x S1024 batches from the
# port's PackedStream(seed=0), 20 AdamW steps at lr 3e-4, warmup 10, as
# launch/train.py sets them
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "llama3.2-1b", 8, 1024, 20
TRAIN_HQ, TRAIN_HKV, TRAIN_D = 32, 8, 64
# train_parity: the card against the CPU, llama3.2-1b widths x 2 layers,
# float32, B2 x S256, 3 AdamW steps.  The loss, ce and LR of a step and
# its gradient norm are float32 sums in another order on the two devices
# (~1e-7 relative); each leaf's gradient of the first batch within
# TRAIN_GRAD_REL in relative L2 norm (sums over 512 tokens and 128256
# logits, the embedding's backward adding rows in another order on the
# card); each leaf's update within TRAIN_UPDATE_REL: AdamW's first steps
# move an element by lr * m / (sqrt(v) + eps), about lr * sign(g), so a
# gradient element within rounding of 0 may move the other way on the
# other device, 2 lr on that element (a share f of them gives 2 sqrt(f)).
TRAIN_METRIC_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_UPDATE_REL = 1e-2
# mamba2's a_log and dt_bias (ssm_train_parity): one value a head, whose
# gradient sums a term over every (b, s) row of the batch (dt_bias's
# ddt_s, a_log's dt_s da_s A, da_s a suffix sum of dcs_t = dy_t . y_t -
# u_t . du_t, two terms that cancel), so float32 rounding in another
# order on the two devices moves it by far more than a leaf of
# independent elements: the SSD backward's da_neg lies 1.46e-3 of its size
# from float64 in the plain float32 version and 4.8e-4 in the kernel at
# b8 S1024 (kernels phase).  Every other leaf stays at TRAIN_GRAD_REL.
SSM_SCALAR_GRAD_REL = 2e-3
# training of the other families: whisper-large-v3 (32 + 32 layers) at
# B8 x S448 text (its max_target_positions) over 1500 frames, and
# mamba2-2.7b (64 layers) at B8 x S1024, 10 AdamW steps each (warmup 5)
AUDIO_TRAIN_ARCH, AUDIO_TRAIN_B, AUDIO_TRAIN_S, AUDIO_TRAIN_STEPS = "whisper-large-v3", 8, 448, 10
SSM_TRAIN_ARCH, SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = "mamba2-2.7b", 8, 1024, 10
# zamba2-2.7b at full width and depth (54 mamba layers, the shared block
# of 32 heads of 80 applied 9 times) at B8 x S1024; mixtral-8x7b at its
# published widths, cut to MOE_TRAIN_LAYERS of 32 layers (the state of 32
# is 521.9 GiB at 12 bytes a parameter), at B2 x S4160: the window of 4096
# binds on each sequence's last 64 rows, as in moe_serve's run 2.  10
# AdamW steps each, warmup 5
HYBRID_TRAIN_ARCH, HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS = "zamba2-2.7b", 8, 1024, 10
MOE_TRAIN_ARCH, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = "mixtral-8x7b", 2, MIX_LONG, 10
MOE_TRAIN_LAYERS = 2
# examples/train_100m_torch.py's steps in the train_100m_torch phase (each
# of its eager and captured runs)
TRAIN_100M_STEPS = 40
# paligemma-3b at full width and depth: B4 x 1024 text tokens after its 256
# image rows (S 1280 through attention), 10 AdamW steps (warmup 5); its
# 2.509 B params are 28.0 GiB of state at 12 bytes a parameter, and B4 x
# 1024 x 257216 logits as many as llama3.2-1b's B8 x 1024 x 128256
VLM_TRAIN_ARCH, VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_STEPS = "paligemma-3b", 4, 1024, 10
# vlm_train_parity: 2 layers, B2 x 128 text tokens after the 256-row prefix
VLM_PARITY_S = 128
# moe_train_parity: mixtral's attention widths (d_model 4096, 32 / 8 heads
# of 128), 8 experts top-2, 1 layer, the window cut to 128 so that it binds
# at S 384 (as moe_parity cuts it), B2 x S384 = 768 tokens, past
# models/moe.py's DENSE_TOKEN_THRESHOLD: the dispatch path and its drops.
# The expert width is cut from 14336 to 2048 so that the host holds the
# CPU run and the kept per-step updates of the three runs
MOE_PARITY_WINDOW, MOE_PARITY_S, MOE_PARITY_FF = 128, 384, 2048
# hybrid_train_parity: the CPU's plain SSD scan over chunks of 64 rows, the
# card kernel's own sub-chunk, instead of zamba2's 256: the same function,
# its decays' exponents summed over the same 64-row spans on both devices
# (over 256 rows the float32 sum of dt * A grows ~4x, and its rounding with
# it).
HYBRID_PARITY_CHUNK = 64
# hybrid_train_parity's run that pins nothing: its gradient norm from step
# 2 on, after the first update (step 0's LR is 0), held within
# TRAIN_GRAD_REL.  AdamW moves an element by about lr * sign(g), so the
# float32 rounding of near-zero gradient elements makes step 1's updates
# differ (ROADMAP hazard 10: zamba2's embed 3.0e-3, its a_log 1.1e-3), and
# through 12 mamba layers (two groups of 6) those params moved the
# next gradient's norm 3.19e-5 apart, on an NVIDIA H100 80GB HBM3 at 700 W.  The cause is
# the params, not the step: started from the CPU's params and moments, the
# card's step 2 gives the norm within 1.7e-6 (the pinned runs, held within
# TRAIN_METRIC_REL); pinning a_log and dt_bias alone leaves 3.13e-5,
# embed alone 2.43e-5
FREE_RUN_GRAD_NORM_REL = TRAIN_GRAD_REL
# picnic_decode: llama3-8b, B4, a prompt of 500 tokens and 32 greedy steps
# into a 1024-row cache split in two along the sequence over a (1, 2)
# ("data", "model") mesh, 512 rows a rank in 64-token blocks, so the steps
# write rows 500..531 across the boundary at 512; a float32 cut of
# PICNIC_F32_LAYERS layers held within PICNIC_F32_REL
PICNIC_MESH, PICNIC_B, PICNIC_MAX_LEN, PICNIC_PROMPT, PICNIC_NEW = (1, 2), 4, 1024, 500, 32
PICNIC_F32_LAYERS, PICNIC_F32_REL = 2, 1e-5
# bf16: the picnic step and the single-rank step differ only where the
# attention output rounds to bf16 from another float32 sum (two shards'
# partials combined, against one kernel's nine splits): an ulp on a few
# elements, carried through 32 layers.  Each (step, sequence) row of
# logits is held within this relative L2 distance of the single-rank row;
# a wrong shard or a mis-weighted partial moves a row by O(1)
PICNIC_BF16_ROW_REL = 0.05
PICNIC_TIMEOUT = 600                # seconds, each rank
# dp_train: llama3.2-1b data-parallel over two ranks on the one card (a
# (2, 1) ("data", "model") mesh over gloo, a file store, a 120 s collective
# timeout), params and AdamW state cut by param_specs(..., "train") /
# opt_state_specs; the train phase's hyper-parameters and PackedStream(0)'s
# global B8 x S1024, B4 a rank.  float32 cut to DP_F32_LAYERS layers for
# DP_F32_STEPS steps: loss, ce and grad_norm within TRAIN_METRIC_REL of rank
# 0's single-rank eager step on the full batch, each leaf's update within
# DP_UPDATE_REL (tests/test_torch_train.py's UPDATE_RTOL, hazard 10), the
# two ranks' gathered params bit-equal after every step.  bf16 (remat) at
# DP_BF16_LAYERS of the 16 layers (cut to make room for sp_train: the gloo
# collectives through the host are most of its time) for DP_BF16_STEPS
# steps: both ranks' losses bit-equal and falling;
# each step's loss within DP_BF16_LOSS_REL and gradient norm within
# DP_BF16_GNORM_REL of the single-rank steps (bf16 gradients of two B4
# shards summed against one B8 gradient, cuBLAS's other tiles at the other
# M; a gradient summed twice or not at all moves the norm 2x, a wrong token
# count the loss 2x)
DP_MESH, DP_F32_LAYERS, DP_F32_STEPS, DP_BF16_STEPS = (2, 1), 2, 3, 3
DP_BF16_LAYERS = 4
DP_UPDATE_REL, DP_BF16_LOSS_REL, DP_BF16_GNORM_REL = 1e-3, 1e-2, 5e-2
DP_TIMEOUT = 900                    # seconds, each rank
# sp_train: llama3.2-1b sequence-parallel over two ranks on the one card (a
# (1, 2) ("data", "model") mesh over gloo, ShardingCtx(sp_attention) over
# "model"), PackedStream(0)'s global B4 x S2048 on both ranks, each
# forward keeping its 1024 rows (rank 1's flash at q_offset 1024); the
# same steps, bars and layers as dp_train but bf16 at full depth (16
# layers, remat)
SP_MESH, SP_B, SP_S = (1, 2), 4, 2048
SP_OPTIONS = {"sp_attention": True, "seq_axes": ("model",), "dp_axes": ("data",)}
# the train phases whose flash forward the kernels phase times at their shape
TRAIN_MODEL_OF = {"train": "llama3.2-1b", "audio_train": "whisper", "hybrid_train": "zamba2",
                  "moe_train": "mixtral", "vlm_train": "paligemma"}


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


def softmax_work(x):
    """Bytes (x read once, the output written once) and float32 operations
    of the SCU softmax: per element the max, the subtraction, the segment's
    multiply and add, the sum and the scale (the segment select not
    counted)."""
    return 2 * x.numel() * x.element_size(), 6 * x.numel()


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


def cim_bound(x, wq, wscale):
    """The least time of the CIM product: the largest of its bytes at
    3.35 TB/s, its int8 operations at 1,979 TOP/s and its float32 ADC
    operations at the non-FMA float32 rate, half of PEAK_FLOPS["float32"]
    (67 TFLOP/s counts an FMA as two operations; none of these pairs into
    one), 33.5 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    nbytes, int8_ops, f32_ops = cim_work(x, wq, wscale)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(int8_ops / PEAK_FLOPS["int8"], f32_ops / (PEAK_FLOPS["float32"] / 2)) * 1e3
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
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = _demangle(line.split("'")[1]) + ": "
            elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {kernel}{line.strip()}")
    log("[build] seconds until each nvcc ended (a library's source, then its parts): "
        + "; ".join(f"{n} {', '.join(map(str, s))}" for n, s in sorted(_build.BUILD_SECONDS.items())))


def _demangle(symbol: str) -> str:
    """A kernel's mangled name as c++filt gives it, without its namespace
    and parameters, or as it is where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    out = out.replace("repro_torch::(anonymous namespace)::", "").removeprefix("void ")
    return out.split("(")[0] or symbol


def _check(torch, name, got, want, dtype, case, tol=None):
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    tol = TOL[dtype] if tol is None else tol
    log(f"[kernels] {name} {case}: max_abs_err={err:.3e} tol={tol:.1e}")
    if not finite or not err <= tol:
        raise AssertionError(f"{name} {case}: kernel disagrees with its plain "
                             f"version (max_abs_err {err}, tol {tol})")
    return err


def _check_flash(torch, got, want, dtype, case, pwl):
    """The flash kernel against its plain version: float32 within 2e-5;
    bfloat16 within 2**-6 and by the per-element rule of
    ``flash_attention.agreement`` (with PWL exp, a few rows may take the
    neighbouring segment at an edge)."""
    from repro_torch.kernels.flash_attention import agreement
    err = _check(torch, "flash_attention", got, want, dtype, case)
    _, ratio, rows_off, ok = agreement(got, want, pwl=pwl)
    log(f"[kernels] flash_attention {case}: worst element at {ratio:.3f} of its bound "
        + ("(2e-5)" if dtype == "float32" else
           f"(2**-7 |want| + 2**-12), {rows_off:.2e} of rows past it"))
    if not ok:
        raise AssertionError(f"flash_attention {case}: kernel breaks the agreement rule "
                             f"(worst element at {ratio} of its bound, {rows_off} of rows)")
    return err


# A float32 score lies within this of a PWL segment edge when its
# rounding (dot products of <= 128 terms in another order, ~1e-6) may put
# it on either side (ROADMAP hazard 4)
PWL_EDGE_EPS = 1e-5


def pwl_edge_scores(torch, q, cache_k, ctx, window, bt, b, h):
    """The PWL arguments of row (b, h) of a paged call on a contiguous
    cache that lie within PWL_EDGE_EPS of a segment edge (x = -8, ..., -1),
    computed in float64 as the kernel forms them: each kept key's score
    less the running max through its pool block, and each block's rescale
    m_prev - m_new.  Returns [(kind, key or block, x)]."""
    from repro_torch.kernels.pwl import SEG_EDGES
    hkv, d = cache_k.shape[2], q.shape[2]
    c = int(ctx[b])
    lo = max(c - window, 0) if window else 0
    s = cache_k[b, lo:c, h // (q.shape[1] // hkv)].double() @ q[b, h].double() * d ** -0.5
    blk = torch.arange(lo, c, device=s.device) // bt
    blk = blk - blk[0]
    bmax = torch.full((int(blk[-1]) + 1,), -math.inf, dtype=torch.float64, device=s.device)
    run = bmax.scatter_reduce(0, blk, s, "amax").cummax(0).values
    edges = torch.tensor(SEG_EDGES[:-1], dtype=torch.float64, device=s.device)
    found = []
    for kind, x, first in (("key", s - run[blk], lo), ("block", run[:-1] - run[1:], lo // bt + 1)):
        near = (x[:, None] - edges).abs().min(-1).values < PWL_EDGE_EPS
        found += [(kind, first + i, float(x[i])) for i in near.nonzero().flatten().tolist()]
    return found


def _check_paged(torch, got, want, dtype, case, pwl, edge_scores=None):
    """Windowed paged attention against its plain version: within TOL, and
    bfloat16 also by the per-element rule of ``flash_attention.agreement``
    (2**-7 |want| + 2**-12): over a window of 4096 unit-normal keys the
    outputs are of order 0.03, where TOL alone would pass a window shifted
    by a block.  float32 with PWL (``edge_scores(b, h)``, see
    ``pwl_edge_scores``): a row past TOL passes only where one of its PWL
    arguments lies within rounding of a segment edge, where the two
    versions may take neighbouring segments (ROADMAP hazard 4); every
    other row is held to TOL."""
    from repro_torch.kernels.flash_attention import agreement
    if edge_scores is not None:
        per_row = (got.float() - want.float()).abs().amax(-1)
        off = (per_row > TOL[dtype]).nonzero().tolist()
        for b, h in off:
            found = edge_scores(b, h)
            log(f"[kernels] paged_attention {case}: row b{b} h{h} off by "
                f"{per_row[b, h].item():.3e}; PWL arguments at a segment edge: {found}")
            if not found:
                raise AssertionError(f"paged_attention {case}: row b{b} h{h} disagrees "
                                     f"with no PWL argument at a segment edge")
        held = per_row <= TOL[dtype]
        log(f"[kernels] paged_attention {case}: {len(off)} of {per_row.numel()} rows past "
            f"{TOL[dtype]:.0e}, each at a segment edge; the other rows held to it")
        err = per_row.max().item()
        got, want = got[held], want[held]
        _check(torch, "paged_attention", got, want, dtype, case)
    else:
        err = _check(torch, "paged_attention", got, want, dtype, case)
    _, ratio, rows_off, ok = agreement(got, want, pwl=pwl)
    log(f"[kernels] paged_attention {case}: worst element at {ratio:.3f} of its bound "
        + ("(2e-5)" if dtype == "float32" else
           f"(2**-7 |want| + 2**-12), {rows_off:.2e} of rows past it"))
    if not ok:
        raise AssertionError(f"paged_attention {case}: kernel breaks the agreement rule "
                             f"(worst element at {ratio} of its bound, {rows_off} of rows)")
    return err


def _check_softmax(torch, got, want, case, tag="kernels"):
    from repro_torch.kernels.pwl_softmax import agreement
    err, share, ok = agreement(got, want)
    rule = ("1.0e-06" if got.dtype == torch.float32
            else "one bf16 step each, < 1% of nonzero elements differ")
    log(f"[{tag}] pwl_softmax {case}: max_abs_err={err:.3e}, "
        f"differing {share:.2e} of nonzero, tol {rule}")
    if not ok:
        raise AssertionError(f"pwl_softmax {case}: kernel disagrees with its plain "
                             f"version (max_abs_err {err}, differing {share}, tol {rule})")
    return err


def phase_kernels(torch, timer, results):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import (
        contiguous_block_tokens, identity_block_table, paged_attention_plain, split_plan)
    from repro_torch.kernels.ssd_scan import resident_ctas, ssd_scan_plain

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
            "design": ("PR 14: mma.sync m16n8k16 bf16 (P as hi + lo bf16), ldmatrix, "
                       "cp.async double-buffered K and V, persistent CTAs"
                       if dt == "bfloat16" else "PR 11: float32 SIMT"),
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
        err = _check_flash(torch, got, want, dt,
                           f"B{b} S{s} Hq{hq} Hkv{hkv} D{d} {dt} causal={causal} pwl={pwl}",
                           pwl)
        if i == 0:
            flash = flash_entry(q, k, v, err, dt)
        elif i == 4:
            extra.append(flash_entry(q, k, v, err, dt))
    torch.cuda.synchronize()
    flash_window_cases(torch, timer, randn, extra)

    # ---- paged attention (decode) -------------------------------------
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

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
        n_splits, bps = split_plan(b * hkv, table.shape[1], pk.shape[1], n_sms)
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
            "design": ("PR 14: split-KV (flash-decoding) + combine kernel, pool blocks "
                       "by 16-byte cp.async, float32 SIMT"),
            "n_splits": n_splits, "blocks_per_split": bps,
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
    # one long sequence: several pool blocks in each of n_splits > 1 splits
    # (exact), or one split over all 250 blocks in order (PWL)
    for dt, pwl in (("bfloat16", False), ("float32", False), ("bfloat16", True)):
        pcases.append(("long context bt16", dt, pwl,
                       scattered_case([4000], 16, dt, HQ, HKV, D)))
    paged = None
    for i, (what, dt, pwl, case) in enumerate(pcases):
        q, pk, pv, table, lens = case[:5]
        n_splits, bps = split_plan(q.shape[0] * pk.shape[2], table.shape[1], pk.shape[1],
                                   n_sms, use_pwl=pwl)
        if what.startswith("long") and (n_splits == 1) != pwl:
            raise AssertionError(f"paged_attention {what} pwl={pwl}: {n_splits} splits")
        got = ops.paged_attention(q, pk, pv, table, lens, use_pwl=pwl)
        want = paged_attention_plain(q, pk, pv, table, lens, use_pwl=pwl)
        torch.cuda.synchronize()
        err = _check(torch, "paged_attention", got, want, dt,
                     f"{what} B{q.shape[0]} ctx={lens.tolist()} {dt} pwl={pwl} "
                     f"splits {n_splits} x {bps} blocks")
        if (lens == 0).any():
            zero = got[lens == 0].float().abs().max().item()
            if zero != 0.0:
                raise AssertionError(f"paged_attention: context 0 gave {zero}, not 0")
        if i == 0:
            paged = paged_entry(case, err, dt)
        elif i == 4:
            extra.append(paged_entry(case, err, dt))
    torch.cuda.synchronize()
    paged_window_cases(torch, timer, randn, extra)
    audio_attention_cases(torch, timer, randn, extra)
    vlm_attention_cases(torch, timer, randn, extra)
    partial = paged_partial_cases(torch, timer, randn)

    # ---- SSD scan (mamba prefill) -------------------------------------
    def ssd_case(b, s, h, p, n, dt, memory, strided=False):
        if strided:         # as the mamba layer slices its conv output
            conv = randn((b, s, h * p + 2 * n), "float32")
            conv[..., h * p:] *= 0.3
            conv = conv.to(getattr(torch, dt))
            x = conv[..., :h * p].reshape(b, s, h, p)
            Bm, Cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        else:
            x, Bm, Cm = randn((b, s, h, p), dt), randn((b, s, n), dt, 0.3), randn((b, s, n), dt, 0.3)
        shift = {"short": 0.0, "long": -5.0}[memory]
        delta = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda") + shift)
        a_neg = -torch.exp(0.2 * torch.randn((h,), generator=gen, device="cuda"))
        return x, delta, a_neg, Bm, Cm

    def ssd_entry(args, err, dt, path=None):
        from repro_torch.kernels.ssd_scan import launch_key
        x, _, _, Bm, _ = args
        b, s, h, p = x.shape
        n = Bm.shape[-1]
        nbytes, flops = ssd_work(b, s, h, p, n, x.element_size())
        bms, by = bound(nbytes, flops, dt)
        return {
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:53",
            "design": "bf16 mma.sync m16n8k16, Att / x*w / state as hi + lo bf16 "
                      "terms, state in registers, cp.async double-buffered 32-row "
                      "sub-chunks, 3 CTAs per SM at N 128",
            "shape": f"b{b} S{s} H{h} P{p} N{n} {dt} chunk{SSM_CHUNK}"
                     + (", strided x/B/C" if path else ""),
            "max_abs_err": err,
            **({"path": path, "launch_key": launch_key(x, Bm)} if path else {}),
            "ms": timer.ms(lambda: ops.ssd_scan(*args, chunk=SSM_CHUNK), 20),
            "plain_ms": timer.ms(lambda: ssd_scan_plain(*args, SSM_CHUNK), 5),
            "library_ms": None,       # no single PyTorch call computes it
            "bound_ms": bms, "bound_by": by,
            "resident_ctas_per_sm": resident_ctas(p, n, x.dtype),
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
        (1, 2048, 8, SSM_P, 128, "bfloat16", "short"),             # 64 sub-chunks
        (1, 2048, 8, SSM_P, 128, "bfloat16", "long"),
    ]
    # the train shapes, x / B / C the strided views the mamba layer passes:
    # mamba2's (ssm_train) and zamba2's (hybrid_train)
    strided_cases = {(SSM_TRAIN_B, SSM_TRAIN_S, SSM_H, SSM_P, 128, "bfloat16", "short"): "ssm_train",
                     (HYBRID_TRAIN_B, HYBRID_TRAIN_S, SSM_H, SSM_P, 64, "bfloat16", "short"):
                         "hybrid_train"}
    scases += list(strided_cases)
    for n in (128, 64):
        for dt in ("bfloat16", "float32"):
            log(f"[kernels] ssd_scan P{SSM_P} N{n} {dt}: "
                f"{resident_ctas(SSM_P, n, getattr(torch, dt))} CTAs resident per SM")
    ssd = None
    for i, case in enumerate(scases):
        b, s, h, p, n, dt, memory = case
        path = strided_cases.get(case) if i >= len(scases) - len(strided_cases) else None
        args = ssd_case(b, s, h, p, n, dt, memory, strided=path is not None)
        y, state = ops.ssd_scan(*args, chunk=SSM_CHUNK)
        want_y, want_state = ssd_scan_plain(*args, SSM_CHUNK)
        torch.cuda.synchronize()
        what = (f"b{b} S{s} H{h} P{p} N{n} {dt} {memory} memory"
                + (f", strided x/B/C ({path})" if path else ""))
        errs = []
        for name, got, want in (("y", y, want_y), ("state", state, want_state)):
            tol = (TOL_SSD if memory == "short"
                   else TOL_SSD_REL * want.abs().max().item())
            errs.append(_check(torch, "ssd_scan", got, want, dt, f"{what} {name}", tol))
        if path:
            flat = (args[0].contiguous(), *args[1:3], args[3].contiguous(), args[4].contiguous())
            again = ops.ssd_scan(*flat, chunk=SSM_CHUNK)
            if not all(torch.equal(a, c) for a, c in zip((y, state), again)):
                raise AssertionError(f"ssd_scan {what}: the views and contiguous copies differ")
        if i == 0:
            ssd = ssd_entry(args, max(errs), dt)
        elif i == 2 or path:
            extra.append(ssd_entry(args, max(errs), dt, path))
    torch.cuda.synchronize()

    softmax = phase_kernels_softmax(torch, timer, randn, extra)
    cim = phase_kernels_cim(torch, timer, randn, extra)

    flash_bwd = flash_bwd_cases(torch, timer, randn, extra)
    ssd_bwd = ssd_bwd_cases(torch, timer, randn, extra)
    offset_fwd, offset_bwd = flash_offset_cases(torch, timer, randn)

    results["kernels"] = [flash, paged, ssd, softmax, cim, flash_bwd, ssd_bwd, partial,
                          offset_fwd, offset_bwd]
    results["kernels_other_shapes"] = extra
    for kern in results["kernels"] + extra:
        lib = kern["library_ms"]
        log(f"[kernels] {kern['name']} at {kern['shape']}: kernel {kern['ms']:.4f} ms, "
            f"plain {kern['plain_ms']:.4f} ms, library "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + f", bound {kern['bound_ms']:.5f} ms ({kern['bound_by']})")


def kept_pairs(sq, skv, causal=True, window=None, prefix_len=0, q_offset=0):
    """The (query, key) pairs a head keeps: under the causal mask the keys
    at or before the query and those below ``prefix_len``, under a window
    (an int or None) those fewer than ``window`` positions before it, of
    ``skv`` keys; query i at position ``q_offset + i``."""
    total = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(max(i + 1, prefix_len), skv) if causal else skv
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def bwd_work(b, sq, skv, hq, hkv, d, esize, causal=True, window=None, prefix_len=0,
             q_offset=0):
    """Bytes (q, k, v, out, dout and the float32 lse read once; dq, dk,
    dv written once) and FLOPs of attention's backward: five products of
    2 * D per (query, key) pair the mask keeps (S, dP, dV, dK, dQ): causal,
    the pairs with kpos <= qpos or kpos < prefix_len, else sq * skv a head;
    a window keeps only the pairs with qpos - kpos < window
    (``kept_pairs``)."""
    pairs = kept_pairs(sq, skv, causal, window, prefix_len, q_offset)
    nbytes = (4 * b * sq * hq * d + 4 * b * skv * hkv * d) * esize + b * hq * sq * 4
    return nbytes, 5 * 2 * b * hq * d * pairs


def flash_bwd_cases(torch, timer, randn, extra):
    """The flash backward kernel (``flash_attention_bwd_cuda``) against its
    plain version (``flash_attention_bwd_plain``, explicit P) on dQ, dK and
    dV by ``flash_attention.bwd_agreement``: llama3.2-1b's train shape (the
    main path), llama3-8b's B4 S512 D128, the smoke D 32, ragged S 1, 129
    and 1000, float32 at train_parity's shape, a NaN in dout and in k
    (non-finite in the same places); without the causal mask whisper's
    train shapes (the encoder B8 S1500 H20 D64, bf16 and float32, and the
    cross-attention of 448 text rows over 1500 frames), ragged GQA with Sq
    != Skv, and a NaN in dout and in k; at D 80 zamba2's train shape (B8
    S1024 H32, MHA), bf16 and float32; under a sliding window mixtral's
    train shape (B2 S4160 Hq32 Hkv8 D128, window 4096), bf16, and
    moe_train_parity's (B2 S384, window 128), float32, windows 1, 100 and
    130 at B4 S512, ragged S under a window, and a NaN in dout and in k
    under windows 100 and 130; with paligemma's bidirectional prefix and at
    its D 256 (8 query heads on one KV head): its train shape B4 S1280 with
    a prefix of 256, bf16, vlm_train_parity's B2 S384, float32, D 256
    without a prefix, prefixes of 100 and past S (200 at S 129), a prefix
    of 256 at llama3.2-1b's D 64 and llama3-8b's D 128 (B4 S512), ragged S
    (1000; 77 in float32), and a NaN in dout and in k inside the prefix and
    outside it.  Each case also holds the forward with the lse output
    bit-equal to the forward without it (under its window or prefix), the
    lse to the plain version's, and two runs of the backward bit-equal (no
    atomics).  The timed cases are timed with the plain version and SDPA's
    backward (fwd + bwd through ``scaled_dot_product_attention(enable_gqa=
    True)`` with ``is_causal`` or, under a window or a prefix, the same
    boolean mask, minus its forward, a yardstick).  Returns the main
    entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    WB, WS = AUDIO_TRAIN_B, AUDIO_TRAIN_S
    ZB, ZS = HYBRID_TRAIN_B, HYBRID_TRAIN_S
    MB, MS = MOE_TRAIN_B, MOE_TRAIN_S
    VB, VS, VPS = VLM_TRAIN_B, V_PREFIX + VLM_TRAIN_S, V_PREFIX + VLM_PARITY_S
    cases = [  # B, Sq, Skv, Hq, Hkv, D, dtype, causal, window, prefix, NaN in,
        # path, timed
        (TRAIN_B, TRAIN_S, TRAIN_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D, "bfloat16", True, None, 0, None,
         "train", True),                                                         # main path
        (B_MAIN, PROMPT, PROMPT, HQ, HKV, D, "bfloat16", True, None, 0, None, "train",
         True),                                                                  # llama3-8b
        (2, 256, 256, TRAIN_HQ, TRAIN_HKV, TRAIN_D, "float32", True, None, 0, None, "train_parity",
         True),
        (WB, W_FRAMES, W_FRAMES, WH, WH, WD, "bfloat16", False, None, 0, None, "audio_train",
         True),                                                                  # whisper encoder
        (WB, WS, W_FRAMES, WH, WH, WD, "bfloat16", False, None, 0, None, "audio_train",
         True),                                                                  # cross
        (WB, W_FRAMES, W_FRAMES, WH, WH, WD, "float32", False, None, 0, None, None, True),
        (ZB, ZS, ZS, ZH, ZH, ZD, "bfloat16", True, None, 0, None, "hybrid_train",
         True),                                                                  # zamba2, D 80
        (ZB, ZS, ZS, ZH, ZH, ZD, "float32", True, None, 0, None, None, True),
        (MB, MS, MS, HQ, HKV, D, "bfloat16", True, MIX_WINDOW, 0, None, "moe_train",
         True),                                                                  # mixtral, window
        (2, MOE_PARITY_S, MOE_PARITY_S, HQ, HKV, D, "float32", True, MOE_PARITY_WINDOW, 0, None,
         "moe_train_parity", True),
        (B_MAIN, PROMPT, PROMPT, HQ, HKV, D, "bfloat16", True, 1, 0, None, None, True),
        (B_MAIN, PROMPT, PROMPT, HQ, HKV, D, "bfloat16", True, 100, 0, None, None, True),
        (B_MAIN, PROMPT, PROMPT, HQ, HKV, D, "bfloat16", True, 130, 0, None, None, True),
        (B_MAIN, PROMPT, PROMPT, HQ, HKV, D, "float32", True, 130, 0, None, None, False),
        (2, 64, 64, 4, 2, 32, "bfloat16", True, None, 0, None, None, False),        # smoke
        (2, 64, 64, 4, 2, 32, "float32", True, None, 0, None, None, False),
        (2, 1, 1, 8, 2, 64, "float32", True, None, 0, None, None, False),           # ragged S
        (2, 1, 1, 4, 1, 128, "bfloat16", True, None, 0, None, None, False),
        (1, 129, 129, 8, 2, 64, "bfloat16", True, None, 0, None, None, False),
        (1, 129, 129, 4, 4, 128, "float32", True, None, 0, None, None, False),
        (2, 1000, 1000, 8, 2, 64, "bfloat16", True, None, 0, None, None, False),
        (1, 1000, 1000, 4, 1, 32, "float32", True, None, 0, None, None, False),
        (1, 1000, 1000, 8, 2, 80, "bfloat16", True, 130, 0, None, None, False),     # ragged, window
        (2, 77, 77, 4, 1, 80, "float32", True, 17, 0, None, None, False),
        (1, 130, 333, 8, 2, 128, "bfloat16", False, None, 0, None, None, False),    # ragged GQA
        (2, 77, 200, 4, 1, 32, "float32", False, None, 0, None, None, False),
        (2, 333, 1, 8, 2, 64, "bfloat16", False, None, 0, None, None, False),
        (1, 300, 300, 4, 1, 64, "float32", True, None, 0, "dout", None, False),     # NaN in dout
        (1, 300, 300, 8, 2, 128, "bfloat16", True, None, 0, "dout", None, False),
        (1, 300, 300, 8, 2, 64, "bfloat16", True, None, 0, "k", None, False),       # NaN in k
        (1, 200, 300, 8, 2, 64, "bfloat16", False, None, 0, "dout", None, False),
        (1, 300, 200, 4, 1, 64, "float32", False, None, 0, "k", None, False),
        (1, 512, 512, 8, 2, 128, "bfloat16", True, 100, 0, "dout", None, False),    # windowed NaN
        (1, 512, 512, 8, 2, 128, "bfloat16", True, 130, 0, "k", None, False),
        (1, 512, 512, 4, 1, 80, "float32", True, 130, 0, "dout", None, False),
        (1, 512, 512, 4, 1, 64, "float32", True, 100, 0, "k", None, False),
        # paligemma: the bidirectional prefix, D 256 (8 query heads on one KV head)
        (VB, VS, VS, VH, 1, VD, "bfloat16", True, None, V_PREFIX, None, "vlm_train", True),
        (2, VPS, VPS, VH, 1, VD, "float32", True, None, V_PREFIX, None, "vlm_train_parity",
         True),
        (VB, VS, VS, VH, 1, VD, "bfloat16", True, None, 0, None, None, True),   # no prefix
        (2, 300, 300, VH, 1, VD, "bfloat16", True, None, 100, None, None, True),
        (2, 129, 129, VH, 1, VD, "bfloat16", True, None, 200, None, None, True),  # prefix > S
        (B_MAIN, PROMPT, PROMPT, TRAIN_HQ, TRAIN_HKV, TRAIN_D, "bfloat16", True, None, V_PREFIX,
         None, None, True),
        (B_MAIN, PROMPT, PROMPT, HQ, HKV, D, "bfloat16", True, None, V_PREFIX, None, None, True),
        (1, 1000, 1000, VH, 1, VD, "bfloat16", True, None, V_PREFIX, None, None, False),
        (1, 77, 77, 4, 1, VD, "float32", True, None, 16, None, None, False),       # ragged S
        (1, 600, 600, VH, 1, VD, "bfloat16", True, None, 100, "dout", None, False),
        (1, 600, 600, VH, 1, VD, "bfloat16", True, None, 100, "dout@P", None, False),
        (1, 600, 600, VH, 1, VD, "bfloat16", True, None, 100, "k", None, False),
        (1, 600, 600, VH, 1, VD, "bfloat16", True, None, 100, "k@P", None, False),
        (1, 300, 300, 4, 1, VD, "float32", True, None, 100, "k", None, False),
        (1, 300, 300, 4, 1, VD, "float32", True, None, 100, "dout@P", None, False),
    ]
    main = None
    for i, (b, sq, skv, hq, hkv, d, dt, causal, window, prefix, nan, path,
            timed) in enumerate(cases):
        q = randn((b, sq, hq, d), dt)
        k, v = (randn((b, skv, hkv, d), dt) for _ in range(2))
        # a NaN at row sq // 2 of dout or key skv // 3 of k, or ("@P") at
        # prefix // 2, inside the prefix
        if nan in ("k", "k@P"):
            k[0, prefix // 2 if nan == "k@P" else skv // 3, 0, 3] = float("nan")
        kw = dict(causal=causal, use_pwl=False, window=window or 0, prefix_len=prefix)
        out0, _ = fa._flash_fwd(q, k, v, with_lse=False, **kw)
        out, lse = fa._flash_fwd(q, k, v, with_lse=True, **kw)
        _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                prefix_len=prefix, return_lse=True)
        g = randn((b, sq, hq, d), dt)
        if nan in ("dout", "dout@P"):
            g[0, prefix // 2 if nan == "dout@P" else sq // 2, hq - 1, 5] = float("nan")
        bkw = dict(causal=causal, window=window, prefix_len=prefix)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **bkw)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **bkw)
        torch.cuda.synchronize()
        shape = (f"B{b} Sq{sq} Skv{skv} Hq{hq} Hkv{hkv} D{d} {dt} "
                 + ("causal" if causal else "non-causal")
                 + (f" window {window}" if window else "") + (f" prefix {prefix}" if prefix else "")
                 + (f" NaN in {nan}" if nan else ""))
        if not torch.equal(out0.nan_to_num(), out.nan_to_num()) or \
                not torch.equal(out0.isnan(), out.isnan()):
            raise AssertionError(f"flash_attention {shape}: the forward with lse is not "
                                 "bit-equal to the forward without it")
        lse_err = (lse - lse_plain).nan_to_num().abs().max().item()
        if not (lse_err <= 1e-5 and torch.equal(lse.isnan(), lse_plain.isnan())):
            raise AssertionError(f"flash_attention {shape}: lse off by {lse_err}")
        errs = []
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err, ratio, ok = fa.bwd_agreement(a, w)
            nonfinite = int((~torch.isfinite(w.float())).sum())
            log(f"[kernels] flash_attention_bwd {shape} {name}: max_abs_err={err:.3e} "
                f"({ratio:.3f} of the bound), {nonfinite} non-finite"
                + (" in the same places" if ok or nonfinite == 0 else ""))
            if not ok:
                raise AssertionError(f"flash_attention_bwd {shape} {name} disagrees with "
                                     f"its plain version ({err:.3e}, {ratio:.3f} of the bound)")
            if nan and nonfinite == 0:
                raise AssertionError(f"flash_attention_bwd {shape}: the NaN was dropped")
            errs.append(err)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **bkw)
        if not all(torch.equal(a.nan_to_num(), c.nan_to_num()) and
                   torch.equal(a.isnan(), c.isnan()) for a, c in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {shape}: two runs differ")
        log(f"[kernels] flash_attention_bwd {shape}: two runs bit-equal")
        del got, want, again
        if not timed:
            continue
        nbytes, flops = bwd_work(b, sq, skv, hq, hkv, d, q.element_size(), causal, window,
                                 prefix)
        bms, by = bound(nbytes, flops, dt)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        gt = g.transpose(1, 2)
        mask = (window_mask(torch, sq, skv, window, causal) if window else
                prefix_mask(torch, sq, prefix) if prefix else None)

        def sdpa_fwd():
            if mask is not None:
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

        entry = {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:153",
            "design": ("no Pallas kernel (the reference differentiates "
                       "full_attention / flash_attention with XLA's autodiff); Delta + "
                       "dK/dV (a CTA per 64 keys over the group's query heads) + dQ (a CTA "
                       "per 64 query rows), no atomics; "
                       + ("bf16 mma.sync m16n8k16, P and dS as hi + lo bf16, the 16 x 16 "
                          "blocks the mask cuts pair by pair" if dt == "bfloat16" else
                          "float32 SIMT")
                       + ("" if causal else "; no causal mask, Sq != Skv")
                       + (f"; sliding window {window} (the tiles of the window only)"
                          if window else "")
                       + (f"; bidirectional prefix {prefix} (kernels compiled apart)"
                          if prefix else "")
                       + ("; D 256: dK / dV columns split over two CTAs"
                          if d == 256 and dt == "bfloat16" else
                          "; D 256: 32-row SIMT tiles" if d == 256 else "")),
            "shape": shape, "max_abs_err": max(errs),
            "launch_key": fa.launch_key(q, k, causal=causal, window=window, prefix_len=prefix),
            "ms": timer.ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **bkw), 10),
            "plain_ms": timer.ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                                      **bkw), 3),
            "library_ms": max(timer.ms(sdpa_fwd_bwd, 10) - timer.ms(sdpa_fwd, 10), 0.0),
            "bound_ms": bms, "bound_by": by,
        }
        if i == 0:
            main = entry
        else:
            if path is not None:
                entry["path"] = path
            extra.append(entry)
        if path in TRAIN_MODEL_OF and (i == 0 or path != "train"):
            # the forward of the same shape, launched twice a layer and step
            ferr = _check_flash(torch, out, fa.flash_attention_plain(
                q, k, v, causal=causal, window=window, prefix_len=prefix), dt,
                f"{TRAIN_MODEL_OF[path]} train forward {shape}", False)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            fbms, fby = bound(nbytes, 4 * b * hq * d * kept_pairs(sq, skv, causal, window, prefix),
                              dt)
            extra.append({
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:76",
                "design": "the mma.sync path with the lse output (training)"
                          + ("" if causal else ", non-causal")
                          + (f", window {window}" if window else "")
                          + (f", prefix {prefix}" if prefix else ""),
                "shape": f"{TRAIN_MODEL_OF[path]} train: {shape}, lse out",
                "max_abs_err": ferr,
                "path": path, "launch_key": fa.launch_key(q, k, causal=causal, window=window,
                                                          prefix_len=prefix),
                "ms": timer.ms(lambda: fa._flash_fwd(q, k, v, with_lse=True, **kw), 10),
                "plain_ms": timer.ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window, prefix_len=prefix), 3),
                "library_ms": timer.ms(sdpa_fwd, 10),
                "bound_ms": fbms, "bound_by": fby,
            })
        del q, k, v, out, lse, g, qt, kt, vt, gt, mask
    torch.cuda.synchronize()
    return main


def offset_mask(torch, sq, skv, q_offset, causal=True, window=None, prefix_len=0):
    """The boolean (sq, skv) mask of query i at position ``q_offset + i``
    (True: attend), for SDPA's ``attn_mask``."""
    qpos = torch.arange(q_offset, q_offset + sq, device="cuda")[:, None]
    kpos = torch.arange(skv, device="cuda")[None, :]
    keep = (kpos <= qpos) | (kpos < prefix_len) if causal else torch.ones_like(kpos <= qpos)
    if window:
        keep &= qpos - kpos < window
    return keep


def flash_offset_cases(torch, timer, randn):
    """The flash forward (with and without its lse output) and backward
    with ``q_offset`` (sequence-parallel attention's rank: query i at
    position q_offset + i against every key of the sequence) against their
    plain versions, by ``flash_attention.agreement`` / ``bwd_agreement``,
    the lse within 1e-5: offsets 0, 1, 250 and 1024 (off the 16-row blocks
    and on the 64-row tiles), causal, under a window of 100, with a prefix
    of 300, without the causal mask, Sq < Skv, bf16 and float32; the
    ``sp_train`` phase's shapes (llama3.2-1b, B4 Sq1024 Skv2048 Hq32 Hkv8
    D64, rank 1 at offset 1024, rank 0 at 0; bf16 and float32) and
    ``picnic_decode``'s sequence-parallel prefill (llama3-8b, B4 Sq250
    Skv500 D128, rank 1 at offset 250; bf16), every backward twice,
    bit-equal.  Rank 1's sp_train shape in bf16 is timed, forward with lse
    and backward, beside the plain versions, SDPA under the same boolean
    offset mask and the bound.  Returns the two timed entries."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    rows = SP_S // (SP_MESH[0] * SP_MESH[1])     # a sp_train rank's
    cases = [  # B, Sq, Skv, Hq, Hkv, D, dtype, causal, window, prefix, q_offset, backward
        (SP_B, rows, SP_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D, "bfloat16", True, None, 0, rows, True),
        (SP_B, rows, SP_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D, "bfloat16", True, None, 0, 0, True),
        (SP_B, rows, SP_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D, "float32", True, None, 0, rows, True),
        (PICNIC_B, PICNIC_PROMPT // 2, PICNIC_PROMPT, HQ, HKV, D, "bfloat16", True, None, 0,
         PICNIC_PROMPT // 2, False),
    ]
    for off in (0, 1, 250, 1024):
        for dt in ("bfloat16", "float32"):
            for causal, window, prefix in ((True, None, 0), (True, 100, 0), (True, None, 300),
                                           (False, None, 0)):
                cases.append((2, 300, off + 337, 8, 2, 64, dt, causal, window, prefix, off, True))
    timed = []
    for i, (b, sq, skv, hq, hkv, d, dt, causal, window, prefix, off, bwd) in enumerate(cases):
        q = randn((b, sq, hq, d), dt)
        k, v = (randn((b, skv, hkv, d), dt) for _ in range(2))
        kw = dict(causal=causal, window=window, prefix_len=prefix, q_offset=off)
        shape = (f"B{b} Sq{sq} Skv{skv} Hq{hq} Hkv{hkv} D{d} {dt} "
                 + ("causal" if causal else "non-causal") + (f" window {window}" if window else "")
                 + (f" prefix {prefix}" if prefix else "") + f" q_offset {off}")
        fkw = dict(causal=causal, use_pwl=False, window=window or 0, prefix_len=prefix,
                   q_offset=off)
        out0, _ = fa._flash_fwd(q, k, v, with_lse=False, **fkw)
        out, lse = fa._flash_fwd(q, k, v, with_lse=True, **fkw)
        want, lse_plain = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out0, out):
            raise AssertionError(f"flash_attention {shape}: the forward with lse is not "
                                 "bit-equal to the forward without it")
        lse_err = (lse - lse_plain).abs().max().item()
        if not lse_err <= 1e-5:
            raise AssertionError(f"flash_attention {shape}: lse off by {lse_err}")
        ferr = _check_flash(torch, out, want, dt, shape, False)
        berrs = []
        if bwd:
            g = randn((b, sq, hq, d), dt)
            got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)
            plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
            again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)
            torch.cuda.synchronize()
            for name, a, w in zip(("dq", "dk", "dv"), got, plain):
                err, ratio, ok = fa.bwd_agreement(a, w)
                if not ok:
                    raise AssertionError(f"flash_attention_bwd {shape} {name} disagrees with "
                                         f"its plain version ({err:.3e}, {ratio:.3f} of the bound)")
                berrs.append(err)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {shape}: two runs differ")
            del got, plain, again
        log(f"[kernels] flash_attention {shape}: forward max_abs_err={ferr:.3e}, lse "
            f"{lse_err:.3e}" + (f"; backward max_abs_err={max(berrs):.3e}, two runs bit-equal"
                               if bwd else ""))
        if i == 0:                          # sp_train rank 1, timed
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            gt = g.transpose(1, 2)
            mask = offset_mask(torch, sq, skv, off, causal, window, prefix)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

            key = fa.launch_key(q, k, causal=causal, window=window, prefix_len=prefix,
                                q_offset=off)
            pairs = kept_pairs(sq, skv, causal, window, prefix, off)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            fbms, fby = bound(nbytes, 4 * b * hq * d * pairs, dt)
            bbytes, bflops = bwd_work(b, sq, skv, hq, hkv, d, q.element_size(), causal, window,
                                      prefix, off)
            bbms, bby = bound(bbytes, bflops, dt)
            sdpa_ms = timer.ms(sdpa_fwd, 10)
            common = {"route": "cuda", "mode": "q_offset", "path": "sp_train", "launch_key": key,
                      "shape": f"sp_train rank 1: {shape}"}
            timed = [{
                "name": "flash_attention", **common,
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:76",
                "design": "the mma.sync path with the lse output and q_offset: the masks read "
                          "the global row, tiles stay local, steps at absolute keys",
                "max_abs_err": ferr,
                "ms": timer.ms(lambda: fa._flash_fwd(q, k, v, with_lse=True, **fkw), 10),
                "plain_ms": timer.ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 3),
                "library_ms": sdpa_ms, "bound_ms": fbms, "bound_by": fby,
            }, {
                "name": "flash_attention_bwd", **common,
                "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                "replaces": "src/repro/models/attention.py:153",
                "design": "q_offset: tiles stay local, the masks read the global row; a "
                          "multiple of 64 keeps the diagonal mode, any other offset runs the "
                          "window's kernels with a window wider than any sequence, blocks "
                          "sorted by block_kept",
                "max_abs_err": max(berrs),
                "ms": timer.ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw),
                               10),
                "plain_ms": timer.ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                                          **kw), 3),
                "library_ms": max(timer.ms(sdpa_fwd_bwd, 10) - sdpa_ms, 0.0),
                "bound_ms": bbms, "bound_by": bby,
            }]
            del qt, kt, vt, gt, mask
        del q, k, v, out, out0, lse, want, lse_plain
    torch.cuda.synchronize()
    return timed


def ssd_bwd_work(b, s, h, p, n, esize, with_dstate):
    """Bytes (x, dt, A, B, C, y, dy, and the final state and its gradient
    where one is given, read once; dx, ddt, dA, dB, dC written once) and
    FLOPs of the SSD backward's recurrent form, the least the function
    needs whatever its chunking: per row and head the carried gradient g
    (its decay and the rank-1 dy ⊗ C, 3·P·N), du = g·B (2·P·N), gᵀ·u into
    dB (2·P·N), the state again (3·P·N) and hᵀ·dy into dC (2·P·N)."""
    flops = 12 * b * s * h * p * n
    nbytes = (2 * (b * s * h * p + 2 * b * s * n) * esize + 2 * (b * s * h + h) * 4
              + 2 * b * s * h * p * 4 + (2 * b * h * p * n * 4 if with_dstate else 0))
    return nbytes, flops


def ssd_bwd_cases(torch, timer, randn, extra):
    """The SSD backward kernel (``ssd_scan_bwd_cuda``) against its plain
    version (``ssd_scan_bwd_plain``, fed the forward kernel's y and state as
    the kernel is) on dx, ddt, da_neg, dB and dC by
    ``ssd_scan.bwd_agreement``: mamba2's train shape b8 S1024 H80 P64 N128
    with x, B and C the strided bf16 views the mamba layer passes (the main
    path) and as float32, zamba2's N 64, ragged S, long memory (dt ~ 0.01)
    at S 2048, the smoke widths, with and without a gradient of the final
    state; every case twice, bit-equal (no atomics), and the strided views
    bit-equal to contiguous copies.  Timed with the plain version; no
    PyTorch call computes it.  Returns the main entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [  # b, S, H, P, N, dtype, memory, dstate given, strided views
        (SSM_TRAIN_B, SSM_TRAIN_S, SSM_H, SSM_P, 128, "bfloat16", "short", False, True),
        (SSM_TRAIN_B, SSM_TRAIN_S, SSM_H, SSM_P, 128, "float32", "short", True, False),
        (SSM_TRAIN_B, SSM_TRAIN_S, SSM_H, SSM_P, 64, "bfloat16", "short", True, True),  # zamba2
        (2, 300, 16, SSM_P, 64, "bfloat16", "long", True, False),                       # ragged S
        (1, 100, 8, SSM_P, 128, "float32", "short", False, False),
        (1, 2048, 8, SSM_P, 128, "bfloat16", "long", False, False),                     # long memory
        (1, 2048, 8, SSM_P, 128, "float32", "long", True, False),
        (2, 77, 8, 32, 16, "float32", "short", True, False),                            # smoke
        (3, 130, 4, 32, 32, "bfloat16", "long", False, True),
    ]
    main = None
    for i, (b, s, h, p, n, dt, memory, with_dstate, strided) in enumerate(cases):
        if strided:         # as the mamba layer slices its conv output
            conv = randn((b, s, h * p + 2 * n), "float32")
            conv[..., h * p:] *= 0.3
            conv = conv.to(getattr(torch, dt))
            x = conv[..., :h * p].reshape(b, s, h, p)
            Bm, Cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        else:
            x, Bm, Cm = randn((b, s, h, p), dt), randn((b, s, n), dt, 0.3), randn((b, s, n), dt, 0.3)
        shift = {"short": 0.0, "long": -5.0}[memory]
        delta = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda") + shift)
        a_neg = -torch.exp(0.2 * torch.randn((h,), generator=gen, device="cuda"))
        args = (x, delta, a_neg, Bm, Cm)
        y, state = ss.ssd_scan_cuda(*args)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dstate = (torch.randn((b, h, p, n), generator=gen, device="cuda")
                  if with_dstate else None)
        got = ss.ssd_scan_bwd_cuda(*args, y, state, dy, dstate)
        again = ss.ssd_scan_bwd_cuda(*args, y, state, dy, dstate)
        want = ss.ssd_scan_bwd_plain(*args, dy, dstate, SSM_CHUNK, y=y, state=state)
        f64 = [t.double() if t is not None else None for t in (*args, dy, dstate, y, state)]
        exact = ss.ssd_scan_bwd_plain(*f64[:7], SSM_CHUNK, y=f64[7], state=f64[8])
        torch.cuda.synchronize()
        shape = (f"b{b} S{s} H{h} P{p} N{n} {dt} {memory} memory, dstate "
                 + ("given" if with_dstate else "absent") + (", strided x/B/C" if strided else ""))
        errs = []
        for name, a, w, x64 in zip(ss.BWD_NAMES, got, want, exact):
            err, ratio, ok = ss.bwd_agreement(a, w, name, exact=x64)
            top = x64.abs().max().item()
            log(f"[kernels] ssd_scan_bwd {shape} {name}: max_abs_err={err:.3e} "
                f"({ratio:.3f} of the bound); from float64, relative to its max: kernel "
                f"{(a.double() - x64).abs().max().item() / top:.2e}, plain "
                f"{(w.double() - x64).abs().max().item() / top:.2e}")
            if not ok:
                raise AssertionError(f"ssd_scan_bwd {shape} {name} disagrees with its plain "
                                     f"version ({err:.3e}, {ratio:.3f} of the bound)")
            errs.append(err)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"ssd_scan_bwd {shape}: two runs differ")
        if strided:
            flat = (x.contiguous(), delta, a_neg, Bm.contiguous(), Cm.contiguous())
            if not all(torch.equal(a, c) for a, c in
                       zip(got, ss.ssd_scan_bwd_cuda(*flat, y, state, dy, dstate))):
                raise AssertionError(f"ssd_scan_bwd {shape}: the views and contiguous "
                                     "copies give different gradients")
        log(f"[kernels] ssd_scan_bwd {shape}: two runs bit-equal"
            + (", views = contiguous copies" if strided else ""))
        del got, again, want, exact, f64
        if i > 2:
            continue
        nbytes, flops = ssd_bwd_work(b, s, h, p, n, x.element_size(), with_dstate)
        bms, by = bound(nbytes, flops, dt)
        entry = {
            "name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:76",
            "design": ("no Pallas kernel (the reference differentiates ssd_chunked "
                       "with XLA's autodiff); a CTA per (batch, head) for each of two walks "
                       "over 32-row sub-chunks (in order: h0 and dC; in reverse: G, dx, ddt, "
                       "dB, da), float32 SIMT, register-tiled products over shared memory, "
                       "per-head shares of dB / dC / da_neg summed in a fixed order"),
            "shape": shape, "max_abs_err": max(errs),
            "launch_key": ss.launch_key(x, Bm),
            "ms": timer.ms(lambda: ss.ssd_scan_bwd_cuda(*args, y, state, dy, dstate), 10),
            "plain_ms": timer.ms(lambda: ss.ssd_scan_bwd_plain(*args, dy, dstate, SSM_CHUNK,
                                                               y=y, state=state), 3),
            "library_ms": None,       # no single PyTorch call computes it
            "bound_ms": bms, "bound_by": by,
        }
        if i == 0:
            main = entry
        else:
            extra.append(entry)
    torch.cuda.synchronize()
    return main


def window_mask(torch, sq, skv, window, causal=True):
    """(sq, skv) bool: the keys a query sees under a sliding window (and
    the causal mask), the yardstick's mask for scaled_dot_product_attention."""
    qpos = torch.arange(sq, device="cuda")[:, None]
    kpos = torch.arange(skv, device="cuda")[None, :]
    valid = (qpos - kpos) < window
    return valid & (qpos >= kpos) if causal else valid


def flash_window_cases(torch, timer, randn, extra):
    """Flash attention under a sliding window against its plain version:
    mixtral's long prefill (B1 S4160, window 4096: rows past 4095 lose
    their oldest keys) in bf16 and float32, mixtral's B4 S512 prefill shape
    with windows of 100 and 130 (rows whose window starts inside a 128-key
    step, tiles that skip steps), PWL under a window; the bf16 main shapes
    timed beside SDPA with the same boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    cases = [  # B, S, Hq, Hkv, D, dtype, window, pwl, timed
        (1, MIX_LONG, HQ, HKV, D, "bfloat16", MIX_WINDOW, False, True),
        (1, MIX_LONG, HQ, HKV, D, "float32", MIX_WINDOW, False, False),
        (B_MAIN, PROMPT, HQ, HKV, D, "bfloat16", 100, False, True),
        (B_MAIN, PROMPT, HQ, HKV, D, "bfloat16", 130, False, False),
        (B_MAIN, PROMPT, HQ, HKV, D, "float32", 130, False, False),
        (B_MAIN, PROMPT, HQ, HKV, D, "bfloat16", 130, True, False),
        (B_MAIN, PROMPT, HQ, HKV, D, "float32", 100, True, False),
        (1, MIX_LONG, HQ, HKV, D, "bfloat16", MIX_WINDOW, True, False),
        (2, 300, 8, 2, 64, "float32", 1, False, False),
        (2, 300, 8, 2, ZD, "bfloat16", 64, True, False),
    ]
    for b, s, hq, hkv, d, dt, window, pwl, timed in cases:
        q, k, v = (randn((b, s, h, d), dt) for h in (hq, hkv, hkv))
        got = ops.flash_attention(q, k, v, use_pwl=pwl, window=window)
        want = flash_attention_plain(q, k, v, use_pwl=pwl, window=window)
        torch.cuda.synchronize()
        what = f"B{b} S{s} Hq{hq} Hkv{hkv} D{d} {dt} causal window {window}"
        err = _check_flash(torch, got, want, dt, f"{what} pwl={pwl}", pwl)
        del got, want
        if not timed:
            continue
        # the (query, key) pairs of the window, each 4 d FLOPs a head
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bms, by = bound(nbytes, 4 * b * hq * d * kept_pairs(s, s, True, window), dt)
        mask = window_mask(torch, s, s, window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        extra.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "design": "sliding window on the mma.sync path (steps from the tile's first "
                      "windowed step, a masked step at each row's lower edge)",
            "shape": f"mixtral {what}", "max_abs_err": err,
            # launches: those of this shape and window in mixtral's run at
            # this batch and length (run 1 runs the published window 4096,
            # so the windows of 100 and 130 count none there)
            "path": "moe_serve_run2" if b == 1 else "moe_serve",
            "launch_key": fa.launch_key(q, k, window=window),
            "ms": timer.ms(lambda: ops.flash_attention(q, k, v, window=window), 20),
            "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v, window=window), 3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 10),
            "bound_ms": bms, "bound_by": by,
        })
        del q, k, v, qt, kt, vt, mask
    torch.cuda.synchronize()


def paged_window_cases(torch, timer, randn, extra):
    """Paged attention under a sliding window against its plain version:
    mixtral's long decode (ctx 4224, window 4096, bt 64: the first 128 keys
    and the first two pool blocks dropped) at B1 (split_plan: 33 splits of
    2 blocks, the first wholly below the window), at a batch of 2 CTAs an
    SM (one split), under PWL (one split), and a batch whose contexts are
    below, at and past the window; bfloat16 also held by the per-element
    rule, float32 PWL by ``_check_paged``'s segment-edge rule; the main
    shape timed beside SDPA with the same boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, paged_attention as pa
    from repro_torch.kernels.paged_attention import (
        identity_block_table, paged_attention_plain, split_plan)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    bt, max_len = 64, MIX_LONG_MAX
    n_blocks = max_len // bt
    one_split = [MIX_LONG_MAX - 4 * i for i in range(-(-2 * n_sms // HKV))]
    cases = [  # contexts, dtype, pwl, timed
        ([MIX_LONG_MAX], "bfloat16", False, True),
        ([MIX_LONG_MAX], "float32", False, False),
        (one_split, "bfloat16", False, False),
        ([MIX_LONG_MAX], "bfloat16", True, False),
        ([MIX_LONG_MAX], "float32", True, False),
        ([100, MIX_WINDOW, MIX_WINDOW + 1, MIX_LONG_MAX], "bfloat16", False, False),
        ([100, MIX_WINDOW, MIX_WINDOW + 1, MIX_LONG_MAX], "float32", True, False),
    ]
    for ctx, dt, pwl, timed in cases:
        b = len(ctx)
        cache_k, cache_v = (randn((b, max_len, HKV, D), dt) for _ in range(2))
        args = (randn((b, HQ, D), dt), cache_k.view(-1, bt, HKV, D), cache_v.view(-1, bt, HKV, D),
                identity_block_table(b, max_len, bt, device="cuda"),
                torch.tensor(ctx, dtype=torch.int32, device="cuda"))
        n_splits, bps = split_plan(b * HKV, n_blocks, bt, n_sms, use_pwl=pwl)
        if (n_splits == 1) != (pwl or ctx is one_split):
            raise AssertionError(f"split_plan gave {n_splits} splits at B{b} pwl={pwl}")
        got = ops.paged_attention(*args, use_pwl=pwl, window=MIX_WINDOW)
        want = paged_attention_plain(*args, use_pwl=pwl, window=MIX_WINDOW)
        torch.cuda.synchronize()
        shown = ctx if b <= 4 else f"{b} of {ctx[-1]}..{ctx[0]}"
        what = (f"B{b} H{HQ} Hkv{HKV} D{D} ctx={shown} window {MIX_WINDOW} bt{bt} {dt} "
                f"pwl={pwl} splits {n_splits} x {bps}")
        edges = None
        if pwl and dt == "float32":
            def edges(bi, hi):
                return pwl_edge_scores(torch, args[0], cache_k, ctx, MIX_WINDOW, bt, bi, hi)
        err = _check_paged(torch, got, want, dt, what, pwl, edges)
        del got, want
        if not timed:
            continue
        lens = args[4]
        kept = sum(min(c, MIX_WINDOW) for c in ctx)
        esize = args[0].element_size()
        nbytes = 2 * args[0].numel() * esize + 2 * kept * HKV * D * esize + b * (n_blocks + 1) * 4
        bms, by = bound(nbytes, 4 * kept * HQ * D, dt)
        kpos = torch.arange(max_len, device="cuda")[None, :]
        mask = ((kpos < lens[:, None]) & (kpos >= lens[:, None] - MIX_WINDOW))[:, None, None, :]
        ql, kl, vl = args[0][:, :, None], cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        extra.append({
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:86",
            "design": "the window's lower bound on the split-KV kernel (blocks from the "
                      "first kept key's, splits below it empty)",
            "n_splits": n_splits, "blocks_per_split": bps,
            "shape": f"mixtral {what}", "max_abs_err": err, "path": "moe_serve_run2",
            "launch_key": pa.launch_key(args[0], args[1], args[3], window=MIX_WINDOW),
            "ms": timer.ms(lambda: ops.paged_attention(*args, window=MIX_WINDOW), 50),
            "plain_ms": timer.ms(lambda: paged_attention_plain(*args, window=MIX_WINDOW), 3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True), 50),
            "bound_ms": bms, "bound_by": by,
        })
    torch.cuda.synchronize()


def merge_partials(torch, parts):
    """The combine of ``models.attention.combine_partials`` over a list of
    shards' (o, m, l), in one process: o / l of the merged terms."""
    o, m, l = (torch.stack(t) for t in zip(*parts))
    w = torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(1e-30)[..., None]


def _hold_partial(torch, got, want, what):
    """A shard's (o, m, l) against the plain version's: the heads with no
    kept key exactly (0, NEG_INF, 0) in both, the others each within
    PICNIC_F32_REL of the plain version's largest |value| (float32 sums in
    another order, from the same inputs in either dtype).  Returns the
    largest relative error."""
    from repro_torch.kernels.paged_attention import NEG_INF
    (o, m, l), (wo, wm, wl) = got, want
    empty = wl == 0
    if not torch.equal(empty, l == 0) or bool(o[empty].any()) \
            or not bool((m[empty] == NEG_INF).all()):
        raise AssertionError(f"paged_attention partial {what}: an empty head is not (0, -1e30, 0)")
    errs = [0.0]
    if bool((~empty).any()):
        errs = [((a - b)[~empty].abs().max() / b[~empty].abs().max().clamp_min(1e-30)).item()
                for a, b in ((o, wo), (m, wm), (l, wl))]
    if not max(errs) <= PICNIC_F32_REL:
        raise AssertionError(f"paged_attention partial {what}: rel errs (o, m, l) {errs}")
    return max(errs)


def paged_partial_cases(torch, timer, randn):
    """Paged attention's partial mode (``ops.paged_attention_partial``, one
    flag of ``csrc/paged_attention.cu``) against its plain version on
    every shard: llama3-8b's decode shape (B4 H32 Hkv8 D128, bt 64) over
    1024 rows cut into 2 and 4 shards by ``key_offset``, contexts ending in
    every shard, windows of 300 and 100 across a boundary, shards with no
    kept key, bf16 and float32, several splits (the split plan's 8 at B4)
    and one (B33); each case's merged output held to the plain version's
    merged output and to the ordinary call over the whole cache.  The
    picnic_decode phase's shape (2 shards, contexts 532, rank 0's shard of
    512 keys) is timed in turns with the ordinary paged call over the same
    keys (no library call gives the partials).  Returns its ``kernels``
    entry."""
    from repro_torch.kernels import ops, paged_attention as pa
    from repro_torch.kernels.paged_attention import (identity_block_table,
                                                     paged_attention_plain, split_plan)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    bt, s = 64, PICNIC_MAX_LEN
    cases = []  # contexts, n_shards, window, dtype
    for dt in ("bfloat16", "float32"):
        for n in (2, 4):
            for window in (None, 300, 100):
                cases.append(([1024, 700, 513, 300], n, window, dt))
    cases.append(([900 - 3 * j for j in range(33)], 2, 200, "bfloat16"))   # one split
    main = ([PICNIC_PROMPT + PICNIC_NEW] * PICNIC_B, 2, None, "bfloat16")
    cases.append(main)
    entry = None
    for ctx, n, window, dt in cases:
        b = len(ctx)
        q = randn((b, HQ, D), dt)
        cache_k, cache_v = (randn((b, s, HKV, D), dt) for _ in range(2))
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        sl = s // n
        table = identity_block_table(b, sl, bt, device="cuda")
        n_splits, bps = split_plan(b * HKV, sl // bt, bt, n_sms)
        if (n_splits == 1) != (b == 33):
            raise AssertionError(f"split_plan gave {n_splits} splits at B{b}")
        got, want, errs, pools = [], [], [], []
        for i in range(n):
            pk, pv = (c[:, i * sl:(i + 1) * sl].contiguous().view(b * sl // bt, bt, HKV, D)
                      for c in (cache_k, cache_v))
            pools.append((pk, pv))
            kw = dict(key_offset=i * sl, window=window)
            got.append(ops.paged_attention_partial(q, pk, pv, table, lens, **kw))
            want.append(paged_attention_plain(q, pk, pv, table, lens, partial=True, **kw))
            torch.cuda.synchronize()
            errs.append(_hold_partial(torch, got[-1], want[-1], f"shard {i} of {n}"))
        merged = merge_partials(torch, got)
        whole = paged_attention_plain(q, cache_k.view(-1, bt, HKV, D), cache_v.view(-1, bt, HKV, D),
                                      identity_block_table(b, s, bt, device="cuda"), lens,
                                      window=window).float()
        err = (merged - merge_partials(torch, want)).abs().max().item()
        err_whole = (merged - whole).abs().max().item()
        what = (f"B{b} H{HQ} Hkv{HKV} D{D} bt{bt} {dt} {n} shards of {sl} rows "
                f"ctx={ctx if b <= 4 else f'{b} of {ctx[-1]}..{ctx[0]}'} window {window} "
                f"splits {n_splits} x {bps}")
        log(f"[kernels] paged_attention partial {what}: shards' max rel err (o, m, l) "
            f"{max(errs):.3e} (tol {PICNIC_F32_REL:.0e}), merged max_abs_err={err:.3e}, "
            f"merged vs the ordinary call over the whole cache {err_whole:.3e}")
        # the whole cache's call rounds to bf16 for a bf16 q
        if not (err <= TOL["float32"] and err_whole <= TOL[dt]):
            raise AssertionError(f"paged_attention partial {what}: merged output disagrees")
        if (ctx, n, window, dt) != main:
            continue
        q0, (pk, pv) = q, pools[0]
        kept = [min(c, sl) for c in ctx]                 # rank 0's keys
        esize = q.element_size()
        nbytes = (q.numel() * esize + 2 * sum(kept) * HKV * D * esize + table.numel() * 4
                  + lens.numel() * 4 + b * HQ * (D + 2) * 4)
        bms, by = bound(nbytes, 4 * sum(kept) * HQ * D, dt)
        local_lens = torch.tensor(kept, dtype=torch.int32, device="cuda")
        # the partial call and the ordinary call over the same keys timed in
        # turns (partial, ordinary, ordinary, partial) x 5, medians: one
        # reading of a ~0.02 ms kernel moves up to 1.8x within a call
        calls = {"partial": lambda: ops.paged_attention_partial(q0, pk, pv, table, lens),
                 "ordinary": lambda: ops.paged_attention(q0, pk, pv, table, local_lens)}
        rounds = {"partial": [], "ordinary": []}
        for _ in range(5):
            for which in ("partial", "ordinary", "ordinary", "partial"):
                rounds[which].append(timer.ms(calls[which], 20))
        med = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}

        def device_ms(fn, n=20):
            """Device time of a call under torch.profiler (its paged kernels
            only, the L2 flushed before each call): no host gap in it."""
            def body():
                for _ in range(n):
                    timer.flush_buf.zero_()
                    fn()
            return trace(torch, body)["device_ms_by_class"]["paged_attention"] / n

        dev = {k: device_ms(fn) for k, fn in calls.items()}
        log(f"[kernels] paged_attention partial at picnic_decode's shape, ms in turns: "
            + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) for k, v in rounds.items())
            + "; device ms a call (profiler): "
            + ", ".join(f"{k} {t:.4f}" for k, t in dev.items()))
        entry = {
            "name": "paged_attention", "mode": "partial", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:86",
            "design": "the split-KV kernel's float32 (o, m, l) under one flag, "
                      "key_offset on both mask bounds",
            "n_splits": n_splits, "blocks_per_split": bps,
            "shape": f"picnic_decode rank 0 {what}", "max_abs_err": err,
            "path": "picnic_decode",
            "launch_key": pa.launch_key(q0, pk, table, partial=True),
            "ms": med["partial"],
            "plain_ms": timer.ms(lambda: paged_attention_plain(q0, pk, pv, table, lens,
                                                               partial=True), 5),
            "ordinary_call_ms": med["ordinary"], "ms_in_turns": rounds,
            "device_ms": dev["partial"], "ordinary_call_device_ms": dev["ordinary"],
            "library_ms": None,        # no PyTorch call returns the partials
            "bound_ms": bms, "bound_by": by,
        }
    torch.cuda.synchronize()
    return entry


def audio_attention_cases(torch, timer, randn, extra):
    """whisper-large-v3's attention shapes (20 heads of 64, MHA, B4), each
    held to its plain version and timed beside SDPA: flash non-causal over
    the encoder's 1500 frames (bf16, the main path, and float32, audio_parity's
    type; ragged against the 128-key step), the decoder's causal
    self-attention over the 4-token prompt, and cross prefill (the prompt
    against 1500 keys); paged over the cross cache (ctx 1500 of 1536 rows,
    bt 64) and over the self cache (ctx 132 of 448 rows, the last of
    audio_serve's 128 steps).  Each entry's launches are those of its own
    shape (``launch_key``) in audio_serve's run (none of the float32 one)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa, paged_attention as pa
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import (
        contiguous_block_tokens, identity_block_table, paged_attention_plain, split_plan)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    prompt = len(W_SOT)
    for sq, skv, dt, causal, what in (
            (W_FRAMES, W_FRAMES, "bfloat16", False, "whisper encoder"),
            (W_FRAMES, W_FRAMES, "float32", False, "whisper encoder (audio_parity's type)"),
            (prompt, prompt, "bfloat16", True, "whisper decoder self prefill"),
            (prompt, W_FRAMES, "bfloat16", False, "whisper cross prefill")):
        q = randn((B_MAIN, sq, WH, WD), dt)
        k, v = (randn((B_MAIN, skv, WH, WD), dt) for _ in range(2))
        got = ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        shape = (f"{what}: B{B_MAIN} Sq{sq} Skv{skv} H{WH} Hkv{WH} D{WD} {dt} "
                 + ("causal" if causal else "non-causal"))
        err = _check_flash(torch, got, want, dt, shape, False)
        del got, want
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bms, by = bound(nbytes, 4 * B_MAIN * WH * WD * pairs, dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        extra.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "design": ("float32 SIMT" if dt == "float32" else "the mma.sync path")
                      + (", causal" if causal else ", non-causal, keys masked at Skv"),
            "shape": shape, "max_abs_err": err, "path": "audio_serve",
            "launch_key": fa.launch_key(q, k, causal=causal),
            "ms": timer.ms(lambda: ops.flash_attention(q, k, v, causal=causal), 20),
            "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v, causal=causal), 3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 20),
            "bound_ms": bms, "bound_by": by,
        })
        del q, k, v, qt, kt, vt
    for rows, ctx, what in ((W_CROSS, W_FRAMES, "whisper cross decode"),
                            (W_MAX_LEN, prompt + W_NEW, "whisper self decode, last step")):
        dt = "bfloat16"
        cache_k, cache_v = (randn((B_MAIN, rows, WH, WD), dt) for _ in range(2))
        bt = contiguous_block_tokens(rows)
        args = (randn((B_MAIN, WH, WD), dt), cache_k.view(-1, bt, WH, WD),
                cache_v.view(-1, bt, WH, WD), identity_block_table(B_MAIN, rows, bt, device="cuda"),
                torch.full((B_MAIN,), ctx, dtype=torch.int32, device="cuda"))
        n_splits, bps = split_plan(B_MAIN * WH, rows // bt, bt, n_sms)
        got = ops.paged_attention(*args)
        want = paged_attention_plain(*args)
        torch.cuda.synchronize()
        shape = (f"{what}: B{B_MAIN} H{WH} Hkv{WH} D{WD} ctx{ctx} of {rows} rows bt{bt} {dt} "
                 f"splits {n_splits} x {bps}")
        err = _check_paged(torch, got, want, dt, shape, False)
        del got, want
        esize = args[0].element_size()
        nbytes = (2 * args[0].numel() * esize + 2 * B_MAIN * ctx * WH * WD * esize
                  + args[3].numel() * 4 + B_MAIN * 4)
        bms, by = bound(nbytes, 4 * B_MAIN * ctx * WH * WD, dt)
        mask = (torch.arange(rows, device="cuda") < ctx)[None, None, None, :]
        ql, kl, vl = args[0][:, :, None], cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        extra.append({
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:86",
            "design": "split-KV + combine over the identity table of a contiguous cache",
            "n_splits": n_splits, "blocks_per_split": bps,
            "shape": shape, "max_abs_err": err, "path": "audio_serve",
            "launch_key": pa.launch_key(args[0], args[1], args[3]),
            "ms": timer.ms(lambda: ops.paged_attention(*args), 50),
            "plain_ms": timer.ms(lambda: paged_attention_plain(*args), 3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask), 50),
            "bound_ms": bms, "bound_by": by,
        })
        del cache_k, cache_v, args, ql, kl, vl
    torch.cuda.synchronize()


def prefix_mask(torch, s, prefix_len):
    """(s, s) bool: the keys a query sees with a bidirectional prefix (the
    causal mask, and every key below prefix_len), the yardstick's mask for
    scaled_dot_product_attention."""
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    return (qpos >= kpos) | (kpos < prefix_len)


def vlm_attention_cases(torch, timer, randn, extra):
    """paligemma-3b's attention shapes (8 query heads on one KV head of
    256, B4), each held to its plain version and timed beside SDPA with its
    bound: flash over the prefill's 288 positions with the 256-row image
    prefix (bf16, the main path, and float32, vlm_parity's type; SDPA takes
    the prefix-LM boolean mask), flash at D 256 without a prefix under PWL;
    paged at the last of vlm_serve's steps, ctx 416 of 448 rows in 64-token
    blocks (bf16 with split_plan's splits, float32, and bf16 under PWL, one
    split; SDPA takes a length mask).  Each entry's launches are those of
    its own shape (``launch_key``) in vlm_serve's run."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa, paged_attention as pa
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import (identity_block_table,
                                                     paged_attention_plain, split_plan)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    s = V_PREFIX + V_PROMPT
    for dt, prefix, pwl in (("bfloat16", V_PREFIX, False), ("float32", V_PREFIX, False),
                            ("bfloat16", 0, True)):
        q = randn((B_MAIN, s, VH, VD), dt)
        k, v = (randn((B_MAIN, s, 1, VD), dt) for _ in range(2))
        kw = dict(prefix_len=prefix, use_pwl=pwl)
        got = ops.flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        shape = (f"paligemma prefill: B{B_MAIN} S{s} Hq{VH} Hkv1 D{VD} {dt} causal "
                 f"prefix {prefix} pwl={pwl}")
        err = _check_flash(torch, got, want, dt, shape, pwl)
        del got, want
        # the (query, key) pairs: query i sees max(i + 1, prefix) keys
        pairs = sum(max(i + 1, prefix) for i in range(s))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bms, by = bound(nbytes, 4 * B_MAIN * VH * VD * pairs, dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = prefix_mask(torch, s, prefix)
        extra.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "design": ("float32 SIMT" if dt == "float32" else
                       "the mma.sync path's D 256 layout (Q in shared memory, one K and "
                       "one V stage, staggered loads)")
                      + (", bidirectional prefix" if prefix else ""),
            "shape": shape, "max_abs_err": err, "path": "vlm_serve",
            "launch_key": fa.launch_key(q, k, **kw),
            "ms": timer.ms(lambda: ops.flash_attention(q, k, v, **kw), 20),
            "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v, **kw), 3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20),
            "bound_ms": bms, "bound_by": by,
        })
        del q, k, v, qt, kt, vt
    bt, ctx = 64, V_PREFIX + V_PROMPT + V_NEW
    for dt, pwl in (("bfloat16", False), ("float32", False), ("bfloat16", True)):
        cache_k, cache_v = (randn((B_MAIN, V_MAX_LEN, 1, VD), dt) for _ in range(2))
        args = (randn((B_MAIN, VH, VD), dt), cache_k.view(-1, bt, 1, VD),
                cache_v.view(-1, bt, 1, VD),
                identity_block_table(B_MAIN, V_MAX_LEN, bt, device="cuda"),
                torch.full((B_MAIN,), ctx, dtype=torch.int32, device="cuda"))
        n_splits, bps = split_plan(B_MAIN, V_MAX_LEN // bt, bt, n_sms, use_pwl=pwl)
        if (n_splits == 1) != pwl:
            raise AssertionError(f"split_plan gave {n_splits} splits at B{B_MAIN} pwl={pwl}")
        got = ops.paged_attention(*args, use_pwl=pwl)
        want = paged_attention_plain(*args, use_pwl=pwl)
        torch.cuda.synchronize()
        shape = (f"paligemma decode, last step: B{B_MAIN} H{VH} Hkv1 D{VD} ctx{ctx} of "
                 f"{V_MAX_LEN} rows bt{bt} {dt} pwl={pwl} splits {n_splits} x {bps}")
        err = _check_paged(torch, got, want, dt, shape, pwl)
        del got, want
        esize = args[0].element_size()
        nbytes = (2 * args[0].numel() * esize + 2 * B_MAIN * ctx * VD * esize
                  + args[3].numel() * 4 + B_MAIN * 4)
        bms, by = bound(nbytes, 4 * B_MAIN * ctx * VH * VD, dt)
        mask = (torch.arange(V_MAX_LEN, device="cuda") < ctx)[None, None, None, :]
        ql, kl, vl = args[0][:, :, None], cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        extra.append({
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:86",
            "design": "split-KV + combine at D 256 over the identity table of a contiguous "
                      "cache" + (", one stage (float32)" if dt == "float32" else ""),
            "n_splits": n_splits, "blocks_per_split": bps,
            "shape": shape, "max_abs_err": err, "path": "vlm_serve",
            "launch_key": pa.launch_key(args[0], args[1], args[3], use_pwl=pwl),
            "ms": timer.ms(lambda: ops.paged_attention(*args, use_pwl=pwl), 50),
            "plain_ms": timer.ms(lambda: paged_attention_plain(*args, use_pwl=pwl), 3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True), 50),
            "bound_ms": bms, "bound_by": by,
        })
        del cache_k, cache_v, args, ql, kl, vl
    torch.cuda.synchronize()


def phase_kernels_softmax(torch, timer, randn, extra):
    """SCU softmax: the indexed PWL exp against the select chain on every
    float32 input; every case against the plain version, with its route
    and the CTAs per SM of the route's kernel logged, and every other route
    that takes a main-path case held and timed beside it; the edge rows
    bit-equal and the non-finite rows NaN where the plain version is, on
    every route; returns the main-shape entry (llama3-8b's prefill score
    rows)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.pwl_softmax import (
        ROUTES, agreement_nan, edge_rows, exp_mismatches, occupancy, pwl_softmax_cuda,
        pwl_softmax_plain, route, takes, vector_rows)

    bad = exp_mismatches()
    log(f"[kernels] pwl_softmax indexed PWL exp over all 2**32 float32 inputs: {bad} "
        f"differ from the attention kernels' select chain pwl_exp (NaN kept)")
    if bad:
        raise AssertionError(f"pwl_softmax: the indexed PWL exp differs on {bad} inputs")

    def scores(shape, dt, scale, causal):
        x = randn(shape, "float32", scale)
        if causal:
            q = torch.arange(shape[-1], device="cuda")
            x = x.masked_fill(q[None, :] > q[:, None], -1e30)
        return x.to(torch.bfloat16 if dt == "bfloat16" else torch.float32)

    def plan_text(way, cs, n, dtype):
        ctas, clusters = occupancy(way, cs, n, dtype)
        kind = ""
        if way == "warp":
            kind = " 16-byte lanes" if vector_rows(n, dtype) else " one element a lane"
        return (f"route {way}{kind}" + (f" x{cs}" if cs > 1 else "")
                + f", {ctas} CTAs per SM" + (f", {clusters} clusters resident" if clusters else ""))

    def entry(x, err, dt, what, plan):
        bms, by = bound(*softmax_work(x), "float32")
        return {
            "name": "pwl_softmax", "route": "cuda",
            "source": "src/repro_torch/csrc/pwl_softmax.cu",
            "replaces": "src/repro/kernels/pwl_softmax.py:47",
            "design": ("PWL exp by segment index, NaN kept; warp: 16-byte rows in "
                       "registers; row: one CTA, the row in shared memory; cluster: a row "
                       "over 2-16 CTAs, max and sum through distributed shared memory; "
                       "three_pass"),
            "softmax_route": plan,
            "shape": f"{what} {tuple(x.shape)} {dt}", "max_abs_err": err,
            "ms": timer.ms(lambda: ops.pwl_softmax(x), 20),
            "plain_ms": timer.ms(lambda: pwl_softmax_plain(x), 5),
            # exact exp, float32 inside, output in x's dtype
            "library_ms": timer.ms(lambda: torch.softmax(x, dim=-1), 20),
            "bound_ms": bms, "bound_by": by,
        }

    vocab = 128256
    cases = [  # shape, dtype, scale, causal, what
        ((B_MAIN, HQ, PROMPT, PROMPT), "bfloat16", 4, True, "llama3-8b prefill scores"),
        ((B_MAIN, HQ, PROMPT, PROMPT), "float32", 4, True, "prefill scores"),
        ((B_MAIN * HQ, PROMPT + 1), "bfloat16", 4, False, "llama3-8b decode scores"),
        ((B_MAIN, vocab), "float32", 4, False, "llama3-8b vocab"),
        ((B_MAIN * HQ, PROMPT + 1), "float32", 4, False, "decode scores"),
        ((256, 512), "float32", 3, False, "kernels bench"),
        ((300, 1000), "float32", 3, False, "ragged"),
        ((4096, 128), "float32", 4, False, "ablations bench"),
        ((37, 5000), "float32", 4, False, "few rows"),
        ((16, 32768), "bfloat16", 4, False, "few rows"),
        ((5, 1025), "float32", 4, False, "row in shared memory, unaligned rows"),
        ((7, 1), "float32", 4, False, "n 1"),
        ((1, vocab), "float32", 4, False, "one vocab row"),
        ((B_MAIN, vocab), "bfloat16", 4, False, "vocab"),
        ((512, 4096), "bfloat16", 4, False, "row in shared memory"),
        ((300, 5000), "float32", 4, False, "row in shared memory"),
        ((1000, 16), "bfloat16", 4, False, "two lanes a row"),
        ((4096, 64), "float32", 4, False, "16 lanes a row"),
        ((1, 917000), "float32", 4, False, "the largest slices of the largest cluster"),
        ((2, 1 << 20), "float32", 4, False, "three passes"),
    ]
    main = None
    for i, (shape, dt, scale, causal, what) in enumerate(cases):
        x = scores(shape, dt, scale, causal)
        n = shape[-1]
        rows = x.numel() // n
        way, cs = route(rows, n, x.dtype)
        plan = plan_text(way, cs, n, x.dtype)
        before = ops.LAUNCHES["pwl_softmax"]
        got = ops.pwl_softmax(x)
        if ops.LAUNCHES["pwl_softmax"] != before + 1:
            raise AssertionError("pwl_softmax: one call must count one launch")
        want = pwl_softmax_plain(x)
        torch.cuda.synchronize()
        err = _check_softmax(torch, got, want, f"{what} {shape} {dt}, {plan}")
        if i in (0, 2, 3):
            # every other route that takes the case: held too, and timed
            # beside the route taken
            times = {}
            for other in (("warp", 1), ("row", 1), ("cluster", 2), ("cluster", 4),
                          ("cluster", 8), ("three_pass", 1)):
                if other == (way, cs) or not takes(*other, rows, n, x.dtype):
                    continue
                _check_softmax(torch, pwl_softmax_cuda(x, other), want,
                               f"{what} {shape} {dt}, forced {other}")
                times[other] = timer.ms(lambda o=other: pwl_softmax_cuda(x, o), 20)
            times[(way, cs)] = timer.ms(lambda: ops.pwl_softmax(x), 20)
            log(f"[kernels] pwl_softmax {what} {shape} {dt}: "
                + ", ".join(f"{w} x{c} {t:.4f} ms" for (w, c), t in times.items())
                + f" (taken: {way} x{cs})")
        if i == 0:
            main = entry(x, err, dt, what, plan)
        elif i in (2, 3):
            extra.append(entry(x, err, dt, what, plan))
        del x, got, want
    torch.cuda.synchronize()

    # the edge rows bit-equal, and rows with NaN, +inf or only -inf NaN
    # where the plain version has NaN, on every route
    for way, cs, n in (("warp", 1, 2), ("warp", 1, 4), ("warp", 1, 512), ("row", 1, 2048),
                       ("cluster", 4, 8192), ("cluster", 16, 8192), ("three_pass", 1, 2048)):
        x = edge_rows(n).cuda()
        got = pwl_softmax_cuda(x, (way, cs))
        want = pwl_softmax_plain(x)
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        unequal = int((got.view(torch.int32) != want.view(torch.int32))[~nan_w].sum())
        log(f"[kernels] pwl_softmax edge rows ({x.shape[0]}, {n}) route {way} x{cs}: "
            f"{unequal} elements not bit-equal, NaN rows {int(nan_g.any(-1).sum())} "
            f"(plain {int(nan_w.any(-1).sum())})")
        if unequal or not torch.equal(nan_g, nan_w):
            raise AssertionError(f"pwl_softmax edge rows, route {way} x{cs}: not bit-equal")
        for dt in ("float32", "bfloat16"):
            x = nonfinite_rows(torch, randn, 64, n, dt)
            got = pwl_softmax_cuda(x, (way, cs))
            want = pwl_softmax_plain(x)
            torch.cuda.synchronize()
            err, share, ok = agreement_nan(got, want)
            log(f"[kernels] pwl_softmax non-finite rows (64, {n}) {dt} route {way} x{cs}: "
                f"NaN rows {int(torch.isnan(got).any(-1).sum())} (plain "
                f"{int(torch.isnan(want).any(-1).sum())}), finite rows max_abs_err={err:.3e}")
            if not ok:
                raise AssertionError(f"pwl_softmax non-finite rows {dt}, route {way} x{cs}: "
                                     f"NaN placement or values differ from plain")
    attention_nan_scores(torch, randn)
    return main


def nonfinite_rows(torch, randn, rows, n, dt):
    """rows x n scores: row 0 holds a NaN, row 1 a +inf, row 2 only -inf,
    row 3 a causal mask's row (one score, the rest -1e30), row 4 -inf
    besides one score, and every 8th row after them a NaN at another
    column; the others normal."""
    x = randn((rows, n), "float32", 4)
    x[0, n // 3] = float("nan")
    x[1, n - 1] = float("inf")
    x[2] = float("-inf")
    x[3, 1:] = -1e30
    x[4, 1:] = float("-inf")
    for r in range(8, rows, 8):
        x[r, (r * 37) % n] = float("nan")
    return x.to(torch.bfloat16 if dt == "bfloat16" else torch.float32)


def attention_nan_scores(torch, randn):
    """The attention kernels keep a NaN score where their plain versions
    do (as the Pallas kernels do): one NaN in a key of a small case, exact
    and PWL, float32 and bfloat16; flash causal and not; paged with one
    split and with several (split + combine), a NaN past one sequence's
    context besides, which no version reads.  The rows with a NaN must be
    the plain version's exactly."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import (
        contiguous_block_tokens, identity_block_table, paged_attention_plain, split_plan)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def nan_rows(t):
        return torch.isnan(t.float()).any(-1)

    def hold(what, got, want):
        g, w = nan_rows(got), nan_rows(want)
        log(f"[kernels] attention with one NaN key score, {what}: NaN rows {int(g.sum())} "
            f"(plain {int(w.sum())}) of {w.numel()}")
        if not torch.equal(g, w) or not w.any():
            raise AssertionError(f"{what}: the kernel's NaN rows are not the plain version's")

    for dt in ("bfloat16", "float32"):
        q, k, v = (randn((1, 128, h, 64), dt) for h in (4, 2, 2))
        k[0, 5, 0, 0] = float("nan")
        for pwl in (False, True):
            for causal in (True, False):
                hold(f"flash {dt} pwl={pwl} causal={causal}",
                     ops.flash_attention(q, k, v, causal=causal, use_pwl=pwl),
                     flash_attention_plain(q, k, v, causal=causal, use_pwl=pwl))
        for max_len, ctx in ((64, [50, 64]), (1024, [1000, 300])):
            cache_k, cache_v = (randn((2, max_len, 2, 64), dt) for _ in range(2))
            cache_k[0, ctx[0] // 2, 0, 3] = float("nan")
            cache_k[1, ctx[1]:, 1, 0] = float("nan")
            bt = contiguous_block_tokens(max_len)
            args = (randn((2, 8, 64), dt), cache_k.view(-1, bt, 2, 64),
                    cache_v.view(-1, bt, 2, 64), identity_block_table(2, max_len, bt, device="cuda"),
                    torch.tensor(ctx, dtype=torch.int32, device="cuda"))
            for pwl in (False, True):
                n_splits, _ = split_plan(4, max_len // bt, bt, n_sms, use_pwl=pwl)
                hold(f"paged {dt} pwl={pwl} ctx {ctx}, {n_splits} splits",
                     ops.paged_attention(*args, use_pwl=pwl),
                     paged_attention_plain(*args, use_pwl=pwl))


def phase_kernels_cim(torch, timer, randn, extra):
    """CIM matmul: kernel against plain version and timings, each case
    with the route the wrapper takes; returns the main-shape entry
    (llama3-8b's MLP up projection over a 4 x 512 prefill, with the weight
    in the kernel's layout as the cim_scu phase passes it)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim_matmul import (ROUTES, calibration_tile, cim_matmul_cuda,
                                                cim_matmul_plain, quantize_weights,
                                                resident_ctas, route, takes, weight_layout)

    for way in ROUTES:
        log(f"[kernels] cim_matmul route {way}: {resident_ctas(way)} CTAs resident per SM")

    def entry(args, wqt, kw, err, what, way):
        x, wq, ws = args
        (M, K), N = x.shape, wq.shape[1]
        bms, by = cim_bound(*args)
        return {
            "name": "cim_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/cim_matmul.cu",
            "replaces": "src/repro/kernels/cim_matmul.py:74",
            "design": {"cluster": "one pass, 2-CTA cluster, TMA ring, int8 wgmma "
                                  "m64n128k32 with the ADC of step k beside the products of "
                                  "k + 1, maxima by st.async, weight pre-laid (N, K)",
                       "decode": "split-K, one CTA per (256 columns, K tile), int8 "
                                 "mma.sync, terms summed in K order, weight pre-laid (N, K)",
                       "two_pass": "int8 mma.sync m16n8k32, two dot passes"}[way],
            "cim_route": way,
            "shape": (f"{what} M{M} K{K} N{N} x {str(x.dtype)[6:]} blocks "
                      f"{kw['block_m']}x{kw['block_n']} adc{kw['adc_bits']}"),
            "max_abs_err": err,
            "ms": timer.ms(lambda: ops.cim_matmul_quantized(*args, wqt=wqt, **kw), 10),
            "plain_ms": timer.ms(lambda: cim_matmul_plain(*args, **kw), 3),
            "library_ms": None,       # no single PyTorch call computes the ADC
            "bound_ms": bms, "bound_by": by,
        }

    D_MODEL, D_FF = 4096, 14336
    cases = [  # M, K, N, x dtype, (block_m, block_n), adc_bits, weight pre-laid, what
        (B_MAIN * PROMPT, D_MODEL, D_FF, "bfloat16", (128, 256), 12, True, "llama3-8b up proj"),
        (B_MAIN * PROMPT, D_MODEL, D_FF, "float32", (128, 256), 12, False, "up proj"),
        (B_MAIN, D_MODEL, D_FF, "bfloat16", (128, 256), 12, True, "llama3-8b decode up proj"),
        (B_MAIN * PROMPT, D_FF, D_MODEL, "bfloat16", (128, 256), 12, True, "llama3-8b down proj"),
        (B_MAIN * PROMPT, D_MODEL, HKV * D, "bfloat16", (128, 256), 6, True, "k proj"),
        (B_MAIN * PROMPT, D_MODEL, HKV * D, "bfloat16", (128, 256), 16, False, "k proj"),
        (64, 512, 128, "float32", (64, 128), 12, False, "bench"),
        (128, 1024, 512, "float32", (128, 512), 12, False, "unblocked"),
        (128, 512, 256, "float32", (32, 64), 8, False, "small tiles"),
        (96, 256, 192, "bfloat16", (128, 256), 16, False, "ragged CTA tiles"),
        (64, 768, 130, "float32", (16, 26), 8, False, "N % 4 != 0"),
        (100, 512, 200, "float32", (128, 256), 12, True, "one tile over both CTAs, ragged"),
        (320, 768, 200, "bfloat16", (64, 200), 12, False, "64 x 200 tiles, ragged M"),
        (256, 512, 384, "float32", (256, 384), 12, True, "two-pass"),
        (B_MAIN, D_MODEL, D_FF, "bfloat16", (128, 256), 12, False, "decode up proj"),
        (B_MAIN, D_MODEL, HKV * D, "bfloat16", (128, 256), 12, True, "decode k proj"),
        (B_MAIN, D_FF, D_MODEL, "bfloat16", (128, 256), 12, True, "decode down proj"),
        (B_MAIN * PROMPT, D_MODEL, D_FF, "bfloat16", (128, 256), 6, True, "up proj"),
        (B_MAIN * PROMPT, D_MODEL, D_FF, "bfloat16", (128, 256), 16, True, "up proj"),
        (B_MAIN * PROMPT, D_MODEL, D_FF, "bfloat16", (64, 128), 12, True, "up proj, 4 tiles a block"),
    ]
    main = None
    for i, (M, K, N, dt, (bm, bn), adc, laid, what) in enumerate(cases):
        args = (randn((M, K), dt), *quantize_weights(randn((K, N), "float32", 0.02)))
        wqt = weight_layout(args[1]) if laid else None
        kw = dict(block_m=bm, block_n=bn, adc_bits=adc)
        tile = calibration_tile(M, N, K, bm, bn)
        way = route(M, N, K, *tile)
        before = ops.LAUNCHES["cim_matmul"]
        got = ops.cim_matmul_quantized(*args, wqt=wqt, **kw)
        if ops.LAUNCHES["cim_matmul"] != before + 1:
            raise AssertionError("cim_matmul: one call must count one launch")
        want = cim_matmul_plain(*args, **kw)
        torch.cuda.synchronize()
        tol = TOL_CIM_REL * want.abs().max().item()
        unequal = int((got != want).sum())
        err = _check(torch, "cim_matmul", got, want, dt,
                     f"{what} M{M} K{K} N{N} {dt} blocks {bm}x{bn} adc{adc} route {way}, "
                     f"weight {'pre-laid' if laid else 'transposed per call'}, "
                     f"{unequal} elements not bit-equal", tol)
        # every other route that takes the shape: bit-equal too, and timed
        # beside the route taken
        times = {}
        for other in ROUTES:
            if other == way or not takes(other, M, N, K, *tile):
                continue
            if not torch.equal(cim_matmul_cuda(*args, wqt=wqt, way=other, **kw), want):
                raise AssertionError(f"cim_matmul {what}: route {other} differs from plain")
            times[other] = timer.ms(
                lambda o=other: cim_matmul_cuda(*args, wqt=wqt, way=o, **kw), 10)
        if times:
            times[way] = timer.ms(lambda: ops.cim_matmul_quantized(*args, wqt=wqt, **kw), 10)
            log(f"[kernels] cim_matmul {what} M{M} K{K} N{N} blocks {bm}x{bn}: "
                + ", ".join(f"route {w} {t:.4f} ms" for w, t in times.items())
                + f" (taken: {way}; the others bit-equal too)")
        if i == 0:
            main = entry(args, wqt, kw, err, what, way)
            x, wq, ws = args
            old_ms, old_by = bound(*cim_work(x, wq, ws)[:2], "int8")
            log(f"[kernels] cim_matmul {what}: bound {main['bound_ms']:.5f} ms "
                f"({main['bound_by']}) with the float32 ADC steps, {old_ms:.5f} ms "
                f"({old_by}) without them")
            log(f"[kernels] cim_matmul {what}: kernel with the weight transposed per call "
                f"{timer.ms(lambda: ops.cim_matmul_quantized(*args, **kw), 10):.4f} ms")
            xq = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(5))
            try:
                int_mm = timer.ms(lambda: torch._int_mm(xq, wqt.t()), 10)
                log(f"[kernels] yardstick, the integer dot alone (another function): "
                    f"torch._int_mm int8 ({M}, {K}) x ({K}, {N}) {int_mm:.4f} ms")
            except RuntimeError as e:
                log(f"[kernels] yardstick torch._int_mm refused the layout: {e}")
        elif i in (2, 3):
            extra.append(entry(args, wqt, kw, err, what, way))
    torch.cuda.synchronize()
    return main


def expected_launches(cfg, new: int):
    """Kernel launches of one prefill and ``new`` decode steps: one flash
    per attention block application in the prefill, one paged per
    attention block application and step, one SSD scan per mamba layer in
    the prefill.  A decoder block of an encoder-decoder attends twice (to
    itself, then to the encoder output), and the encoder's layers launch
    one flash each in the prefill."""
    from repro_torch import models
    kinds, n_groups = models.group_layout(cfg)
    n_mamba = kinds.count("mamba") * n_groups
    n_attn = sum({"mamba": 0, "dec": 2}.get(k, 1) for k in kinds) * n_groups
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    return {"flash_attention": n_attn + n_enc, "flash_attention_bwd": 0,
            "paged_attention": n_attn * new, "ssd_scan": n_mamba, "ssd_scan_bwd": 0,
            "pwl_softmax": 0, "cim_matmul": 0}


def decode_loop(torch, step, params, cache, tok, start: int, new: int):
    """``new`` greedy steps of ``step`` from the prefill's token, the first
    writing cache row ``start``, timed on the host clock; returns (ids (B,
    new + 1), seconds).  Each step's token is copied: the graph's output
    buffer is overwritten by the next replay."""
    ids = [tok]
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(new):
        tok, cache = step(params, cache, tok, start + i + 1)
        ids.append(tok.clone())
    torch.cuda.synchronize()
    return torch.cat(ids, 1), time.time() - t0


def phase_serve(torch, results, phase):
    """The served model of ``phase`` at full width and depth, one run of
    ``serve_run``."""
    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH[phase])
    params = init_logged(torch, cfg, f"[{phase}]")
    res, launches = serve_run(torch, cfg, params, f"[{phase}]",
                              random_prompt(torch, cfg, B_MAIN, PROMPT), NEW, MAX_LEN)
    results[phase] = res
    return launches


def random_prompt(torch, cfg, batch, length):
    """(batch, length) token ids on the card from numpy seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length))).cuda()


def init_logged(torch, cfg, tag):
    """Random weights of ``cfg`` on the card from seed 0, with their count
    and init time logged."""
    from repro_torch import models
    t0 = time.time()
    params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in {cfg.dtype}, init {time.time() - t0:.1f}s")
    return params


def serve_run(torch, cfg, params, tag, prompt, new, max_len, inputs=None):
    """Prefill the (batch, prompt_len) ``prompt`` (with ``inputs``, the
    prefill batch's other entries: an encoder-decoder's ``encoder_embeds``,
    a prefix-LM's ``prefix_embeds``), then ``new`` decode steps, eager and
    then under the captured graph, from the same prompt; the main path
    (counted) is the prefill and the graph's decode, as the card's Server
    runs it.  The graph's ids and caches must equal the eager step's.
    Returns (results, launches of the main path, per kernel and per
    (kernel, launch_key))."""
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (CompiledServeStep, make_prefill_step,
                                          make_serve_step)

    batch, prompt_len = prompt.shape
    enc = dict(inputs or {})
    # cache rows the prefill fills: a prefix's, then the prompt's
    rows = prompt_len + (enc["prefix_embeds"].shape[1] if "prefix_embeds" in enc else 0)
    prefill = make_prefill_step(cfg, kv_max=max_len)
    serve = make_serve_step(cfg)

    # warm-up outside the counted window (cuBLAS heuristics, allocator), and
    # the graph captured over a cache of its own, into which the prefill's
    # cache is copied; its memory is what the capture leaves reserved
    prefill(params, {"tokens": prompt[:, :64], **enc})
    graph_cache = models.init_cache(cfg, batch, max_len, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.time()
    compiled = CompiledServeStep(cfg, params, graph_cache, batch)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    torch.cuda.empty_cache()
    graph_gib = (torch.cuda.memory_reserved() - reserved) / 2 ** 30

    # the eager step, outside the counted window: the yardstick
    tok, eager_cache = prefill(params, {"tokens": prompt, **enc})
    ops.reset_launch_counts()
    ids_eager, t_eager = decode_loop(torch, serve, params, eager_cache, tok, rows, new)
    want_eager = {**expected_launches(cfg, new), "flash_attention": 0, "ssd_scan": 0}
    if dict(ops.LAUNCHES) != want_eager:
        raise AssertionError(f"eager decode launches {ops.LAUNCHES}, expected {want_eager}")

    def timed_prefill():
        """(token, cache, host ms, cudaMalloc calls) of one prefill."""
        segments = torch.cuda.memory_stats()["segment.all.allocated"]
        t0 = time.time()
        out = prefill(params, {"tokens": prompt, **enc})
        torch.cuda.synchronize()
        return (*out, (time.time() - t0) * 1e3,
                torch.cuda.memory_stats()["segment.all.allocated"] - segments)

    # prefills outside the counted window, each cache freed before the next,
    # so the allocator holds the blocks that the counted prefill takes (the
    # eager step's cache is still alive, kept for the comparison below)
    repeats = [timed_prefill()[2:] for _ in range(PREFILL_REPEATS)]

    # the main path: prefill, then the decode through the graph
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tok, cache, prefill_ms, prefill_mallocs = timed_prefill()
    for key, entry in cache.items():
        for name, t in entry.items():
            graph_cache[key][name].copy_(t)
    del cache
    ids, t_decode = decode_loop(torch, compiled, params, graph_cache, tok, rows, new)
    launches = dict(ops.LAUNCHES)
    by_shape = dict(ops.LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    want = expected_launches(cfg, new)
    log(f"{tag} launches on the main path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError("token id out of range")
    if not torch.equal(ids, ids_eager):
        raise AssertionError(f"graph and eager greedy ids differ: {ids.tolist()} against "
                             f"{ids_eager.tolist()}")
    # logits check, outside the counted window: the prefill's logits are
    # finite and their last-position argmax is the prefill step's token
    with torch.no_grad():
        logits, aux, _ = models.forward(cfg, params, prompt, **enc)
    if not bool(torch.isfinite(logits.float()).all()) or not bool(torch.isfinite(aux)):
        raise AssertionError("prefill logits or aux loss are not finite")
    if not torch.equal(logits[:, -1:].float().argmax(-1), ids[:, :1]):
        raise AssertionError("prefill argmax differs from the prefill step's token")
    del logits
    cache_equal = True
    for key, entry in graph_cache.items():
        for name, t in entry.items():
            cache_equal &= torch.equal(t, eager_cache[key][name])
            if name in ("k", "v"):
                t = t[:, :, :rows + new]
            if not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"cache {key}/{name} is not finite")
    del eager_cache
    if not cache_equal:
        raise AssertionError("the graph's cache differs from the eager step's")
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
           "prompt": prompt_len, "prefix": rows - prompt_len, "new_tokens": new,
           "max_len": max_len,
           "prefill_ms": prefill_ms, "prefill_cuda_mallocs": prefill_mallocs,
           "prefill_tokens_per_s": batch * rows / prefill_ms * 1e3,
           "prefill_repeats_ms": [ms for ms, _ in repeats],
           "prefill_repeats_cuda_mallocs": [n for _, n in repeats],
           "decode_ms_per_step": t_decode / new * 1e3,
           "decode_tokens_per_s": batch * new / t_decode,
           "eager_decode_ms_per_step": t_eager / new * 1e3,
           "eager_decode_tokens_per_s": batch * new / t_eager,
           "graph_build_s": t_build, "graph_reserved_gib": graph_gib,
           "graph_cache_bit_equal_to_eager": cache_equal, "aux_loss": aux.item(),
           "peak_mem_gib": peak, "launches": launches,
           "launches_by_shape": {f"{n} {key}": c for (n, key), c in sorted(by_shape.items())}}
    log(f"{tag} B{batch} x " + (f"({rows - prompt_len} + {prompt_len})" if rows > prompt_len
                                 else f"{prompt_len}")
        + f": prefill {res['prefill_ms']:.2f} ms "
        f"({res['prefill_tokens_per_s']:.0f} tok/s); "
        f"decode eager {res['eager_decode_ms_per_step']:.3f} ms/step "
        f"({res['eager_decode_tokens_per_s']:.1f} tok/s), graph "
        f"{res['decode_ms_per_step']:.3f} ms/step ({res['decode_tokens_per_s']:.1f} tok/s); "
        f"greedy ids equal, caches bit-equal {cache_equal}; graph built in {t_build:.2f}s, "
        f"{graph_gib:.3f} GiB reserved by it; peak {peak:.2f} GiB")
    log(f"{tag} prefill {prefill_ms:.2f} ms ({prefill_mallocs} cudaMalloc), before it "
        f"outside the counted window: " + ", ".join(f"{ms:.2f} ms ({n} cudaMalloc)"
                                                   for ms, n in repeats))
    log(f"{tag} first ids per sequence: {ids[:, :8].tolist()}")
    for what, c in res["launches_by_shape"].items():
        log(f"{tag} launches of {what}: {c}")
    return res, {**launches, **by_shape}


def mixtral_cut():
    """mixtral-8x7b at its published widths, cut to MIX_LAYERS layers (bf16
    weights of all 32 do not fit the card)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mixtral-8x7b"), n_layers=MIX_LAYERS)


def phase_moe_serve(torch, results):
    """mixtral-8x7b, published widths, MIX_LAYERS layers, bf16: run 1 at
    the main shape (B4 x 512, 32 steps; the window does not bind), run 2
    at B1 x 4160 with 64 steps (the window binds in prefill rows >= 4096
    and in every decode step), each eager and then through the graph.
    Returns the launches of each run's main path (run 1, run 2)."""
    cfg = mixtral_cut()
    log(f"[moe_serve] depth cut to {MIX_LAYERS} of 32 layers: 32 x 2.90 GB of bf16 weights "
        f"(93 GB) exceed the card's 80 GB; {MIX_LAYERS} layers are "
        f"{MIX_LAYERS * 2.90:.1f} GB (+0.5 GB embeddings and head)")
    params = init_logged(torch, cfg, "[moe_serve]")
    out = {}
    res, launches = serve_run(torch, cfg, params, "[moe_serve] run 1",
                              random_prompt(torch, cfg, B_MAIN, PROMPT), NEW, MAX_LEN)
    out["run1"] = res
    torch.cuda.empty_cache()
    res, launches2 = serve_run(torch, cfg, params, "[moe_serve] run 2",
                               random_prompt(torch, cfg, 1, MIX_LONG),
                               MIX_LONG_MAX - MIX_LONG, MIX_LONG_MAX)
    out["run2"] = res
    results["moe_serve"] = out
    return launches, launches2


def phase_moe_parity(torch, results):
    """mixtral widths, 1 layer, float32: the card against the CPU with the
    window cut to 128 so that it binds at S 300; then on the card at the
    published window 4096 and S 4160, prefill(S-1) + decode(1) against
    forward(S) at the last token (capacity factor 8: no drops)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    import numpy as np
    out = {}
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=1, dtype="float32",
                              sliding_window=128)
    params, _, out["card_vs_cpu_window_128"] = _parity(torch, cfg, b=2, s=300, steps=8,
                                                       max_len=320, seed=3)
    # capacity factor 8, as tests/test_models.py takes it: no choice is
    # dropped, so the forward's dispatch and the decode step's dense path
    # compute the last token alike (capacity drops hit the last tokens)
    cfg = dataclasses.replace(cfg, sliding_window=MIX_WINDOW,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, MIX_LONG))).cuda()
    with torch.no_grad():
        full, aux, _ = models.forward(cfg, params, toks)
        last = full[:, -1].clone()
        del full
        _, _, cache = models.forward(cfg, params, toks[:, :-1], collect_cache=True,
                                     kv_max=MIX_LONG_MAX)
        lg, _ = models.decode_step(cfg, params, toks[:, -1:], cache, MIX_LONG)
    rel = ((lg[:, 0] - last).abs().max() / last.abs().max()).item()
    log(f"[moe_parity] {cfg.name} widths x 1 layer fp32, window {MIX_WINDOW}, S {MIX_LONG}: "
        f"prefill(S-1) + decode(1) vs forward(S) on the card, rel err {rel:.3e} (tol 1e-3); "
        f"aux {aux.item():.6f}")
    if not (rel < 1e-3 and bool(torch.isfinite(aux))):
        raise AssertionError(f"{cfg.name}: decode does not continue the windowed prefill")
    out["decode_vs_forward_rel_err_window_4096"] = rel
    results["moe_parity"] = out


def whisper_frames(torch, cfg, batch, seed):
    """(batch, encoder_seq, d_model) float32 frame embeddings (the conv
    front end's output, a stub in both packages) from a seed, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda")


def phase_audio_serve(torch, results):
    """whisper-large-v3 at published widths and full depth (32 encoder, 32
    decoder layers), bf16, weights and frames from a seed: the encoder
    alone (its launches counted), then ``serve_run`` from the 4-token
    start-of-transcript prompt with 128 steps over a 448-row self cache.
    Returns the launches of the main path."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import cross_rows

    cfg = get_config("whisper-large-v3")
    if cross_rows(cfg.encoder_seq) != W_CROSS:
        raise AssertionError(f"cross cache of {cross_rows(cfg.encoder_seq)} rows")
    params = init_logged(torch, cfg, "[audio_serve]")
    frames = whisper_frames(torch, cfg, B_MAIN, seed=0)
    with torch.no_grad():
        models.encode(cfg, params, frames)                          # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        enc = models.encode(cfg, params, frames)
        torch.cuda.synchronize()
    t_enc = time.time() - t0
    enc_launches = dict(ops.LAUNCHES)
    log(f"[audio_serve] the encoder alone, B{B_MAIN} x {cfg.encoder_seq} frames: "
        f"{t_enc * 1e3:.2f} ms, launches {enc_launches}")
    if enc_launches["flash_attention"] != cfg.n_encoder_layers or \
            sum(enc_launches.values()) != cfg.n_encoder_layers:
        raise AssertionError(f"encoder launches {enc_launches}")
    if not bool(torch.isfinite(enc.float()).all()):
        raise AssertionError("encoder output is not finite")
    del enc
    prompt = torch.tensor([W_SOT] * B_MAIN, device="cuda")
    res, launches = serve_run(torch, cfg, params, "[audio_serve]", prompt, W_NEW, W_MAX_LEN,
                              inputs={"encoder_embeds": frames})
    res.update(encoder_layers=cfg.n_encoder_layers, encoder_frames=cfg.encoder_seq,
               encoder_ms=t_enc * 1e3, encoder_launches=enc_launches)
    results["audio_serve"] = res
    return launches


def phase_audio_parity(torch, results):
    """whisper widths, 4 encoder + 4 decoder layers, 1500 frames, float32:
    the card (kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("whisper-large-v3"), n_layers=4, n_encoder_layers=4,
                              dtype="float32")
    results["audio_parity"] = _parity(torch, cfg, b=2, s=len(W_SOT), steps=8, max_len=64,
                                      seed=5)[2]


def paligemma_prefix(torch, cfg, batch, seed, device="cuda"):
    """(batch, n_prefix_tokens, d_model) float32 patch embeddings (the
    SigLIP front end's output, a stub in both packages) from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.n_prefix_tokens, cfg.d_model), generator=gen,
                       device=device)


def phase_vlm_serve(torch, results):
    """paligemma-3b at published widths and full depth (18 layers), bf16,
    weights and the image prefix from a seed: ``serve_run`` over 256 image
    rows and a 32-token prompt (a prefill of 288 positions, the prefix
    seen bidirectionally), then 128 steps over a 448-row cache.  Returns
    the launches of the main path."""
    from repro_torch.configs import get_config

    cfg = get_config("paligemma-3b")
    if (cfg.n_prefix_tokens, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) != (V_PREFIX, VH, 1, VD):
        raise AssertionError(f"paligemma-3b's config is not the one this phase sizes: {cfg}")
    params = init_logged(torch, cfg, "[vlm_serve]")
    res, launches = serve_run(torch, cfg, params, "[vlm_serve]",
                              random_prompt(torch, cfg, B_MAIN, V_PROMPT), V_NEW, V_MAX_LEN,
                              inputs={"prefix_embeds": paligemma_prefix(torch, cfg, B_MAIN, 0)})
    results["vlm_serve"] = res
    return launches


def phase_vlm_parity(torch, results):
    """paligemma widths (d_model 2048, 8 heads of 256 on one KV head,
    vocab 257216), 2 layers, float32, the published 256-row image prefix
    before 16 tokens: the card (the SIMT flash kernel with the prefix at D
    256, float32 paged at D 256) against the CPU (plain versions)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("paligemma-3b"), n_layers=2, dtype="float32")
    results["vlm_parity"] = _parity(torch, cfg, b=2, s=16, steps=8, max_len=V_PREFIX + 32,
                                    seed=6)[2]


def cim_scu_layer(torch, cfg, weights, x, pos0, cache=None, *, exact=False, calls=None):
    """One llama3-8b decoder layer whose seven projections run on the RRAM
    crossbar (``ops.cim_matmul_quantized`` on weights quantised once) and
    whose attention softmax runs on the SCU (``ops.pwl_softmax``), in bf16
    between them.  ``exact``: the same layer with bf16 matmuls of the
    unquantised weights and torch.softmax, the yardstick.  x: (B, S, d).
    Each kernel call is appended to ``calls`` as (name, inputs, output).
    Returns the layer output, the (k, v) cache and the softmax rows."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import apply_rope, rmsnorm, silu

    B, S, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16

    def proj(name, h):
        w, wq, ws, wqt = weights[name]
        if exact:
            return h @ w
        out = ops.cim_matmul_quantized(h, wq, ws, wqt=wqt)
        if calls is not None:
            calls.append(("cim_matmul", (h, wq, ws), out))
        return out.to(bf)

    pos = torch.arange(pos0, pos0 + S, device=x.device)[None].expand(B, S)
    h = rmsnorm(x, None).reshape(B * S, d)
    q = apply_rope(proj("q", h).view(B, S, hq, hd), pos, cfg.rope_theta)
    k = apply_rope(proj("k", h).view(B, S, hkv, hd), pos, cfg.rope_theta)
    v = proj("v", h).view(B, S, hkv, hd)
    if cache is not None:
        k, v = torch.cat([cache[0], k], 1), torch.cat([cache[1], v], 1)
    T = k.shape[1]
    qg = q.float().view(B, S, hkv, hq // hkv, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    qpos = torch.arange(pos0, pos0 + S, device=x.device)
    masked = torch.arange(T, device=x.device)[None, :] > qpos[:, None]
    s = s.masked_fill(masked, -1e30).reshape(B, hq, S, T).to(bf)
    if exact:
        p = torch.softmax(s, dim=-1)
    else:
        p = ops.pwl_softmax(s)
        if calls is not None:
            calls.append(("pwl_softmax", (s,), p))
    a = torch.einsum("bkgst,btkd->bskgd", p.float().view(B, hkv, hq // hkv, S, T), v.float())
    x = x + proj("o", a.reshape(B * S, hq * hd).to(bf)).view(B, S, d)
    h = rmsnorm(x, None).reshape(B * S, d)
    f = (silu(proj("gate", h).float()) * proj("up", h).float()).to(bf)
    x = x + proj("down", f).view(B, S, d)
    return x, (k, v), p


def cim_scu_setup(torch):
    """llama3-8b's config, one layer's seven weights in bf16 from a seed,
    each with its quantisation and that weight in the kernel's layout (w,
    wq, wscale, wqt), made once, the LM head, and the
    prefill / decode inputs (B_MAIN x PROMPT and B_MAIN x 1 tokens' hidden
    states)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.cim_matmul import quantize_weights, weight_layout

    cfg = get_config("llama3-8b")
    d, hq, hkv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    shapes = {"q": (d, hq * hd), "k": (d, hkv * hd), "v": (d, hkv * hd),
              "o": (hq * hd, d), "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    weights = {}
    for name, (k_in, n_out) in shapes.items():
        w = randn(k_in, n_out, scale=k_in ** -0.5)
        wq, ws = quantize_weights(w)
        weights[name] = (w, wq, ws, weight_layout(wq))
    head = randn(d, cfg.vocab_size, scale=d ** -0.5)
    return cfg, weights, head, randn(B_MAIN, PROMPT, d), randn(B_MAIN, 1, d)


def phase_cim_scu(torch, results):
    """llama3-8b's full widths, one layer, bf16 weights from a seed: a
    4 x 512 prefill, the SCU softmax of its last-position vocab logits and
    a batch-4 decode step through the CIM and SCU kernels; then every
    output against the plain versions, the layer against its exact
    counterpart, and the JAX package's ablations."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim_matmul import cim_matmul_plain
    from repro_torch.kernels.pwl_softmax import pwl_softmax_plain
    from repro_torch.models.common import rmsnorm

    cfg, weights, head, x, x_new = cim_scu_setup(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)

    def path(calls):
        t0 = time.time()
        y, cache, _ = cim_scu_layer(torch, cfg, weights, x, 0, calls=calls)
        logits = (rmsnorm(y[:, -1], None) @ head).float()
        probs = ops.pwl_softmax(logits)
        if calls is not None:
            calls.append(("pwl_softmax", (logits,), probs))
        torch.cuda.synchronize()
        t1 = time.time()
        y_new, _, p_dec = cim_scu_layer(torch, cfg, weights, x_new, PROMPT, cache, calls=calls)
        torch.cuda.synchronize()
        return y, probs, y_new, p_dec, t1 - t0, time.time() - t1

    path(None)                  # warm-up outside the counted window (cuBLAS, allocator)
    calls = []                  # every kernel call of the counted window
    ops.reset_launch_counts()
    y, probs, y_new, p_dec, t_prefill, t_decode = path(calls)
    launches = dict(ops.LAUNCHES)

    want = {**dict.fromkeys(launches, 0), "cim_matmul": 14, "pwl_softmax": 3}
    log(f"[cim_scu] launches on the path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"cim_scu launches {launches}, expected {want}")
    if tuple(p_dec.shape) != (B_MAIN, HQ, 1, PROMPT + 1) or tuple(probs.shape) != (B_MAIN, cfg.vocab_size):
        raise AssertionError(f"unexpected shapes {tuple(p_dec.shape)} {tuple(probs.shape)}")
    for what, t in (("prefill output", y), ("decode output", y_new), ("vocab probs", probs)):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"cim_scu {what} is not finite")
    rows = probs.sum(-1)
    if not bool(((rows - 1).abs() < 1e-5).all()):
        raise AssertionError(f"vocab softmax rows sum to {rows.tolist()}")

    # every launch of the window against its plain version
    errs = {"cim_matmul": 0.0, "pwl_softmax": 0.0}
    for name, args, out in calls:
        if name == "cim_matmul":
            ref = cim_matmul_plain(*args)
            err = (out - ref).abs().max().item() / ref.abs().max().item()
            tol = TOL_CIM_REL
            if not err <= tol:
                raise AssertionError(f"cim_scu cim_matmul {tuple(args[0].shape)}: kernel "
                                     f"disagrees with its plain version ({err} > {tol})")
        else:
            err = _check_softmax(torch, out, pwl_softmax_plain(*args),
                                 f"{tuple(args[0].shape)} {str(out.dtype)[6:]}", "cim_scu")
        errs[name] = max(errs[name], err)
    log(f"[cim_scu] {len(calls)} launches against their plain versions: cim_matmul max "
        f"rel err {errs['cim_matmul']:.3e} (tol {TOL_CIM_REL:.0e}), pwl_softmax max abs "
        f"err {errs['pwl_softmax']:.3e}")

    # the layer against its exact counterpart (bf16 matmuls, exact softmax)
    with torch.no_grad():
        y_ex, cache_ex, _ = cim_scu_layer(torch, cfg, weights, x, 0, exact=True)
        y_new_ex, _, _ = cim_scu_layer(torch, cfg, weights, x_new, PROMPT, cache_ex,
                                       exact=True)
    dev = {}
    for what, got, ex, x_in in (("prefill", y, y_ex, x), ("decode", y_new, y_new_ex, x_new)):
        upd, upd_ex = got.float() - x_in.float(), ex.float() - x_in.float()
        dev[what] = (upd - upd_ex).norm().item() / upd_ex.norm().item()
    log(f"[cim_scu] layer update vs the exact layer (rel norm): prefill "
        f"{dev['prefill']:.4f}, decode {dev['decode']:.4f}")

    # ablations of the JAX package's benches: ADC bits on the up projection
    h_up = rmsnorm(x, None).reshape(B_MAIN * PROMPT, cfg.d_model)
    w_up, wq_up, ws_up, wqt_up = weights["up"]
    exact_up = h_up.float() @ w_up.float()
    adc_err = {}
    for adc in (6, 8, 10, 12, 14):
        o = ops.cim_matmul_quantized(h_up, wq_up, ws_up, wqt=wqt_up, adc_bits=adc)
        adc_err[adc] = ((o - exact_up).norm() / exact_up.norm()).item()
    errs_list = list(adc_err.values())
    log("[cim_scu] up proj rel err vs the exact product by adc_bits: "
        + ", ".join(f"{a}: {e:.5f}" for a, e in adc_err.items()))
    if not (all(map(math.isfinite, errs_list))
            and all(a >= b for a, b in zip(errs_list, errs_list[1:]))):
        raise AssertionError(f"ADC sweep not finite and non-increasing: {adc_err}")
    # PWL softmax against the exact softmax at attention scale
    s = 4 * torch.randn((4096, 128), generator=gen, device="cuda")
    pw, ex = ops.pwl_softmax(s), torch.softmax(s, dim=-1)
    agree = (pw.argmax(-1) == ex.argmax(-1)).float().mean().item()
    maxdev = (pw - ex).abs().max().item()
    log(f"[cim_scu] pwl softmax vs exact at (4096, 128) x 4: top-1 agreement "
        f"{agree:.4f}, max deviation {maxdev:.5f}")
    if not (math.isfinite(maxdev) and 0 <= agree <= 1):
        raise AssertionError("PWL ablation is not finite")
    log(f"[cim_scu] layer prefill {B_MAIN} x {PROMPT} + vocab softmax {t_prefill * 1e3:.2f} ms, "
        f"decode step {t_decode * 1e3:.2f} ms (host clock)")
    results["cim_scu"] = {
        "launches": launches, "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
        "kernel_vs_plain": errs, "layer_update_rel_dev_vs_exact": dev,
        "adc_rel_err_vs_exact": adc_err, "pwl_top1_agreement": agree,
        "pwl_max_dev": maxdev}
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


def host_peak_gib():
    """This process's peak resident memory so far, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20

# glibc's mallopt parameters (malloc.h) and their defaults
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
TRIM_THRESHOLD_DEFAULT, MMAP_MAX_DEFAULT = 128 * 1024, 65536


@contextlib.contextmanager
def host_heap():
    """The CPU reference runs' host tensors from glibc's heap, reused once
    freed, instead of a fresh mmap for each large block (glibc's default):
    such a block is page-faulted in anew on every allocation, and the CPU's
    memory-bound passes (AdamW over a vocabulary-wide embedding) allocate
    one for each temporary.  On leaving, the defaults come back and the
    heap's free pages go back to the system.  The numbers are the same
    either way.  Where the C library has no ``mallopt``, nothing changes."""
    import ctypes
    libc = ctypes.CDLL(None)
    mallopt = getattr(libc, "mallopt", None)
    if mallopt is None:
        yield
        return
    mallopt(M_MMAP_MAX, 0)
    mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)
    try:
        yield
    finally:
        mallopt(M_MMAP_MAX, MMAP_MAX_DEFAULT)
        mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD_DEFAULT)
        libc.malloc_trim(0)


def _parity(torch, cfg, *, b, s, steps, max_len, seed):
    """float32 weights from a seed on the card, copied to the CPU: prefill
    logits, ``steps`` decode-step logits and the greedy ids of both (an
    encoder-decoder also takes frame embeddings from the seed, a prefix-LM
    its image prefix)."""
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
    inputs = {}
    if cfg.is_encoder_decoder:
        inputs["encoder_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    if cfg.n_prefix_tokens:
        inputs["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model), dtype=np.float32))
    rows = s + cfg.n_prefix_tokens          # cache rows after the prefill
    out = {}
    for dev in ("cuda", "cpu"):
        with host_heap() if dev == "cpu" else contextlib.nullcontext():
            ops.reset_launch_counts()
            t0 = time.time()
            enc = {k: t.to(dev) for k, t in inputs.items()}
            with torch.no_grad():
                logits, _, _ = models.forward(cfg, params[dev], prompt.to(dev), **enc)
            tok, cache = make_prefill_step(cfg, kv_max=max_len)(
                params[dev], {"tokens": prompt.to(dev), **enc})
            serve = make_serve_step(cfg)
            ids, step_logits = [tok.cpu()], []
            for i in range(steps):
                with torch.no_grad():
                    lg, _ = models.decode_step(cfg, params[dev], tok,
                                               {k: {kk: vv.clone() for kk, vv in c.items()}
                                                for k, c in cache.items()}, rows + i + 1)
                step_logits.append(lg.float().cpu())
                tok, cache = serve(params[dev], cache, tok, rows + i + 1)
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
    log(f"[parity] {cfg.name} widths x {cfg.n_layers} layers fp32, B{b} S{s} "
        + (f"after a {cfg.n_prefix_tokens}-row prefix " if cfg.n_prefix_tokens else "")
        + f"+{steps} "
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
    """Requests through the card's Server, whose decode step is a captured
    CUDA graph, for the six served models (mixtral at MIX_LAYERS layers;
    whisper without its encoder, as the JAX Server: a zero cross cache;
    paligemma without its image prefix, as the JAX Server);
    the launch counters, zeroed after the Server is built, count each
    replay's kernels exactly."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import CompiledServeStep
    import numpy as np

    out = {}
    for arch in (*SERVE_ARCH.values(), "mixtral-8x7b", "whisper-large-v3", "paligemma-3b"):
        cfg = mixtral_cut() if arch == "mixtral-8x7b" else get_config(arch)
        t0 = time.time()
        srv = Server(cfg, max_batch=4, max_len=64, seed=0)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        if not isinstance(srv.step_fn, CompiledServeStep):
            raise AssertionError("the card's Server does not run the captured step")
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
        want = {**dict.fromkeys(ops.LAUNCHES, 0),
                "paged_attention": expected_launches(cfg, steps)["paged_attention"]}
        if dict(ops.LAUNCHES) != want:
            raise AssertionError(f"Server launches {ops.LAUNCHES}, expected {want}")
        for s in srv.slots[:len(prompts)]:
            if len(s.generated) != rounds:
                raise AssertionError("a slot missed a decode round")
            if not all(0 <= t < cfg.vocab_size for t in s.generated):
                raise AssertionError("token id out of range")
        if srv.active() != len(prompts):
            raise AssertionError("wrong number of active slots")
        log(f"[server] {arch}: built (params, cache, graph) in {t_build:.1f}s; "
            f"{len(prompts)} requests, {steps} decode steps in {dt:.2f}s "
            f"({dt / steps * 1e3:.2f} ms a step), launches {dict(ops.LAUNCHES)}")
        out[arch] = {"requests": len(prompts), "steps": steps, "seconds": dt,
                     "build_s": t_build}
        del srv
        torch.cuda.empty_cache()
    results["server"] = out


def picnic_cfgs():
    """The picnic_decode phase's configs: llama3-8b as published (bf16),
    and its float32 cut of PICNIC_F32_LAYERS layers."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    return {"bfloat16": cfg,
            "float32": dataclasses.replace(cfg, n_layers=PICNIC_F32_LAYERS, dtype="float32")}


def picnic_rank(rank: int, out_dir: str) -> int:
    """One rank of the picnic_decode phase (run as ``chip_smoke.py
    --picnic-rank R --picnic-dir DIR`` by the phase): gloo over a file
    store in DIR, the (1, 2) mesh on the card, each config's prefill of the
    full batch under ``sp_attention`` and ``picnic_decode`` (each rank its
    250 rows of the 500, rank 1's flash at q_offset 250; it returns the
    rank's cache shard), then PICNIC_NEW eager greedy steps under the same
    context; the launch counters are zeroed before the prefill and read
    after the decode.  Rank 0 then runs the single-rank prefill and
    decode, fed the picnic run's tokens.  Writes DIR/rank{R}_{dtype}.pt
    (logits, ids, ms a step, launches)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import models, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step

    import datetime
    world = PICNIC_MESH[0] * PICNIC_MESH[1]
    # a rank that fails stops the other at its next collective within 120 s
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    torch.cuda.set_device(rank % torch.cuda.device_count())     # both on the one card
    mesh = init_device_mesh("cuda", PICNIC_MESH, mesh_dim_names=("data", "model"))
    ctx = sharding.ShardingCtx(mesh, {}, {"picnic_decode": True, "sp_attention": True,
                                          "seq_axes": ("model",), "dp_axes": ("data",)})
    tag = f"[picnic_decode rank {rank}]"
    for dt, cfg in picnic_cfgs().items():
        params = init_logged(torch, cfg, tag)
        prompt = random_prompt(torch, cfg, PICNIC_B, PICNIC_PROMPT)
        prefill = make_prefill_step(cfg, kv_max=PICNIC_MAX_LEN)
        prefill(params, {"tokens": prompt[:, :64]})             # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with sharding.use_sharding(ctx):     # sequence-parallel: this rank's cache shard
            tok, local = prefill(params, {"tokens": prompt})
        first, ids, logits, step_s = tok, [tok], [], []
        with torch.no_grad(), sharding.use_sharding(ctx):
            for i in range(PICNIC_NEW):
                torch.cuda.synchronize()
                t0 = time.time()
                lg, local = models.decode_step(cfg, params, tok, local, PICNIC_PROMPT + i + 1)
                tok = torch.argmax(lg[:, -1:], dim=-1)
                torch.cuda.synchronize()
                step_s.append(time.time() - t0)
                logits.append(lg[:, 0].float())
                ids.append(tok)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        by_shape = [[n, key, c] for (n, key), c in sorted(ops.LAUNCHES_BY_SHAPE.items())]
        saved = {"logits": torch.stack(logits).cpu(), "ids": torch.cat(ids, 1).cpu(),
                 "step_ms": [t * 1e3 for t in step_s], "launches": launches,
                 "launches_by_shape": by_shape,
                 "shard_rows": local["b0_dense"]["k"].shape[2],
                 "seq_index": sharding.axes_index(mesh, ("model",))}
        del local, logits
        if rank == 0:                   # the single-rank prefill and decode, the same tokens
            _, cache = prefill(params, {"tokens": prompt})
            single = []
            with torch.no_grad():
                for i in range(PICNIC_NEW):
                    lg, cache = models.decode_step(cfg, params, ids[i], cache,
                                                   PICNIC_PROMPT + i + 1)
                    single.append(lg[:, 0].float())
            saved["single_logits"] = torch.stack(single).cpu()
            del cache, single
        torch.save(saved, f"{out_dir}/rank{rank}_{dt}.pt")
        log(f"{tag} {dt}: launches {launches}, first ids {first[:, 0].tolist()}")
        del params, prompt, first, ids, tok, lg
        torch.cuda.empty_cache()
    dist.barrier()                      # no rank tears gloo down while another still talks
    dist.destroy_process_group()
    return 0


def phase_picnic_decode(torch, results):
    """PICNIC's sequence-sharded decode on the card, from the
    sequence-parallel prefill: spawns the two ranks (``picnic_rank``) and
    holds what they wrote: the shard of 512 rows each; both ranks' logits
    bit-equal (the batch is not split, and the all-reduces give both the
    same sums); each rank's prefill launching the flash kernel once a
    layer at its rows' shape and q_offset (250 rows against 500 keys, rank
    1 at 250); each paged launch of the decode in the partial mode, 32 a
    step a rank; bf16 against the single-rank prefill and decode per row
    within PICNIC_BF16_ROW_REL, with the share of equal greedy ids
    printed; float32 greedy ids equal and logits within PICNIC_F32_REL.  Returns rank 0's launches, per kernel and per (kernel,
    launch_key)."""
    import tempfile
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import launch_key

    _build.build_all()                  # built once here, loaded by the ranks
    torch.cuda.empty_cache()
    world = PICNIC_MESH[0] * PICNIC_MESH[1]
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--picnic-rank", str(r), "--picnic-dir", d],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=PICNIC_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, texts)):
            for line in text.splitlines():
                log(f"[picnic_decode] {line}" if line.startswith("[picnic_decode")
                    else f"[picnic_decode rank {r}] {line}")
            if p.returncode != 0:
                raise AssertionError(f"picnic_decode: rank {r} exited {p.returncode}")
        runs = {dt: [torch.load(f"{d}/rank{r}_{dt}.pt") for r in range(world)]
                for dt in picnic_cfgs()}
    out = {}
    for dt, ranks in runs.items():
        cfg = picnic_cfgs()[dt]
        r0 = ranks[0]
        want = r0["single_logits"]
        got = r0["logits"]
        if got.shape != (PICNIC_NEW, PICNIC_B, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"picnic_decode {dt}: logits {tuple(got.shape)}, or not finite")
        for r, run in enumerate(ranks):
            if run["shard_rows"] != PICNIC_MAX_LEN // world or run["seq_index"] != r:
                raise AssertionError(f"picnic_decode: rank {r} holds {run['shard_rows']} rows "
                                     f"as shard {run['seq_index']}")
            if not (torch.equal(run["logits"], got) and torch.equal(run["ids"], r0["ids"])):
                raise AssertionError(f"picnic_decode {dt}: rank {r}'s logits differ from rank 0's")
            key = [["paged_attention", k, c] for _, k, c in run["launches_by_shape"]
                   if k.endswith("mode=partial")]
            want_paged = cfg.n_layers * PICNIC_NEW
            rows = PICNIC_PROMPT // world
            q = torch.empty((PICNIC_B, rows, cfg.n_heads, cfg.head_dim),
                            dtype=getattr(torch, dt), device="meta")
            k = torch.empty((PICNIC_B, PICNIC_PROMPT, cfg.n_kv_heads, cfg.head_dim),
                            dtype=getattr(torch, dt), device="meta")
            flash = ["flash_attention", launch_key(q, k, q_offset=r * rows), cfg.n_layers]
            if run["launches"] != {"flash_attention": cfg.n_layers, "paged_attention": want_paged} \
                    or len(key) != 1 or key[0][2] != want_paged \
                    or flash not in run["launches_by_shape"]:
                raise AssertionError(f"picnic_decode {dt} rank {r}: launches {run['launches']}, "
                                     f"{run['launches_by_shape']}")
        same_ids = (want.argmax(-1) == r0["ids"][:, 1:].T).float().mean().item()
        rows = ((got - want).norm(dim=-1) / want.norm(dim=-1)).flatten()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        step_ms = sorted(r0["step_ms"][1:])[len(r0["step_ms"][1:]) // 2]
        res = {"n_layers": cfg.n_layers, "batch": PICNIC_B, "prompt": PICNIC_PROMPT,
               "new_tokens": PICNIC_NEW, "max_len": PICNIC_MAX_LEN, "mesh": PICNIC_MESH,
               "shard_rows": r0["shard_rows"], "greedy_ids_equal_share": same_ids,
               "logits_rel_err": rel, "row_rel_l2_max": rows.max().item(),
               "row_rel_l2_median": rows.median().item(),
               "decode_ms_per_step_correctness_only": step_ms,
               "launches": r0["launches"]}
        log(f"[picnic_decode] llama3-8b {dt} x {cfg.n_layers} layers, B{PICNIC_B}, "
            f"{PICNIC_PROMPT} + {PICNIC_NEW} steps, 2 ranks of {r0['shard_rows']} rows: "
            f"against the single-rank decode, logits rel err {rel:.3e}, per-row relative L2 "
            f"max {res['row_rel_l2_max']:.3e} median {res['row_rel_l2_median']:.3e}, greedy "
            f"ids equal {100 * same_ids:.2f}%; ranks bit-equal; decode {step_ms:.2f} ms a step "
            f"(median, correctness-only: two ranks share one card's SMs)")
        if dt == "float32" and not (rel <= PICNIC_F32_REL and same_ids == 1.0):
            raise AssertionError(f"picnic_decode float32: rel err {rel}, ids equal {same_ids}")
        if dt == "bfloat16" and not res["row_rel_l2_max"] <= PICNIC_BF16_ROW_REL:
            raise AssertionError(f"picnic_decode bf16: a row {res['row_rel_l2_max']} from "
                                 f"the single-rank decode")
        out[dt] = res
    results["picnic_decode"] = out
    r0 = runs["bfloat16"][0]
    return {**r0["launches"], **{(n, k): c for n, k, c in r0["launches_by_shape"]}}


def sharded_cfgs(kind):
    """The ``kind`` phase's configs (``dp_train`` or ``sp_train``):
    llama3.2-1b's float32 cut of DP_F32_LAYERS layers, and bf16 with remat
    at DP_BF16_LAYERS layers (``dp_train``) or as published, 16 layers
    (``sp_train``)."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    bf16 = cfg if kind == "sp_train" else dataclasses.replace(cfg, n_layers=DP_BF16_LAYERS)
    return {"float32": dataclasses.replace(cfg, n_layers=DP_F32_LAYERS, dtype="float32"),
            "bfloat16": bf16}


def _params_bits_equal(torch, dist, params):
    """Whether every rank's ``params`` are rank 0's, bit for bit (each leaf
    broadcast from rank 0 and compared as bytes)."""
    from repro_torch.tree import tree_leaves
    differ = 0
    for t in tree_leaves(params):
        mine = t.detach().contiguous()
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        differ += not torch.equal(theirs.view(torch.uint8), mine.view(torch.uint8))
    flag = torch.tensor([differ], device=mine.device)
    dist.all_reduce(flag)
    return int(flag.item()) == 0


def sharded_rank(kind: str, rank: int, out_dir: str) -> int:
    """One rank of the ``dp_train`` or ``sp_train`` phase (run as
    ``chip_smoke.py --dp-rank R --dp-dir DIR`` / ``--sp-rank R --sp-dir
    DIR`` by the phase): gloo over a file store in DIR, the phase's mesh on
    the card (``dp_train`` (2, 1), each rank its B4 of the global B8 x
    S1024; ``sp_train`` (1, 2) under ``sp_attention``, each rank the global
    B4 x S2048, of which its forward keeps 1024 rows).  For each of
    ``sharded_cfgs(kind)``: rank 0 first runs the single-rank eager steps
    on the full batches (the other rank waits), then both ranks cut the
    same seed-0 state by the specs and run ``make_sharded_train_step`` on
    their batch shards, the launch counters zeroed just before and read
    just after.  ``dp_train`` then runs ``compressed_allreduce`` over the
    two ranks on CUDA tensors of llama3.2-1b's embed-gradient shape and on
    the same values on the CPU, and after the bf16 steps times the step's
    two collectives apart: the gather of every param shard, and the SUM
    all-reduce of float32 buffers of the gradients' shapes.  Writes
    DIR/rank{R}.pt."""
    import datetime
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.runtime import compressed_allreduce
    from repro_torch.tree import tree_from_paths, tree_paths

    sp = kind == "sp_train"
    mesh_shape, (gb, gs) = (SP_MESH, (SP_B, SP_S)) if sp else (DP_MESH, (TRAIN_B, TRAIN_S))
    world = mesh_shape[0] * mesh_shape[1]
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    torch.cuda.set_device(rank % torch.cuda.device_count())     # both on the one card
    mesh = init_device_mesh("cuda", mesh_shape, mesh_dim_names=("data", "model"))
    tag = f"[{kind} rank {rank}]"
    saved = {}
    hyper = dict(base_lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    host = lambda tree: {path: t.detach().to("cpu", torch.float32, copy=True)
                         for path, t in tree_paths(tree)}
    for dt, cfg in sharded_cfgs(kind).items():
        n_steps = DP_F32_STEPS if dt == "float32" else DP_BF16_STEPS
        batches = train_batches(torch, cfg, gb, gs, n_steps)
        res = {"seconds": {}}
        t_part = time.time()
        if rank == 0:                   # the single-rank steps on the full batches
            params, state = steps.init_train_state(
                cfg, torch.Generator(device="cuda").manual_seed(0))
            p0 = host(params) if dt == "float32" else None
            single = steps.make_train_step(cfg, **hyper)
            res["single"] = []
            for b in batches:
                params, state, m = single(params, state, b)
                res["single"].append({k: float(v) for k, v in m.items()})
            p_single = host(params) if dt == "float32" else None
            log(f"{tag} {dt}: single-rank losses {[m['loss'] for m in res['single']]}")
            del params, state, single
            torch.cuda.empty_cache()
        res["seconds"]["single_rank"] = time.time() - t_part
        dist.barrier()
        t_part = time.time()
        torch.cuda.reset_peak_memory_stats()
        params, state = steps.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
        pspecs = sharding.param_specs(cfg, params, mesh, "train")
        ospecs = sharding.opt_state_specs(cfg, state, pspecs, mesh)
        ps, os_ = steps.shard_train_state(params, state, pspecs, ospecs, mesh)
        del params, state
        torch.cuda.empty_cache()
        ctx = sharding.ShardingCtx(mesh, sharding.activation_rules(cfg, mesh, "train"),
                                   SP_OPTIONS if sp else None)
        step = steps.make_sharded_train_step(cfg, ctx, pspecs, ospecs, **hyper)
        bspecs = sharding.batch_specs(cfg, batches[0], mesh)
        local = [{k: sharding.local_shard(v, bspecs[k], mesh) for k, v in b.items()}
                 for b in batches]
        del batches
        res.update(metrics=[], step_ms=[], bits_equal=[])
        torch.cuda.synchronize()
        res["seconds"]["cut"] = time.time() - t_part
        t_part = time.time()
        ops.reset_launch_counts()
        for b in local:
            t0 = time.time()
            ps, os_, m = step(ps, os_, b)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            res["step_ms"].append((time.time() - t0) * 1e3)
            if dt == "float32":
                full = tree_from_paths(
                    (path, sharding.gather_shard(t, spec, mesh,
                                                 sharding.full_shape(t.shape, spec, mesh)))
                    for (path, t), (_, spec) in zip(tree_paths(ps), tree_paths(pspecs)))
                res["bits_equal"].append(_params_bits_equal(torch, dist, full))
        res["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        res["launches_by_shape"] = [[n, key, c] for (n, key), c in
                                    sorted(ops.LAUNCHES_BY_SHAPE.items())]
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["seconds"]["sharded_steps"] = time.time() - t_part
        if dt == "bfloat16" and not sp:     # the step's collectives, timed apart
            leaves = [(t, spec) for (_, t), (_, spec) in zip(tree_paths(ps), tree_paths(pspecs))]
            torch.cuda.synchronize()
            t0 = time.time()
            for t, spec in leaves:
                sharding.gather_shard(t, spec, mesh, sharding.full_shape(t.shape, spec, mesh))
            torch.cuda.synchronize()
            res["seconds"]["gather_params"] = time.time() - t0
            t0 = time.time()
            for t, spec in leaves:
                buf = torch.zeros(sharding.full_shape(t.shape, spec, mesh), device="cuda")
                dist.all_reduce(buf, group=mesh.get_group("data"))
                del buf
            torch.cuda.synchronize()
            res["seconds"]["allreduce_f32_grads"] = time.time() - t0
        if dt == "float32" and rank == 0:
            mine = host(full)
            res["update_rel"] = {"/".join(path): (
                (mine[path] - p_single[path]).norm()
                / (p_single[path] - p0[path]).norm().clamp_min(1e-30)).item() for path in p0}
            del p0, p_single, mine
        log(f"{tag} {dt}: losses {[m['loss'] for m in res['metrics']]}, "
            f"{res['step_ms'][-1]:.1f} ms the last step, peak {res['peak_gib']:.2f} GiB, "
            f"launches {res['launches']}, seconds "
            + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()))
        saved[dt] = res
        del ps, os_, step, local
        if dt == "float32":
            del full
        torch.cuda.empty_cache()
    if not sp:
        # the compressed all-reduce at the embed gradient's shape, CUDA and CPU
        shape = (sharded_cfgs(kind)["bfloat16"].vocab_size,
                 sharded_cfgs(kind)["bfloat16"].d_model)
        g = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(rank),
                        device="cuda") * 1e-3
        t0 = time.time()
        red, err = compressed_allreduce({"g": g}, {"g": torch.zeros_like(g)}, mesh, "data")
        torch.cuda.synchronize()
        cuda_s = time.time() - t0
        t0 = time.time()
        red_cpu, err_cpu = compressed_allreduce({"g": g.cpu()}, {"g": torch.zeros(shape)}, mesh,
                                                "data")
        cpu_s = time.time() - t0
        exact = g.cpu().double()
        dist.all_reduce(exact)
        got = red["g"].cpu()
        saved["compress"] = {
            "bit_equal": bool(torch.equal(got.view(torch.int32), red_cpu["g"].view(torch.int32))
                              and torch.equal(err["g"].cpu().view(torch.int32),
                                              err_cpu["g"].view(torch.int32))),
            "rel": ((got.double() - exact).norm() / exact.norm()).item(),
            "cuda_s": cuda_s, "cpu_s": cpu_s, "shape": list(shape)}
        log(f"{tag} compressed all-reduce {shape}: {saved['compress']}")
    torch.save(saved, f"{out_dir}/rank{rank}.pt")
    dist.barrier()                      # no rank tears gloo down while another still talks
    dist.destroy_process_group()
    return 0


def sp_launch_keys(torch, cfg, rank: int):
    """The flash forward's and backward's launch key of ``sp_train``'s rank
    ``rank``: its 1024 rows of the global S2048 against all 2048 keys, at
    ``q_offset`` rank * 1024."""
    from repro_torch.kernels.flash_attention import launch_key
    dt = getattr(torch, cfg.dtype)
    rows = SP_S // (SP_MESH[0] * SP_MESH[1])
    q = torch.empty((SP_B, rows, cfg.n_heads, cfg.head_dim), dtype=dt, device="meta")
    k = torch.empty((SP_B, SP_S, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device="meta")
    return launch_key(q, k, q_offset=rank * rows)


def phase_sharded_train(torch, results, kind):
    """Sharded training on the card, ``dp_train`` or ``sp_train``: spawns
    the two ranks (``sharded_rank``) and holds what they wrote (see DP_*
    and SP_* above): float32 metrics within TRAIN_METRIC_REL of the
    single-rank steps, updates within DP_UPDATE_REL, gathered params
    bit-equal across ranks after every step; bf16 losses bit-equal across
    ranks and falling, within the DP_BF16_* bars of the single-rank steps;
    exact launch counts a rank (2 flash forwards with lse and 1 backward a
    layer a step, as ``train``; ``sp_train``: each at its rank's shape and
    ``q_offset``, ``sp_launch_keys``); ``dp_train``: the compressed
    all-reduce's CUDA result bit-equal to the CPU's.  The ms a step is
    correctness-only: both ranks share one card's SMs and gloo stages every
    collective through the host.  Returns the last rank's bf16 launches,
    per kernel and per (kernel, launch_key)."""
    import tempfile
    from repro_torch.kernels import _build

    _build.build_all()                  # built once here, loaded by the ranks
    torch.cuda.empty_cache()
    sp = kind == "sp_train"
    flag = "--sp" if sp else "--dp"
    mesh_shape = SP_MESH if sp else DP_MESH
    world = mesh_shape[0] * mesh_shape[1]
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   f"{flag}-rank", str(r), f"{flag}-dir", d],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=DP_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, texts)):
            for line in text.splitlines():
                log(line if line.startswith(f"[{kind}") else f"[{kind} rank {r}] {line}")
            if p.returncode != 0:
                raise AssertionError(f"{kind}: rank {r} exited {p.returncode}")
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(world)]
    out = {}
    for dt, cfg in sharded_cfgs(kind).items():
        runs = [rk[dt] for rk in ranks]
        single = runs[0]["single"]
        n = len(single)
        want = {"flash_attention": 2 * cfg.n_layers * n, "flash_attention_bwd": cfg.n_layers * n}
        for r, run in enumerate(runs):
            if run["launches"] != want:
                raise AssertionError(f"{kind} {dt} rank {r}: launches {run['launches']}, "
                                     f"expected {want}")
            if sp:
                key = sp_launch_keys(torch, cfg, r)
                shaped = sorted([n_, k_, c] for n_, k_, c in run["launches_by_shape"])
                if shaped != sorted([[name, key, c] for name, c in want.items()]):
                    raise AssertionError(f"{kind} {dt} rank {r}: launches by shape {shaped}, "
                                         f"expected {want} at {key}")
            if run["metrics"] != runs[0]["metrics"]:
                raise AssertionError(f"{kind} {dt}: rank {r}'s metrics differ from rank 0's")
        rel = {k: max(abs(m[k] - s[k]) / abs(s[k]) for m, s in zip(runs[0]["metrics"], single))
               for k in ("loss", "ce", "grad_norm")}
        losses = [m["loss"] for m in runs[0]["metrics"]]
        res = {"n_layers": cfg.n_layers, "steps": n,
               "global_batch": [SP_B, SP_S] if sp else [TRAIN_B, TRAIN_S],
               "mesh": mesh_shape, "losses": losses,
               "single_losses": [s["loss"] for s in single],
               "rel_vs_single": rel, "launches_a_rank": runs[0]["launches"],
               "peak_gib": [run["peak_gib"] for run in runs],
               "step_ms_correctness_only": runs[0]["step_ms"]}
        log(f"[{kind}] llama3.2-1b {dt} x {cfg.n_layers} layers, global "
            f"B{res['global_batch'][0]} x S{res['global_batch'][1]} on 2 ranks"
            + (" (sequence-parallel: 1024 rows a rank)" if sp else "")
            + f": losses {losses} (single-rank {res['single_losses']}); "
            f"largest relative gap to the single-rank steps: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f"; peak {', '.join(f'{g:.2f}' for g in res['peak_gib'])} GiB a rank; "
            f"{sorted(runs[0]['step_ms'])[n // 2]:.1f} ms a step (median, correctness-only: "
            f"two ranks share one card, gloo through the host); launches a rank "
            f"{runs[0]['launches']}")
        res["seconds_rank0"] = runs[0]["seconds"]
        log(f"[{kind}] {dt} rank 0 seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in runs[0]["seconds"].items()))
        if dt == "float32":
            worst = max(runs[0]["update_rel"].items(), key=lambda kv: kv[1])
            res["update_rel_max"] = worst
            equal = all(all(run["bits_equal"]) for run in runs)
            log(f"[{kind}] float32: updates after {n} steps within {worst[1]:.3e} of the "
                f"single-rank run ({worst[0]}; bar {DP_UPDATE_REL}); ranks' gathered params "
                f"bit-equal after every step: {equal}")
            if not (max(rel.values()) <= TRAIN_METRIC_REL and worst[1] <= DP_UPDATE_REL
                    and equal and len(runs[0]["bits_equal"]) == n):
                raise AssertionError(f"{kind} float32: {rel}, {worst}, bits equal {equal}")
        else:
            if not (rel["loss"] <= DP_BF16_LOSS_REL and rel["grad_norm"] <= DP_BF16_GNORM_REL
                    and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
                raise AssertionError(f"{kind} bf16: {rel}, losses {losses}")
        out[dt] = res
    if not sp:
        comp = [rk["compress"] for rk in ranks]
        log(f"[dp_train] compressed all-reduce over 2 ranks at {comp[0]['shape']} float32: "
            f"CUDA bit-equal to the CPU call on both ranks: {all(c['bit_equal'] for c in comp)}; "
            f"relative error to the exact sum {comp[0]['rel']:.4e}; {comp[0]['cuda_s']:.2f} s "
            f"on the card, {comp[0]['cpu_s']:.2f} s on the CPU (correctness-only)")
        if not all(c["bit_equal"] for c in comp) or not comp[0]["rel"] < 0.02:
            raise AssertionError(f"dp_train: compressed all-reduce {comp}")
        out["compressed_allreduce"] = comp[0]
    results[kind] = out
    last = ranks[-1]["bfloat16"]
    return {**last["launches"], **{(n_, k_): c for n_, k_, c in last["launches_by_shape"]}}


def train_batches(torch, cfg, batch, seq, n, seed=0, device="cuda"):
    """``n`` batches of the port's PackedStream(seed) on ``device``, token
    ids as int64."""
    from repro_torch.data import PackedStream
    stream = PackedStream(cfg.vocab_size, seq, seed=seed)
    out = []
    for _ in range(n):
        b = stream.next_batch(batch)
        out.append({"tokens": torch.from_numpy(b["tokens"]).long().to(device),
                    "labels": torch.from_numpy(b["labels"]).long().to(device),
                    "mask": torch.from_numpy(b["mask"]).to(device)})
    return out


def first_grads(torch, cfg, params, batch):
    """Each leaf's gradient of the loss on ``batch`` (the first step's),
    by path."""
    from repro_torch.launch.steps import make_loss_fn
    from repro_torch.tree import tree_paths
    paths = list(tree_paths(params))
    loss, _ = make_loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in paths])
    return {path: g for (path, _), g in zip(paths, grads)}


def first_step_grads(step, params, state, batch):
    """``step(params, state, batch)``'s result and each leaf's gradient
    that step took (by path, before clipping), kept from the step's
    ``clip_by_global_norm``, which is wrapped for the call.  On the CPU it
    is the gradient ``first_grads`` takes, bit for bit, without a forward
    and backward of its own."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.tree import tree_paths
    clip, kept = steps_mod.clip_by_global_norm, {}

    def keep(grads, max_norm):
        kept.update((k, g.detach().clone()) for k, g in tree_paths(grads))
        return clip(grads, max_norm)

    steps_mod.clip_by_global_norm = keep
    try:
        out = step(params, state, batch)
    finally:
        steps_mod.clip_by_global_norm = clip
    return out, kept


def run_train(torch, results, phase, cfg, batches, *, steps, warmup, want, want_by_shape=None):
    """``steps`` + 2 AdamW steps of ``cfg`` (bf16, random weights from seed
    0) over ``batches`` (``steps`` + 2 of them) with lr 3e-4, the given
    warmup and total ``steps``: half of ``steps`` through the eager
    ``launch.steps.make_train_step``, one more eager step under
    torch.profiler, then the rest through a ``CompiledTrainStep`` built on
    the params and state the eager half leaves (its first call an eager
    step on a side stream, its second captures and replays), and one more
    replay under torch.profiler.  The main path is all of them: the launch
    counters are zeroed just before and read just after, and must equal
    ``want`` (launches a step; every kernel not named there 0) times the
    steps, and likewise per shape ``want_by_shape``.  Fails unless the last
    loss is below the first and every leaf's gradient at the first batch
    (taken apart, before the counted steps) is finite and non-zero.  Prints
    eager and graph ms a step (medians, host clock after the loss is read:
    eager steps 3 on, replays after the capture), tokens/s, the capture's
    seconds, the graph pool's GiB, peak GiB of each half, and each profiled
    step's device busy share and kernels' device time."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import CompiledTrainStep, init_train_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, opt_state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    tokens = batches[0]["tokens"].numel()
    log(f"[{phase}] {cfg.name}: {cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.is_encoder_decoder else "")
        + f", d_model {cfg.d_model}, {n_params / 1e9:.3f} B params in {cfg.dtype}, remat "
        f"{cfg.remat}, optimizer {cfg.optimizer}; batch {tuple(batches[0]['tokens'].shape)}"
        + (f" + {tuple(batches[0]['encoder_embeds'].shape)} frames"
           if "encoder_embeds" in batches[0] else "")
        + (f" after {tuple(batches[0]['prefix_embeds'].shape)} prefix rows"
           if "prefix_embeds" in batches[0] else "")
        + f"; init {time.time() - t0:.1f}s")
    grads = first_grads(torch, cfg, params, batches[0])
    bad = [path for path, g in grads.items()
           if not bool(torch.isfinite(g.float()).all()) or not bool(g.any())]
    if bad:
        raise AssertionError(f"{phase}: leaves without a finite non-zero gradient: {bad}")
    log(f"[{phase}] first step's gradient finite and non-zero on all {len(grads)} leaves")
    del grads
    hyper = dict(base_lr=3e-4, warmup=warmup, total_steps=steps)
    step = make_train_step(cfg, **hyper)
    half = steps // 2
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times, losses = [], []

    def timed(fn, batch):
        t = time.time()
        p, s, m = fn(params, opt_state, batch)
        losses.append(float(m["loss"]))          # reads the loss: the step is done
        times.append(time.time() - t)
        return p, s

    for i in range(half):
        params, opt_state = timed(step, batches[i])
    profiled = {"eager": trace(torch, lambda: timed(step, batches[half]))}
    params, opt_state = profiled["eager"].pop("result")
    peak_eager = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    compiled = CompiledTrainStep(cfg, params, opt_state, **hyper)
    for i in range(half + 1, steps + 1):
        timed(compiled, batches[i])
    profiled["graph"] = trace(torch, lambda: timed(compiled, batches[steps + 1]))
    launches, by_shape = dict(ops.LAUNCHES), dict(ops.LAUNCHES_BY_SHAPE)
    peak_graph = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_graph = torch.cuda.max_memory_reserved() / 2 ** 30
    n_run = steps + 2
    want = {**dict.fromkeys(launches, 0), **{k: n * n_run for k, n in want.items()}}
    log(f"[{phase}] launches on the main path ({n_run} steps): {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{phase} launches {launches}, expected {want}")
    for key, n in (want_by_shape or {}).items():
        log(f"[{phase}]   {key[0]} at {key[1]}: {by_shape.get(key, 0)} (expected {n * n_run})")
        if by_shape.get(key, 0) != n * n_run:
            raise AssertionError(f"{phase}: {by_shape.get(key, 0)} launches of {key}, "
                                 f"expected {n * n_run}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    med = median(times[2:half])
    med_graph = median(times[half + 3:steps + 1])
    pool = compiled.pool_bytes / 2 ** 30
    log(f"[{phase}] loss {losses[0]:.4f} -> {losses[-1]:.4f} over {n_run} steps; eager "
        f"{med * 1e3:.2f} ms a step (median of steps 3-{half}; first two {times[0] * 1e3:.1f} / "
        f"{times[1] * 1e3:.1f} ms), graph {med_graph * 1e3:.2f} ms a step (median of "
        f"{steps - half - 2} replays; the step's eager call {times[half + 1] * 1e3:.1f} ms, "
        f"capture and first replay {times[half + 2] * 1e3:.1f} ms, the capture "
        f"{compiled.capture_seconds:.2f} s), {tokens / med:.0f} -> {tokens / med_graph:.0f} "
        f"tokens/s; peak {peak_eager:.2f} GiB eager, {peak_graph:.2f} GiB with the graph "
        f"(pool {pool:.2f} GiB, reserved {reserved_graph:.2f} GiB); {nvidia_smi_line()}")
    profiled["graph"].pop("result")
    for what, prof in profiled.items():
        for us, n, key in [t for t in prof.pop("top") if "repro_torch" in t[2]]:
            log(f"[{phase}]   {what}: {us / 1e3:9.3f} ms  x{n:<5d} {key}")
        log(f"[{phase}] one {what} step under torch.profiler: wall {prof['wall_ms']:.2f} ms, "
            f"device busy {prof['device_busy_ms']:.2f} ms ({100 * prof['busy_share']:.1f}%), "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(prof["device_ms_by_class"].items())))
    results[phase] = {
        "arch": cfg.name, "batch": list(batches[0]["tokens"].shape), "steps": n_run,
        "losses": losses, "step_ms": [t * 1e3 for t in times], "median_step_ms": med * 1e3,
        "median_graph_step_ms": med_graph * 1e3, "capture_s": compiled.capture_seconds,
        "graph_pool_gib": pool, "tokens_per_s": tokens / med,
        "graph_tokens_per_s": tokens / med_graph, "peak_gib": peak_eager,
        "graph_peak_gib": peak_graph, "graph_reserved_gib": reserved_graph,
        "profiled_step": profiled["eager"], "profiled_replay": profiled["graph"]}
    return {**launches, **by_shape}


def phase_train(torch, results):
    """llama3.2-1b at full width and depth (16 layers, remat as the config
    has it) in bf16: 20 + 2 steps of B8 x S1024 from the port's
    PackedStream(seed=0), warmup 10 (``run_train``).  Each step launches
    the flash forward twice a layer (the forward, then remat's recompute)
    and its backward once."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat or cfg.n_layers != 16:
        raise AssertionError(f"{cfg.name}: expected 16 layers under remat")
    batches = train_batches(torch, cfg, TRAIN_B, TRAIN_S, TRAIN_STEPS + 2)
    return run_train(torch, results, "train", cfg, batches, steps=TRAIN_STEPS, warmup=10,
                     want={"flash_attention": 2 * cfg.n_layers,
                           "flash_attention_bwd": cfg.n_layers})


def audio_batches(torch, cfg, batch, seq, n, seed=0, device="cuda"):
    """``n`` batches of text from the port's PackedStream(seed) with the
    random frame embeddings (``cfg.encoder_seq`` of them, N(0, 0.02²),
    float32) that the train driver, as the reference's, gives an
    encoder-decoder (``launch.train._batch``, seeded by the step)."""
    from repro_torch.data import PackedStream
    from repro_torch.launch.train import _batch
    stream = PackedStream(cfg.vocab_size, seq, seed=seed)
    return [_batch(cfg, stream, batch, i, device) for i in range(n)]


def phase_audio_train(torch, results):
    """whisper-large-v3 at published widths and full depth (32 encoder + 32
    decoder layers, 1.601 B params) in bf16 under remat: 10 + 2 steps of B8 x
    S448 text (whisper's max_target_positions) over 1500 frames a sequence,
    warmup 5 (``run_train``).  Remat checkpoints each encoder layer and
    each decoder layer, so a step launches the flash forward twice for each
    of the 32 encoder self-attentions (non-causal, S1500), 32 decoder
    self-attentions (causal, S448) and 32 cross-attentions (non-causal, 448
    rows over 1500 frames), and its backward once for each: 192 + 96."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import launch_key

    cfg = get_config(AUDIO_TRAIN_ARCH)
    if not cfg.remat or (cfg.n_layers, cfg.n_encoder_layers, cfg.encoder_seq) != (32, 32,
                                                                                  W_FRAMES):
        raise AssertionError(f"{cfg.name}: expected 32 + 32 layers over {W_FRAMES} frames "
                             "under remat")
    batches = audio_batches(torch, cfg, AUDIO_TRAIN_B, AUDIO_TRAIN_S, AUDIO_TRAIN_STEPS + 2)
    n, n_enc, steps = cfg.n_layers, cfg.n_encoder_layers, AUDIO_TRAIN_STEPS

    def key(sq, skv, causal):
        q, k = (torch.empty((AUDIO_TRAIN_B, n, WH, WD), dtype=torch.bfloat16, device="meta")
                for n in (sq, skv))
        return launch_key(q, k, causal=causal)

    per_layer = {key(W_FRAMES, W_FRAMES, False): n_enc,                     # encoder
                 key(AUDIO_TRAIN_S, AUDIO_TRAIN_S, True): n,                # decoder self
                 key(AUDIO_TRAIN_S, W_FRAMES, False): n}                    # cross
    by_shape = {}
    for k, layers in per_layer.items():
        by_shape[("flash_attention", k)] = 2 * layers
        by_shape[("flash_attention_bwd", k)] = layers
    return run_train(torch, results, "audio_train", cfg, batches, steps=steps, warmup=5,
                     want={"flash_attention": 2 * (n_enc + 2 * n),
                           "flash_attention_bwd": (n_enc + 2 * n)},
                     want_by_shape=by_shape)


def phase_ssm_train(torch, results):
    """mamba2-2.7b at full width and depth (64 mamba layers, 2.830 B
    params) in bf16 under remat: 10 + 2 steps of B8 x S1024 from the port's
    PackedStream(seed=0), warmup 5 (``run_train``).  A step launches the
    SSD scan twice a layer (the forward, then remat's recompute) and its
    backward once: 128 + 64."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import launch_key

    cfg = get_config(SSM_TRAIN_ARCH)
    if not cfg.remat or cfg.n_layers != 64:
        raise AssertionError(f"{cfg.name}: expected 64 layers under remat")
    batches = train_batches(torch, cfg, SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS + 2)
    steps = SSM_TRAIN_STEPS
    x = torch.empty((SSM_TRAIN_B, SSM_TRAIN_S, SSM_H, SSM_P), dtype=torch.bfloat16,
                    device="meta")
    bm = torch.empty((SSM_TRAIN_B, SSM_TRAIN_S, cfg.ssm.d_state), device="meta")
    return run_train(torch, results, "ssm_train", cfg, batches, steps=steps, warmup=5,
                     want={"ssd_scan": 2 * cfg.n_layers,
                           "ssd_scan_bwd": cfg.n_layers},
                     want_by_shape={("ssd_scan", launch_key(x, bm)): 2 * cfg.n_layers,
                                    ("ssd_scan_bwd", launch_key(x, bm)): cfg.n_layers})


def phase_hybrid_train(torch, results):
    """zamba2-2.7b at full width and depth (54 mamba layers in 9 groups,
    each closed by the shared attention block of 32 heads of 80; 2.422 B
    params) in bf16 under remat: 10 + 2 steps of B8 x S1024 from the port's
    PackedStream(seed=0), warmup 5 (``run_train``).  Remat checkpoints
    each group (models/model.py's forward), so a step launches the SSD
    scan twice a mamba layer and its backward once (108 + 54), and the
    flash forward twice an application of the shared block and its
    backward, at D 80, once (18 + 9)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss

    cfg = get_config(HYBRID_TRAIN_ARCH)
    if not cfg.remat or (cfg.n_layers, cfg.attn_every, cfg.head_dim) != (54, 6, ZD):
        raise AssertionError(f"{cfg.name}: expected 54 mamba layers in groups of 6 and a "
                             f"shared block of head dim {ZD} under remat")
    b, s, steps = HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS
    batches = train_batches(torch, cfg, b, s, steps + 2)
    n, n_groups = cfg.n_layers, cfg.n_layers // cfg.attn_every
    x = torch.empty((b, s, SSM_H, SSM_P), dtype=torch.bfloat16, device="meta")
    bm = torch.empty((b, s, cfg.ssm.d_state), device="meta")
    q = torch.empty((b, s, ZH, ZD), dtype=torch.bfloat16, device="meta")
    fkey = fa.launch_key(q, q)
    return run_train(torch, results, "hybrid_train", cfg, batches, steps=steps, warmup=5,
                     want={"ssd_scan": 2 * n, "ssd_scan_bwd": n,
                           "flash_attention": 2 * n_groups,
                           "flash_attention_bwd": n_groups},
                     want_by_shape={("ssd_scan", ss.launch_key(x, bm)): 2 * n,
                                    ("ssd_scan_bwd", ss.launch_key(x, bm)): n,
                                    ("flash_attention", fkey): 2 * n_groups,
                                    ("flash_attention_bwd", fkey): n_groups})


def mixtral_train_cut():
    """mixtral-8x7b at its published widths, cut to MOE_TRAIN_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)


def phase_moe_train(torch, results):
    """mixtral-8x7b at its published widths (d_model 4096, 32 / 8 heads of
    128, 8 experts of 14336, top-2, window 4096) cut to MOE_TRAIN_LAYERS of
    32 layers, in bf16 under remat: 10 + 2 steps of B2 x S4160 from the port's
    PackedStream(seed=0), warmup 5 (``run_train``).  The window binds on
    each sequence's last 64 rows; 8320 tokens take the MoE dispatch path.
    A step launches the windowed flash forward twice a layer and its
    backward once."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import launch_key

    full, cfg = get_config(MOE_TRAIN_ARCH), mixtral_train_cut()
    if not cfg.remat or cfg.sliding_window != MIX_WINDOW:
        raise AssertionError(f"{cfg.name}: expected the window {MIX_WINDOW} under remat")
    per_layer = full.n_params(include_embeddings=False) / full.n_layers
    embed = full.n_params() - full.n_params(include_embeddings=False)
    gib = 12 / 2 ** 30              # bf16 weights and gradients, float32 AdamW moments
    log(f"[moe_train] depth cut to {cfg.n_layers} of {full.n_layers} layers: the state of "
        f"{full.n_layers} is {full.n_params() * gib:.1f} GiB at 12 bytes a parameter; a layer "
        f"is {per_layer / 1e9:.3f} B params ({per_layer * gib:.1f} GiB), the untied embedding "
        f"and head {embed / 1e9:.3f} B ({embed * gib:.1f} GiB), so {cfg.n_layers} layers are "
        f"{(cfg.n_layers * per_layer + embed) * gib:.1f} GiB")
    batches = train_batches(torch, cfg, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS + 2)
    steps, n = MOE_TRAIN_STEPS, cfg.n_layers
    q = torch.empty((MOE_TRAIN_B, MOE_TRAIN_S, HQ, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((MOE_TRAIN_B, MOE_TRAIN_S, HKV, D), dtype=torch.bfloat16, device="meta")
    key = launch_key(q, k, window=MIX_WINDOW)
    return run_train(torch, results, "moe_train", cfg, batches, steps=steps, warmup=5,
                     want={"flash_attention": 2 * n, "flash_attention_bwd": n},
                     want_by_shape={("flash_attention", key): 2 * n,
                                    ("flash_attention_bwd", key): n})


def vlm_batches(torch, cfg, batch, seq, n, seed=0, device="cuda"):
    """``n`` batches of text from the port's PackedStream(seed), each with
    ``paligemma_prefix``'s patch embeddings (float32 N(0, 1), drawn on the
    CPU from seed 1000 * seed + the batch's index, the same on either
    device) before its tokens."""
    out = train_batches(torch, cfg, batch, seq, n, seed=seed, device=device)
    for i, b in enumerate(out):
        b["prefix_embeds"] = paligemma_prefix(torch, cfg, batch, 1000 * seed + i,
                                              device="cpu").to(device)
    return out


def phase_vlm_train(torch, results):
    """paligemma-3b at published widths and full depth (18 layers, 8 query
    heads on one KV head of 256, GeGLU of 16384, a tied vocabulary of
    257216; 2.509 B params) in bf16 under remat: 10 + 2 steps of B4 x 1024
    text tokens from the port's PackedStream(seed=0), each sequence after
    256 rows of seeded random patch embeddings (``vlm_batches``; not the
    zero prefix of ``launch.train._batch``, whose keys would all be 0 in
    the first layer),
    warmup 5 (``run_train``).  A step launches the flash forward with the
    bidirectional prefix twice a layer and its backward once, at S 1280:
    36 + 18."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import launch_key

    cfg = get_config(VLM_TRAIN_ARCH)
    if not cfg.remat or (cfg.n_layers, cfg.n_prefix_tokens, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim) != (18, V_PREFIX, VH, 1, VD):
        raise AssertionError(f"{cfg.name}: expected 18 layers of {VH} heads on one KV head of "
                             f"{VD} after {V_PREFIX} prefix rows, under remat")
    b, s, steps, n = VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_STEPS, cfg.n_layers
    batches = vlm_batches(torch, cfg, b, s, steps + 2)
    q = torch.empty((b, V_PREFIX + s, VH, VD), dtype=torch.bfloat16, device="meta")
    key = launch_key(q, q[:, :, :1], prefix_len=V_PREFIX)
    return run_train(torch, results, "vlm_train", cfg, batches, steps=steps, warmup=5,
                     want={"flash_attention": 2 * n, "flash_attention_bwd": n},
                     want_by_shape={("flash_attention", key): 2 * n,
                                    ("flash_attention_bwd", key): n})


def hold_graph(phase, what, graph, card, cpu, *, again, card_vs_cpu):
    """A parity phase's captured run (``run``'s tuple) against its eager
    card run on each step's metrics and each leaf's update: bit-equal, or
    else, with a second eager run (``again()``, made only then), by
    ``checks.graph_vs_eager``; and against the CPU by TRAIN_METRIC_REL
    and TRAIN_UPDATE_REL as the eager card run (whose figures,
    ``card_vs_cpu`` = (metric max rel by name, update max rel a step), are
    the graph's when the two are bit-equal)."""
    def steps(r):
        return [{**{("metric", k): v for k, v in m.items()},
                 **{("update",) + k: u for k, u in upd.items()}}
                for m, upd in zip(r[1], r[2])]

    g, a = steps(graph), steps(card)
    n = len(a[0])
    equal = all(x == y if isinstance(x, float) else x.equal(y)
                for gs, es in zip(g, a) for x, y in ((gs[k], es[k]) for k in es))
    spread, worst, bad = set(), 0.0, []
    if not equal:
        from repro_torch.checks import graph_vs_eager
        spread, worst, bad = graph_vs_eager(g, a, steps(again()))
    if equal:
        mrel, upd_rel = card_vs_cpu
    else:
        mrel = {k: max(abs(gm[k] - pm[k]) / max(abs(pm[k]), 1e-30)
                       for gm, pm in zip(graph[1], cpu[1]))
                for k in ("loss", "ce", "grad_norm", "lr")}
        upd_rel = [max(float((gu[k] - pu[k]).norm() / pu[k].norm().clamp_min(1e-30))
                       if pu[k].any() else float(gu[k].abs().max()) for k in pu)
                   for gu, pu in zip(graph[2], cpu[2])]
    names = sorted("/".join(map(str, k)) for k in spread)
    log(f"[{phase}] {what} graph vs eager on the card: "
        + (f"bit-equal on all {n} names (metrics and each leaf's update) at every step"
           if equal else
           f"not bit-equal; a second eager run is bit-equal to the first on "
           f"{n - len(names)} of {n} names"
           + (f", not on {len(names)} ({', '.join(names[:6])}{', ...' if len(names) > 6 else ''})"
              f", where the graph is at most {worst:.3f} of its bound" if names else "")
           + f"; {len(bad)} failures")
        + f"; vs the CPU metrics max rel {max(mrel.values()):.3e} (bound "
        f"{TRAIN_METRIC_REL:.0e}), updates max rel L2 per step "
        + ", ".join(f"{u:.3e}" for u in upd_rel) + f" (bound {TRAIN_UPDATE_REL:.0e})")
    if bad:
        raise AssertionError(f"{phase} {what}: the graph and the eager step disagree: {bad[:6]}")
    if not (max(mrel.values()) <= TRAIN_METRIC_REL and all(u <= TRAIN_UPDATE_REL
                                                           for u in upd_rel)):
        raise AssertionError(f"{phase} {what}: the graph and the CPU disagree")
    return {"bit_equal_to_eager": equal, "eager_not_bit_equal": names,
            "worst_of_bound": worst, "metric_max_rel_cpu": max(mrel.values()),
            "update_max_rel_l2_cpu": upd_rel}


@host_heap()
def run_train_parity(torch, results, phase, base, *, batches_fn, want_of, grad_rel=None,
                     pin_state=False):
    """``base`` (float32, cut in depth): 3 AdamW steps (lr 3e-4, warmup
    10, total 20) on the card (kernels) and on the CPU (plain versions)
    from the same weights (seed 1) and batches (``batches_fn(cfg, device)``),
    the card once with remat on and once off.  Compares each step's loss,
    ce, grad norm and LR (TRAIN_METRIC_REL), each leaf's gradient of the
    first batch (within ``grad_rel`` of the leaf's last key where it names
    one, else TRAIN_GRAD_REL) and each leaf's update per step
    (TRAIN_UPDATE_REL); the card's launches must equal ``want_of(remat)``.
    The CPU runs once, without remat: remat moves no number on the CPU
    (tests/test_torch_train.py); its first gradient is the one its first
    step takes (``first_step_grads``).

    Beside each card run, 3 steps through a ``CompiledTrainStep`` from the
    same starting state (its first call, an eager warm-up step, undone by
    loading that state back): the graph's metrics and updates are held to
    the eager run's (``hold_graph``) and to the CPU's by every bound above.

    ``pin_state``: the card's two runs take every leaf's params and AdamW
    moments from the CPU's after each step, once that step's update is
    compared, so that each step starts from the CPU's state and is held to
    every bound above on equal inputs.  A third card run (remat on) pins
    nothing, as the other phases run: its loss, ce and LR are held within
    TRAIN_METRIC_REL, its updates within TRAIN_UPDATE_REL and its gradient
    norm within FREE_RUN_GRAD_NORM_REL, the drift of a step after the first
    update (see there).  The phase's host tensors (the CPU run, the card
    runs' copies, the comparisons) come from glibc's heap (``host_heap``)."""
    from repro_torch import models
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import CompiledTrainStep, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map, tree_paths

    n_steps = 3
    params0 = models.init_params(base, torch.Generator(device="cuda").manual_seed(1))

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def run(dev, remat, pinned=None, record=False, graph=False, first_grad=True):
        """pinned: the CPU's recorded states (pin every leaf after each
        step), False (pin nothing, skip the first gradient) or None;
        graph: step through a CompiledTrainStep."""
        cfg = dataclasses.replace(base, remat=remat)
        t_setup = time.time()
        p = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), params0)
        batches = batches_fn(cfg, dev)
        t0 = time.time()
        t_setup = t0 - t_setup
        # the CPU's first gradient is kept from its first step
        from_step = dev == "cpu" and pinned is not False and first_grad
        grads = ({k: g.cpu() for k, g in first_grads(torch, cfg, p, batches[0]).items()}
                 if pinned is not False and first_grad and not from_step else None)
        state = adamw_init(p)
        hyper = dict(base_lr=3e-4, warmup=10, total_steps=20)
        if graph:
            step = CompiledTrainStep(cfg, p, state, **hyper)
            step(p, state, batches[0])            # its eager warm-up call, undone:
            step.load(params0, adamw_init(params0))
        else:
            step = make_train_step(cfg, **hyper)
        ops.reset_launch_counts()
        metrics, updates, pins = [], [], []
        for i, batch in enumerate(batches):
            before = {k: t.detach().clone() for k, t in tree_paths(p)}
            if i == 0 and from_step:
                (p, state, m), grads = first_step_grads(step, p, state, batch)
            else:
                p, state, m = step(p, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            updates.append({k: (t.detach() - before[k]).cpu() for k, t in tree_paths(p)})
            if i == len(batches) - 1:
                break
            if record:
                pins.append({k: [leaf(t, k).detach().cpu().clone() for t in
                                 (p, state["m"], state["v"])] for k, _ in tree_paths(p)})
            if pinned:
                with torch.no_grad():
                    for k, vals in pinned[i].items():
                        for t, val in zip((p, state["m"], state["v"]), vals):
                            leaf(t, k).copy_(val)
        launches = {**ops.LAUNCHES, **ops.LAUNCHES_BY_SHAPE}
        log(f"[{phase}] {dev} remat={remat}" + (" graph" if graph else "")
            + (", each step from the CPU's state" if pinned else "")
            + f": {time.time() - t0:.1f}s (set-up {t_setup:.1f}s), launches {dict(ops.LAUNCHES)}"
            + (f", host peak RSS {host_peak_gib():.1f} GiB" if dev == "cpu" else ""))
        return grads, metrics, updates, launches, pins

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def compare(card, cpu):
        mrel = {k: [abs(cm[k] - pm[k]) / max(abs(pm[k]), 1e-30)
                    for cm, pm in zip(card[1], cpu[1])] for k in ("loss", "ce", "grad_norm", "lr")}
        upd = [{k: rel_l2(cu[k], pu[k]) if pu[k].any() else float(cu[k].abs().max())
                for k in pu} for cu, pu in zip(card[2], cpu[2])]
        return mrel, upd

    def describe(mrel, upd):
        per_step = ", ".join(f"{k} [" + ", ".join(f"{v:.3e}" for v in vs) + "]"
                             for k, vs in mrel.items())
        tops = []
        for i, u in enumerate(upd):
            top = sorted(u, key=u.get, reverse=True)[:3]
            tops.append(f"step {i}: " + ", ".join(f"{'/'.join(k)} {u[k]:.3e}" for k in top))
        return f"metrics rel per step {per_step}; largest updates rel L2 " + "; ".join(tops)

    cpu = run("cpu", False, record=pin_state)
    if any(v for k, v in cpu[3].items() if isinstance(k, str)):
        raise AssertionError(f"the CPU run launched kernels: {cpu[3]}")
    out, card_launches = {}, {}
    for remat in (True, False):
        card = run("cuda", remat, pinned=cpu[4] if pin_state else None)
        want = {**dict.fromkeys(ops.LAUNCHES, 0), **want_of(remat, n_steps)}
        got = {k: v for k, v in card[3].items() if isinstance(k, str)}
        if got != want:
            raise AssertionError(f"{phase} remat={remat}: launches {got}, expected {want}")
        if remat:
            card_launches = card[3]
        rel = {k: rel_l2(card[0][k], cpu[0][k]) for k in cpu[0]}
        bound = {k: (grad_rel or {}).get(k[-1], TRAIN_GRAD_REL) for k in rel}
        worst = max(rel, key=lambda k: rel[k] / bound[k])
        top = sorted(rel, key=rel.get, reverse=True)[:3]
        mrel, upd = compare(card, cpu)
        mmax = {k: max(v) for k, v in mrel.items()}
        upd_rel = [max(u.values()) for u in upd]
        log(f"[{phase}] remat={remat}: metrics max rel "
            + ", ".join(f"{k} {v:.3e}" for k, v in mmax.items())
            + f" (bound {TRAIN_METRIC_REL:.0e}), first gradient rel "
            f"L2 nearest its bound {rel[worst]:.3e}"
            f" at {'/'.join(worst)} (bound {bound[worst]:.0e}; largest "
            + ", ".join(f"{'/'.join(k)} {rel[k]:.3e}" for k in top) + "), updates max rel L2 per step "
            + ", ".join(f"{u:.3e}" for u in upd_rel) + f" (bound {TRAIN_UPDATE_REL:.0e}); "
            f"losses card {[round(m['loss'], 6) for m in card[1]]} cpu "
            f"{[round(m['loss'], 6) for m in cpu[1]]}")
        log(f"[{phase}] remat={remat}: {describe(mrel, upd)}")
        if not (max(mmax.values()) <= TRAIN_METRIC_REL and rel[worst] <= bound[worst]
                and all(u <= TRAIN_UPDATE_REL for u in upd_rel)):
            raise AssertionError(f"{phase} remat={remat}: card and CPU disagree")
        out[f"remat_{remat}"] = {"metric_max_rel": max(mmax.values()), "metric_rel": mmax,
                                 "grad_max_rel_l2": rel[top[0]],
                                 "grad_max_rel_l2_leaf": "/".join(top[0]),
                                 "update_max_rel_l2": upd_rel}
        pins = cpu[4] if pin_state else None
        graph = run("cuda", remat, pinned=pins, first_grad=False, graph=True)
        got = {k: v for k, v in graph[3].items() if isinstance(k, str)}
        if got != want:
            raise AssertionError(f"{phase} remat={remat} graph: launches {got}, expected {want}")
        out[f"remat_{remat}"]["graph"] = hold_graph(
            phase, f"remat={remat}", graph, card, cpu,
            again=lambda: run("cuda", remat, pinned=pins, first_grad=False),
            card_vs_cpu=(mmax, upd_rel))
        del card, graph
    if pin_state:
        del cpu[4][:]
        free = run("cuda", True, pinned=False)
        mrel, upd = compare(free, cpu)
        upd_rel = [max(u.values()) for u in upd]
        log(f"[{phase}] remat=True, nothing pinned: {describe(mrel, upd)} (bounds: grad_norm "
            f"{FREE_RUN_GRAD_NORM_REL:.0e}, loss / ce / lr {TRAIN_METRIC_REL:.0e}, updates "
            f"{TRAIN_UPDATE_REL:.0e})")
        if not (max(mrel["loss"] + mrel["ce"] + mrel["lr"]) <= TRAIN_METRIC_REL
                and max(mrel["grad_norm"]) <= FREE_RUN_GRAD_NORM_REL
                and all(u <= TRAIN_UPDATE_REL for u in upd_rel)):
            raise AssertionError(f"{phase}, nothing pinned: card and CPU disagree")
        out["unpinned"] = {"metric_rel_per_step": mrel, "update_max_rel_l2": upd_rel}
    log(f"[{phase}] host peak RSS so far {host_peak_gib():.1f} GiB")
    results[phase] = out
    return card_launches


def phase_train_parity(torch, results):
    """llama3.2-1b widths (d_model 2048, 32 / 8 heads of 64, d_ff 8192,
    vocab 128256, tied), 2 layers, float32, B2 x S256 from PackedStream(1)
    (``run_train_parity``)."""
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, dtype="float32")
    return run_train_parity(
        torch, results, "train_parity", base,
        batches_fn=lambda cfg, dev: train_batches(torch, cfg, 2, 256, 3, seed=1, device=dev),
        want_of=lambda remat, n: {"flash_attention": base.n_layers * (2 if remat else 1) * n,
                                  "flash_attention_bwd": base.n_layers * n})


def phase_audio_train_parity(torch, results):
    """whisper-large-v3 widths (d_model 1280, 20 heads of 64, d_ff 5120,
    vocab 51866), 2 encoder + 2 decoder layers over 1500 frames, float32,
    B2 x S256 text (``run_train_parity``): the non-causal backward over the
    encoder and the cross-attention, and encode's remat."""
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(AUDIO_TRAIN_ARCH), n_layers=2, n_encoder_layers=2,
                               dtype="float32")
    per_step = base.n_encoder_layers + 2 * base.n_layers
    return run_train_parity(
        torch, results, "audio_train_parity", base,
        batches_fn=lambda cfg, dev: audio_batches(torch, cfg, 2, 256, 3, seed=1, device=dev),
        want_of=lambda remat, n: {"flash_attention": per_step * (2 if remat else 1) * n,
                                  "flash_attention_bwd": per_step * n})


def phase_ssm_train_parity(torch, results):
    """mamba2-2.7b widths (d_model 2560, 80 SSD heads of 64, d_state 128,
    vocab 50280), 2 layers, float32, B2 x S512 (``run_train_parity``): the
    float32 SSD backward through the model; a_log and dt_bias held within
    SSM_SCALAR_GRAD_REL."""
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(SSM_TRAIN_ARCH), n_layers=2, dtype="float32")
    return run_train_parity(
        torch, results, "ssm_train_parity", base,
        batches_fn=lambda cfg, dev: train_batches(torch, cfg, 2, 512, 3, seed=1, device=dev),
        want_of=lambda remat, n: {"ssd_scan": base.n_layers * (2 if remat else 1) * n,
                                  "ssd_scan_bwd": base.n_layers * n},
        grad_rel={"a_log": SSM_SCALAR_GRAD_REL, "dt_bias": SSM_SCALAR_GRAD_REL})


def phase_hybrid_train_parity(torch, results):
    """zamba2-2.7b widths (d_model 2560, 80 SSD heads of 64, d_state 64,
    the shared block of 32 heads of 80 with d_ff 10240, vocab 32000), two
    groups (12 mamba layers, 2 applications of the shared block, whose
    gradient sums over both), float32, B2 x S512 (``run_train_parity``):
    the float32 flash backward at D 80 and the SSD backward through the
    model; a_log and dt_bias held within SSM_SCALAR_GRAD_REL as in
    ``ssm_train_parity``.  Each card step starts from the CPU's state
    (``pin_state``), and a run that pins nothing is held beside
    (FREE_RUN_GRAD_NORM_REL).  The CPU's plain scan runs at
    HYBRID_PARITY_CHUNK (the kernel ignores the chunk)."""
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_TRAIN_ARCH)
    base = dataclasses.replace(cfg, n_layers=2 * cfg.attn_every, dtype="float32",
                               ssm=dataclasses.replace(cfg.ssm, chunk=HYBRID_PARITY_CHUNK))
    n_groups = base.n_layers // base.attn_every
    return run_train_parity(
        torch, results, "hybrid_train_parity", base,
        batches_fn=lambda cfg, dev: train_batches(torch, cfg, 2, 512, 3, seed=1, device=dev),
        want_of=lambda remat, n: {"ssd_scan": base.n_layers * (2 if remat else 1) * n,
                                  "ssd_scan_bwd": base.n_layers * n,
                                  "flash_attention": n_groups * (2 if remat else 1) * n,
                                  "flash_attention_bwd": n_groups * n},
        grad_rel={"a_log": SSM_SCALAR_GRAD_REL, "dt_bias": SSM_SCALAR_GRAD_REL},
        pin_state=True)


def phase_moe_train_parity(torch, results):
    """mixtral-8x7b's attention widths (d_model 4096, 32 / 8 heads of 128,
    vocab 32000, untied), 8 experts top-2 of width MOE_PARITY_FF (cut from
    14336), 1 layer, the window cut to MOE_PARITY_WINDOW so that it binds,
    float32, B2 x S384 (``run_train_parity``): the windowed float32 flash
    backward and the MoE dispatch with its capacity drops under autograd."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_TRAIN_ARCH)
    base = dataclasses.replace(cfg, n_layers=1, dtype="float32", sliding_window=MOE_PARITY_WINDOW,
                               moe=dataclasses.replace(cfg.moe, d_ff_expert=MOE_PARITY_FF))
    return run_train_parity(
        torch, results, "moe_train_parity", base,
        batches_fn=lambda cfg, dev: train_batches(torch, cfg, 2, MOE_PARITY_S, 3, seed=1,
                                                  device=dev),
        want_of=lambda remat, n: {"flash_attention": base.n_layers * (2 if remat else 1) * n,
                                  "flash_attention_bwd": base.n_layers * n})


def phase_vlm_train_parity(torch, results):
    """paligemma widths (d_model 2048, 8 heads of 256 on one KV head, GeGLU
    of 16384, vocab 257216, tied), 2 layers, float32, B2 x 128 text tokens
    after the 256-row prefix of ``vlm_batches`` (``run_train_parity``): the
    float32 SIMT backward with the bidirectional prefix at D 256."""
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(VLM_TRAIN_ARCH), n_layers=2, dtype="float32")
    return run_train_parity(
        torch, results, "vlm_train_parity", base,
        batches_fn=lambda cfg, dev: vlm_batches(torch, cfg, 2, VLM_PARITY_S, 3, seed=1,
                                                device=dev),
        want_of=lambda remat, n: {"flash_attention": base.n_layers * (2 if remat else 1) * n,
                                  "flash_attention_bwd": base.n_layers * n})


def phase_train_driver(torch, results):
    """``repro_torch.launch.train.main`` on the card at llama3.2-1b's smoke
    size (bf16, head_dim 32) in a temporary directory, through the
    captured step (``CompiledTrainStep``; a restored state is copied into
    its tensors): run 1 trains 10 steps and saves at 10; run 2 (--steps 30
    --save-every 10 --simulate-failures 1) restores step 10, fails at step
    15, restarts from the step-10 checkpoint and ends with the loss down.
    The full-width state would be 12.4 GB a checkpoint, so the card saves
    only at smoke size."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", TRAIN_ARCH, "--smoke", "--ckpt-dir", d]
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            first = train.main(base + ["--steps", "10", "--save-every", "10"])
            second = train.main(base + ["--steps", "30", "--save-every", "10",
                                        "--simulate-failures", "1"])
        text = buf.getvalue()
    for line in text.splitlines():
        log(f"[train_driver] {line}")
    for want in ("step=captured", "restored from checkpoint at step 10",
                 "[ft] restarted from step 10"):
        if want not in text:
            raise AssertionError(f"train_driver: no '{want}' in the driver's output")
    if not second[-1] < second[0]:
        raise AssertionError(f"train_driver: the loss did not fall: {second}")
    results["train_driver"] = {"run1_losses": first, "run2_losses": second,
                               "seconds": time.time() - t0}


def phase_train_100m(torch, results):
    """``examples/train_100m_torch.py`` (smollm-100m: 10 layers, d_model
    640, remat off, B2 x S256 from PackedStream(0), bf16) for
    TRAIN_100M_STEPS steps with the eager step on the card (``--eager``),
    then as many through the captured step (its default); each run's loss
    must fall, and each launches the flash forward and its backward once a
    layer a step (counters zeroed just before the run, read just after).
    Prints both ms a step (medians of steps 3 on; the captured run's first
    two are its eager call and its capture), peak GiB, and one more step of
    each under torch.profiler."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    spec = importlib.util.spec_from_file_location("train_100m_torch",
                                                  ROOT / "examples" / "train_100m_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    from repro_torch.kernels import ops
    n = example.smollm_100m().n_layers * TRAIN_100M_STEPS
    out = {}
    for what, flags in (("eager", ["--eager"]), ("graph", [])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        ops.reset_launch_counts()
        with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf):
            run = example.main(["--steps", str(TRAIN_100M_STEPS), "--ckpt-dir", d] + flags)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        for line in buf.getvalue().splitlines():
            log(f"[train_100m_torch] {what}: {line}")
        log(f"[train_100m_torch] {what}: launches {launches}")
        if launches != {"flash_attention": n, "flash_attention_bwd": n}:
            raise AssertionError(f"train_100m_torch {what}: launches {launches}, expected "
                                 f"{n} of flash_attention and of flash_attention_bwd")
        if run["step"] != {"eager": "eager", "graph": "captured"}[what]:
            raise AssertionError(f"train_100m_torch: the {what} run stepped {run['step']}")
        step_fn, params, opt_state, batch = run["last"]
        prof = trace(torch, lambda: float(step_fn(params, opt_state, batch)[2]["loss"]))
        prof.pop("top")
        prof.pop("result")
        times = run["step_s"][2:]
        out[what] = {"median_step_ms": sorted(times)[len(times) // 2] * 1e3,
                     "losses": run["losses"],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "profiled_step": prof}
        del run, step_fn, params, opt_state, batch
    e, g = out["eager"], out["graph"]
    log(f"[train_100m_torch] {TRAIN_100M_STEPS} steps each: eager {e['median_step_ms']:.2f} ms "
        f"a step, graph {g['median_step_ms']:.2f} ms ({e['median_step_ms'] / g['median_step_ms']:.2f}"
        f"x); busy {100 * e['profiled_step']['busy_share']:.1f}% eager, "
        f"{100 * g['profiled_step']['busy_share']:.1f}% a replay; peak {e['peak_gib']:.2f} / "
        f"{g['peak_gib']:.2f} GiB; loss {g['losses'][0]:.4f} -> {g['losses'][-1]:.4f}; "
        f"{nvidia_smi_line()}")
    results["train_100m_torch"] = out


def trace(torch, fn):
    """``fn()`` under torch.profiler: host wall, device busy time and its
    share, device ms by kernel class, the kernels by device time, and what
    ``fn`` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        result = fn()
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
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / wall_us,
            "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
            "top": sorted(top, reverse=True), "result": result}


def _kernel_class(name: str) -> str:
    if "ssd_bwd_" in name:
        return "ssd_scan_bwd"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if "flash_fwd_" in name:
        return "flash_attention"
    if "paged_fwd_kernel" in name or "paged_combine_kernel" in name:
        return "paged_attention"
    if "ssd_fwd_" in name:
        return "ssd_scan"
    if any(k in name for k in ("softmax_vec_kernel", "softmax_warp_kernel",
                                "softmax_slice_kernel")):
        return "pwl_softmax"
    if any(k in name for k in ("cim_transpose_kernel", "cim_dac_kernel", "cim_dot_kernel",
                                "cim_cluster_kernel", "cim_decode_kernel",
                                "cim_combine_kernel")):
        return "cim_matmul"
    if any(t in name for t in ("gemm", "gemv", "sm90_xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


# the train steps the profile phase traces: (arch, B, S, total steps);
# mixtral at MOE_TRAIN_LAYERS layers
TRAIN_PROFILED = {
    "train": (TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS),
    "hybrid_train": (HYBRID_TRAIN_ARCH, HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS),
    "moe_train": (MOE_TRAIN_ARCH, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS),
    "vlm_train": (VLM_TRAIN_ARCH, VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_STEPS),
}


def profile_windows(torch, arch):
    """The (name, function) windows the profile phase traces for ``arch``,
    warmed up: a full-width prefill and 8 decode steps of a served model
    (mixtral at MIX_LAYERS layers; whisper's prefill with its encoder over
    1500 frames, from its 4-token prompt into a 448-row cache; paligemma's
    over its 256-row image prefix and a 32-token prompt, into a 448-row
    cache),
    eager and through the captured graph (on a copy of the cache), the
    cim_scu phase's layer prefill (with the vocab softmax) and decode
    step, or one train step of llama3.2-1b (``train``), zamba2-2.7b
    (``hybrid_train``), mixtral-8x7b at MOE_TRAIN_LAYERS layers
    (``moe_train``) or paligemma-3b with its image prefix (``vlm_train``)
    at its train phase's shape."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (CompiledServeStep, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models.common import rmsnorm

    if arch in TRAIN_PROFILED:
        from repro_torch.launch.steps import init_train_state, make_train_step
        name, b, s, steps = TRAIN_PROFILED[arch]
        cfg = mixtral_train_cut() if name == MOE_TRAIN_ARCH else get_config(name)
        params, opt_state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
        batch = (vlm_batches if cfg.n_prefix_tokens else train_batches)(torch, cfg, b, s, 1)[0]
        step = make_train_step(cfg, base_lr=3e-4, warmup=10, total_steps=steps)
        state = {"p": params, "o": opt_state}

        def train_step():
            state["p"], state["o"], m = step(state["p"], state["o"], batch)
            float(m["loss"])

        train_step()                                            # warm-up
        return [("train_step", train_step)]

    if arch == "cim_scu":
        cfg, weights, head, x, x_new = cim_scu_setup(torch)
        state = {}

        def layer_prefill():
            y, state["cache"], _ = cim_scu_layer(torch, cfg, weights, x, 0)
            ops.pwl_softmax((rmsnorm(y[:, -1], None) @ head).float())

        def layer_decode():
            cim_scu_layer(torch, cfg, weights, x_new, PROMPT, state["cache"])

        layer_prefill()
        layer_decode()
        return [("prefill", layer_prefill), ("decode_x1", layer_decode)]

    cfg = mixtral_cut() if arch == "mixtral-8x7b" else get_config(arch)
    params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if cfg.is_encoder_decoder:
        prompt = torch.tensor([W_SOT] * B_MAIN, device="cuda")
        batch = {"tokens": prompt, "encoder_embeds": whisper_frames(torch, cfg, B_MAIN, 0)}
        max_len = W_MAX_LEN
    elif cfg.n_prefix_tokens:
        prompt = random_prompt(torch, cfg, B_MAIN, V_PROMPT)
        batch = {"tokens": prompt, "prefix_embeds": paligemma_prefix(torch, cfg, B_MAIN, 0)}
        max_len = V_MAX_LEN
    else:
        prompt = random_prompt(torch, cfg, B_MAIN, PROMPT)
        batch, max_len = {"tokens": prompt}, MAX_LEN
    start = prompt.shape[1] + cfg.n_prefix_tokens         # cache rows after the prefill
    prefill = make_prefill_step(cfg, kv_max=max_len)
    serve = make_serve_step(cfg)
    tok, cache = prefill(params, batch)                         # warm-up
    graph_cache = {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}
    compiled = CompiledServeStep(cfg, params, graph_cache, B_MAIN)
    compiled(params, graph_cache, tok, start + 1)
    tok, cache = serve(params, cache, tok, start + 1)
    state = {"tok": tok, "cache": cache, "graph_tok": tok.clone()}

    def do_prefill():
        state["tok"], state["cache"] = prefill(params, batch)

    def do_decode():
        for i in range(8):
            state["tok"], state["cache"] = serve(params, state["cache"],
                                                 state["tok"], start + i + 1)

    def do_decode_graph():
        tok = state["graph_tok"]
        for i in range(8):
            tok, _ = compiled(params, graph_cache, tok, start + i + 1)
        state["graph_tok"] = tok.clone()

    return [("prefill", do_prefill), ("decode_x8", do_decode),
            ("decode_x8_graph", do_decode_graph)]


def phase_profile(torch, results, arch):
    out = {}
    for what, fn in profile_windows(torch, arch):
        t = trace(torch, fn)
        top = t.pop("top")
        t.pop("result")
        out[what] = t
        log(f"[profile] {arch} {what}: wall {t['wall_ms']:.2f} ms, device busy "
            f"{t['device_busy_ms']:.2f} ms ({100 * t['busy_share']:.1f}%), by class "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(t["device_ms_by_class"].items())))
        # the 8 largest, and every kernel of the port's sources below them
        for us, n, key in top[:8] + [t for t in top[8:] if "repro_torch" in t[2]]:
            log(f"[profile]   {us / 1e3:9.3f} ms  x{n:<5d} {key}")
    results.setdefault("profile", {})[arch] = out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--picnic-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--picnic-dir", help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--sp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--sp-dir", help=argparse.SUPPRESS)
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
    if args.picnic_rank is not None:    # one rank of the picnic_decode phase
        return picnic_rank(args.picnic_rank, args.picnic_dir)
    if args.dp_rank is not None:        # one rank of the dp_train phase
        return sharded_rank("dp_train", args.dp_rank, args.dp_dir)
    if args.sp_rank is not None:        # one rank of the sp_train phase
        return sharded_rank("sp_train", args.sp_rank, args.sp_dir)
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
        elif phase == "moe_serve":
            launches_of[phase], launches_of["moe_serve_run2"] = phase_moe_serve(torch, results)
        elif phase == "audio_serve":
            launches_of[phase] = phase_audio_serve(torch, results)
        elif phase == "vlm_serve":
            launches_of[phase] = phase_vlm_serve(torch, results)
        elif phase == "cim_scu":
            launches_of[phase] = phase_cim_scu(torch, results)
        elif phase == "parity":
            phase_parity(torch, results)
        elif phase == "ssm_parity":
            phase_ssm_parity(torch, results)
        elif phase == "moe_parity":
            phase_moe_parity(torch, results)
        elif phase == "audio_parity":
            phase_audio_parity(torch, results)
        elif phase == "vlm_parity":
            phase_vlm_parity(torch, results)
        elif phase == "server":
            phase_server(torch, results)
        elif phase == "picnic_decode":
            launches_of[phase] = phase_picnic_decode(torch, results)
        elif phase == "train":
            launches_of[phase] = phase_train(torch, results)
        elif phase == "dp_train":
            launches_of[phase] = phase_sharded_train(torch, results, phase)
        elif phase == "sp_train":
            launches_of[phase] = phase_sharded_train(torch, results, phase)
        elif phase == "train_parity":
            launches_of[phase] = phase_train_parity(torch, results)
        elif phase == "train_driver":
            phase_train_driver(torch, results)
        elif phase == "train_100m_torch":
            phase_train_100m(torch, results)
        elif phase == "audio_train":
            launches_of[phase] = phase_audio_train(torch, results)
        elif phase == "audio_train_parity":
            launches_of[phase] = phase_audio_train_parity(torch, results)
        elif phase == "ssm_train":
            launches_of[phase] = phase_ssm_train(torch, results)
        elif phase == "ssm_train_parity":
            launches_of[phase] = phase_ssm_train_parity(torch, results)
        elif phase == "hybrid_train":
            launches_of[phase] = phase_hybrid_train(torch, results)
        elif phase == "hybrid_train_parity":
            launches_of[phase] = phase_hybrid_train_parity(torch, results)
        elif phase == "moe_train":
            launches_of[phase] = phase_moe_train(torch, results)
        elif phase == "moe_train_parity":
            launches_of[phase] = phase_moe_train_parity(torch, results)
        elif phase == "vlm_train":
            launches_of[phase] = phase_vlm_train(torch, results)
        elif phase == "vlm_train_parity":
            launches_of[phase] = phase_vlm_train_parity(torch, results)
        elif phase == "profile":
            for arch in (*SERVE_ARCH.values(), "mixtral-8x7b", "whisper-large-v3",
                         "paligemma-3b", "cim_scu", *TRAIN_PROFILED):
                phase_profile(torch, results, arch)
                torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[{phase}] ok in {time.time() - t0:.1f}s")
    log(f"[all] ok in {time.time() - t_start:.1f}s")
    # a main entry counts its kernel's launches on its path; an entry of
    # another shape counts those of its own launch_key on its path (None:
    # its path's phase was not run)
    shaped = [k for k in results.get("kernels_other_shapes", []) if "path" in k]
    for kern in results.get("kernels", []) + shaped:
        path = launches_of.get(kern.get("path", MAIN_PATH_OF[kern["name"]]))
        key = (kern["name"], kern["launch_key"]) if "launch_key" in kern else kern["name"]
        kern["launches"] = None if path is None else path.get(key, 0)
    for kern in shaped:
        log(f"[kernels] {kern['name']} at {kern['shape']}: {kern['launches']} launches "
            f"of this shape on {kern['path']}")
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
