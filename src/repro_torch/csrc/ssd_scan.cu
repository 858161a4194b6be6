// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py
// (ssd_scan -> _ssd_kernel), which computes what the JAX model runs as
// repro/models/ssm.py:ssd_chunked.  Unlike the Pallas kernel it also writes
// the final state, which a prefill needs for the decode cache.
//
// The function, per (batch, head), over sub-chunks of rows in order:
//   cs    = inclusive cumsum of dt * A (one warp, shuffle scan)
//   Att   = (C B^T) * exp(cs_l - cs_m) * dt_m on m <= l, 0 above; exp is
//           taken only below the diagonal, where cs_l - cs_m <= 0 (the
//           cumulative decay reaches ~-180 over a chunk)
//   y     = Att x + exp(cs) * (C state^T)          (state of the previous step)
//   state = exp(cs_last) * state + (x * dt * exp(cs_last - cs))^T B
// SSD is exactly associative across chunks, so the sub-chunk length is the
// kernel's own and not part of the result.  Rows past S are masked to 0
// (dt = 0 too), which is what zero padding gives: they add nothing to y or
// the state, and y is not written there.  B and C have one group: each CTA
// reads them by batch, with no copy per head (the Pallas wrapper
// broadcasts them to every head in memory).  The TPU grid walks chunks in
// order on one core and carries the state in VMEM; on Hopper nothing
// carries over between blocks, so one CTA per (batch, head) walks the
// sequence itself and carries the (P, N) state.
//
// What bounds it on an H100: per row and head (P 64, N 128) the state terms
// do 4 * P * N and the quadratic form ~L * P FLOPs, ~37k, against P * 2
// bytes of bf16 x read and P * 4 bytes of float32 y written: ~100 FLOP per
// byte.  That is below the bf16 tensor cores' balance point (~295), so the
// card's bound is the bytes (~0.022 ms at b 4, S 512, H 80), but far above
// the float32 SIMT cores' (~20): on the SIMT cores the scan is bound by its
// operations and their shared-memory reads.  On the tensor cores, with the
// products of a float32 operand taken as two bf16 terms, it stays below
// the balance point, and what is left is latency: the sub-chunks of one
// (batch, head) are a chain, and b * H CTAs (320 at the main shape) are
// only ~2.4 per SM, so the time is set by how long one CTA's chain takes
// and by whether every CTA is resident at once.
//
// bfloat16 x/B/C (ssd_fwd_mma_kernel), the main path: the four products on
// the bf16 tensor cores (mma.sync m16n8k16, float32 accumulators).
// - One CTA of P / 16 warps (4 at P 64) per (batch, head).  Warp w owns
//   rows [16w, 16w + 16) of the (P, N) state, in its mma accumulators, in
//   float32 for the whole sequence (N 128: 64 registers a thread), and
//   columns [16w, 16w + 16) of y.
// - Sub-chunks of 32 rows, not the float32 kernel's 64: that halves the
//   shared tiles, so at the main shape three CTAs reside per SM (four at N
//   <= 64) and all 320 CTAs run in one wave.  At 64 rows only two would
//   reside, and the last 56 CTAs would run as a second wave costing nearly
//   a CTA's whole latency.  32 rows also make the triangle of scores three
//   16 x 16 blocks, one a warp, so no warp's exps hold the others up.
// - Each sub-chunk's B, C and x tiles (bf16) and dt are staged with
//   cp.async (16 bytes a copy, 4 for dt), double-buffered: sub-chunk j+1's
//   copies are in flight while j computes.  Shared rows are padded by 16
//   bytes, so ldmatrix is free of bank conflicts.  x, B and C are read
//   where they lie, with the row stride they have (the mamba layer passes
//   views of its conv output), so nothing is copied before the launch.
// - Each warp scans cs itself, one row a lane, into its own shared slots:
//   no barrier waits for it.
// - S = C B^T by mma for the warp's score block; the mask,
//   exp(cs_l - cs_m) (ex2.approx) and dt_m are applied to the float32
//   accumulator in registers, and Att goes to shared memory as two bf16
//   terms, att = hi + lo, hi = bf16(att), as flash attention splits P
//   (csrc/flash_attention.cu).  Unlike flash's P, whose rows stay with one
//   warp, every warp's y columns need every row of Att, so the blocks cross
//   warps once, through 5 KB of shared memory.
// - y = exp(cs_l) * C state^T: the m16n8k16 accumulator layout of the
//   warp's state rows is, pair for pair, the B-fragment layout of this
//   product (k = the state's column n, n = its row p), so the state is the
//   B operand straight from registers, split hi + lo, with no copy of it in
//   shared memory.  Then y += Att x (x the B operand by ldmatrix.trans),
//   only the k-tiles at or below the diagonal.  y rows are stored as
//   float32 pairs (8-byte stores, 32 contiguous bytes a quad).
// - state = exp(cs_last) * state + (x * w)^T B: the accumulators are scaled
//   by the decay, then accumulate; x^T is the A operand by ldmatrix.trans,
//   multiplied by w = dt * exp(cs_last - cs) in float32 in registers and
//   split hi + lo; B is the B operand by ldmatrix.trans.
// - Why hi + lo: Att, x * w and the state are float32 by nature; rounded
//   once to bf16 each, y is off by ~2e-3 of max |y| with long memory (dt ~
//   0.01), 20x past the bar of the card checks; split, the error is ~1e-5
//   of it (tests/test_torch_ssd_mma.py emulates this arithmetic on the
//   CPU).  x, B and C are bf16 already, so those operands are exact.
// - C B^T depends only on (batch, sub-chunk), since B and C have one group,
//   but each head's CTA computes it again: on the tensor cores that is
//   ~1/13 of the CTA's products, cheaper than a pass that shares it.
// - Shared memory at P 64, N 128: two stages of B, C, x and dt (44,288
//   bytes), Att hi + lo (5,120) and each warp's cs, exp(cs) and w (1,536):
//   50,944 bytes.  The launch bounds cap registers at 168 a thread (no
//   spills), so three CTAs (12 warps) reside per SM; at N 64, 128 and four.
//   The float32 kernel's ~130 KB held one.  chip_smoke.py's kernels phase
//   logs the count (ssd_scan_resident_ctas).
//
// float32 x/B/C (ssd_fwd_kernel): the port's first version, float32 FMAs on
// the SIMT cores throughout, kept so the float32 card-vs-CPU parity checks
// see no TF32.  One CTA of 256 threads per (batch, head), 64-row
// sub-chunks; B, C and x staged as float32, the 64 x 64 quadratic form and
// the (P, N) state in shared memory (~130 KB at P 64, N 128, one CTA per
// SM).  Shared rows are padded by one float where threads walk columns.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kL = 64;        // rows per sub-chunk
constexpr int kThreads = 256;

template <int P, int N>
constexpr size_t ssd_smem_bytes() {
  return sizeof(float) * (2 * size_t(kL) * (N + 1) + size_t(kL) * P + size_t(kL) * (kL + 1) +
                          size_t(P) * (N + 1) + 4 * size_t(kL));
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_neg, const T* __restrict__ Bm,
               const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ state_out,
               int S, int H) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  constexpr int NP = N + 1, LP = kL + 1;
  constexpr int CP = P / 16;   // y columns per thread
  constexpr int RP = P / 16;   // state rows per thread
  constexpr int CN = N / 16;   // state columns per thread
  extern __shared__ float smem[];
  float* Bs = smem;            // kL x NP
  float* Cs = Bs + kL * NP;    // kL x NP
  float* Xs = Cs + kL * NP;    // kL x P
  float* Att = Xs + kL * P;    // kL x LP
  float* St = Att + kL * LP;   // P x NP, the carried state
  float* cs = St + P * NP;     // kL, cumsum of dt * A within the sub-chunk
  float* dts = cs + kL;        // kL, dt
  float* wts = dts + kL;       // kL, dt * exp(cs_last - cs)
  float* eds = wts + kL;       // kL, exp(cs)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = a_neg[h];
  const int64_t x_row = int64_t(H) * P;
  const T* xb = x + int64_t(b) * S * x_row + int64_t(h) * P;
  float* yb = y + int64_t(b) * S * x_row + int64_t(h) * P;
  const float* dtb = dt + int64_t(b) * S * H + h;
  const T* Bb = Bm + int64_t(b) * S * N;
  const T* Cb = Cm + int64_t(b) * S * N;

  for (int i = tid; i < P * NP; i += kThreads) St[i] = 0.f;

  const int n_sub = (S + kL - 1) / kL;
  for (int sc = 0; sc < n_sub; ++sc) {
    const int t0 = sc * kL;
    const int n_valid = min(kL, S - t0);
    for (int idx = tid; idx < kL * N; idx += kThreads) {
      const int r = idx / N, c = idx % N;
      const bool ok = r < n_valid;
      Bs[r * NP + c] = ok ? to_float(Bb[int64_t(t0 + r) * N + c]) : 0.f;
      Cs[r * NP + c] = ok ? to_float(Cb[int64_t(t0 + r) * N + c]) : 0.f;
    }
    for (int idx = tid; idx < kL * P; idx += kThreads) {
      const int r = idx / P, c = idx % P;
      Xs[idx] = r < n_valid ? to_float(xb[int64_t(t0 + r) * x_row + c]) : 0.f;
    }
    if (tid < 32) {  // inclusive scan of dt * A, two rows per lane
      const int r0 = 2 * tid;
      const float d0 = r0 < n_valid ? dtb[int64_t(t0 + r0) * H] : 0.f;
      const float d1 = r0 + 1 < n_valid ? dtb[int64_t(t0 + r0 + 1) * H] : 0.f;
      const float s0 = d0 * a, pair = s0 + d1 * a;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const float excl = incl - pair;
      cs[r0] = excl + s0;
      cs[r0 + 1] = incl;
      dts[r0] = d0;
      dts[r0 + 1] = d1;
    }
    __syncthreads();
    const float cs_last = cs[kL - 1];  // = the last valid row's: padded rows add 0
    if (tid < kL) {
      eds[tid] = expf(cs[tid]);
      wts[tid] = dts[tid] * expf(cs_last - cs[tid]);
    }

    // Att[l][m], thread rows ty*4+i, columns tx+16j
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          Att[l * LP + m] = m <= l ? s[i][j] * expf(cs[l] - cs[m]) * dts[m] : 0.f;
        }
      }
    }
    __syncthreads();

    // y rows ty*4+i, columns tx+16j: Att x (only m <= l is non-zero) plus
    // the incoming state's contribution
    {
      float acc[4][CP], off[4][CP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] = off[i][j] = 0.f;
      const int m_end = ty * 4 + 4;
#pragma unroll 4
      for (int m = 0; m < m_end; ++m) {
        float av[4], xv[CP];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Att[(ty * 4 + i) * LP + m];
#pragma unroll
        for (int j = 0; j < CP; ++j) xv[j] = Xs[m * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[CP];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < CP; ++j) sv[j] = St[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CP; ++j) off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty * 4 + i;
        if (l >= n_valid) continue;
        const float e = eds[l];
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          yb[int64_t(t0 + l) * x_row + tx + 16 * j] = acc[i][j] + e * off[i][j];
        }
      }
    }
    __syncthreads();

    // state rows ty*RP+i, columns tx+16j
    {
      const float decay = expf(cs_last);
      float acc[RP][CN];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int m = 0; m < kL; ++m) {
        const float w = wts[m];
        float xv[RP], bv[CN];
#pragma unroll
        for (int i = 0; i < RP; ++i) xv[i] = Xs[m * P + ty * RP + i] * w;
#pragma unroll
        for (int j = 0; j < CN; ++j) bv[j] = Bs[m * NP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int p = ty * RP + i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float& st = St[p * NP + tx + 16 * j];
          st = st * decay + acc[i][j];
        }
      }
    }
    __syncthreads();
  }

  float* sb = state_out + (int64_t(b) * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) sb[idx] = St[(idx / N) * NP + idx % N];
}

// ---- bfloat16: tensor cores -------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kSub = 32;           // rows per sub-chunk of the tensor-core kernel
constexpr int kSubT = kSub / 16;   // its 16-row tiles

// CTAs per SM the launch bounds ask for: three at N 128 (registers cap at
// 170 a thread), four below (128)
template <int N>
constexpr int kMmaCtas = N > 64 ? 3 : 4;

// Shared memory of ssd_fwd_mma_kernel<P, N>: rows padded by 8 bf16 (16
// bytes) for conflict-free ldmatrix.
template <int P, int N>
struct MmaLayout {
  static constexpr int kWarps = P / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BS = N + 8, XS = P + 8, AS = kSub + 8;  // row strides, bf16
  static constexpr int kBC = kSub * BS, kX = kSub * XS;         // elements of a tile
  // one stage: B, C, x, then dt (float32)
  static constexpr size_t kStage =
      (2 * size_t(kBC) + kX) * sizeof(bf16) + kSub * sizeof(float);
  static constexpr size_t kAtt = 2 * size_t(kSub) * AS * sizeof(bf16);  // hi, lo
  static constexpr size_t kWarpSlots = size_t(kWarps) * 3 * kSub * sizeof(float);
  static constexpr size_t kBytes = 2 * kStage + kAtt + kWarpSlots;
  static_assert(kStage % 16 == 0 && kAtt % 16 == 0, "16-byte aligned regions");
};

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

template <int P, int N>
__global__ void __launch_bounds__(MmaLayout<P, N>::kThreads, kMmaCtas<N>)
ssd_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_neg, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, float* __restrict__ y,
                   float* __restrict__ state_out, int S, int H, int64_t x_stride,
                   int64_t bc_stride) {
  using Lay = MmaLayout<P, N>;
  constexpr int kThr = Lay::kThreads, kWarps = Lay::kWarps;
  constexpr int BS = Lay::BS, XS = Lay::XS, AS = Lay::AS;
  constexpr int kNK = N / 16;                        // k16 chunks over N
  constexpr int kBlocks = kSubT * (kSubT + 1) / 2;   // 16 x 16 score blocks, m <= l
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  static_assert(kSub == 32, "one lane a row in the scan of cs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* att_hi = reinterpret_cast<bf16*>(smem_raw + 2 * Lay::kStage);
  bf16* att_lo = att_hi + kSub * AS;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row group, column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: the matrix and row this lane addresses
  const int p0 = warp * 16;                // the warp's state rows and y columns
  // this warp's cs, exp(cs) and w = dt * exp(cs_last - cs) of the sub-chunk
  float* cs_w =
      reinterpret_cast<float*>(smem_raw + 2 * Lay::kStage + Lay::kAtt) + warp * 3 * kSub;
  float* e_w = cs_w + kSub;
  float* w_w = e_w + kSub;

  const float a = a_neg[h];
  const bf16* xb = x + int64_t(b) * S * x_stride + int64_t(h) * P;
  const bf16* Bb = Bm + int64_t(b) * S * bc_stride;
  const bf16* Cb = Cm + int64_t(b) * S * bc_stride;
  const float* dtb = dt + int64_t(b) * S * H + h;
  const int64_t y_row = int64_t(H) * P;
  float* yb = y + int64_t(b) * S * y_row + int64_t(h) * P;

  auto tiles = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * Lay::kStage); };
  // sub-chunk sc's B, C, x and dt into stage st; rows past S are zeros
  auto load_sub = [&](int sc, int st) {
    const int t0 = sc * kSub, n_valid = min(kSub, S - t0);
    bf16* Bs = tiles(st);
    bf16* Cs = Bs + Lay::kBC;
    bf16* Xs = Cs + Lay::kBC;
    float* dts = reinterpret_cast<float*>(Xs + Lay::kX);
    constexpr int kNC = N / 8, kPC = P / 8;  // 16-byte chunks of a row
    for (int c = threadIdx.x; c < kSub * kNC; c += kThr) {
      const int r = c / kNC, col = (c % kNC) * 8;
      const bool ok = r < n_valid;
      const int64_t off = int64_t(t0 + (ok ? r : 0)) * bc_stride + col;
      cp_async16(Bs + r * BS + col, Bb + off, ok);
      cp_async16(Cs + r * BS + col, Cb + off, ok);
    }
    for (int c = threadIdx.x; c < kSub * kPC; c += kThr) {
      const int r = c / kPC, col = (c % kPC) * 8;
      const bool ok = r < n_valid;
      cp_async16(Xs + r * XS + col, xb + int64_t(t0 + (ok ? r : 0)) * x_stride + col, ok);
    }
    for (int r = threadIdx.x; r < kSub; r += kThr) {
      const bool ok = r < n_valid;
      cp_async4(dts + r, dtb + int64_t(t0 + (ok ? r : 0)) * H, ok);
    }
  };

  // the state rows p0 + g (e 0, 1) and p0 + g + 8 (e 2, 3), columns
  // 8 nt + 2 t4 + (e & 1): the accumulator layout of mma
  float st[2 * kNK][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kNK; ++nt) st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;

  const int n_sub = (S + kSub - 1) / kSub;
  load_sub(0, 0);
  cp_async_commit();
  for (int sc = 0; sc < n_sub; ++sc) {
    const int stage = sc & 1, t0 = sc * kSub, n_valid = min(kSub, S - t0);
    cp_async_wait<0>();
    __syncthreads();  // sub-chunk sc is in; every warp is done with sc - 1
    if (sc + 1 < n_sub) load_sub(sc + 1, stage ^ 1);
    cp_async_commit();
    const bf16* Bs = tiles(stage);
    const bf16* Cs = Bs + Lay::kBC;
    const bf16* Xs = Cs + Lay::kBC;
    const float* dts = reinterpret_cast<const float*>(Xs + Lay::kX);

    // cs: inclusive scan of dt * A, one row a lane
    float decay;
    {
      const float d = dts[lane];
      float c = d * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, c, o);
        if (lane >= o) c += up;
      }
      // = the last valid row's: padded rows add 0
      const float cs_last = __shfl_sync(0xffffffffu, c, 31);
      cs_w[lane] = c;
      e_w[lane] = expf(c);
      w_w[lane] = d * expf(cs_last - c);
      decay = expf(cs_last);
    }
    __syncwarp();

    // Att, 16 x 16 blocks (r, c) on or below the diagonal, one a warp, to
    // shared memory as hi + lo; exp(cs_l - cs_m) is taken on m <= l only
    for (int blk = warp; blk < kBlocks; blk += kWarps) {
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= blk) ++r;
      const int c = blk - r * (r + 1) / 2;
      float s[2][4] = {};
      const bf16* crow = Cs + (16 * r + (mi & 1) * 8 + mr) * BS + (mi >> 1) * 8;
      const bf16* brow = Bs + (16 * c + (mi >> 1) * 8 + mr) * BS + (mi & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < kNK; ++kc) {
        uint32_t af[4], rb[4];
        ldsm_x4(af, crow + kc * 16);
        ldsm_x4(rb, brow + kc * 16);
        mma_bf16(s[0], af, rb[0], rb[1]);
        mma_bf16(s[1], af, rb[2], rb[3]);
      }
      const int l_a = 16 * r + g, l_b = l_a + 8;
      const float cs_a = cs_w[l_a], cs_b = cs_w[l_b];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * c + 8 * half + 2 * t4;
        const float2 csm = *reinterpret_cast<const float2*>(cs_w + m);
        const float2 dtm = *reinterpret_cast<const float2*>(dts + m);
        const float* sv = s[half];
        const float v0 = m <= l_a ? sv[0] * ex2_approx((cs_a - csm.x) * kLog2e) * dtm.x : 0.f;
        const float v1 = m < l_a ? sv[1] * ex2_approx((cs_a - csm.y) * kLog2e) * dtm.y : 0.f;
        const float v2 = m <= l_b ? sv[2] * ex2_approx((cs_b - csm.x) * kLog2e) * dtm.x : 0.f;
        const float v3 = m < l_b ? sv[3] * ex2_approx((cs_b - csm.y) * kLog2e) * dtm.y : 0.f;
        uint32_t lo_a, lo_b;
        const uint32_t hi_a = split_bf16x2(v0, v1, lo_a);
        const uint32_t hi_b = split_bf16x2(v2, v3, lo_b);
        *reinterpret_cast<uint32_t*>(att_hi + l_a * AS + m) = hi_a;
        *reinterpret_cast<uint32_t*>(att_lo + l_a * AS + m) = lo_a;
        *reinterpret_cast<uint32_t*>(att_hi + l_b * AS + m) = hi_b;
        *reinterpret_cast<uint32_t*>(att_lo + l_b * AS + m) = lo_b;
      }
    }

    // y[:, p0:p0+16] = exp(cs_l) * C state^T, the state (previous
    // sub-chunk's) as the B operand from the accumulators, hi + lo
    float yacc[kSubT][2][4];
#pragma unroll
    for (int r = 0; r < kSubT; ++r)
#pragma unroll
      for (int pb = 0; pb < 2; ++pb)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[r][pb][e] = 0.f;
    if (sc > 0) {
      const bf16* crow = Cs + ((mi & 1) * 8 + mr) * BS + (mi >> 1) * 8;
#pragma unroll
      for (int kc = 0; kc < kNK; ++kc) {
        // [p-block: rows p0 + g, p0 + 8 + g][k-half: columns 16 kc + 2 t4, + 8]
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int pb = 0; pb < 2; ++pb)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
            bh[pb][kh] = split_bf16x2(st[2 * kc + kh][2 * pb], st[2 * kc + kh][2 * pb + 1],
                                      bl[pb][kh]);
#pragma unroll
        for (int r = 0; r < kSubT; ++r) {
          uint32_t af[4];
          ldsm_x4(af, crow + r * 16 * BS + kc * 16);
#pragma unroll
          for (int pb = 0; pb < 2; ++pb) {
            mma_bf16(yacc[r][pb], af, bh[pb][0], bh[pb][1]);
            mma_bf16(yacc[r][pb], af, bl[pb][0], bl[pb][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kSubT; ++r) {
        const float ea = e_w[16 * r + g], eb = e_w[16 * r + g + 8];
#pragma unroll
        for (int pb = 0; pb < 2; ++pb) {
          yacc[r][pb][0] *= ea;
          yacc[r][pb][1] *= ea;
          yacc[r][pb][2] *= eb;
          yacc[r][pb][3] *= eb;
        }
      }
    }
    __syncthreads();  // every warp's Att blocks are in

    // y += Att x, k-tiles at or below the diagonal
    {
      const bf16* xrow = Xs + ((mi & 1) * 8 + mr) * XS + p0 + (mi >> 1) * 8;
      const int arow = ((mi & 1) * 8 + mr) * AS + (mi >> 1) * 8;
#pragma unroll
      for (int kc = 0; kc < kSubT; ++kc) {
        uint32_t xf[4];
        ldsm_x4_trans(xf, xrow + kc * 16 * XS);
#pragma unroll
        for (int r = kc; r < kSubT; ++r) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, att_hi + arow + r * 16 * AS + kc * 16);
          ldsm_x4(al, att_lo + arow + r * 16 * AS + kc * 16);
          mma_bf16(yacc[r][0], ah, xf[0], xf[1]);
          mma_bf16(yacc[r][1], ah, xf[2], xf[3]);
          mma_bf16(yacc[r][0], al, xf[0], xf[1]);
          mma_bf16(yacc[r][1], al, xf[2], xf[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSubT; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = 16 * r + g + 8 * half;
        if (l < n_valid) {
          float* yrow = yb + int64_t(t0 + l) * y_row + p0 + 2 * t4;
#pragma unroll
          for (int pb = 0; pb < 2; ++pb) {
            *reinterpret_cast<float2*>(yrow + 8 * pb) =
                make_float2(yacc[r][pb][2 * half], yacc[r][pb][2 * half + 1]);
          }
        }
      }
    }

    // state = exp(cs_last) * state + (x * w)^T B
#pragma unroll
    for (int nt = 0; nt < 2 * kNK; ++nt) {
      st[nt][0] *= decay;
      st[nt][1] *= decay;
      st[nt][2] *= decay;
      st[nt][3] *= decay;
    }
    {
      // A = x^T (rows p, k = m) by ldmatrix.trans: xa[0] (p0 + g, m 2 t4 + {0, 1}),
      // xa[1] (p0 + g + 8, same m), xa[2] and xa[3] the same at m + 8
      const bf16* xrow = Xs + ((mi >> 1) * 8 + mr) * XS + p0 + (mi & 1) * 8;
      const bf16* brow = Bs + ((mi & 1) * 8 + mr) * BS + (mi >> 1) * 8;
#pragma unroll
      for (int kc = 0; kc < kSubT; ++kc) {
        uint32_t xa[4], ah[4], al[4];
        ldsm_x4_trans(xa, xrow + kc * 16 * XS);
        const float2 w0 = *reinterpret_cast<const float2*>(w_w + 16 * kc + 2 * t4);
        const float2 w8 = *reinterpret_cast<const float2*>(w_w + 16 * kc + 8 + 2 * t4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 w = i < 2 ? w0 : w8;
          ah[i] = split_bf16x2(bf16_lo(xa[i]) * w.x, bf16_hi(xa[i]) * w.y, al[i]);
        }
#pragma unroll
        for (int np = 0; np < kNK; ++np) {
          uint32_t rb[4];
          ldsm_x4_trans(rb, brow + kc * 16 * BS + np * 16);
          mma_bf16(st[2 * np], ah, rb[0], rb[1]);
          mma_bf16(st[2 * np + 1], ah, rb[2], rb[3]);
          mma_bf16(st[2 * np], al, rb[0], rb[1]);
          mma_bf16(st[2 * np + 1], al, rb[2], rb[3]);
        }
      }
    }
  }

  float* sb = state_out + (int64_t(b) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 2 * kNK; ++nt) {
    const int col = 8 * nt + 2 * t4;
    *reinterpret_cast<float2*>(sb + (p0 + g) * N + col) = make_float2(st[nt][0], st[nt][1]);
    *reinterpret_cast<float2*>(sb + (p0 + g + 8) * N + col) = make_float2(st[nt][2], st[nt][3]);
  }
}

// ---- host side ----------------------------------------------------------
struct Args {
  const void *x, *dt, *a_neg, *Bm, *Cm;
  void *y, *state;
  int batch, S, H;
  int64_t x_stride, bc_stride;
  cudaStream_t stream;
  int* resident;  // not null: report CTAs per SM instead of launching
};

template <typename T, int P, int N>
cudaError_t run(const Args& a) {
  const void* kernel;
  int threads;
  size_t smem;
  if constexpr (std::is_same_v<T, float>) {
    auto fn = ssd_fwd_kernel<T, P, N>;
    kernel = reinterpret_cast<const void*>(fn);
    threads = kThreads;
    smem = ssd_smem_bytes<P, N>();
  } else {
    auto fn = ssd_fwd_mma_kernel<P, N>;
    kernel = reinterpret_cast<const void*>(fn);
    threads = MmaLayout<P, N>::kThreads;
    smem = MmaLayout<P, N>::kBytes;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (a.resident) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.resident, kernel, threads, smem);
  }
  if constexpr (std::is_same_v<T, float>) {
    ssd_fwd_kernel<T, P, N><<<a.batch * a.H, threads, smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
        static_cast<const float*>(a.a_neg), static_cast<const T*>(a.Bm),
        static_cast<const T*>(a.Cm), static_cast<float*>(a.y), static_cast<float*>(a.state), a.S,
        a.H);
  } else {
    ssd_fwd_mma_kernel<P, N><<<a.batch * a.H, threads, smem, a.stream>>>(
        static_cast<const bf16*>(a.x), static_cast<const float*>(a.dt),
        static_cast<const float*>(a.a_neg), static_cast<const bf16*>(a.Bm),
        static_cast<const bf16*>(a.Cm), static_cast<float*>(a.y), static_cast<float*>(a.state),
        a.S, a.H, a.x_stride, a.bc_stride);
  }
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int N, const Args& a) {
  switch (N) {
    case 16: return run<T, P, 16>(a);
    case 32: return run<T, P, 32>(a);
    case 64: return run<T, P, 64>(a);
    case 128: return run<T, P, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int P, int N, int dtype, const Args& a) {
  if (dtype == 0) {
    // the float32 kernel reads contiguous rows
    if (a.x_stride != int64_t(a.H) * P || a.bc_stride != N) return cudaErrorInvalidValue;
    switch (P) {
      case 32: return dispatch_n<float, 32>(N, a);
      case 64: return dispatch_n<float, 64>(N, a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (P) {
      case 32: return dispatch_n<bf16, 32>(N, a);
      case 64: return dispatch_n<bf16, 64>(N, a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// x: (batch, S, H, P), row s of batch i at (i * S + s) * x_stride elements,
// each row's H * P contiguous; dt: (batch, S, H) float32, contiguous;
// a_neg: (H,) float32; B, C: (batch, S, N), rows at bc_stride elements, each
// row's N contiguous; y: (batch, S, H, P) float32 and state: (batch, H, P, N)
// float32, contiguous.  dtype of x/B/C: 0 = float32 (x_stride H * P and
// bc_stride N only), 1 = bfloat16 (x, B and C 16-byte aligned, strides
// multiples of 8).  Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_neg, const void* Bm,
                            const void* Cm, void* y, void* state, int batch, int S, int H,
                            int P, int N, int x_stride, int bc_stride, int dtype, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  const Args a{x, dt, a_neg, Bm, Cm, y, state, batch, S, H, x_stride, bc_stride,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(P, N, dtype, a);
}

// CTAs of the (P, N, dtype) kernel that reside on one SM at once, into
// *out.  Returns a CUDA error code.
extern "C" int ssd_scan_resident_ctas(int P, int N, int dtype, int* out) {
  using namespace repro_torch;
  Args a{};
  a.H = 1;
  a.x_stride = P;
  a.bc_stride = N;
  a.resident = out;
  return dispatch(P, N, dtype, a);
}
