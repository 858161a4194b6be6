// RRAM crossbar (CIM) matmul for Hopper (sm_90a): int8 tensor cores for the
// integer dot, float32 for the DAC, the ADC and the recombination.
//
// Replaces the Pallas TPU kernel repro/kernels/cim_matmul.py
// (cim_matmul -> _cim_kernel).  Per K tile of 256 rows (one crossbar):
//   DAC   xs = (max|x| + 1e-9) / qmax_a per row, xq = clip(rint(x / xs))
//   MAC   psum = xq @ wq, an integer dot
//   ADC   cal = max(max|psum| over the (bm, bn) calibration tile, 1),
//         code = clip(rint(psum / cal * adc_max)), psum_q = code * (cal / adc_max)
//   out  += psum_q * xs * wscale
// with IEEE division and round-half-to-even, each operation rounded on its
// own (no FMA contraction), in the reference's order, and the float32 sum
// over K tiles taken in K order: the result equals the plain version's,
// bit for bit.
//
// The integer dot is exact: |xq|, |wq| <= 127 (act_bits <= 8) over 256 terms
// gives |psum| <= 4,129,024 < 2^22, so int8 x int8 -> int32 gives the
// integers that the reference's float32 dot gives.  The wrapper refuses
// act_bits > 8.
//
// What bounds it on an H100, at llama3-8b's MLP (M 2048, K 4096, N 14336):
// the 2 M K N int8 operations (0.12 ms at 1,979 TOP/s), the bytes (0.058 ms
// at 3.35 TB/s) and the M N K / 256 float32 ADC steps, 9 float32
// operations each that no FMA can pair (0.126 ms at 33.5 TFLOP/s).  The ADC
// steps are the largest term: the design keeps them on the SIMT cores while
// the tensor cores run the next K step's dot.
//
// The calibration tile (bm, bn) is not the kernel's tiling (ROADMAP hazard
// 3): it is part of the result, 128 x 256 by default and up to M x N.  The
// wrapper (kernels/cim_matmul.route) picks one of three routes by shape,
// the first that takes it:
//
//   decode    M <= 16 and every calibration tile lies in one 256-column
//             block (N <= 256 or bn | 256), at most kDMaxSlots a block:
//             split-K, one CTA per (256 columns, K tile).
//   cluster   (the main path) a thread block cluster of two CTAs of
//             128 x 128 output each, side by side along N, holds a
//             128 x 256 block that is one calibration tile (M <= 128 and
//             bm = M, or bm = 128; N <= 256 and bn = N, or bn = 256), so
//             the max of a K step is complete on chip.
//   two_pass  any other tile that the first design's kernels take (a
//             64 x 128 CTA tile meets at most kMaxSlots calibration
//             tiles), e.g. the unblocked 128 x 512 tile or 64 x 128
//             tiles: the dot once for the maxima and once more for the ADC.
// A shape no route takes raises in the wrapper, as before.  At M <= 16 the
// cluster route runs N / 128 CTAs that each walk all K tiles (8 at
// llama3-8b's k projection), so decode splits K.  A cluster variant for
// several calibration tiles a block was measured and removed: on an H100
// it was 1.6x slower than two_pass with 64 x 128 tiles at the up
// projection's size.
//
// Every route first runs cim_dac_kernel (one warp per (row, K tile): xs
// (M, K / 256) float32 and xq (M, K) int8), a pass of its own: folding it
// into the dot would quantise each row again in each of the N / 256 column
// blocks.  The weight enters as wqt (N, K) int8, k contiguous, because the
// s8 tensor-core products take both operands K-major (the transpose bits of
// wgmma exist only for 16-bit types).  A caller that keeps the weight in
// that layout (kernels/cim_matmul.weight_layout, made once per weight)
// passes it; otherwise cim_transpose_kernel writes it on every call.
//
// cluster route: cim_cluster_kernel, one pass.
// - 384 threads: warpgroups 0 and 1 consume (64 x 128 output rows each),
//   warpgroup 2 produces: one thread issues TMA loads of each K tile's xq
//   (128 x 256 bytes) and wqt (128 x 256) tiles, as four 128 x 128-byte
//   boxes with the 128-byte swizzle, into a ring of 3 stages of 64 KB with
//   full / empty mbarriers.  setmaxnreg moves registers from the producer
//   (24 a thread) to the consumers (240).
// - A consumer warpgroup's K step is 8 wgmma.mma_async m64n128k32
//   s8.s8 -> s32 from shared memory, into one of two int32 accumulator sets
//   (64 registers a thread each).  It issues step k + 1 into the other set,
//   then runs step k's max and ADC while the tensor cores work; the float32
//   sums take 64 registers more: 192 + addresses and indices, under 240
//   with a few dozen bytes of spills (at 232 it spilled more and ran
//   slower).
// - The max of step k over the block: each warp reduces its fragments, and
//   a named barrier of the 256 consumers collects the 8 warps' maxima.
//   Then one st.async writes the CTA's max into the partner's shared
//   memory and completes 4 bytes on the partner's mbarrier, which its own
//   thread 0 armed with expect_tx; each consumer waits on its CTA's barrier
//   and takes the larger of the two maxima.  Maxima and barriers are
//   double-buffered by the parity of k.
// - The ADC divides by the calibration max through its reciprocal with one
//   correction (adc_div), which gives IEEE division's bits, and needs no
//   clip (adc_term), and converts and rounds on the FMA pipe (psum_float,
//   rint_small): ~14 instructions an element, none on the SM's slow
//   conversion pipe.
// - Each consumer thread stages one scale a step in shared memory, xs of
//   one of the CTA's 128 rows or wscale of one of its 128 columns, loaded a
//   step ahead; the named barrier publishes them.
// - Shared memory: 3 x 64 KB stages + ~2 KB of maxima, scales and
//   barriers (~199 KB with the 1 KB alignment slack): 1 CTA per SM.
//   Waves: the up projection's 16 x 112 = 1,792 CTAs are 13.6 waves of
//   132; the down projection's 16 x 32 = 512 are 3.9.  blockIdx.x walks M,
//   so the CTAs that run together share wqt's columns in L2.
// - A CTA of the pair that lies past N (N <= 128) loads zeros (TMA fills
//   out-of-range boxes with 0), contributes max 0 and writes nothing.
//
// decode route: cim_decode_kernel, then cim_combine_kernel.
// - One CTA of 256 threads per (256 output columns, K tile): 896 CTAs at
//   the decode up projection (M 4, K 4096, N 14336), ~74 KB of shared
//   memory each, 3 per SM, so each byte of the weight is read once and the
//   whole card reads.  The M <= 16 rows are one mma.sync m16n8k32 row
//   fragment (rows past M zero-filled), 8 warps of 32 columns.
// - The max of each calibration tile in the CTA (shared memory), the ADC,
//   and the K tile's term ((code * step) * xs) * wscale written to a
//   (K / 256, M, N) float32 scratch; the combine kernel sums the terms in K
//   order from 0, as the accumulator does, so the sum is bit-equal.
//
// two_pass route: the first design's kernels, cim_dot_kernel<false> (maxima by
// atomicMax per calibration tile and K tile) then cim_dot_kernel<true>
// (the dot again, the ADC and the sum); 64 x 128 CTA tiles of int8
// mma.sync m16n8k32 fed by cp.async.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTileK = 256;
constexpr int kBM = 64, kBN = 128;
constexpr int kThreads = 256;
constexpr int kRowBytes = kTileK + 16;
constexpr int kMaxSlots = 512;   // calibration tiles one CTA tile may meet
constexpr int kStageBytes = (kBM + kBN) * kRowBytes;
constexpr int kSmemBytes = 2 * kStageBytes;
constexpr int kT = 64;           // transpose tile

// wqt[n][k] = wq[k][n], through a 64 x 64 tile in shared memory: 16-byte
// loads along n where N allows, 16-byte stores along k.
__global__ void __launch_bounds__(256)
cim_transpose_kernel(const int8_t* __restrict__ wq, int8_t* __restrict__ wqt, int K, int N) {
  __shared__ __align__(16) int8_t tile[kT][kT + 4];
  const int k0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  const int8_t* src = wq + int64_t(k0 + r) * N + n0 + c;
  if (N % 16 == 0 && n0 + c + 16 <= N) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    uint32_t* dst = reinterpret_cast<uint32_t*>(&tile[r][c]);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    for (int j = 0; j < 16; ++j) tile[r][c + j] = n0 + c + j < N ? src[j] : int8_t(0);
  }
  __syncthreads();
  // thread: wqt row n0 + r, k bytes k0 + c .. + 16
  if (n0 + r >= N) return;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[q] |= uint32_t(uint8_t(tile[c + 4 * q + j][r])) << (8 * j);
  }
  *reinterpret_cast<uint4*>(wqt + int64_t(n0 + r) * K + k0 + c) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(256)
cim_dac_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
               int M, int K, float qmax_a) {
  const int kt = K / kTileK;
  const int64_t pair = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;   // (row, K tile)
  if (pair >= int64_t(M) * kt) return;
  const int lane = threadIdx.x % 32;
  const int64_t row = pair / kt;
  const int ki = int(pair % kt);
  const int64_t off = row * K + int64_t(ki) * kTileK;
  float v[kTileK / 32];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kTileK / 32; ++j) {
    v[j] = to_float(x[off + lane + 32 * j]);
    m = fmaxf(m, fabsf(v[j]));
  }
  m = warp_max(m);
  const float s = __fdiv_rn(__fadd_rn(m, 1e-9f), qmax_a);
#pragma unroll
  for (int j = 0; j < kTileK / 32; ++j) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], s)), -qmax_a), qmax_a);
    xq[off + lane + 32 * j] = static_cast<int8_t>(__float2int_rn(q));
  }
  if (lane == 0) xs[row * kt + ki] = s;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Output tile (blockIdx.x * 64, blockIdx.y * 128).  kFinal false: max|psum|
// per (calibration tile, K tile) into cal (zeroed by the caller).  kFinal
// true: the ADC with those maxima and the accumulation, written to out.
template <bool kFinal>
__global__ void __launch_bounds__(kThreads, kFinal ? 1 : 2)
cim_dot_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wqt,
               const float* __restrict__ xs, const float* __restrict__ wscale,
               int* __restrict__ cal, float* __restrict__ out, int M, int K, int N, int bm,
               int bn, float adc_max) {
  // two stages of kBM rows of xq, then kBN rows of wqt, 256 k each, padded
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int slot_max[kMaxSlots];
  __shared__ float slot_cal[kMaxSlots];        // max(max|psum|, 1)
  __shared__ float slot_step[kMaxSlots];       // cal / adc_max
  __shared__ float xs_s[kBM], ws_s[kBN];

  const int kt = K / kTileK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ntn = N / bn;
  // calibration tiles met by this CTA: rows tr0.., cols tc0.., row-major slots
  const int tr0 = m0 / bm, tc0 = n0 / bn;
  const int ncols = (min(n0 + kBN, N) - 1) / bn - tc0 + 1;
  const int nslots = ((min(m0 + kBM, M) - 1) / bm - tr0 + 1) * ncols;

  // slot parts of this thread's fragment rows (mi, h) and columns (ni, e);
  // -1 past M or N
  int rslot[4], cslot[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + wm * 32 + (i / 2) * 16 + (i % 2) * 8 + g;
    rslot[i] = r < M ? (r / bm - tr0) * ncols : -1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = n0 + wn * 32 + (i / 2) * 8 + tig * 2 + (i % 2);
    cslot[i] = c < N ? c / bn - tc0 : -1;
  }
  if (!kFinal) {
    for (int i = tid; i < nslots; i += kThreads) slot_max[i] = 0;
  }
  float facc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[mi][ni][e] = 0.f;

  auto load_tile = [&](int ki, unsigned char* stage) {
    const int64_t k0 = int64_t(ki) * kTileK;
    for (int idx = tid; idx < (kBM + kBN) * 16; idx += kThreads) {
      const int r = idx / 16, c = idx % 16;
      const bool a = r < kBM;
      const int row = a ? m0 + r : n0 + r - kBM;
      const bool ok = row < (a ? M : N);
      const int8_t* src = (a ? xq : wqt) + (ok ? int64_t(row) * K + k0 + c * 16 : 0);
      cp_async16(stage + r * kRowBytes + c * 16, src, ok);
    }
  };

  load_tile(0, smem);
  cp_async_commit();
  for (int ki = 0; ki < kt; ++ki) {
    unsigned char* As = smem + (ki & 1) * kStageBytes;
    unsigned char* Bs = As + kBM * kRowBytes;
    // the other stage was released by the last iteration's closing barrier
    if (ki + 1 < kt) load_tile(ki + 1, smem + ((ki + 1) & 1) * kStageBytes);
    cp_async_commit();
    cp_async_wait<1>();
    if (kFinal) {
      for (int r = tid; r < kBM; r += kThreads) {
        xs_s[r] = m0 + r < M ? xs[int64_t(m0 + r) * kt + ki] : 0.f;
      }
      for (int c = tid; c < kBN; c += kThreads) {
        ws_s[c] = n0 + c < N ? wscale[int64_t(ki) * N + n0 + c] : 0.f;
      }
      for (int i = tid; i < nslots; i += kThreads) {
        const int tile = (tr0 + i / ncols) * ntn + tc0 + i % ncols;
        const float c = fmaxf(__int2float_rn(cal[int64_t(tile) * kt + ki]), 1.f);
        slot_cal[i] = c;
        slot_step[i] = __fdiv_rn(c, adc_max);
      }
    }
    __syncthreads();

    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    // ldmatrix on the bytes as b16 pairs gives the s8 fragments: lane l
    // addresses row l % 8 of 8 x 16-byte matrix l / 8
    const unsigned char* a_lane =
        As + (wm * 32 + (lane % 8) + 8 * ((lane / 8) % 2)) * kRowBytes + 16 * (lane / 16);
    const unsigned char* b_lane =
        Bs + (wn * 32 + (lane % 8) + 8 * (lane / 16)) * kRowBytes + 16 * ((lane / 8) % 2);
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 32) {
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldsm_x4(a[mi], a_lane + mi * 16 * kRowBytes + kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, b_lane + np * 16 * kRowBytes + kk);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], bf[ni]);
    }

    // fragment element (mi, ni, e): row mi*16 + (e/2)*8 + g, column
    // ni*8 + tig*2 + e%2 of the warp tile
    if (!kFinal && nslots == 1) {
      // the CTA tile lies in one calibration tile: out-of-range elements
      // are 0 (zero-filled operands) and change no max
      int best = 0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) best = max(best, abs(acc[mi][ni][e]));
      best = __reduce_max_sync(0xffffffffu, best);
      if (lane == 0) atomicMax(&slot_max[0], best);
    } else if (!kFinal) {
      int cur = -1, best = 0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int rs = rslot[mi * 2 + h], cs = cslot[ni * 2 + e];
              if (rs < 0 || cs < 0) continue;
              const int slot = rs + cs;
              const int v = abs(acc[mi][ni][h * 2 + e]);
              if (slot != cur) {
                if (cur >= 0) atomicMax(&slot_max[cur], best);
                cur = slot;
                best = v;
              } else {
                best = max(best, v);
              }
            }
      if (cur >= 0) atomicMax(&slot_max[cur], best);
    }
    if (!kFinal) {
      __syncthreads();
      for (int i = tid; i < nslots; i += kThreads) {
        const int v = slot_max[i];
        const int tile = (tr0 + i / ncols) * ntn + tc0 + i % ncols;
        if (v > 0) atomicMax(&cal[int64_t(tile) * kt + ki], v);
        slot_max[i] = 0;
      }
    } else if (nslots == 1) {
      // one calibration tile: its scale, and each fragment row's xs and
      // column's wscale, read once; out-of-range elements add 0 and are
      // not written
      const float cv = slot_cal[0], step = slot_step[0];
      float xr[4], wc[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = xs_s[wm * 32 + (i / 2) * 16 + (i % 2) * 8 + g];
#pragma unroll
      for (int i = 0; i < 8; ++i) wc[i] = ws_s[wn * 32 + (i / 2) * 8 + tig * 2 + (i % 2)];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = __int2float_rn(acc[mi][ni][h * 2 + e]);
              const float code =
                  fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(p, cv), adc_max)), -adc_max), adc_max);
              float& f = facc[mi][ni][h * 2 + e];
              f = __fadd_rn(f, __fmul_rn(__fmul_rn(__fmul_rn(code, step), xr[mi * 2 + h]),
                                         wc[ni * 2 + e]));
            }
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int rs = rslot[mi * 2 + h], cs = cslot[ni * 2 + e];
              if (rs < 0 || cs < 0) continue;
              const int slot = rs + cs;
              const float p = __int2float_rn(acc[mi][ni][h * 2 + e]);
              const float code = fminf(
                  fmaxf(rintf(__fmul_rn(__fdiv_rn(p, slot_cal[slot]), adc_max)), -adc_max),
                  adc_max);
              const float q = __fmul_rn(code, slot_step[slot]);
              const float xsv = xs_s[wm * 32 + mi * 16 + h * 8 + g];
              const float wsv = ws_s[wn * 32 + ni * 8 + tig * 2 + e];
              float& f = facc[mi][ni][h * 2 + e];
              f = __fadd_rn(f, __fmul_rn(__fmul_rn(q, xsv), wsv));
            }
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }

  if (kFinal) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = m0 + wm * 32 + mi * 16 + h * 8 + g;
            const int c = n0 + wn * 32 + ni * 8 + tig * 2 + e;
            if (r < M && c < N) out[int64_t(r) * N + c] = facc[mi][ni][h * 2 + e];
          }
  }
}

template <bool kFinal>
cudaError_t launch_dot(const int8_t* xq, const int8_t* wqt, const float* xs, const float* ws,
                       int* cal, float* out, int M, int K, int N, int bm, int bn,
                       float adc_max, cudaStream_t s) {
  auto kernel = cim_dot_kernel<kFinal>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(xq, wqt, xs, ws, cal, out, M, K, N, bm, bn, adc_max);
  return cudaGetLastError();
}

// Calibration tiles that one CTA tile can meet, at most.
int max_slots(int M, int N, int bm, int bn) {
  const int rows = std::min(M / bm, (kBM + bm - 2) / bm + 1);
  const int cols = std::min(N / bn, (kBN + bn - 2) / bn + 1);
  return rows * cols;
}


// ---- the ADC of the new routes -----------------------------------------------

// RN(p / cal) for integers |p| <= cal < 2^24, from rcp = RN(1 / cal):
// q0 = RN(p rcp) lies within 1 ulp of p / cal, so the residual p - cal q0
// is exact in one FMA, and RN(q0 + residual rcp) is RN(p / cal)
// (Markstein's theorem).  It gives __fdiv_rn's bits: the gpu test
// test_adc_division_equals_fdiv_rn checks every pair with cal <= 2^16 and
// 10^8 random pairs with cal < 2^24 (cim_adc_div_mismatches below).
__device__ __forceinline__ float adc_div(float p, float cal, float rcp) {
  const float q0 = __fmul_rn(p, rcp);
  return __fmaf_rn(__fmaf_rn(-q0, cal, p), rcp, q0);
}

// The integer p (|p| < 2^22, as every psum) as a float, on the FMA and
// integer pipes: p added to the bits of 1.5 * 2^23 is that float's
// significand, and the subtraction is exact.  (The conversion instructions
// I2FP and FRND issue at an eighth of the FMA rate on an SM, and the ADC
// needs one of each an element.)
__device__ __forceinline__ float psum_float(int p) {
  return __fsub_rn(__int_as_float(p + 0x4B400000), 12582912.f);
}

// rintf(x), half to even, for |x| < 2^23: |x| + 2^23 rounds to an integer
// in [2^23, 2^24), where the spacing is 1; the subtraction is exact; the
// sign (also of a zero) goes back on.
__device__ __forceinline__ float rint_small(float x) {
  return copysignf(__fsub_rn(__fadd_rn(fabsf(x), 8388608.f), 8388608.f), x);
}

// One ADC term ((code * step) * xs) * wscale of a psum p (a float holding
// an integer) whose calibration max is cal >= |p|.  code = clip(rint(p /
// cal * adc_max)) needs no clip here: |p| <= cal gives |RN(p / cal)| <= 1,
// so the rounded product and its rint lie in [-adc_max, adc_max] already,
// and |adc_max| < 2^23 (adc_bits <= 24).
__device__ __forceinline__ float adc_term(float p, float cal, float rcp, float step,
                                          float adc_max, float xs, float ws) {
  const float code = rint_small(__fmul_rn(adc_div(p, cal, rcp), adc_max));
  return __fmul_rn(__fmul_rn(__fmul_rn(code, step), xs), ws);
}

// ---- cluster route ----------------------------------------------------------

constexpr int kCM = 128, kCN = 128;          // a CTA's output tile
constexpr int kPairN = 2 * kCN;              // the pair's output block: 128 x 256
constexpr int kStages = 3;
constexpr int kBoxBytes = 128 * 128;         // one TMA box: 128 rows x 128 k bytes
constexpr int kCStageBytes = 4 * kBoxBytes;  // xq k 0-127, 128-255; wqt the same
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kCThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kCSmemBytes = kStages * kCStageBytes + 8 * (2 * kStages + 2) + 4 * (2 + 16) +
                            4 * (4 * kCM) + 1024;   // stages, barriers, maxima, xs/wscale,
                                                    // alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// v into the shared::cluster address addr of another CTA of the cluster,
// completing 4 bytes on its mbarrier at bar (same CTA)
__device__ __forceinline__ void st_async_u32(uint32_t addr, unsigned v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator set
// across the asynchronous product that owns it
__device__ __forceinline__ void reg_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO); the
// start may move by 32 bytes within the swizzle atom for each k32 slice.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// d (+)= a b over k 32: a 64 x 32 from shared memory, b 128 x 32 (K-major)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The K step's 8 products of one consumer warpgroup: 64 rows of xq from
// row 64 * wg of the stage, 128 rows of wqt, two 128-byte halves of k.
__device__ __forceinline__ void issue_step(int (&d)[64], uint32_t stage, int wg) {
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a = stage + h * kBoxBytes + wg * 64 * 128 + kk * 32;
      const uint32_t b = stage + (2 + h) * kBoxBytes + kk * 32;
      wgmma_s8(d, smem_desc(a), smem_desc(b), h | kk);
    }
  }
  wgmma_commit();
}

// What a consumer thread keeps through the K loop besides its registers.
struct ClusterCtx {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* xbar;          // [2], completed by the partner's st.async bytes
  unsigned* pin;           // [2], the partner's max of a step
  unsigned* wmax;          // [2][8], each consumer warp's
  float* xsb;              // [2][kCM xs, then kCN wscale]
  uint32_t stage0;         // shared address of stage 0
  uint32_t pin_remote;     // the partner's pin and xbar, shared::cluster addresses
  uint32_t xbar_remote;
  const float* xs;
  const float* wscale;
  int tid, wg, lane, g, tig, rloc;   // rloc: the CTA row of this thread's first rows
  int m0, n0, M, N, kt;
  float adc_max;
};

// The scale consumer thread t stages for step ki: xs of row m0 + t (t < 128)
// or wscale of column n0 + t - 128, 0 past M or N.
__device__ __forceinline__ float load_scale(int ki, const ClusterCtx& c) {
  if (c.tid < kCM) {
    const int r = c.m0 + c.tid;
    return r < c.M ? c.xs[int64_t(r) * c.kt + ki] : 0.f;
  }
  const int col = c.n0 + c.tid - kCM;
  return col < c.N ? c.wscale[int64_t(ki) * c.N + col] : 0.f;
}

// One K step of a consumer thread: wait for the products of step ki into
// cur (kNext: issuing step ki + 1 into nxt first), release the stage, share
// the calibration max with the pair, then the ADC into facc.  kNext is
// known at compile time, so ptxas sees one group in flight at every wait and
// keeps the products asynchronous.
template <bool kNext>
__device__ __forceinline__ void consume_step(int (&cur)[64], int (&nxt)[64], float (&facc)[64],
                                             float& scale, int ki, const ClusterCtx& c) {
  const int buf = ki & 1;
  // stage this step's scale (loaded a step ahead), then load the next one
  c.xsb[buf * 2 * kCM + c.tid] = scale;
  if constexpr (kNext) scale = load_scale(ki + 1, c);
  if constexpr (kNext) {
    const int s1 = (ki + 1) % kStages;
    mbar_wait(&c.full[s1], ((ki + 1) / kStages) & 1);
    reg_fence(nxt);
    issue_step(nxt, c.stage0 + s1 * kCStageBytes, c.wg);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  reg_fence(cur);
  __syncwarp();
  if (c.lane == 0) mbar_arrive(&c.empty[ki % kStages]);

  // the psums as floats, in place, and this CTA's max |p| of the step as the
  // bits of a float >= 0 (which order as the unsigned integers do); rows
  // past M and columns past N hold psum 0
  float best = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = psum_float(cur[i]);
    cur[i] = __float_as_int(p);
    best = fmaxf(best, fabsf(p));
  }
  const unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(best));
  if (c.lane == 0) c.wmax[buf * 8 + c.tid / 32] = bits;
  // the staged scales and the maxima of all 8 consumer warps are in place
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // send the CTA's max to the partner's pin[buf] with st.async, which
  // completes bytes on its xbar[buf]; ours arrives the same way
  unsigned own = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) own = max(own, c.wmax[buf * 8 + w]);
  if (c.tid == 0) {
    mbar_expect_tx(&c.xbar[buf], 4);
    st_async_u32(c.pin_remote + buf * 4, own, c.xbar_remote + buf * 8);
  }
  mbar_wait(&c.xbar[buf], (ki >> 1) & 1);

  const float adc_max = c.adc_max;
  const float* xsb = c.xsb + buf * 2 * kCM;
  const float* wsb = xsb + kCM;
  const float cal = fmaxf(__uint_as_float(max(own, c.pin[buf])), 1.f);
  const float rcp = __frcp_rn(cal);
  const float step = __fdiv_rn(cal, adc_max);
  const float xr[2] = {xsb[c.rloc], xsb[c.rloc + 8]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 w = *reinterpret_cast<const float2*>(&wsb[8 * j + 2 * c.tig]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        facc[i] = __fadd_rn(facc[i], adc_term(__int_as_float(cur[i]), cal, rcp, step,
                                              adc_max, xr[h], e ? w.y : w.x));
      }
    }
  }
}

// Output tile (blockIdx.x * 128, blockIdx.y * 128); CTAs 2c and 2c + 1
// along y are a cluster over columns [256 c, 256 c + 256), the pair's block,
// which is one calibration tile.
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(kCThreads, 1)
cim_cluster_kernel(const __grid_constant__ CUtensorMap tm_xq,
                   const __grid_constant__ CUtensorMap tm_wqt, const float* __restrict__ xs,
                   const float* __restrict__ wscale, float* __restrict__ out, int M, int K,
                   int N, float adc_max) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kCStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* xbar = empty + kStages;
  unsigned* pin = reinterpret_cast<unsigned*>(xbar + 2);
  unsigned* wmax = pin + 2;
  float* xsb = reinterpret_cast<float*>(wmax + 16);

  const int tid = threadIdx.x;
  const int kt = K / kTileK;
  const int m0 = blockIdx.x * kCM, n0 = blockIdx.y * kCN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(&xbar[0], 1);   // our expect_tx; the partner's bytes complete it
    mbar_init(&xbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // barriers of both CTAs ready before any remote access

  if (tid >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      for (int ki = 0; ki < kt; ++ki) {
        const int s = ki % kStages;
        mbar_wait(&empty[s], ((ki / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kCStageBytes);
        unsigned char* st = smem + s * kCStageBytes;
        const int k0 = ki * kTileK;
        tma_load_2d(st, &tm_xq, k0, m0, &full[s]);
        tma_load_2d(st + kBoxBytes, &tm_xq, k0 + 128, m0, &full[s]);
        tma_load_2d(st + 2 * kBoxBytes, &tm_wqt, k0, n0, &full[s]);
        tma_load_2d(st + 3 * kBoxBytes, &tm_wqt, k0 + 128, n0, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    ClusterCtx c;
    c.full = full;
    c.empty = empty;
    c.xbar = xbar;
    c.pin = pin;
    c.wmax = wmax;
    c.xsb = xsb;
    c.stage0 = smem_u32(smem);
    const uint32_t partner = cluster_rank() ^ 1;
    c.pin_remote = cluster_map(smem_u32(pin), partner);
    c.xbar_remote = cluster_map(smem_u32(xbar), partner);
    c.xs = xs;
    c.wscale = wscale;
    c.tid = tid;
    c.wg = tid / 128;
    c.lane = tid % 32;
    c.g = c.lane / 4;
    c.tig = c.lane % 4;
    c.rloc = c.wg * 64 + ((tid / 32) % 4) * 16 + c.g;
    c.m0 = m0;
    c.n0 = n0;
    c.M = M;
    c.N = N;
    c.kt = kt;
    c.adc_max = adc_max;

    int acc0[64], acc1[64];
    float facc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) facc[i] = 0.f;
    mbar_wait(&full[0], 0);
    issue_step(acc0, c.stage0, c.wg);
    reg_fence(acc0);
    float scale = load_scale(0, c);
    int ki = 0;
    for (; ki + 2 < kt; ki += 2) {   // steps ki and ki + 1 both have a next one
      consume_step<true>(acc0, acc1, facc, scale, ki, c);
      consume_step<true>(acc1, acc0, facc, scale, ki + 1, c);
    }
    if (ki + 2 == kt) {
      consume_step<true>(acc0, acc1, facc, scale, ki, c);
      consume_step<false>(acc1, acc0, facc, scale, ki + 1, c);
    } else {
      consume_step<false>(acc0, acc1, facc, scale, ki, c);
    }

    // element i = 4 j + 2 h + e: row m0 + rloc + 8 h, column n0 + 8 j + 2 tig + e
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + c.rloc + 8 * h;
      if (r >= M) continue;
      float* orow = out + int64_t(r) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * c.tig;
        const float v0 = facc[4 * j + 2 * h], v1 = facc[4 * j + 2 * h + 1];
        if (pairs && col + 1 < N) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < N) orow[col] = v0;
          if (col + 1 < N) orow[col + 1] = v1;
        }
      }
    }
  }
}

// ---- decode route -----------------------------------------------------------

constexpr int kDM = 16, kDN = 256;
constexpr int kDMaxSlots = 64;   // calibration tiles one decode CTA may meet
constexpr int kDSmemBytes = (kDM + kDN) * kRowBytes;

// CTA (blockIdx.x: 256 output columns, blockIdx.y: K tile); M <= 16.
// Writes the K tile's ADC term of each output to terms (K / 256, M, N).
__global__ void __launch_bounds__(kThreads, 3)
cim_decode_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wqt,
                  const float* __restrict__ xs, const float* __restrict__ wscale,
                  float* __restrict__ terms, int M, int K, int N, int bm, int bn,
                  float adc_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int slot_max[kDMaxSlots];
  __shared__ float slot_cal[kDMaxSlots];
  __shared__ float slot_rcp[kDMaxSlots];
  __shared__ float slot_step[kDMaxSlots];
  __shared__ float xs_s[kDM], ws_s[kDN];

  const int kt = K / kTileK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kDN, ki = blockIdx.y;
  const int64_t k0 = int64_t(ki) * kTileK;
  const int tc0 = n0 / bn;
  const int ncols = (min(n0 + kDN, N) - 1) / bn - tc0 + 1;
  const int nslots = ((M - 1) / bm + 1) * ncols;

  unsigned char* As = smem;
  unsigned char* Bs = smem + kDM * kRowBytes;
  for (int idx = tid; idx < (kDM + kDN) * 16; idx += kThreads) {
    const int r = idx / 16, c = idx % 16;
    const bool a = r < kDM;
    const int row = a ? r : n0 + r - kDM;
    const bool ok = row < (a ? M : N);
    const int8_t* src = (a ? xq : wqt) + (ok ? int64_t(row) * K + k0 + c * 16 : 0);
    cp_async16(smem + r * kRowBytes + c * 16, src, ok);
  }
  cp_async_commit();
  for (int i = tid; i < nslots; i += kThreads) slot_max[i] = 0;
  if (tid < kDM) xs_s[tid] = tid < M ? xs[int64_t(tid) * kt + ki] : 0.f;
  for (int c = tid; c < kDN; c += kThreads) {
    ws_s[c] = n0 + c < N ? wscale[int64_t(ki) * N + n0 + c] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  int acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0;
  const unsigned char* a_lane =
      As + ((lane % 8) + 8 * ((lane / 8) % 2)) * kRowBytes + 16 * (lane / 16);
  const unsigned char* b_lane =
      Bs + (warp * 32 + (lane % 8) + 8 * (lane / 16)) * kRowBytes + 16 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 32) {
    uint32_t a[4], bf[4][2];
    ldsm_x4(a, a_lane + kk);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, b_lane + np * 16 * kRowBytes + kk);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8(acc[ni], a, bf[ni]);
  }

  // fragment element (ni, e): row (e / 2) * 8 + g, column warp * 32 + ni * 8
  // + tig * 2 + e % 2 of the CTA tile; rows past M and columns past N are
  // 0 (zero-filled operands) and change no max
  if (nslots == 1) {
    int best = 0;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best = max(best, abs(acc[ni][e]));
    best = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) atomicMax(&slot_max[0], best);
  } else {
    int cur = -1, best = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = h * 8 + g, col = n0 + warp * 32 + ni * 8 + tig * 2 + e;
          if (r >= M || col >= N) continue;
          const int slot = (r / bm) * ncols + col / bn - tc0;
          const int v = abs(acc[ni][h * 2 + e]);
          if (slot != cur) {
            if (cur >= 0) atomicMax(&slot_max[cur], best);
            cur = slot;
            best = v;
          } else {
            best = max(best, v);
          }
        }
    if (cur >= 0) atomicMax(&slot_max[cur], best);
  }
  __syncthreads();
  for (int i = tid; i < nslots; i += kThreads) {
    const float c = fmaxf(__int2float_rn(slot_max[i]), 1.f);
    slot_cal[i] = c;
    slot_rcp[i] = __frcp_rn(c);
    slot_step[i] = __fdiv_rn(c, adc_max);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = h * 8 + g, cl = warp * 32 + ni * 8 + tig * 2 + e, col = n0 + cl;
        if (r >= M || col >= N) continue;
        const int slot = (r / bm) * ncols + col / bn - tc0;
        terms[(int64_t(ki) * M + r) * N + col] =
            adc_term(psum_float(acc[ni][h * 2 + e]), slot_cal[slot], slot_rcp[slot],
                     slot_step[slot], adc_max, xs_s[r], ws_s[cl]);
      }
}

// out[i] = ((0 + terms[0][i]) + terms[1][i]) + ...: the K tiles in order,
// as the accumulator of the other routes sums them
__global__ void __launch_bounds__(256)
cim_combine_kernel(const float* __restrict__ terms, float* __restrict__ out, int64_t mn,
                   int kt) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < mn;
       i += int64_t(gridDim.x) * blockDim.x) {
    float f = 0.f;
    for (int ki = 0; ki < kt; ++ki) f = __fadd_rn(f, terms[ki * mn + i]);
    out[i] = f;
  }
}

// ---- the division check --------------------------------------------------------

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ void div_check(int p, int cal, unsigned long long* bad) {
  const float pf = __int2float_rn(p), cf = __int2float_rn(cal);
  if (__float_as_uint(adc_div(pf, cf, __frcp_rn(cf))) != __float_as_uint(__fdiv_rn(pf, cf))) {
    atomicAdd(bad, 1ull);
  }
}

// exhaustive: block b takes cal = b + 1 and every p in [-cal, cal]
__global__ void __launch_bounds__(256) cim_div_all_kernel(unsigned long long* bad) {
  const int cal = blockIdx.x + 1;
  for (int p = -cal + int(threadIdx.x); p <= cal; p += blockDim.x) div_check(p, cal, bad);
}

// random: pair i has cal uniform in [1, 2^24) and p uniform in [-cal, cal]
__global__ void __launch_bounds__(256)
cim_div_random_kernel(unsigned long long* bad, int64_t n, uint64_t seed) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const uint64_t h = splitmix64(seed ^ splitmix64(uint64_t(i)));
    const int cal = 1 + int((h & 0xFFFFFFFFull) % ((1u << 24) - 1));
    const int p = int((h >> 32) % uint64_t(2 * cal + 1)) - cal;
    div_check(p, cal, bad);
  }
}

// ---- host side --------------------------------------------------------------

enum Route { kRouteCluster = 0, kRouteDecode = 1, kRouteTwoPass = 2 };

// calibration tiles of size b along a dimension of the given size lie in
// blocks of `block` (the dimension fits one block, or b divides it)
bool held(int size, int block, int b) { return size <= block || block % b == 0; }

// a block of `block` along a dimension of the given size is one calibration
// tile of size b (the dimension fits one block and b is all of it, or b is
// the block)
bool one_tile(int size, int block, int b) { return size <= block ? b == size : b == block; }

bool route_takes(int route, int M, int N, int bm, int bn) {
  switch (route) {
    case kRouteCluster:
      return one_tile(M, kCM, bm) && one_tile(N, kPairN, bn);
    case kRouteDecode:
      return M <= kDM && held(N, kDN, bn) && (M / bm) * (std::min(N, kDN) / bn) <= kDMaxSlots;
    case kRouteTwoPass:
      return max_slots(M, N, bm, bn) <= kMaxSlots;
  }
  return false;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (so the
// library needs no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (rows, K) int8, k contiguous, as boxes of 128 rows x 128 bytes with the
// 128-byte swizzle; rows past the end read as 0
bool tile_map(CUtensorMap* map, const void* base, int rows, int K) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {128, 128};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_cluster(const int8_t* xq, const int8_t* wqt, const float* xs,
                           const float* ws, float* out, int M, int K, int N, float adc_max,
                           cudaStream_t s) {
  CUtensorMap tm_xq, tm_wqt;
  if (!tile_map(&tm_xq, xq, M, K) || !tile_map(&tm_wqt, wqt, N, K)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = cim_cluster_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kCM - 1) / kCM, 2 * ((N + kPairN - 1) / kPairN));
  kernel<<<grid, kCThreads, kCSmemBytes, s>>>(tm_xq, tm_wqt, xs, ws, out, M, K, N, adc_max);
  return cudaGetLastError();
}

cudaError_t launch_decode(const int8_t* xq, const int8_t* wqt, const float* xs, const float* ws,
                          float* terms, float* out, int M, int K, int N, int bm, int bn,
                          float adc_max, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(cim_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDSmemBytes);
  if (err != cudaSuccess) return err;
  const int kt = K / kTileK;
  cim_decode_kernel<<<dim3((N + kDN - 1) / kDN, kt), kThreads, kDSmemBytes, s>>>(
      xq, wqt, xs, ws, terms, M, K, N, bm, bn, adc_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t mn = int64_t(M) * N;
  const int blocks = int(std::min<int64_t>((mn + 255) / 256, 4096));
  cim_combine_kernel<<<blocks, 256, 0, s>>>(terms, out, mn, kt);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x: (M, K) float32 or bfloat16 (dtype 0 / 1); wq: (K, N) int8; wscale:
// (K / 256, N) float32; out: (M, N) float32.  wqt: (N, K) int8, the weight
// in the kernels' layout, read as it is if wqt_ready, else written here
// from wq.  Scratch from the caller: xq (M, K) int8, xs (M, K / 256)
// float32, and by route (kernels/cim_matmul.route, checked again here)
// scratch = cal ((M / bm) * (N / bn) * (K / 256)) int32 (two_pass), terms
// (K / 256, M, N) float32 (decode), or nothing (cluster).  All contiguous,
// 16-byte aligned.  qmax_a = 2^(act_bits-1) - 1 <= 127, adc_max =
// 2^(adc_bits-1) - 1.  Launches on the stream and returns the first CUDA
// error (cudaGetLastError() after each launch).
extern "C" int cim_matmul_fwd(const void* x, const void* wq, const void* wscale, void* out,
                              void* wqt, void* xq, void* xs, void* scratch, int M, int K, int N,
                              int bm, int bn, int dtype, int qmax_a, int adc_max, int route,
                              int wqt_ready, void* stream) {
  using namespace repro_torch;
  if (M <= 0 || N <= 0 || K <= 0 || K % kTileK || bm <= 0 || bn <= 0 || M % bm || N % bn ||
      qmax_a < 1 || qmax_a > 127 || adc_max < 1 || !route_takes(route, M, N, bm, bn)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* wqt8 = static_cast<int8_t*>(wqt);
  cudaError_t err;
  if (!wqt_ready) {
    cim_transpose_kernel<<<dim3((N + kT - 1) / kT, K / kT), 256, 0, s>>>(
        static_cast<const int8_t*>(wq), wqt8, K, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int kt = K / kTileK;
  const int64_t pairs = int64_t(M) * kt;
  const int dac_grid = int((pairs + 7) / 8);
  int8_t* xq8 = static_cast<int8_t*>(xq);
  float* xsf = static_cast<float*>(xs);
  if (dtype == 0) {
    cim_dac_kernel<float><<<dac_grid, 256, 0, s>>>(static_cast<const float*>(x), xq8, xsf, M,
                                                  K, float(qmax_a));
  } else if (dtype == 1) {
    cim_dac_kernel<__nv_bfloat16><<<dac_grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), xq8, xsf, M, K, float(qmax_a));
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* wsf = static_cast<const float*>(wscale);
  float* of = static_cast<float*>(out);
  const float am = float(adc_max);
  if (route == kRouteCluster) {
    return launch_cluster(xq8, wqt8, xsf, wsf, of, M, K, N, am, s);
  }
  if (route == kRouteDecode) {
    return launch_decode(xq8, wqt8, xsf, wsf, static_cast<float*>(scratch), of, M, K, N, bm,
                         bn, am, s);
  }
  int* cal32 = static_cast<int*>(scratch);
  err = cudaMemsetAsync(cal32, 0, sizeof(int) * size_t(M / bm) * (N / bn) * kt, s);
  if (err != cudaSuccess) return err;
  err = launch_dot<false>(xq8, wqt8, xsf, wsf, cal32, of, M, K, N, bm, bn, am, s);
  if (err != cudaSuccess) return err;
  return launch_dot<true>(xq8, wqt8, xsf, wsf, cal32, of, M, K, N, bm, bn, am, s);
}

// Pairs whose ADC division (adc_div) differs from __fdiv_rn in any bit, into
// bad (one uint64 on the card, zeroed by the caller): mode 0 every (p, cal)
// with 1 <= cal <= max_cal and |p| <= cal; mode 1 n random pairs with
// cal < 2^24 from seed.
extern "C" int cim_adc_div_mismatches(int mode, int max_cal, int64_t n, uint64_t seed,
                                      void* bad, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned long long*>(bad);
  if (mode == 0 && max_cal >= 1) {
    cim_div_all_kernel<<<max_cal, 256, 0, s>>>(b);
  } else if (mode == 1 && n > 0) {
    cim_div_random_kernel<<<132 * 16, 256, 0, s>>>(b, n, seed);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// CTAs of the route's main kernel that reside on one SM of the current card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; for the cluster kernel,
// if that query refuses a kernel with cluster dimensions, 2 x the clusters
// resident on the card / its SMs).
extern "C" int cim_matmul_resident_ctas(int route, int* out) {
  using namespace repro_torch;
  cudaError_t err;
  if (route == kRouteCluster) {
    const void* kernel = reinterpret_cast<const void*>(cim_cluster_kernel);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kCThreads, kCSmemBytes);
    if (err == cudaSuccess) return 0;
    cudaGetLastError();
    int dev = 0, sms = 0, clusters = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 2 * sms);
    cfg.blockDim = dim3(kCThreads);
    cfg.dynamicSmemBytes = kCSmemBytes;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    *out = 2 * clusters / sms;
    return 0;
  }
  if (route == kRouteDecode) {
    err = cudaFuncSetAttribute(cim_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDSmemBytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cim_decode_kernel, kThreads,
                                                         kDSmemBytes);
  }
  err = cudaFuncSetAttribute(cim_dot_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cim_dot_kernel<true>, kThreads,
                                                       kSmemBytes);
}
