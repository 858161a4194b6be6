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
// own (no FMA contraction), in the reference's order: the result equals
// the plain version's, whose float32 steps are the same.
//
// The integer dot is exact: |xq|, |wq| <= 127 (act_bits <= 8) over 256 terms
// gives |psum| < 2^24, so int8 x int8 -> int32 (mma.sync m16n8k32 s8) gives
// the integers that the reference's float32 dot gives.  The wrapper refuses
// act_bits > 8.
//
// What bounds it on an H100: 2 M K N int8 operations against M K + K N
// bytes of operands and 4 M N of float32 output; at llama3-8b's MLP (M 2048,
// K 4096, N 14336) the operations (~0.12 ms at 1,979 TOP/s) outweigh the
// bytes (~0.058 ms at 3.35 TB/s).  This version runs the dot on the tensor
// cores through mma.sync from shared memory, without TMA or wgmma, and runs
// it twice (below); the M N K / 256 float32 ADC steps (an IEEE division,
// two roundings, three products and a sum each) run on the SIMT cores and
// cost more than the dot.
//
// The calibration tile is not the kernel's tiling (ROADMAP hazard 3): the
// ADC scale of a K step is the max over the caller's whole (bm, bn) output
// tile, 128 x 256 by default and up to M x N.  So the work is four
// launches:
//   0. cim_transpose_kernel  wq (K, N) -> wqt (N, K): the s8 mma takes B
//                        with k contiguous, and wq has n contiguous;
//   1. cim_dac_kernel    one warp per (row, K tile): xs (M, K/256) float32
//                        and xq (M, K) int8;
//   2. cim_dot_kernel<false>  the integer dot of every (64 x 128) CTA tile
//                        and K tile; max|psum| per calibration tile over the
//                        fragments (a warp reduction where the CTA tile lies
//                        in one calibration tile, else per element by
//                        slot), then shared memory, then one atomicMax on
//                        int32 per (calibration tile, K tile) that the CTA
//                        meets: exact and independent of order;
//   3. cim_dot_kernel<true>   the dot again, then the ADC with those maxima
//                        and the float32 accumulation over K tiles in
//                        registers; writes the output once.
// A single pass, with a calibration tile covered by one CTA or by a thread
// block cluster sharing its maxima through distributed shared memory, is
// later work.
//
// CTA: 256 threads, 8 warps as 2 (m) x 4 (n), each warp a 32 x 32 tile of
// 2 x 4 mma.sync m16n8k32 fragments, loaded with ldmatrix (the s8 fragment
// layout is the b16 one on byte pairs).  K tiles of xq (64 x 256 bytes) and
// of wqt (128 x 256) stream through two shared-memory stages with cp.async,
// the next tile's copy in flight while the current one is multiplied; rows
// are padded by 16 bytes so the fragment reads are free of bank conflicts.
// blockIdx.x walks M, so the CTAs that run together share wqt's columns in
// L2.  The calibration pass fits two CTAs an SM (111 KB of shared memory
// each); the final pass keeps 32 float32 sums a thread beside 32 int32
// fragments and runs one CTA an SM without spilling.
#include <algorithm>
#include <cmath>
#include <cstdint>

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

}  // namespace
}  // namespace repro_torch

// 1 if the kernel takes calibration tiles (bm, bn) of an (M, N) output,
// else 0: a CTA tile keeps the running max of each calibration tile it
// meets in shared memory, at most kMaxSlots of them.
extern "C" int cim_matmul_tile_fits(int M, int N, int bm, int bn) {
  using namespace repro_torch;
  return bm > 0 && bn > 0 && max_slots(M, N, bm, bn) <= kMaxSlots;
}

// x: (M, K) float32 or bfloat16 (dtype 0 / 1); wq: (K, N) int8; wscale:
// (K / 256, N) float32; out: (M, N) float32.  Scratch from the caller: wqt
// (N, K) int8, xq (M, K) int8, xs (M, K / 256) float32, cal ((M / bm) *
// (N / bn) * (K / 256)) int32.  All contiguous.  qmax_a = 2^(act_bits-1) - 1
// <= 127, adc_max = 2^(adc_bits-1) - 1.  Launches the four kernels on the
// stream and returns the first CUDA error (cudaGetLastError() after each
// launch).
extern "C" int cim_matmul_fwd(const void* x, const void* wq, const void* wscale, void* out,
                              void* wqt, void* xq, void* xs, void* cal, int M, int K, int N,
                              int bm, int bn, int dtype, int qmax_a, int adc_max,
                              void* stream) {
  using namespace repro_torch;
  if (M <= 0 || N <= 0 || K <= 0 || K % kTileK || bm <= 0 || bn <= 0 || M % bm || N % bn ||
      qmax_a < 1 || qmax_a > 127 || adc_max < 1 || max_slots(M, N, bm, bn) > kMaxSlots) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* wqt8 = static_cast<int8_t*>(wqt);
  cim_transpose_kernel<<<dim3((N + kT - 1) / kT, K / kT), 256, 0, s>>>(
      static_cast<const int8_t*>(wq), wqt8, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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
  int* cal32 = static_cast<int*>(cal);
  err = cudaMemsetAsync(cal32, 0, sizeof(int) * size_t(M / bm) * (N / bn) * kt, s);
  if (err != cudaSuccess) return err;
  const float* wsf = static_cast<const float*>(wscale);
  float* of = static_cast<float*>(out);
  err = launch_dot<false>(xq8, wqt8, xsf, wsf, cal32, of, M, K, N, bm, bn, float(adc_max), s);
  if (err != cudaSuccess) return err;
  return launch_dot<true>(xq8, wqt8, xsf, wsf, cal32, of, M, K, N, bm, bn, float(adc_max), s);
}
