// Mamba2 SSD chunked scan for Hopper (sm_90a), float32 inside.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py
// (ssd_scan -> _ssd_kernel), which computes what the JAX model runs as
// repro/models/ssm.py:ssd_chunked.  Unlike the Pallas kernel it also writes
// the final state, which a prefill needs for the decode cache.
//
// What bounds it on an H100: per row and head (P 64, N 128) the state terms
// do 4 * P * N and the quadratic form ~L * P FLOPs, ~37k, against P * 2
// bytes of bf16 x read and P * 4 bytes of float32 y written: ~100 FLOP per
// byte.  That is below the bf16 tensor cores' balance point (~295), so the
// card's bound is the bytes (~0.022 ms at b 4, S 512, H 80), but above the
// float32 SIMT cores' (~20): this first version computes every product with
// float32 FMAs on the SIMT cores (67 TFLOP/s peak), so it is limited by its
// operations and their shared-memory reads.  wgmma and a split of the scan
// across CTAs are later work.
//
// Design: one CTA of 256 threads per (batch, head), which walks the
// sequence in sub-chunks of 64 rows itself (the TPU grid walks chunks in
// order on one core and carries the state in VMEM; on Hopper nothing
// carries over between blocks).  The (P, N) state stays in shared memory
// for the whole sequence.  The sub-chunk length is the kernel's own: SSD
// is exactly associative across chunks, and at 64 rows B, C, x, the 64 x 64
// quadratic form and the state fit in ~130 KB of shared memory, where the
// model's 256-row chunk would need 256 KB for B and C alone.  B and C have
// one group: each CTA reads them by batch, with no copy per head (the
// Pallas wrapper broadcasts them to every head in memory).  Per sub-chunk:
//   cs    = inclusive cumsum of dt * A (one warp, shuffle scan)
//   Att   = (C B^T) * exp(cs_l - cs_m) * dt_m on m <= l, 0 above; exp is
//           taken only below the diagonal, where cs_l - cs_m <= 0
//   y     = Att x + exp(cs) * (C state^T)          (state of the previous step)
//   state = exp(cs_last) * state + (x * dt * exp(cs_last - cs))^T B
// Rows past S are masked to 0 (dt = 0 too), which is what zero padding
// gives: they add nothing to y or the state, and y is not written there.
// Shared rows are padded by one float where threads walk columns.
#include <cmath>
#include <cstdint>

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

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* a_neg, const void* Bm,
                   const void* Cm, void* y, void* state, int batch, int S, int H,
                   cudaStream_t stream) {
  constexpr size_t smem = ssd_smem_bytes<P, N>();
  auto kernel = ssd_fwd_kernel<T, P, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a_neg),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), S, H);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int N, const void* x, const void* dt, const void* a, const void* Bm,
                       const void* Cm, void* y, void* st, int batch, int S, int H,
                       cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, a, Bm, Cm, y, st, batch, S, H, s);
    case 32: return launch<T, P, 32>(x, dt, a, Bm, Cm, y, st, batch, S, H, s);
    case 64: return launch<T, P, 64>(x, dt, a, Bm, Cm, y, st, batch, S, H, s);
    case 128: return launch<T, P, 128>(x, dt, a, Bm, Cm, y, st, batch, S, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int P, int N, const void* x, const void* dt, const void* a, const void* Bm,
                     const void* Cm, void* y, void* st, int batch, int S, int H,
                     cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<T, 32>(N, x, dt, a, Bm, Cm, y, st, batch, S, H, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, a, Bm, Cm, y, st, batch, S, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// x: (batch, S, H, P); dt: (batch, S, H) float32; a_neg: (H,) float32;
// B, C: (batch, S, N); y: (batch, S, H, P) float32; state: (batch, H, P, N)
// float32; all contiguous.  dtype of x/B/C: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_neg, const void* Bm,
                            const void* Cm, void* y, void* state, int batch, int S, int H,
                            int P, int N, int dtype, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(P, N, x, dt, a_neg, Bm, Cm, y, state, batch, S, H, s);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(P, N, x, dt, a_neg, Bm, Cm, y, state, batch, S, H, s);
  }
  return cudaErrorInvalidValue;
}
