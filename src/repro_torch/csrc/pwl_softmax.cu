// SCU row softmax for Hopper (sm_90a), float32 inside.
//
// Replaces the Pallas TPU kernel repro/kernels/pwl_softmax.py
// (pwl_softmax -> _softmax_kernel).  Per row of n values: the max, the
// SCU's 8-segment PWL exp of x - max (pwl_exp of common.cuh, the device
// function of the attention kernels' use_pwl variant), the sum, the
// reciprocal 1 / max(sum, 1e-30) and the scale e * r, output in x's dtype.
// The reciprocal is IEEE (__frcp_rn) and the scale a separately rounded
// multiply, as the reference computes them.
//
// What bounds it on an H100: ~6 float32 operations per element (max, the
// subtraction, the segment's multiply and add, the sum, the scale) against
// 4 to 8 bytes read and written: far below the SIMT cores' balance point,
// so it is bound by bytes.  The design reads each row from device memory
// once where it can and writes it once.
//
// PWL exp is not multiplicative, so a row cannot be done as an online
// softmax that rescales running sums by pwl(m_old - m_new): the max has to
// be known before the first exp.  Three layouts by row length:
//   n <= 1024        one warp per row, the row in registers (up to 32
//                    values a lane), 8 rows per CTA of 256 threads;
//   n <= 49152       one CTA of 512 threads per row, the row cached as
//                    float32 in shared memory (up to 192 KB);
//   longer           one CTA per row, three passes over device memory:
//                    max, sum of pwl(x - m), write (the exp is recomputed,
//                    with the same result).  llama3-8b's vocab row of
//                    128,256 floats (501 KB) is here; with a few rows this
//                    leaves most SMs idle, and splitting a row across a
//                    thread block cluster is later work.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarpThreads = 256;
constexpr int kWarpRows = kWarpThreads / 32;   // rows per CTA, one per warp
constexpr int kWarpMaxN = 1024;
constexpr int kRowThreads = 512;
constexpr int kCacheMaxN = 49152;

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarpThreads)
softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int n,
                    PwlCoeffs pwl) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kWarpRows + warp;
  if (row >= rows) return;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  float v[VPT];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < n ? to_float(xr[i]) : -INFINITY;
    m = fmaxf(m, v[j]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < n ? pwl_exp(__fsub_rn(v[j], m), pwl) : 0.f;
    s += v[j];
  }
  s = warp_sum(s);
  const float r = __frcp_rn(fmaxf(s, 1e-30f));
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + 32 * j;
    if (i < n) orow[i] = from_float<T>(__fmul_rn(v[j], r));
  }
}

// Max or sum over the CTA; every thread gets the result.  red: one float
// per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kRowThreads / 32 ? red[lane] : (kMax ? -INFINITY : 0.f);
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();
  return v;
}

template <typename T, bool kCached>
__global__ void __launch_bounds__(kRowThreads)
softmax_row_kernel(const T* __restrict__ x, T* __restrict__ out, int n, PwlCoeffs pwl) {
  extern __shared__ float cache[];   // n floats when kCached
  __shared__ float red[kRowThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const float v = to_float(xr[i]);
    if constexpr (kCached) cache[i] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const float v = kCached ? cache[i] : to_float(xr[i]);
    const float e = pwl_exp(__fsub_rn(v, m), pwl);
    if constexpr (kCached) cache[i] = e;
    s += e;
  }
  s = block_reduce<false>(s, red);
  const float r = __frcp_rn(fmaxf(s, 1e-30f));
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const float e = kCached ? cache[i] : pwl_exp(__fsub_rn(to_float(xr[i]), m), pwl);
    orow[i] = from_float<T>(__fmul_rn(e, r));
  }
}

template <typename T, int VPT>
cudaError_t launch_warp(const T* x, T* out, int rows, int n, const PwlCoeffs& pwl,
                        cudaStream_t s) {
  const int grid = (rows + kWarpRows - 1) / kWarpRows;
  softmax_warp_kernel<T, VPT><<<grid, kWarpThreads, 0, s>>>(x, out, rows, n, pwl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, void* ov, int rows, int n, const PwlCoeffs& pwl,
                   cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(ov);
  if (n <= 32) return launch_warp<T, 1>(x, out, rows, n, pwl, s);
  if (n <= 64) return launch_warp<T, 2>(x, out, rows, n, pwl, s);
  if (n <= 128) return launch_warp<T, 4>(x, out, rows, n, pwl, s);
  if (n <= 256) return launch_warp<T, 8>(x, out, rows, n, pwl, s);
  if (n <= 512) return launch_warp<T, 16>(x, out, rows, n, pwl, s);
  if (n <= kWarpMaxN) return launch_warp<T, 32>(x, out, rows, n, pwl, s);
  if (n <= kCacheMaxN) {
    const int smem = int(sizeof(float)) * n;
    auto kernel = softmax_row_kernel<T, true>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<rows, kRowThreads, smem, s>>>(x, out, n, pwl);
    return cudaGetLastError();
  }
  softmax_row_kernel<T, false><<<rows, kRowThreads, 0, s>>>(x, out, n, pwl);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, out: (rows, n), contiguous.  dtype 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch.
extern "C" int pwl_softmax_fwd(const void* x, void* out, int rows, int n, int dtype,
                               const void* pwl_host, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || n <= 0) return cudaErrorInvalidValue;
  const PwlCoeffs pwl = read_pwl(pwl_host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, rows, n, pwl, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, rows, n, pwl, s);
  return cudaErrorInvalidValue;
}
