// Shared device helpers of the port's kernels: max and min that keep a NaN,
// the SCU's 8-segment PWL exp, the SFU's 2^x, float32/bfloat16
// conversion, warp reductions, cp.async,
// ldmatrix, the bf16 tensor-core product with its hi + lo split of
// float32 operands, and thread block cluster addressing and barriers.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kPwlSegments = 8;
constexpr float kNegInf = -1e30f;

// Launch argument with the coefficients of repro_torch/kernels/pwl.py
// (PWL_COEFFS): 8 slopes, 8 intercepts, x_min, x_max.
struct PwlCoeffs {
  float slope[kPwlSegments];
  float intercept[kPwlSegments];
  float x_min, x_max;
};

// max and min that keep a NaN, as jnp.max / torch.amax / jnp.clip do
// (fmaxf and fminf return the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The Pallas select chain _pwl_exp_vec: clip to [x_min, x_max], the last
// segment whose lower edge is <= x wins, 0 below x_min.  Multiply and add
// are rounded separately (no FMA contraction), as the reference computes.
// The clip keeps a NaN, so a NaN gives NaN, as in the reference.
__device__ __forceinline__ float pwl_exp(float x, const PwlCoeffs& c) {
  const float xc = min_nan(max_nan(x, c.x_min), c.x_max);
  const float seg_w = (c.x_max - c.x_min) / kPwlSegments;
  float y = __fadd_rn(__fmul_rn(c.slope[0], xc), c.intercept[0]);
#pragma unroll
  for (int i = 1; i < kPwlSegments; ++i) {
    if (xc >= c.x_min + i * seg_w) {
      y = __fadd_rn(__fmul_rn(c.slope[i], xc), c.intercept[i]);
    }
  }
  return x < c.x_min ? 0.f : y;
}

template <bool kPwl>
__device__ __forceinline__ float softmax_exp(float x, const PwlCoeffs& c) {
  if constexpr (kPwl) {
    return pwl_exp(x, c);
  } else {
    return expf(x);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU's approximation (relative error ~2^-22), subnormals to 0
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// over the 32 lanes; a NaN in any lane gives NaN
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 matrices of b16 from shared memory, one row address a lane.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b on the tensor cores: mma.sync m16n8k16, bf16 operands, float32
// accumulators (a: the A fragment of a 16 x 16 tile; b0, b1: the B fragment
// of a 16 x 8 tile)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bf16x2 (x0 in the low half), and in lo the residuals
// x - bf16(x), rounded to bf16 (the subtraction is exact)
__device__ __forceinline__ uint32_t split_bf16x2(float x0, float x1, uint32_t& lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hi);
  const __nv_bfloat162 rest = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  lo = *reinterpret_cast<const uint32_t*>(&rest);
  return *reinterpret_cast<const uint32_t*>(&hi);
}

// Thread block clusters: a shared::cta address of this CTA mapped to the
// same variable in CTA `rank` of the cluster, this CTA's rank, and a
// barrier over every thread of the cluster (release / acquire).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

inline PwlCoeffs read_pwl(const void* host) {
  PwlCoeffs c;
  const float* f = static_cast<const float*>(host);
  for (int i = 0; i < kPwlSegments; ++i) {
    c.slope[i] = f[i];
    c.intercept[i] = f[kPwlSegments + i];
  }
  c.x_min = f[2 * kPwlSegments];
  c.x_max = f[2 * kPwlSegments + 1];
  return c;
}

}  // namespace repro_torch
