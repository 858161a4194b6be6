// Prefill (flash) attention forward for Hopper (sm_90a), float32 inside.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) and the GQA repeat/padding of its
// wrapper repro/kernels/ops.py:flash_attention.
//
// What bounds it on an H100: at prefill shapes (S = 512, D = 128) the
// causal work is ~2 * S * D FLOPs per byte of q/k/v/o, far above the
// card's ~295 FLOP/byte balance point, so it is bound by operations.  This
// first version computes both products with float32 FMAs on the SIMT cores
// (67 TFLOP/s peak), not on the tensor cores; wgmma, TMA and warp
// specialisation are later work.
//
// Design: one CTA of 256 threads per (batch * q-head, 64-row q tile).  The
// q tile (pre-scaled by D^-0.5, as the Pallas kernel does) stays in shared
// memory; K and then V tiles of 128 keys are staged one after the other in
// one shared buffer, so every K/V row is read from device memory once per
// q tile.  Each thread owns a 4 x 8 block of the 64 x 128 score tile and a
// 4 x D/16 block of the output accumulator, in registers (D = 32, 64, 80
// or 128: a multiple of 16; 80 is zamba2's shared attention).  Rows of shared
// memory are padded by one float so the column walks are free of bank
// conflicts.  The KV head is h / (Hq / Hkv) (no repeat in memory); keys
// are masked at their true length Skv (no padding); the causal loop stops
// at the diagonal tile.  The online softmax steps over keys [0,128),
// [128,256), ... exactly as the Pallas kernel does, which the PWL variant
// needs: PWL exp is not multiplicative, so the step is part of its result.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;    // q rows per CTA
constexpr int kBK = 128;   // keys per online-softmax step (the Pallas block_k)
constexpr int kThreads = 256;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) + size_t(kBQ) * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int n_rows,
                                          int64_t row_stride, int n_valid) {
  // dst[r * (D + 1) + c] = src[(row0 + r) * row_stride + c], 0 past n_valid
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n_valid ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T, int D, bool kPwl>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal,
                 float scale, PwlCoeffs pwl) {
  constexpr int DP = D + 1, BKP = kBK + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x DP, pre-scaled q
  float* KVs = Qs + kBQ * DP;       // kBK x DP, K then V of the step
  float* Ps = KVs + kBK * DP;       // kBQ x BKP, scores then probabilities
  float* m_s = Ps + kBQ * BKP;      // running max per row
  float* l_s = m_s + kBQ;           // running denominator per row
  float* a_s = l_s + kBQ;           // rescale factor of this step per row

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const T* qb = q + int64_t(b) * Sq * q_stride + int64_t(h) * D;
  const T* kb = k + int64_t(b) * Skv * kv_stride + int64_t(hk) * D;
  const T* vb = v + int64_t(b) * Skv * kv_stride + int64_t(hk) * D;
  T* ob = out + int64_t(b) * Sq * q_stride + int64_t(h) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * DP + c] = q0 + r < Sq ? to_float(qb[(q0 + r) * q_stride + c]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int n_steps = (Skv + kBK - 1) / kBK;
  if (causal) n_steps = min(n_steps, (min(q0 + kBQ, Sq) - 1) / kBK + 1);

  for (int step = 0; step < n_steps; ++step) {
    const int k0 = step * kBK;
    load_tile<T, D>(KVs, kb, k0, kBK, kv_stride, Skv);
    __syncthreads();

    // scores of this thread's 4 rows x 8 keys
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = KVs[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Skv && (!causal || qpos >= kpos);
        Ps[(ty * 4 + i) * BKP + tx + 16 * j] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // V of this step replaces K; meanwhile each warp turns 8 score rows
    // into probabilities and updates the running max / denominator
    load_tile<T, D>(KVs, vb, k0, kBK, kv_stride, Skv);
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const int qpos = q0 + r;
      float sv[4];
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = kpos < Skv && (!causal || qpos >= kpos);
        sv[c] = Ps[r * BKP + lane + 32 * c];
        if (ok[c]) mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);
      const bool seen = __any_sync(0xffffffffu, ok[0] || ok[1] || ok[2] || ok[3]);
      const float m_prev = m_s[r];
      const float m_new = seen ? fmaxf(m_prev, mx) : m_prev;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? softmax_exp<kPwl>(sv[c] - m_new, pwl) : 0.f;
        Ps[r * BKP + lane + 32 * c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = seen ? softmax_exp<kPwl>(m_prev - m_new, pwl) : 1.f;
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    float pv_acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) pv_acc[i][j] = 0.f;
    const int n_keys = min(kBK, Skv - k0);
#pragma unroll 4
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * BKP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = KVs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) pv_acc[i][j] = fmaf(pv[i], vv[j], pv_acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = acc[i][j] * alpha + pv_acc[i][j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      ob[(q0 + r) * q_stride + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int D, bool kPwl>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int Hq, int Hkv, int causal, const PwlCoeffs& pwl,
                   cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D, kPwl>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, Hq, Hkv, causal, float(pow(double(D), -0.5)), pwl);
  return cudaGetLastError();
}

template <typename T, bool kPwl>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* out, int B,
                         int Sq, int Skv, int Hq, int Hkv, int causal, const PwlCoeffs& pwl,
                         cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, kPwl>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, stream);
    case 64: return launch<T, 64, kPwl>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, stream);
    case 80: return launch<T, 80, kPwl>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, stream);
    case 128: return launch<T, 128, kPwl>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D), all
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D, int dtype, int causal,
                                   int use_pwl, const void* pwl_host, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const PwlCoeffs pwl = read_pwl(pwl_host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return use_pwl ? dispatch_dim<float, true>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, s)
                   : dispatch_dim<float, false>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, s);
  }
  if (dtype == 1) {
    return use_pwl
               ? dispatch_dim<__nv_bfloat16, true>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, s)
               : dispatch_dim<__nv_bfloat16, false>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, pwl, s);
  }
  return cudaErrorInvalidValue;
}
