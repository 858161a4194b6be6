// Paged decode attention for Hopper (sm_90a), float32 inside.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention -> _paged_kernel).
//
// What bounds it on an H100: one query token per sequence, so each K/V
// element read from device memory feeds 2 * G FLOPs (G = query heads per
// KV head, 4 for Llama-3-8B): far below the card's ~295 FLOP/byte balance
// point, so it is bound by bytes.  The design reads each K/V row of the
// context once: one CTA per (sequence, KV head) serves all G query heads of
// that KV head, instead of the Pallas grid's one program per query head.
//
// Design: 256 threads.  The CTA reads its own block-table row and context
// length, walks ceil(ctx / block_tokens) pool blocks in order, and stages
// each block's K and V rows (rows past the context are not read, they are
// zero) in shared memory, padded by one float per row against bank
// conflicts.  Scores for G heads x block_tokens keys, then one warp per
// head updates the running max and denominator, then the G x D
// accumulator in shared memory is rescaled and advanced by P V.  The
// online softmax steps one pool block at a time, as the Pallas kernel
// does, which the PWL variant needs (PWL exp is not multiplicative).  A
// context of 0 writes zeros.  The CTA count is B * H_kv, small at decode
// batch sizes; splitting the context across CTAs is later work.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int D>
size_t paged_smem_bytes(int G, int bt) {
  return sizeof(float) * (2 * size_t(bt) * (D + 1) + 2 * size_t(G) * D + size_t(G) * bt + 3 * G);
}

template <typename T, int D, bool kPwl>
__global__ void __launch_bounds__(kThreads)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ context_lens, T* __restrict__ out, int H, int Hkv,
                 int bt, int max_blocks, float scale, PwlCoeffs pwl) {
  constexpr int DP = D + 1;
  const int G = H / Hkv;
  extern __shared__ float smem[];
  float* Ks = smem;              // bt x DP
  float* Vs = Ks + bt * DP;      // bt x DP
  float* Qs = Vs + bt * DP;      // G x D, pre-scaled q
  float* acc = Qs + G * D;       // G x D
  float* Ps = acc + G * D;       // G x bt
  float* m_s = Ps + G * bt;      // G
  float* l_s = m_s + G;          // G
  float* a_s = l_s + G;          // G

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ctx = context_lens[b];
  const int n_blocks = min((ctx + bt - 1) / bt, max_blocks);
  const int* table = tables + int64_t(b) * max_blocks;
  const int64_t tok_stride = int64_t(Hkv) * D;  // between tokens of the pool
  const T* qb = q + (int64_t(b) * H + int64_t(hk) * G) * D;
  T* ob = out + (int64_t(b) * H + int64_t(hk) * G) * D;

  for (int idx = tid; idx < G * D; idx += kThreads) {
    Qs[idx] = to_float(qb[idx]) * scale;
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int i = 0; i < n_blocks; ++i) {
    const int64_t phys = table[i];
    const int n_valid = min(bt, ctx - i * bt);
    const T* kblk = k_pool + phys * bt * tok_stride + int64_t(hk) * D;
    const T* vblk = v_pool + phys * bt * tok_stride + int64_t(hk) * D;
    for (int idx = tid; idx < bt * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool ok = j < n_valid;
      Ks[j * DP + d] = ok ? to_float(kblk[j * tok_stride + d]) : 0.f;
      Vs[j * DP + d] = ok ? to_float(vblk[j * tok_stride + d]) : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < G * bt; idx += kThreads) {
      const int g = idx / bt, j = idx % bt;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[j * DP + d], s);
      Ps[idx] = j < n_valid ? s : kNegInf;
    }
    __syncthreads();

    // one warp per head: running max, probabilities, denominator
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, Ps[g * bt + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bt; j += 32) {
        const float p = j < n_valid ? softmax_exp<kPwl>(Ps[g * bt + j] - m_new, pwl) : 0.f;
        Ps[g * bt + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = softmax_exp<kPwl>(m_prev - m_new, pwl);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      float pv = 0.f;
      for (int j = 0; j < n_valid; ++j) pv = fmaf(Ps[g * bt + j], Vs[j * DP + d], pv);
      acc[idx] = acc[idx] * a_s[g] + pv;
    }
    __syncthreads();
  }
  __syncthreads();

  for (int idx = tid; idx < G * D; idx += kThreads) {
    ob[idx] = from_float<T>(acc[idx] / fmaxf(l_s[idx / D], 1e-30f));
  }
}

template <typename T, int D, bool kPwl>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                   const void* context_lens, void* out, int B, int H, int Hkv, int bt,
                   int max_blocks, const PwlCoeffs& pwl, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes<D>(H / Hkv, bt);
  auto kernel = paged_fwd_kernel<T, D, kPwl>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(context_lens),
      static_cast<T*>(out), H, Hkv, bt, max_blocks, float(pow(double(D), -0.5)), pwl);
  return cudaGetLastError();
}

template <typename T, bool kPwl>
cudaError_t dispatch_dim(int D, const void* q, const void* kp, const void* vp, const void* tb,
                         const void* cl, void* out, int B, int H, int Hkv, int bt, int mb,
                         const PwlCoeffs& pwl, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, kPwl>(q, kp, vp, tb, cl, out, B, H, Hkv, bt, mb, pwl, s);
    case 64: return launch<T, 64, kPwl>(q, kp, vp, tb, cl, out, B, H, Hkv, bt, mb, pwl, s);
    case 80: return launch<T, 80, kPwl>(q, kp, vp, tb, cl, out, B, H, Hkv, bt, mb, pwl, s);
    case 128: return launch<T, 128, kPwl>(q, kp, vp, tb, cl, out, B, H, Hkv, bt, mb, pwl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, D); k_pool, v_pool: (N_blocks, bt, Hkv, D); tables:
// (B, max_blocks) int32; context_lens: (B,) int32; out: (B, H, D), all
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch.
extern "C" int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* context_lens, void* out,
                                   int B, int H, int Hkv, int D, int bt, int max_blocks,
                                   int dtype, int use_pwl, const void* pwl_host, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || bt <= 0) return cudaErrorInvalidValue;
  const PwlCoeffs pwl = read_pwl(pwl_host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return use_pwl ? dispatch_dim<float, true>(D, q, k_pool, v_pool, tables, context_lens, out,
                                               B, H, Hkv, bt, max_blocks, pwl, s)
                   : dispatch_dim<float, false>(D, q, k_pool, v_pool, tables, context_lens, out,
                                                B, H, Hkv, bt, max_blocks, pwl, s);
  }
  if (dtype == 1) {
    return use_pwl ? dispatch_dim<__nv_bfloat16, true>(D, q, k_pool, v_pool, tables,
                                                       context_lens, out, B, H, Hkv, bt,
                                                       max_blocks, pwl, s)
                   : dispatch_dim<__nv_bfloat16, false>(D, q, k_pool, v_pool, tables,
                                                        context_lens, out, B, H, Hkv, bt,
                                                        max_blocks, pwl, s);
  }
  return cudaErrorInvalidValue;
}
