// Paged decode attention for Hopper (sm_90a), float32 arithmetic.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention -> _paged_kernel).  Same function: one query token per
// (sequence, head); K/V read through the block table; masked at the
// context length; a context of 0 gives zeros; GQA; D = 32, 64, 80, 128 or
// 256 (paligemma's); any block_tokens from 1 to 128.
// A sliding window (window > 0; the JAX model's, which the Pallas kernel
// does not take) keeps the keys [max(ctx - window, 0), ctx) of a sequence
// of context ctx: a CTA starts at the block that holds the first of them
// and masks the keys before it in that block, so blocks stay aligned to
// absolute positions and the PWL result composes as without a window.
// A NaN score goes through as in the Pallas kernel and the plain version:
// the max keeps it (max.NaN), the PWL exp's clip keeps it, and the
// combine counts a split whose l is NaN as live, so a head that sees a NaN
// key in its context comes out NaN.
//
// What bounds it on an H100: one query token per sequence, so each K/V
// element read from device memory feeds 2 * G FLOPs (G = query heads per
// KV head, 4 for Llama-3-8B): far below the card's ~295 FLOP/byte balance
// point, so it is bound by bytes.  At decode batch sizes one CTA per
// (sequence, KV head) leaves most of the 132 SMs idle (32 CTAs for
// Llama-3-8B at batch 4) and each of them waits on its pool blocks in
// series, so the design spreads the context over the card and keeps
// loads in flight.
//
// Design:
// - Split-KV (flash-decoding).  The grid is (B * H_kv, n_splits); split s
//   of a sequence takes the whole pool blocks [s * bps, (s + 1) * bps) of
//   its table (bps = blocks_per_split).  The wrapper chooses n_splits and
//   bps (kernels/paged_attention.split_plan); the kernel takes them as
//   given.  One CTA serves all G query heads of its KV head, so each K/V
//   row is read once.
// - Loads: each pool block's K and V rows of the CTA's KV head go to
//   shared memory with 16-byte cp.async copies (8 bf16 or 4 float32) and
//   stay in the input dtype; two stages where a split has several blocks,
//   so block i + 1 is in flight while block i is used (one where two would
//   not fit in shared memory: float32 with 128-token blocks, or with
//   64-token blocks at D 256).  Rows are
//   padded by 16 bytes against bank conflicts.  Values go to float32 in
//   registers, at use.  CTAs of 128 threads and ~40 KB at the main shape
//   (one 64-token stage), so the 288 CTAs of Llama-3-8B's decode are all
//   resident at once.
// - Scores and P V are float32 FMAs on the SIMT cores (2 * G FLOPs per K/V
//   element leaves the tensor cores nothing to win); the online softmax
//   steps one pool block at a time, in float32, as the Pallas kernel does.
// - With n_splits == 1 the CTA writes the output.  Otherwise it writes a
//   float32 partial (m, l, acc[G][D]) to the wrapper's scratch, and
//   paged_combine_kernel, launched next on the same stream by the same C
//   entry, merges a (sequence, head)'s partials: m = max m_i, l = sum
//   e^(m_i - m) l_i, out = sum e^(m_i - m) acc_i / max(l, 1e-30).  A split
//   past its sequence's last block, or wholly below its window, writes
//   m = -1e30, l = 0 and the combine skips it; a context of 0 gives zeros.
// - PWL exp is not multiplicative, so splitting and combining would not
//   compose the segments as the Pallas kernel does (block by block, in
//   order): with use_pwl the wrapper asks for one split and the entry
//   refuses more.
// - key_offset (PICNIC sequence-sharded decode, the JAX model's
//   decode_attention_partial): the pool holds one shard of each
//   sequence, whose local key j is global position key_offset + j, while
//   context_lens stays global.  A CTA keeps local key j where key_offset +
//   j < ctx and, under a window, key_offset + j >= ctx - window: both
//   bounds move by key_offset, so on a shard before the last the window's
//   lower bound is not the one the global context alone would give.
// - partial (same entry, same kernels): instead of o / l the output is
//   the float32 partial of the shard, o = sum e^(s - m) v (not
//   normalised), m (the max scaled score, natural-exp units) and l = sum
//   e^(s - m), in one buffer: o (B, H, D), then m (B, H), then l (B, H).
//   With one split the main kernel writes them; with several the combine
//   writes (sum w_i acc_i, M, sum w_i l_i), w_i = e^(m_i - M).  A head
//   with no kept key gives (0, -1e30, 0).  PWL is refused in this mode.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr size_t kMaxSmem = 232448;  // per block on the H100, opted in

// elements per shared row of K/V: D and a 16-byte pad
template <typename T, int D>
constexpr int kKvStride = D + 16 / int(sizeof(T));

template <typename T, int D>
size_t paged_smem_bytes(int G, int bt, int stages) {
  return sizeof(T) * 2 * size_t(stages) * bt * kKvStride<T, D> +
         sizeof(float) * (2 * size_t(G) * D + size_t(G) * bt + 3 * G);
}

__device__ __forceinline__ float dot8(const float* qv, const __nv_bfloat16* kv) {
  const uint4 raw = *reinterpret_cast<const uint4*>(kv);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s = fmaf(qv[2 * i], f.x, s);
    s = fmaf(qv[2 * i + 1], f.y, s);
  }
  return s;
}

__device__ __forceinline__ float dot8(const float* qv, const float* kv) {
  const float4 a = *reinterpret_cast<const float4*>(kv);
  const float4 b = *reinterpret_cast<const float4*>(kv + 4);
  float s = 0.f;
  s = fmaf(qv[0], a.x, s);
  s = fmaf(qv[1], a.y, s);
  s = fmaf(qv[2], a.z, s);
  s = fmaf(qv[3], a.w, s);
  s = fmaf(qv[4], b.x, s);
  s = fmaf(qv[5], b.y, s);
  s = fmaf(qv[6], b.z, s);
  s = fmaf(qv[7], b.w, s);
  return s;
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T, int D, bool kPwl>
__global__ void __launch_bounds__(kThreads)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ context_lens, void* __restrict__ out,
                 float* __restrict__ partials, int H, int Hkv, int bt, int max_blocks,
                 int blocks_per_split, int window, int key_offset, int partial, int stages,
                 float scale, PwlCoeffs pwl) {
  constexpr int KS = kKvStride<T, D>;
  constexpr int kChunk = 16 / int(sizeof(T));  // elements per 16-byte copy
  const int G = H / Hkv;
  const int n_splits = gridDim.y, split = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);               // stages x bt x KS
  T* Vs = Ks + stages * bt * KS;                         // stages x bt x KS
  float* Qs = reinterpret_cast<float*>(Vs + stages * bt * KS);  // G x D, pre-scaled q
  float* acc = Qs + G * D;                               // G x D
  float* Ps = acc + G * D;                               // G x bt
  float* m_s = Ps + G * bt;                              // G
  float* l_s = m_s + G;                                  // G
  float* a_s = l_s + G;                                  // G

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // local keys [lo, ctx) of this pool: global positions shifted by key_offset
  const int ctx = max(context_lens[b] - key_offset, 0);
  const int lo = window > 0 ? max(context_lens[b] - window - key_offset, 0) : 0;
  const int n_blocks = min((ctx + bt - 1) / bt, max_blocks);
  const int first = max(split * blocks_per_split, lo / bt);
  const int last = min(split * blocks_per_split + blocks_per_split, n_blocks);  // may be <= first
  const int* table = tables + int64_t(b) * max_blocks;
  const int64_t tok_stride = int64_t(Hkv) * D;  // between tokens of the pool
  const T* qb = q + (int64_t(b) * H + int64_t(hk) * G) * D;

  for (int idx = tid; idx < G * D; idx += kThreads) {
    Qs[idx] = to_float(qb[idx]) * scale;
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // K and V rows of pool block i (of this sequence) into stage st; rows
  // outside [lo, ctx) are zeros
  auto load_block = [&](int i, int st) {
    const int64_t phys = table[i];
    const int n_valid = min(bt, ctx - i * bt);
    const int j_lo = max(lo - i * bt, 0);
    const T* kblk = k_pool + phys * bt * tok_stride + int64_t(hk) * D;
    const T* vblk = v_pool + phys * bt * tok_stride + int64_t(hk) * D;
    T* kd = Ks + st * bt * KS;
    T* vd = Vs + st * bt * KS;
    constexpr int kPerRow = D / kChunk;
    for (int c = tid; c < bt * kPerRow; c += kThreads) {
      const int j = c / kPerRow, d = (c % kPerRow) * kChunk;
      const bool ok = j >= j_lo && j < n_valid;
      const int64_t off = ok ? j * tok_stride + d : 0;
      cp_async16(kd + j * KS + d, kblk + off, ok);
      cp_async16(vd + j * KS + d, vblk + off, ok);
    }
  };

  if (first < last) load_block(first, 0);
  cp_async_commit();
  for (int i = first; i < last; ++i) {
    const int st = stages == 2 ? (i - first) & 1 : 0;
    if (stages == 2) {
      if (i + 1 < last) load_block(i + 1, st ^ 1);  // that stage was freed by block i - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_valid = min(bt, ctx - i * bt);  // keys [j_lo, n_valid) of the block
    const int j_lo = max(lo - i * bt, 0);
    const T* kt = Ks + st * bt * KS;
    const T* vt = Vs + st * bt * KS;

    for (int idx = tid; idx < G * bt; idx += kThreads) {
      const int g = idx / bt, j = idx % bt;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 8) s += dot8(Qs + g * D + d, kt + j * KS + d);
      Ps[idx] = j >= j_lo && j < n_valid ? s : kNegInf;
    }
    __syncthreads();

    // one warp per head: running max, probabilities, denominator
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = j_lo + lane; j < n_valid; j += 32) mx = max_nan(mx, Ps[g * bt + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = max_nan(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bt; j += 32) {
        const float p =
            j >= j_lo && j < n_valid ? softmax_exp<kPwl>(Ps[g * bt + j] - m_new, pwl) : 0.f;
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

    // acc = acc * alpha + P V, two neighbouring d of one head a thread
    for (int idx = tid; idx < G * D / 2; idx += kThreads) {
      const int g = idx / (D / 2), d = 2 * (idx % (D / 2));
      float pv0 = 0.f, pv1 = 0.f;
      for (int j = j_lo; j < n_valid; ++j) {
        const float p = Ps[g * bt + j];
        const float2 vv = load2(vt + j * KS + d);
        pv0 = fmaf(p, vv.x, pv0);
        pv1 = fmaf(p, vv.y, pv1);
      }
      const float alpha = a_s[g];
      acc[g * D + d] = acc[g * D + d] * alpha + pv0;
      acc[g * D + d + 1] = acc[g * D + d + 1] * alpha + pv1;
    }
    __syncthreads();  // the stage of block i is free again
    if (stages == 1 && i + 1 < last) {
      load_block(i + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int64_t head0 = int64_t(b) * H + int64_t(hk) * G;  // first query head of the CTA
  if (n_splits == 1 && partial) {
    const int64_t BH = int64_t(gridDim.x / Hkv) * H;
    float* ob = static_cast<float*>(out);
    for (int idx = tid; idx < G * D; idx += kThreads) ob[head0 * D + idx] = acc[idx];
    for (int g = tid; g < G; g += kThreads) {
      ob[BH * D + head0 + g] = m_s[g];
      ob[BH * D + BH + head0 + g] = l_s[g];
    }
    return;
  }
  if (n_splits == 1) {
    T* ob = static_cast<T*>(out) + head0 * D;
    for (int idx = tid; idx < G * D; idx += kThreads) {
      ob[idx] = from_float<T>(acc[idx] / max_nan(l_s[idx / D], 1e-30f));
    }
    return;
  }
  // partial of (head, split): m, l, then acc[D]
  for (int idx = tid; idx < G * (D + 2); idx += kThreads) {
    const int g = idx / (D + 2), c = idx % (D + 2);
    float* part = partials + ((head0 + g) * n_splits + split) * (D + 2);
    part[c] = c == 0 ? m_s[g] : c == 1 ? l_s[g] : acc[g * D + c - 2];
  }
}

// out[b, h] from the n_splits partials of (b, h); one CTA per (b, h).  The
// first warp takes m = max m_i and the weights e^(m_i - m) into shared
// memory (0 for a split past the context, l = 0, whose acc is not read).
// A split that met a NaN score has m = l = NaN: it counts as live, and its
// NaN goes through the max, the weights and the sum, as in the plain
// version.  With partial, out is the float32 (o, m, l) buffer and gets
// (sum w_i acc_i, m, sum w_i l_i), not normalised.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ partials, void* __restrict__ out, int n_splits,
                     int partial) {
  extern __shared__ float w[];  // n_splits weights, then l
  const float* part = partials + int64_t(blockIdx.x) * n_splits * (D + 2);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = kNegInf;
    for (int s = lane; s < n_splits; s += 32) {
      if (!(part[s * (D + 2) + 1] <= 0.f)) m = max_nan(m, part[s * (D + 2)]);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float ls = part[s * (D + 2) + 1];
      const float ws = !(ls <= 0.f) ? expf(part[s * (D + 2)] - m) : 0.f;
      w[s] = ws;
      l = fmaf(ws, ls, l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      w[n_splits] = max_nan(l, 1e-30f);
      if (partial) {
        const int64_t BH = gridDim.x;
        static_cast<float*>(out)[BH * D + blockIdx.x] = m;
        static_cast<float*>(out)[BH * D + BH + blockIdx.x] = l;
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      if (w[s] != 0.f) o = fmaf(w[s], part[s * (D + 2) + 2 + d], o);
    }
    if (partial) {
      static_cast<float*>(out)[int64_t(blockIdx.x) * D + d] = o;
    } else {
      static_cast<T*>(out)[int64_t(blockIdx.x) * D + d] = from_float<T>(o / w[n_splits]);
    }
  }
}

template <typename T, int D, bool kPwl>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                   const void* context_lens, void* out, void* scratch, int B, int H, int Hkv,
                   int bt, int max_blocks, int n_splits, int blocks_per_split, int window,
                   int key_offset, int partial, const PwlCoeffs& pwl, cudaStream_t stream) {
  const int G = H / Hkv;
  // a second stage only where a split has a next block to load into it
  int stages = blocks_per_split > 1 ? 2 : 1;
  size_t smem = paged_smem_bytes<T, D>(G, bt, stages);
  if (smem > kMaxSmem) {
    stages = 1;
    smem = paged_smem_bytes<T, D>(G, bt, stages);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;  // kernels.paged_attention refuses it
  }
  auto kernel = paged_fwd_kernel<T, D, kPwl>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(context_lens), out,
      static_cast<float*>(scratch), H, Hkv, bt, max_blocks, blocks_per_split, window, key_offset,
      partial, stages, float(pow(double(D), -0.5)), pwl);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  paged_combine_kernel<T, D><<<B * H, kCombineThreads, (n_splits + 1) * sizeof(float), stream>>>(
      static_cast<const float*>(scratch), out, n_splits, partial);
  return cudaGetLastError();
}

template <typename T, bool kPwl>
cudaError_t dispatch_dim(int D, const void* q, const void* kp, const void* vp, const void* tb,
                         const void* cl, void* out, void* scratch, int B, int H, int Hkv,
                         int bt, int mb, int ns, int bps, int w, int ko, int pt,
                         const PwlCoeffs& pwl, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32, kPwl>(q, kp, vp, tb, cl, out, scratch, B, H, Hkv, bt, mb, ns, bps, w,
                                 ko, pt, pwl, s);
    case 64:
      return launch<T, 64, kPwl>(q, kp, vp, tb, cl, out, scratch, B, H, Hkv, bt, mb, ns, bps, w,
                                 ko, pt, pwl, s);
    case 80:
      return launch<T, 80, kPwl>(q, kp, vp, tb, cl, out, scratch, B, H, Hkv, bt, mb, ns, bps, w,
                                 ko, pt, pwl, s);
    case 128:
      return launch<T, 128, kPwl>(q, kp, vp, tb, cl, out, scratch, B, H, Hkv, bt, mb, ns, bps, w,
                                  ko, pt, pwl, s);
    case 256:
      return launch<T, 256, kPwl>(q, kp, vp, tb, cl, out, scratch, B, H, Hkv, bt, mb, ns, bps, w,
                                  ko, pt, pwl, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, D); k_pool, v_pool: (N_blocks, bt, Hkv, D); tables:
// (B, max_blocks) int32; context_lens: (B,) int32; out: (B, H, D), all
// contiguous and 16-byte aligned.  dtype 0 = float32, 1 = bfloat16.  The
// context is cut into n_splits ranges of blocks_per_split pool blocks
// (n_splits * blocks_per_split >= max_blocks); with n_splits > 1, scratch
// holds B * H * n_splits * (D + 2) floats, else it is not read.  use_pwl
// needs n_splits == 1.  window > 0 keeps only the keys [ctx - window, ctx)
// of each sequence; 0 is no window.  key_offset >= 0 is the global
// position of the pool's local key 0 (context_lens stay global).  With
// partial = 1, out is a float32 buffer of B * H * (D + 2): the unnormalised
// o (B, H, D), then m (B, H), then l (B, H); use_pwl must be 0.  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* context_lens, void* out,
                                   void* scratch, int B, int H, int Hkv, int D, int bt,
                                   int max_blocks, int n_splits, int blocks_per_split, int window,
                                   int key_offset, int partial, int dtype, int use_pwl,
                                   const void* pwl_host, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || bt <= 0 || n_splits < 1 || window < 0 ||
      key_offset < 0 || (partial != 0 && partial != 1) || (partial && use_pwl) ||
      blocks_per_split < 1 || int64_t(n_splits) * blocks_per_split < max_blocks ||
      (use_pwl && n_splits != 1) || (n_splits > 1 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const PwlCoeffs pwl = read_pwl(pwl_host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ns = n_splits, bps = blocks_per_split, w = window, ko = key_offset, pt = partial;
  if (dtype == 0) {
    return use_pwl ? dispatch_dim<float, true>(D, q, k_pool, v_pool, tables, context_lens, out,
                                               scratch, B, H, Hkv, bt, max_blocks, ns, bps, w,
                                               ko, pt, pwl, s)
                   : dispatch_dim<float, false>(D, q, k_pool, v_pool, tables, context_lens, out,
                                                scratch, B, H, Hkv, bt, max_blocks, ns, bps, w,
                                                ko, pt, pwl, s);
  }
  if (dtype == 1) {
    return use_pwl ? dispatch_dim<__nv_bfloat16, true>(D, q, k_pool, v_pool, tables,
                                                       context_lens, out, scratch, B, H, Hkv,
                                                       bt, max_blocks, ns, bps, w, ko, pt, pwl, s)
                   : dispatch_dim<__nv_bfloat16, false>(D, q, k_pool, v_pool, tables,
                                                        context_lens, out, scratch, B, H, Hkv,
                                                        bt, max_blocks, ns, bps, w, ko, pt, pwl,
                                                        s);
  }
  return cudaErrorInvalidValue;
}
