// Prefill (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) and the GQA repeat/padding of its
// wrapper repro/kernels/ops.py:flash_attention.  Both paths below compute
// one function: scale D^-0.5; an online softmax over KV steps of exactly
// 128 keys, [0,128), [128,256), ..., as the Pallas kernel steps (PWL exp is
// not multiplicative, so the step is part of the PWL result); a row skips a
// step in which it sees no key; keys masked at their true length Skv (no
// padding); the causal loop stops at the diagonal step; the KV head is
// h / (Hq / Hkv) (no repeat in memory); D = 32, 64, 80, 128 or 256 (80 is
// zamba2's shared attention, 256 paligemma's).
// A bidirectional prefix (prefix_len > 0, causal only; the JAX model's
// prefix-LM, which the Pallas kernel does not take) also makes keys below
// prefix_len visible to every query: a causal tile's steps run on to the
// prefix's last step, and a step wholly inside the prefix runs unmasked.
// A sliding window (window > 0; the JAX model's, which the Pallas kernel
// does not take) masks a key window or more positions before its query,
// causal or not.  Steps stay aligned to absolute key positions, as the
// plain version steps, so the PWL result under a window is the plain
// version's step for step: a tile starts at the step that holds the first
// key inside the window of its first row, and the steps before it, which
// no row of the tile sees, contribute nothing.
// A query offset (q_offset >= 0; the JAX model's, which the Pallas kernel
// does not take) puts q row i at global position q_offset + i against keys
// at 0 .. Skv - 1: the causal mask, the window and the prefix read the
// global position (sequence-parallel attention, where a rank's q rows are
// its cut of the sequence and K/V the whole gathered sequence).  Tiles
// stay aligned to local rows and steps to absolute key positions, so the
// PWL result is still the plain version's step for step.
// An optional lse output (B, Hq, Sq) float32 takes each row's m + log l,
// the log-sum-exp of its scaled scores, for the backward
// (flash_attention_bwd.cu); where its pointer is null nothing else changes.
// A NaN score goes through as in the Pallas kernel and the plain version:
// the row max keeps it (max.NaN), the PWL exp's clip keeps it, and a
// row's "sees a key" test comes from the mask, so the (query, head) rows
// that see a NaN key come out NaN and no other row does.
//
// What bounds it on an H100: at prefill shapes (S = 512, D = 128) the
// causal work is ~2 * S * D FLOPs per byte of q/k/v/o, far above the card's
// ~295 FLOP/byte balance point for bf16, so it is bound by operations: on
// the tensor cores (989 TFLOP/s), not on the SIMT cores (67 TFLOP/s).
//
// bfloat16 (flash_fwd_mma_kernel), in the FlashAttention-2 shape:
// - Tiles of (batch * q-head, 128-row q tile), the longest causal tiles
//   first, each to one CTA of 8 warps; each warp owns 16 q rows, so a row's
//   max and sum are reduced over the 4 lanes of a quad, without shared
//   memory.  Persistent: one CTA per SM walks every gridDim-th tile and
//   loads the next tile's Q and first K/V during its current tile's last
//   step, so a tile's start does not wait on memory.
// - Q is loaded once per tile into registers as mma A-fragments
//   (ldmatrix), not pre-scaled in bf16: the scale (times log2 e for the
//   exact path's ex2.approx) is applied to the float32 scores.
// - K and V tiles of 128 keys are staged as bf16 in shared memory with
//   16-byte cp.async copies, rows padded by 16 bytes so ldmatrix is free of
//   bank conflicts.  Both are double-buffered: step j+1's K and V are in
//   flight while step j computes, and one barrier a step both publishes a
//   step's tiles and frees the stage the step before read.  Shared memory
//   is 5 tiles (K and V twice, the next tile's Q): 174,080 bytes at D 128,
//   so one CTA fits per SM, not two; the ~200-255 registers of a thread
//   hold one CTA of 8 warps per SM anyway.
// - D 256 (kBig) has a layout of its own: 5 tiles of 256 columns would be
//   337,920 bytes, and Q's fragments (64 registers) beside O's (128) and
//   the scores' (64) would pass the 255 registers of a thread.  So Q stays
//   in shared memory for the whole tile and each k16 chunk's A-fragment is
//   read by ldmatrix where it is used, and K and V have one stage each:
//   3 tiles, 202,752 bytes.  The loads are staggered instead of doubled:
//   V of step j is in flight while step j's scores are taken, K of step
//   j + 1 (or the next tile's Q and first K) while step j's softmax and
//   P V run; two barriers a step.  The epilogue stages O in the V tile.
// - S = Q K^T by mma.sync m16n8k16 bf16 -> f32; the mask, the row max, p
//   (ex2.approx, or common.cuh's pwl_exp) and the alpha rescale stay in
//   registers.  Only a step that holds the causal diagonal, the window's
//   lower edge of a row of the warp, or keys past Skv masks; there a warp
//   also skips the 16-key tiles past its last row and below its first
//   row's window.  The other steps run without a branch.
// - P V: the m16n8k16 accumulator layout is the A-fragment layout of the
//   next product, so P goes to bf16 in registers, with no trip through
//   shared memory; V is the B operand by ldmatrix.trans.  P is split into
//   two bf16 terms, p = hi + lo with hi = bf16(p), and both are multiplied
//   (three products per key step instead of two): a single bf16 P rounds
//   each term by up to 2^-9, which on an output near 0 by cancellation is
//   an absolute error of ~2^-9 * sum_j |p_j v_j| / l, several times the
//   2^-12 floor of kernels/flash_attention.agreement.  With the split, P is
//   kept to ~2^-17 and the output rounds once, to bf16, as the plain
//   version rounds it.
// - The denominator l is the sum of the float32 p, a per-lane partial sum
//   reduced over the quad at the end.
// - Epilogue: O * (1 / max(l, 1e-30)) -> bf16, staged per warp in shared
//   memory and written with 16-byte stores.
//
// float32 (flash_fwd_kernel): the SIMT body of the port's first version,
// float32 FMAs throughout, kept so the float32 card-vs-CPU parity checks see
// no TF32.  One CTA of 256 threads per (batch * q-head, 64-row q tile); the
// q tile (pre-scaled by D^-0.5, as the Pallas kernel does) stays in shared
// memory; K and then V tiles of 128 keys are staged one after the other in
// one shared buffer.  Each thread owns a 4 x 8 block of the 64 x 128 score
// tile and a 4 x D/16 block of the output accumulator, in registers.  Rows
// of shared memory are padded by one float against bank conflicts.
#include <cmath>
#include <cstdint>
#include <type_traits>

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

// The key steps [first, last) of a tile of q rows [q0, q1): from the step
// that holds the first key inside the window of row q0 (later rows'
// windows start later; 0 without a window) to the last step with a key
// before Skv, or, causal, at or before row q1 - 1 or below prefix_len.  At
// least one step: a tile whose rows see no key (non-causal, Skv far below
// the window) runs its last step, fully masked, and gives zeros as the
// plain version does.
__device__ __forceinline__ int2 step_range(int q0, int q1, int Skv, int causal, int window,
                                           int prefix) {
  int last = (Skv + kBK - 1) / kBK;
  if (causal) last = min(last, max((q1 - 1) / kBK + 1, (prefix + kBK - 1) / kBK));
  const int first = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  return make_int2(min(first, last - 1), last);
}

// Whether key kpos is valid for query qpos: inside the sequence, not after
// the query when causal unless it lies in the prefix, and fewer than window
// positions before it.
__device__ __forceinline__ bool key_valid(int qpos, int kpos, int Skv, int causal, int window,
                                          int prefix) {
  // kpos <= qpos or kpos < prefix, as one compare against a per-row bound
  return kpos < Skv && (!causal || kpos <= max(qpos, prefix - 1)) &&
         (window <= 0 || qpos - kpos < window);
}

// A row's log-sum-exp of its scaled scores, m + log l (m: the scaled row
// max), the backward's input: +inf for a row that saw no key (l = 0), so
// that its probabilities exp(s - lse) are 0; a NaN stays NaN.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l == 0.f ? INFINITY : m + logf(l);
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
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int causal,
                 int window, int prefix, int q_offset, float scale, PwlCoeffs pwl) {
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

  const int2 steps =
      step_range(q0 + q_offset, min(q0 + kBQ, Sq) + q_offset, Skv, causal, window, prefix);
  for (int step = steps.x; step < steps.y; ++step) {
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
      const int qpos = q_offset + q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = key_valid(qpos, kpos, Skv, causal, window, prefix);
        Ps[(ty * 4 + i) * BKP + tx + 16 * j] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // V of this step replaces K; meanwhile each warp turns 8 score rows
    // into probabilities and updates the running max / denominator
    load_tile<T, D>(KVs, vb, k0, kBK, kv_stride, Skv);
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const int qpos = q_offset + q0 + r;
      float sv[4];
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = key_valid(qpos, kpos, Skv, causal, window, prefix);
        sv[c] = Ps[r * BKP + lane + 32 * c];
        if (ok[c]) mx = max_nan(mx, sv[c]);
      }
      mx = warp_max(mx);
      const bool seen = __any_sync(0xffffffffu, ok[0] || ok[1] || ok[2] || ok[3]);
      const float m_prev = m_s[r];
      const float m_new = seen ? max_nan(m_prev, mx) : m_prev;
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

  if (lse != nullptr && tid < kBQ && q0 + tid < Sq) {
    lse[int64_t(blockIdx.x) * Sq + q0 + tid] = row_lse(m_s[tid], l_s[tid]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float denom = max_nan(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      ob[(q0 + r) * q_stride + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    }
  }
}

// ---- bfloat16: tensor cores -------------------------------------------
constexpr int kMmaBQ = 128;                // q rows per CTA, 16 per warp
constexpr int kMmaWarps = kMmaBQ / 16;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
constexpr int kMmaStride = D + 8;  // bf16 per shared row: a 16-byte pad

// D 256 holds Q in shared memory and K and V in one stage each (see above)
template <int D>
constexpr bool kMmaBig = D > 128;

template <int D>
constexpr size_t mma_smem_bytes() {
  return (kMmaBig<D> ? 3 : 5) * size_t(kBK) * kMmaStride<D> * sizeof(__nv_bfloat16);
}

// rows [row0, row0 + 128) of a bf16 matrix with row_stride elements between
// rows into a padded shared tile, 16 bytes a copy; zeros past n_valid
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row0, int64_t row_stride, int n_valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBK * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < n_valid;
    cp_async16(dst + r * kMmaStride<D> + col,
               ok ? src + int64_t(row0 + r) * row_stride + col : src, ok);
  }
}

template <int D, bool kPwl>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                     int prefix, int q_offset, float scale, PwlCoeffs pwl) {
  constexpr bool kBig = kMmaBig<D>;
  constexpr int kS = kMmaStride<D>;
  constexpr int kTile = kBK * kS;  // elements of one staged tile
  constexpr int kKC = D / 16;      // k16 chunks of Q K^T = pairs of n8 d-tiles of P V
  constexpr int kNT = kBK / 8;     // n8 key tiles of a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q of this tile (kBig) or of the next; kBig: one stage of K and of V,
  // else two of each
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTile;
  __nv_bfloat16* Vs = Ks + (kBig ? 1 : 2) * kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row group, column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: the matrix and row this lane addresses
  const int n_qt = (Sq + kMmaBQ - 1) / kMmaBQ, n_bh = B * Hq, n_tiles = n_qt * n_bh;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  // Tile t: rows [q0, q0 + 128) of (batch, q-head) t % n_bh, the longest
  // causal tiles first; the CTA takes tiles blockIdx.x, + gridDim.x, ...
  auto q0_of = [&](int t) { return (n_qt - 1 - t / n_bh) * kMmaBQ; };
  auto q_off = [&](int t) {  // of q and out: (b, 0, h, 0)
    const int bh = t % n_bh;
    return (int64_t(bh / Hq) * Sq * Hq + bh % Hq) * D;
  };
  auto kv_off = [&](int t) {  // of k and v: (b, 0, h / (Hq / Hkv), 0)
    const int bh = t % n_bh;
    return (int64_t(bh / Hq) * Skv * Hkv + (bh % Hq) / (Hq / Hkv)) * D;
  };

  uint32_t qf[kBig ? 1 : kKC][4];  // kBig reads Q's fragments from Qs at use
  float o[2 * kKC][4];
  float m_run[2], l_run[2];  // rows g and g + 8: unscaled max, this lane's share of l
  int row_w = 0;             // the warp's first q row in the tile
  int pos_w = 0;             // its global position, row_w + q_offset: what the masks read
  const float scale_log2 = scale * kLog2e;
  // this lane's ldmatrix address of the warp's Q rows in Qs
  auto q_row = [&]() { return Qs + (warp * 16 + (mi & 1) * 8 + mr) * kS + (mi >> 1) * 8; };

  auto steps_of = [&](int t) {
    return step_range(q0_of(t) + q_offset, min(q0_of(t) + kMmaBQ, Sq) + q_offset, Skv, causal,
                      window, prefix);
  };

  // A masked step holds keys past Skv, past a row of this warp outside the
  // prefix (the causal diagonal) or before a row's window; there the warp
  // skips the 16-key tiles it cannot see, [k0, k0 + k_lo) and [k0 + n_keys,
  // k0 + 128), and masks the rest; every other step runs without a branch.
  auto live_keys = [&](auto masked, int k0) {
    constexpr bool kMasked = decltype(masked)::value;
    const int n_keys =
        kMasked && causal ? max(0, min(kBK, max(pos_w + 16, prefix) - k0)) : kBK;
    // keys before k0 + k_lo are outside the window of the warp's first row
    const int k_lo = kMasked && window > 0 ? min(kBK, max(0, pos_w - window + 1 - k0)) : 0;
    return make_int2(k_lo, n_keys);
  };

  // S = Q K^T of keys [k0, k0 + 128) from the K tile kt, masked
  auto scores = [&](auto masked, int k0, const __nv_bfloat16* kt, float (&s)[kNT][4]) {
    constexpr bool kMasked = decltype(masked)::value;
    const int2 live = live_keys(masked, k0);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* krow = kt + ((mi >> 1) * 8 + mr) * kS + (mi & 1) * 8;
    const __nv_bfloat16* qrow = q_row();
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t a[4];
      if constexpr (kBig) {
        ldsm_x4(a, qrow + kc * 16);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kc][i];
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (!kMasked || (16 * np < live.y && 16 * np + 16 > live.x)) {
          uint32_t r[4];
          ldsm_x4(r, krow + np * 16 * kS + kc * 16);
          mma_bf16(s[2 * np], a, r[0], r[1]);
          mma_bf16(s[2 * np + 1], a, r[2], r[3]);
        }
      }
    }
    if constexpr (kMasked) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = pos_w + g + (e >> 1) * 8;
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          if (!key_valid(row, key, Skv, causal, window, prefix)) s[nt][e] = -INFINITY;
        }
    }
  };

  // The online-softmax step of rows g and g + 8 over the scores s, then
  // O += P V with the V tile vt
  auto softmax_pv = [&](auto masked, int k0, const __nv_bfloat16* vt, float (&s)[kNT][4]) {
    constexpr bool kMasked = decltype(masked)::value;
    const int2 live = live_keys(masked, k0);
    // the max keeps a NaN score, and whether a row sees a key of the step
    // comes from the mask (some key of the step is valid for it: the
    // step's keys [k0, k0 + 128) meet the row's [row - window + 1, row],
    // [0, prefix) or [0, Skv)), not from the max; under a window the step's
    // first key may be too old for a row that sees later keys of the step
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      mx[0] = max_nan(mx[0], max_nan(s[nt][0], s[nt][1]));
      mx[1] = max_nan(mx[1], max_nan(s[nt][2], s[nt][3]));
    }
    float alpha[2], m_sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = max_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = max_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      bool seen = true;
      if constexpr (kMasked) {
        const int row = pos_w + g + 8 * r;
        const int lo = window > 0 ? max(k0, row - window + 1) : k0;
        const int hi = min(min(k0 + kBK, Skv), causal ? max(row + 1, prefix) : Skv);
        seen = lo < hi;
      }
      const float m_new = seen ? max_nan(m_run[r], mx[r]) : m_run[r];
      if constexpr (kPwl) {
        alpha[r] = seen ? pwl_exp(__fsub_rn(__fmul_rn(m_run[r], scale),
                                            __fmul_rn(m_new, scale)), pwl)
                        : 1.f;
      } else {
        alpha[r] = seen ? ex2_approx((m_run[r] - m_new) * scale_log2) : 1.f;
      }
      m_run[r] = m_new;
      // a row that has seen no key yet subtracts 0: its p are exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      m_sub[r] = kPwl ? __fmul_rn(m_use, scale) : m_use * scale_log2;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if constexpr (kPwl) {
          p = pwl_exp(__fsub_rn(__fmul_rn(s[nt][e], scale), m_sub[e >> 1]), pwl);
        } else {
          p = ex2_approx(fmaf(s[nt][e], scale_log2, -m_sub[e >> 1]));
        }
        s[nt][e] = p;
        rowsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int dt = 0; dt < 2 * kKC; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V, P as hi + lo bf16 A-fragments straight from the score registers
    const __nv_bfloat16* vrow = vt + ((mi & 1) * 8 + mr) * kS + (mi >> 1) * 8;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      if (!kMasked || (16 * kc < live.y && 16 * kc + 16 > live.x)) {
        uint32_t a_hi[4], a_lo[4];
        a_hi[0] = split_bf16x2(s[2 * kc][0], s[2 * kc][1], a_lo[0]);
        a_hi[1] = split_bf16x2(s[2 * kc][2], s[2 * kc][3], a_lo[1]);
        a_hi[2] = split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], a_lo[2]);
        a_hi[3] = split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], a_lo[3]);
#pragma unroll
        for (int dp = 0; dp < kKC; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(r, vrow + kc * 16 * kS + dp * 16);
          mma_bf16(o[2 * dp], a_hi, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], a_hi, r[2], r[3]);
          mma_bf16(o[2 * dp], a_lo, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], a_lo, r[2], r[3]);
        }
      }
    }
  };

  int t = blockIdx.x;
  if (t >= n_tiles) return;
  load_tile_async<D>(Qs, q + q_off(t), q0_of(t), q_stride, Sq);
  load_tile_async<D>(Ks, k + kv_off(t), steps_of(t).x * kBK, kv_stride, Skv);
  if constexpr (!kBig) load_tile_async<D>(Vs, v + kv_off(t), steps_of(t).x * kBK, kv_stride, Skv);
  cp_async_commit();
  int gs = 0;  // steps taken by the CTA: their stage alternates
  for (; t < n_tiles; t += gridDim.x) {
    const int q0 = q0_of(t), t_next = t + gridDim.x;
    const int64_t kvo = kv_off(t);
    const int2 steps = steps_of(t);
    const int step0 = steps.x, n_steps = steps.y;
    row_w = q0 + warp * 16;
    pos_w = row_w + q_offset;
    if constexpr (!kBig) {
      cp_async_wait<0>();  // Q and step 0's K and V of this tile
      __syncthreads();
      const __nv_bfloat16* qrow = q_row();
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) ldsm_x4(qf[kc], qrow + kc * 16);
    }
#pragma unroll
    for (int dt = 0; dt < 2 * kKC; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;

    for (int step = step0; step < n_steps; ++step) {
      const int k0 = step * kBK, st = kBig ? 0 : gs & 1;
      const bool masked = k0 + kBK > Skv ||
                          (causal && k0 + kBK - 1 > pos_w && k0 + kBK > prefix) ||
                          (window > 0 && k0 < pos_w + 16 - window);
      float s[kNT][4];
      if constexpr (kBig) {
        // Two barriers a step.  The first publishes this step's K (and, on
        // a tile's first step, its Q) and frees the V tile (read by the
        // step before, or the staging of the tile before's output) for
        // this step's V, which loads while the scores are taken.  The
        // second publishes V and frees K (and, on the last step, Q) for
        // the next step's K, or the next tile's Q and first K, which load
        // while the softmax and P V run.
        cp_async_wait<0>();
        __syncthreads();
        load_tile_async<D>(Vs, v + kvo, k0, kv_stride, Skv);
        cp_async_commit();
        if (masked) scores(std::true_type{}, k0, Ks, s);
        else scores(std::false_type{}, k0, Ks, s);
        cp_async_wait<0>();
        __syncthreads();
        if (step + 1 < n_steps) {
          load_tile_async<D>(Ks, k + kvo, k0 + kBK, kv_stride, Skv);
        } else if (t_next < n_tiles) {
          load_tile_async<D>(Qs, q + q_off(t_next), q0_of(t_next), q_stride, Sq);
          load_tile_async<D>(Ks, k + kv_off(t_next), steps_of(t_next).x * kBK, kv_stride, Skv);
        }
        cp_async_commit();
        if (masked) softmax_pv(std::true_type{}, k0, Vs, s);
        else softmax_pv(std::false_type{}, k0, Vs, s);
      } else {
        // One barrier a step: it publishes the step's K and V to every
        // warp and frees the other stage (read by the step before) for the
        // copies of the next step, or of the next tile's Q and first step
        // after the last, which run while this step computes.
        if (step > step0) cp_async_wait<0>();
        __syncthreads();  // the first step: every warp holds its Q fragments, Qs is free
        if (step + 1 < n_steps) {
          load_tile_async<D>(Ks + (st ^ 1) * kTile, k + kvo, k0 + kBK, kv_stride, Skv);
          load_tile_async<D>(Vs + (st ^ 1) * kTile, v + kvo, k0 + kBK, kv_stride, Skv);
        } else if (t_next < n_tiles) {
          load_tile_async<D>(Qs, q + q_off(t_next), q0_of(t_next), q_stride, Sq);
          const int k0_next = steps_of(t_next).x * kBK;
          load_tile_async<D>(Ks + (st ^ 1) * kTile, k + kv_off(t_next), k0_next, kv_stride, Skv);
          load_tile_async<D>(Vs + (st ^ 1) * kTile, v + kv_off(t_next), k0_next, kv_stride, Skv);
        }
        cp_async_commit();
        if (masked) {
          scores(std::true_type{}, k0, Ks + st * kTile, s);
          softmax_pv(std::true_type{}, k0, Vs + st * kTile, s);
        } else {
          scores(std::false_type{}, k0, Ks + st * kTile, s);
          softmax_pv(std::false_type{}, k0, Vs + st * kTile, s);
        }
      }
      ++gs;
    }

    // O * (1 / max(l, 1e-30)) -> bf16, staged in the warp's 16 rows of a
    // tile no copy is headed to (the K tile the last step read; kBig: the V
    // tile) for 16-byte stores
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = __frcp_rn(max_nan(l_run[r], 1e-30f));
    }
    if (lse != nullptr && t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_w + g + 8 * r;
        if (row < Sq) lse[int64_t(t % n_bh) * Sq + row] = row_lse(m_run[r] * scale, l_run[r]);
      }
    }
    __syncthreads();  // every warp is done with that tile
    __nv_bfloat16* os = (kBig ? Vs : Ks + ((gs - 1) & 1) * kTile) + warp * 16 * kS;
#pragma unroll
    for (int dt = 0; dt < 2 * kKC; ++dt) {
      const int col = dt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(os + g * kS + col) =
          __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * kS + col) =
          __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
    }
    __syncwarp();
    __nv_bfloat16* ob = out + q_off(t);
    constexpr int kChunks = D / 8;
    for (int c = lane; c < 16 * kChunks; c += 32) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      if (row_w + r < Sq) {
        *reinterpret_cast<int4*>(ob + int64_t(row_w + r) * q_stride + col) =
            *reinterpret_cast<const int4*>(os + r * kS + col);
      }
    }
  }
}

template <int D, bool kPwl>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, int window, int prefix, int q_offset,
                       const PwlCoeffs& pwl, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_fwd_mma_kernel<D, kPwl>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // persistent: one CTA per SM (its registers allow no more), each walking tiles
  const int n_tiles = B * Hq * ((Sq + kMmaBQ - 1) / kMmaBQ);
  using bf16 = __nv_bfloat16;
  kernel<<<n_tiles < n_sm ? n_tiles : n_sm, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix, q_offset,
      float(pow(double(D), -0.5)), pwl);
  return cudaGetLastError();
}

template <typename T, int D, bool kPwl>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                   int Skv, int Hq, int Hkv, int causal, int window, int prefix, int q_offset,
                   const PwlCoeffs& pwl, cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>) {
    return launch_mma<D, kPwl>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix,
                               q_offset, pwl, stream);
  } else {
    constexpr size_t smem = flash_smem_bytes<D>();
    auto kernel = flash_fwd_kernel<T, D, kPwl>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, Sq, Skv, Hq, Hkv, causal, window, prefix, q_offset,
        float(pow(double(D), -0.5)), pwl);
    return cudaGetLastError();
  }
}

template <typename T, bool kPwl>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                         int B,
                         int Sq, int Skv, int Hq, int Hkv, int causal, int window, int prefix,
                         int q_offset, const PwlCoeffs& pwl, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32, kPwl>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix,
                                q_offset, pwl, s);
    case 64:
      return launch<T, 64, kPwl>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix,
                                q_offset, pwl, s);
    case 80:
      return launch<T, 80, kPwl>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix,
                                q_offset, pwl, s);
    case 128:
      return launch<T, 128, kPwl>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix,
                                 q_offset, pwl, s);
    case 256:
      return launch<T, 256, kPwl>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, window, prefix,
                                 q_offset, pwl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); out: (B, Sq, Hq, D), all
// contiguous; lse: null, or (B, Hq, Sq) float32 that receives each row's
// log-sum-exp of its scaled scores (the backward's input; +inf for a row
// that sees no key).  dtype 0 = float32, 1 = bfloat16.  window > 0 masks keys
// window or more positions before the query; 0 is no window.  prefix_len
// > 0 makes keys below it visible to every query (causal only, and with
// neither a window nor PWL exp: refused).  q_offset >= 0 is the global
// position of q's row 0 (keys at 0 .. Skv - 1).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse_out, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D, int dtype, int causal,
                                   int window, int prefix_len, int q_offset, int use_pwl,
                                   const void* pwl_host, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      prefix_len < 0 || q_offset < 0 ||
      (prefix_len > 0 && (!causal || window > 0 || use_pwl)))
    return cudaErrorInvalidValue;
  const PwlCoeffs pwl = read_pwl(pwl_host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = window, p = prefix_len, o = q_offset;
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0) {
    return use_pwl
               ? dispatch_dim<float, true>(D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, w, p, o,
                                           pwl, s)
               : dispatch_dim<float, false>(D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, w, p, o,
                                            pwl, s);
  }
  if (dtype == 1) {
    return use_pwl ? dispatch_dim<__nv_bfloat16, true>(D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                                                       causal, w, p, o, pwl, s)
                   : dispatch_dim<__nv_bfloat16, false>(D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                                                        causal, w, p, o, pwl, s);
  }
  return cudaErrorInvalidValue;
}
