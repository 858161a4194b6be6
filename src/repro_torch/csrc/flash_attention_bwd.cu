// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of exact
// attention with GQA, causal or not (Sq may differ from Skv), with or
// without a sliding window, float32 (SIMT) and bfloat16 (tensor cores),
// D = 32, 64, 80 or 128.
//
// The reference has no backward kernel: its training step differentiates
// repro.models.attention.full_attention / flash_attention with XLA's
// autodiff.  This is the counterpart of that autodiff for the port's
// forward kernel (flash_attention.cu), which hands over each row's
// log-sum-exp lse = m + log l of its scaled scores.  With scale = D^-0.5,
// S = scale Q K^T and a key valid for a query when kpos < Skv, qpos < Sq,
// under the causal mask kpos <= qpos, and under a window (window > 0)
// qpos - kpos < window (repro.models.attention._chunk_mask):
//   P  = exp(S - lse) on valid pairs, 0 elsewhere (the forward's softmax)
//   dV = P^T dO
//   dP = dO V^T,  Delta_i = sum_d dO_id O_id
//   dS = P o (dP - Delta) on valid pairs, 0 elsewhere
//   dQ = scale dS K,  dK = scale dS^T Q
// summed over the Hq / Hkv query heads of a KV head for dK and dV.
//
// Three launches on one stream, counted as one by the wrapper:
// - flash_bwd_delta_kernel: Delta (B, Hq, Sq) float32, a warp a row.
// - dK/dV: one CTA per (b, KV head, 64-key tile), longest first.  It keeps
//   K and V of its keys in shared memory and walks the group's query heads
//   and, for each, the 64-row query tiles that hold a row some of its keys
//   see (query_tiles: from its first key's tile under the causal mask,
//   else from 0; under a window only to the tile of row k0 + 62 + window);
//   a tile recomputes P and dS and adds P^T dO and dS^T Q to dV and dK,
//   held in registers to the end.
// - dQ: one CTA per (b, query head, 64-row query tile), longest first,
//   over the key tiles that hold a key its rows see (key_tiles: under a
//   window from the tile of key q0 - window + 1; under the causal mask to
//   the tile of its last row); it recomputes P and dS and adds dS K to dQ
//   in registers.
// Without the causal mask or a window every CTA walks the same number of
// tiles, so the longest-first order means nothing there, and the only
// masked pairs are those past Sq or Skv.
// Every sum is taken in one CTA in a fixed order, so the result does not
// depend on scheduling: no atomics, two runs agree bit for bit.  P and dS
// are recomputed in both kernels (7 products of 2 Sq Skv D per head,
// halved by the mask, where the function needs 5).
//
// bfloat16 (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel): tensor
// cores, mma.sync m16n8k16 with the forward's fragment layouts (ldmatrix,
// ldmatrix.trans), 4 warps of 16 rows each, tiles staged as bf16 by 16-byte
// cp.async (D 80: rows of 88 bf16, 176 bytes, 16-byte aligned).  The dK/dV
// warp takes S^T = K Q^T and dP^T = V dO^T for its 16 keys, so that P^T and
// dS^T lie in registers in the A-fragment layout of dV += P^T dO and dK +=
// dS^T Q; the dQ warp takes S = Q K^T and dP = dO V^T for its 16 rows and
// adds dS K.  P and dS are multiplied as hi + lo bf16 terms (~2^-17 of the
// float32 value), as the forward multiplies P, so the gradients agree with
// the float32 plain version before their one rounding to bf16.  exp is the
// SFU's ex2.approx, as in the forward.  A warp's share of a tile is
// compiled apart for each way the mask keeps its pairs (kTileFull: every
// pair, no branch between its products; kTileDiag: the causal diagonal,
// the warp's own 16 x 16 block cut; kTileCut: a window's), and each kernel
// is compiled with and without a window (kWindow), so that a call without
// one runs none of the window's code.
//
// float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): SIMT FMAs (no
// TF32), tiles staged as float32, rows padded by one float against bank
// conflicts; a thread computes a 4 x 4 block of a 64 x 64 score tile.
//
// NaN: a gradient depends on exactly the (query, key) pairs the mask keeps,
// as in the plain version (kernels/flash_attention.flash_attention_bwd_plain):
// P and dS are selected, not multiplied, to 0 on masked pairs.  On a tile
// that the causal diagonal or the window's lower edge cuts, the SIMT path
// adds a pair's term under a select.  The mma path takes each warp's four
// 16 x 16 blocks (16 keys or rows of the warp against a 16-row or 16-key
// chunk of the tile): a block with no kept pair is skipped, a block whose
// every pair is kept goes through mma.sync, and a block that the diagonal
// or the window's edge cuts is added pair by pair (a masked pair's 0 times
// a NaN row in a product would be NaN).  Without a window only the
// diagonal's block is cut; under one, block_kept sorts the blocks, since
// the edge cuts them at any offset (a window need not be a multiple of 16).  So a NaN in dO, Q, K or V reaches the
// gradients of the pairs that see it and no other.  A NaN lse (a row that
// saw a NaN score) makes that row's P NaN on its kept keys.  A row that
// sees no key has lse = +inf: P = 0.  Rows past Sq and keys past Skv are
// staged as zeros and their P and dS selected to 0, so they add nothing
// to a real row's or key's gradient, NaN or not (0 times a staged 0); a
// padded key's or row's own gradient, where a real NaN may reach it, is
// never stored.
//
// Refused (cudaErrorNotSupported): a bidirectional prefix, PWL exp, and D
// outside 32 / 64 / 80 / 128.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kT = 64;  // query rows of a query tile, keys of a key tile
constexpr int kThreads = 256;
constexpr int kTP = kT + 1;  // padded row of a 64 x 64 tile

template <int D>
constexpr size_t bwd_smem_bytes() {
  // four 64 x D tiles, two 64 x 64 tiles, lse and Delta of 64 rows
  return sizeof(float) * (4 * size_t(kT) * (D + 1) + 2 * size_t(kT) * kTP + 2 * kT);
}

// the mask keeps the pair: the key at or before the query under the causal
// mask, fewer than window positions before it under a window (window 0:
// none); the Sq / Skv edges are checked apart
__device__ __forceinline__ bool pair_kept(int qpos, int kpos, bool causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

// which pairs of rows [r0, r0 + n) against keys [c0, c0 + n) the mask keeps
enum { kNone = 0, kSome = 1, kAll = 2 };
__device__ __forceinline__ int block_kept(int r0, int c0, int n, bool causal, int window) {
  const int r1 = r0 + n - 1, c1 = c0 + n - 1;
  if ((causal && r1 < c0) || (window > 0 && r0 - c1 >= window)) return kNone;
  if ((!causal || c1 <= r0) && (window <= 0 || r1 - c0 < window)) return kAll;
  return kSome;
}

// the query tiles [x, y) that hold a row some key of [k0, k0 + 64) sees
__device__ __forceinline__ int2 query_tiles(int k0, int Sq, bool causal, int window) {
  const int n_qt = (Sq + kT - 1) / kT;
  const int hi = window > 0 ? min(n_qt, (k0 + kT - 2 + window) / kT + 1) : n_qt;
  return make_int2(causal ? k0 / kT : 0, hi);
}

// the key tiles [x, y) that hold a key some row of [q0, min(q0 + 64, Sq)) sees
__device__ __forceinline__ int2 key_tiles(int q0, int Sq, int Skv, bool causal, int window) {
  const int n_kt = (Skv + kT - 1) / kT;
  const int hi = causal ? min(n_kt, (min(q0 + kT, Sq) - 1) / kT + 1) : n_kt;
  return make_int2(window > 0 ? max(0, q0 - window + 1) / kT : 0, hi);
}

// rows [row0, row0 + 64) of a matrix with row_stride elements between rows
// into a padded float32 tile; zeros past n_valid
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int64_t row_stride,
                                      int n_valid) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n_valid ? to_float(src[int64_t(row) * row_stride + c]) : 0.f;
  }
}

// 64 values of a (.., Sq) float32 row vector from q0 on; `pad` past Sq
__device__ __forceinline__ void stage_row(float* dst, const float* src, int q0, int Sq,
                                          float pad) {
  if (threadIdx.x < kT) dst[threadIdx.x] = q0 + threadIdx.x < Sq ? src[q0 + threadIdx.x] : pad;
}

// P and dS of a 64-row query tile against a 64-key tile into Ps and dSs
// (row r at r * kTP): this thread's 4 rows ty * 4 + i and 4 keys tx + 16 j.
template <int D>
__device__ __forceinline__ void probs_and_dscores(const float* Qs, const float* Ks,
                                                  const float* dOs, const float* Vs,
                                                  const float* lse_s, const float* delta_s,
                                                  float* Ps, float* dSs, int q0, int k0, int Sq,
                                                  int Skv, bool causal, int window, float scale) {
  constexpr int DP = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4], ov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * DP + d];
      ov[i] = dOs[(ty * 4 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * DP + d];
      vv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      const bool ok = qpos < Sq && kpos < Skv && pair_kept(qpos, kpos, causal, window);
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      Ps[r * kTP + c] = p;
      dSs[r * kTP + c] = ok ? p * (dp[i][j] - delta_s[r]) : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int Sq, int Hq) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;  // (b, q, h) in memory order
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* o = out + int64_t(row) * D;
  const T* g = dout + int64_t(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(g[c]), to_float(o[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % Hq, q = (row / Hq) % Sq, b = row / (Hq * Sq);
    delta[(int64_t(b) * Hq + h) * Sq + q] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int B, int Sq, int Skv, int Hq, int Hkv, bool causal, int window,
                      float scale) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kT * DP;
  float* Qs = Vs + kT * DP;
  float* dOs = Qs + kT * DP;
  float* Ps = dOs + kT * DP;
  float* dSs = Ps + kT * kTP;
  float* lse_s = dSs + kT * kTP;
  float* delta_s = lse_s + kT;

  // the longest CTAs (first key tiles: most query tiles) first
  const int n_bkv = B * Hkv;
  const int kt = blockIdx.x / n_bkv, bkv = blockIdx.x % n_bkv;
  const int b = bkv / Hkv, hk = bkv % Hkv, G = Hq / Hkv;
  const int k0 = kt * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const int64_t kv_off = (int64_t(b) * Skv * Hkv + hk) * D;

  stage<T, D>(Ks, k + kv_off, k0, kv_stride, Skv);
  stage<T, D>(Vs, v + kv_off, k0, kv_stride, Skv);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int2 tiles = query_tiles(k0, Sq, causal, window);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t q_off = (int64_t(b) * Sq * Hq + h) * D;
    const int64_t row_off = (int64_t(b) * Hq + h) * Sq;
    for (int qt = tiles.x; qt < tiles.y; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the tile before is consumed
      stage<T, D>(Qs, q + q_off, q0, q_stride, Sq);
      stage<T, D>(dOs, dout + q_off, q0, q_stride, Sq);
      stage_row(lse_s, lse + row_off, q0, Sq, INFINITY);
      stage_row(delta_s, delta + row_off, q0, Sq, 0.f);
      __syncthreads();
      probs_and_dscores<D>(Qs, Ks, dOs, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq, Skv, causal,
                           window, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows; on a tile that the
      // diagonal or the window's edge cuts a masked pair adds nothing (a
      // select, so a NaN of its row stays out)
      const bool cut = block_kept(q0, k0, kT, causal, window) != kAll;
#pragma unroll 2
      for (int r = 0; r < kT; ++r) {
        float p[4], ds[4], ov[CPT], qv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * kTP + ty * 4 + i];
          ds[i] = dSs[r * kTP + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          ov[j] = dOs[r * DP + tx + 16 * j];
          qv[j] = Qs[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool keep = !cut || pair_kept(q0 + r, k0 + ty * 4 + i, causal, window);
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float a = fmaf(p[i], ov[j], dv_acc[i][j]);
            const float c = fmaf(ds[i], qv[j], dk_acc[i][j]);
            dv_acc[i][j] = keep ? a : dv_acc[i][j];
            dk_acc[i][j] = keep ? c : dk_acc[i][j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int64_t at = kv_off + int64_t(key) * kv_stride + tx + 16 * j;
      dk[at] = from_float<T>(dk_acc[i][j] * scale);
      dv[at] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int B, int Sq, int Skv,
                    int Hq, int Hkv, bool causal, int window, float scale) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kT * DP;
  float* Ks = dOs + kT * DP;
  float* Vs = Ks + kT * DP;
  float* Ps = Vs + kT * DP;
  float* dSs = Ps + kT * kTP;
  float* lse_s = dSs + kT * kTP;
  float* delta_s = lse_s + kT;

  // the longest CTAs (last query tiles: most key tiles) first
  const int n_bh = B * Hq, n_qt = (Sq + kT - 1) / kT;
  const int qt = n_qt - 1 - blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const int64_t q_off = (int64_t(b) * Sq * Hq + h) * D;
  const int64_t kv_off = (int64_t(b) * Skv * Hkv + hk) * D;
  const int64_t row_off = int64_t(bh) * Sq;

  stage<T, D>(Qs, q + q_off, q0, q_stride, Sq);
  stage<T, D>(dOs, dout + q_off, q0, q_stride, Sq);
  stage_row(lse_s, lse + row_off, q0, Sq, INFINITY);
  stage_row(delta_s, delta + row_off, q0, Sq, 0.f);

  float dq_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq_acc[i][j] = 0.f;

  const int2 tiles = key_tiles(q0, Sq, Skv, causal, window);
  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the tile before is consumed
    stage<T, D>(Ks, k + kv_off, k0, kv_stride, Skv);
    stage<T, D>(Vs, v + kv_off, k0, kv_stride, Skv);
    __syncthreads();
    probs_and_dscores<D>(Qs, Ks, dOs, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq, Skv, causal,
                         window, scale);
    __syncthreads();
    // dQ += dS K over the tile's keys; on a tile that the diagonal or the
    // window's edge cuts a masked pair adds nothing (a select)
    const bool cut = block_kept(q0, k0, kT, causal, window) != kAll;
#pragma unroll 2
    for (int c = 0; c < kT; ++c) {
      float ds[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kTP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool keep = !cut || pair_kept(q0 + ty * 4 + i, k0 + c, causal, window);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float a = fmaf(ds[i], kv[j], dq_acc[i][j]);
          dq_acc[i][j] = keep ? a : dq_acc[i][j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dq[q_off + int64_t(row) * q_stride + tx + 16 * j] = from_float<T>(dq_acc[i][j] * scale);
    }
  }
}

// ---- bfloat16: tensor cores ---------------------------------------------
constexpr int kMmaWarps = kT / 16;  // each warp owns 16 rows of the CTA's 64
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
constexpr int kStride = D + 8;  // bf16 per shared row: a 16-byte pad (ldmatrix)

template <int D>
constexpr size_t mma_smem_bytes() {
  // four 64 x D bf16 tiles, lse and Delta of 64 rows
  return 4 * size_t(kT) * kStride<D> * sizeof(__nv_bfloat16) + 2 * kT * sizeof(float);
}

// rows [row0, row0 + 64) of a bf16 matrix into a padded shared tile, 16
// bytes a copy; zeros past n_valid
template <int D>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                            int64_t row_stride, int n_valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kT * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < n_valid;
    cp_async16(dst + r * kStride<D> + col, ok ? src + int64_t(row0 + r) * row_stride + col : src,
               ok);
  }
}

// acc (16 x 64) = A B^T over D: A the 16 rows of a shared tile at `a`, B the
// 64 rows of the shared tile `b`; only the 16-column groups np with bit np
// of `groups` set (the others stay 0)
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, unsigned groups) {
  const int lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
  const __nv_bfloat16* arow = a + ((mi & 1) * 8 + mr) * kStride<D> + (mi >> 1) * 8;
  const __nv_bfloat16* brow = b + ((mi >> 1) * 8 + mr) * kStride<D> + (mi & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, arow + kc * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (groups >> np & 1u) {
        uint32_t r[4];
        ldsm_x4(r, brow + np * 16 * kStride<D> + kc * 16);
        mma_bf16(acc[2 * np], af, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
      }
    }
  }
}

// acc (16 x D) += P B over the 16-row chunks kc of the shared tile `b` (64 x
// D) with bit kc of `chunks` set: P (16 x 64) from accumulators, multiplied
// as hi + lo bf16 terms (~2^-17 of p) against bf16 B, as the forward
// multiplies P
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[8][4],
                                       const __nv_bfloat16* b, unsigned chunks) {
  const int lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
  const __nv_bfloat16* brow = b + ((mi & 1) * 8 + mr) * kStride<D> + (mi >> 1) * 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (chunks >> kc & 1u) {
      uint32_t a_hi[4], a_lo[4];
      a_hi[0] = split_bf16x2(p[2 * kc][0], p[2 * kc][1], a_lo[0]);
      a_hi[1] = split_bf16x2(p[2 * kc][2], p[2 * kc][3], a_lo[1]);
      a_hi[2] = split_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1], a_lo[2]);
      a_hi[3] = split_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3], a_lo[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, brow + kc * 16 * kStride<D> + dp * 16);
        mma_bf16(acc[2 * dp], a_hi, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], a_hi, r[2], r[3]);
        mma_bf16(acc[2 * dp], a_lo, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], a_lo, r[2], r[3]);
      }
    }
  }
}

// acc (16 x D) += P B over the 16 x 16 block of chunk KC, pair by pair
// where keep(h, j, c) holds for the warp's row g + 8 h and the chunk's row
// j (the tile's row c = 16 KC + j) of b: a select, so that a masked pair's
// 0 times a NaN of B adds nothing, as the plain version leaves the pair
// out.  P's values of a row are gathered from the 4 lanes of its quad.
template <int D, int KC, typename Keep>
__device__ __forceinline__ void add_block(float (&acc)[D / 8][4], const float (&p)[8][4],
                                          const __nv_bfloat16* b, Keep keep) {
  const int lane = threadIdx.x % 32, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int src = (lane & ~3) | ((j % 8) / 2);
    const float p0 = __shfl_sync(0xffffffffu, p[2 * KC + j / 8][j % 2], src);
    const float p1 = __shfl_sync(0xffffffffu, p[2 * KC + j / 8][2 + j % 2], src);
    const bool keep0 = keep(0, j, 16 * KC + j), keep1 = keep(1, j, 16 * KC + j);
    const __nv_bfloat16* brow = b + (16 * KC + j) * kStride<D> + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float2 bv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(brow + dt * 8));
      acc[dt][0] = keep0 ? fmaf(p0, bv.x, acc[dt][0]) : acc[dt][0];
      acc[dt][1] = keep0 ? fmaf(p0, bv.y, acc[dt][1]) : acc[dt][1];
      acc[dt][2] = keep1 ? fmaf(p1, bv.x, acc[dt][2]) : acc[dt][2];
      acc[dt][3] = keep1 ? fmaf(p1, bv.y, acc[dt][3]) : acc[dt][3];
    }
  }
}

// add_block over the causal diagonal's block, chunk `warp`
template <int D, typename Keep>
__device__ __forceinline__ void add_diagonal_block(float (&acc)[D / 8][4], const float (&p)[8][4],
                                                   const __nv_bfloat16* b, int warp, Keep keep) {
  switch (warp) {
    case 0: add_block<D, 0>(acc, p, b, keep); break;
    case 1: add_block<D, 1>(acc, p, b, keep); break;
    case 2: add_block<D, 2>(acc, p, b, keep); break;
    default: add_block<D, 3>(acc, p, b, keep); break;
  }
}

// add_block over each chunk with bit KC of `cut` set (warp-uniform)
template <int D, typename Keep>
__device__ __forceinline__ void add_cut_blocks(float (&acc)[D / 8][4], const float (&p)[8][4],
                                               const __nv_bfloat16* b, unsigned cut, Keep keep) {
  if (cut & 1u) add_block<D, 0>(acc, p, b, keep);
  if (cut & 2u) add_block<D, 1>(acc, p, b, keep);
  if (cut & 4u) add_block<D, 2>(acc, p, b, keep);
  if (cut & 8u) add_block<D, 3>(acc, p, b, keep);
}

// the 16 x 16 blocks of a warp's 16 rows from w0 against the tile's four
// 16-key chunks from t0 (`by_key`: of its 16 keys from w0 against four
// 16-row chunks from t0): bits of the chunks with a kept pair (.x) and of
// those the mask keeps whole (.y)
__device__ __forceinline__ uint2 warp_blocks(int w0, int t0, bool by_key, bool causal,
                                             int window) {
  unsigned need = 0, full = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = by_key ? block_kept(t0 + 16 * c, w0, 16, causal, window)
                         : block_kept(w0, t0 + 16 * c, 16, causal, window);
    need |= unsigned(m != kNone) << c;
    full |= unsigned(m == kAll) << c;
  }
  return make_uint2(need, full);
}

// which pairs of a warp's 16 x 64 share of a tile the mask keeps, each
// mode compiled apart: every pair (kTileFull); the causal diagonal tile
// without a window (kTileDiag: the warp's own chunk cut, a compile-time
// rule per warp); under a window, the chunks of warp_blocks (kTileCut:
// cut chunks pair by pair within a lane's span of the tile)
enum { kTileFull = 0, kTileDiag = 1, kTileCut = 2 };

// One query tile's share of a dK/dV warp's keys kw0 .. kw0 + 15: P^T and
// dS^T (16 keys x 64 rows) from S^T = K Q^T and dP^T = V dO^T, then dV +=
// P^T dO and dK += dS^T Q.  blocks (kTileCut): the query chunks that see
// the warp's keys (.x) and those that see them all (.y).
template <int D, int kMode>
__device__ __forceinline__ void dkdv_tile(float (&dk_acc)[D / 8][4], float (&dv_acc)[D / 8][4],
                                          const __nv_bfloat16* Kw, const __nv_bfloat16* Vw,
                                          const __nv_bfloat16* Qs, const __nv_bfloat16* dOs,
                                          const float* lse_s, const float* delta_s, uint2 blocks,
                                          int warp, int q0, int kw0, int Sq, int Skv, bool causal,
                                          int window, float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  unsigned need = 0xFu, full = 0xFu;
  if (kMode == kTileDiag) {  // the warp's keys see query chunks >= warp
    need = (0xFu << warp) & 0xFu;
    full = need & ~(1u << warp);
  } else if (kMode == kTileCut) {
    need = blocks.x;
    full = blocks.y;
  }
  float s[8][4], dp[8][4];
  mma_abt<D>(s, Kw, Qs, need);
  mma_abt<D>(dp, Vw, dOs, need);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kw0 + g + 8 * (e >> 1);
      const int ql = nt * 8 + 2 * t4 + (e & 1), qpos = q0 + ql;
      bool ok = qpos < Sq && key < Skv;
      if (kMode == kTileDiag) ok = ok && key <= qpos;
      if (kMode == kTileCut) ok = ok && pair_kept(qpos, key, causal, window);
      const float p = ok ? ex2_approx(fmaf(s[nt][e], scale_log2, -lse_s[ql])) : 0.f;
      dp[nt][e] = ok ? p * (dp[nt][e] - delta_s[ql]) : 0.f;
      s[nt][e] = p;
    }
  if constexpr (kMode == kTileDiag) {
    // keys 16 warp + g (+ 8) see queries 16 warp + j with j >= g (+ 8)
    auto keep = [g](int h, int j, int) { return j >= g + 8 * h; };
    add_diagonal_block<D>(dv_acc, s, dOs, warp, keep);
    add_diagonal_block<D>(dk_acc, dp, Qs, warp, keep);
  } else if constexpr (kMode == kTileCut) {
    const unsigned cut = need & ~full;
    if (cut) {
      // key kw0 + g (+ 8) sees query q0 + c for c from key - q0 (causal)
      // to below key - q0 + window
      const int first = kw0 + g - q0;
      auto keep = [first, causal, window](int h, int, int c) {
        return (!causal || first + 8 * h <= c) && c < first + 8 * h + window;
      };
      add_cut_blocks<D>(dv_acc, s, dOs, cut, keep);
      add_cut_blocks<D>(dk_acc, dp, Qs, cut, keep);
    }
  }
  mma_pb<D>(dv_acc, s, dOs, full);
  mma_pb<D>(dk_acc, dp, Qs, full);
}

// One key tile's share of a dQ warp's rows qw0 .. qw0 + 15: dS (16 rows x
// 64 keys) from S = Q K^T and dP = dO V^T, then dQ += dS K.  blocks and
// kMode as in dkdv_tile, over the tile's 16-key chunks.
template <int D, int kMode>
__device__ __forceinline__ void dq_tile(float (&dq_acc)[D / 8][4], const __nv_bfloat16* Qw,
                                        const __nv_bfloat16* dOw, const __nv_bfloat16* Ks,
                                        const __nv_bfloat16* Vs, const float (&lse2)[2],
                                        const float (&dlt)[2], uint2 blocks, int warp, int qw0,
                                        int k0, int Sq, int Skv, bool causal, int window,
                                        float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  unsigned need = 0xFu, full = 0xFu;
  if (kMode == kTileDiag) {  // the warp's rows see key chunks <= warp
    need = 0xFu >> (3 - warp);
    full = need & ~(1u << warp);
  } else if (kMode == kTileCut) {
    need = blocks.x;
    full = blocks.y;
  }
  float s[8][4], dp[8][4];
  mma_abt<D>(s, Qw, Ks, need);
  mma_abt<D>(dp, dOw, Vs, need);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qw0 + g + 8 * (e >> 1);
      const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
      bool ok = row < Sq && key < Skv;
      if (kMode == kTileDiag) ok = ok && key <= row;
      if (kMode == kTileCut) ok = ok && pair_kept(row, key, causal, window);
      const float p = ok ? ex2_approx(fmaf(s[nt][e], scale_log2, -lse2[e >> 1])) : 0.f;
      s[nt][e] = ok ? p * (dp[nt][e] - dlt[e >> 1]) : 0.f;  // dS
    }
  if constexpr (kMode == kTileDiag) {
    // rows 16 warp + g (+ 8) see keys 16 warp + j with j <= g (+ 8)
    add_diagonal_block<D>(dq_acc, s, Ks, warp, [g](int h, int j, int) { return j <= g + 8 * h; });
  } else if constexpr (kMode == kTileCut) {
    const unsigned cut = need & ~full;
    if (cut) {
      // row qw0 + g (+ 8) sees key k0 + c for c above row - k0 - window and
      // up to row - k0 (causal)
      const int last = qw0 + g - k0;
      auto keep = [last, causal, window](int h, int, int c) {
        return (!causal || c <= last + 8 * h) && c > last + 8 * h - window;
      };
      add_cut_blocks<D>(dq_acc, s, Ks, cut, keep);
    }
  }
  mma_pb<D>(dq_acc, s, Ks, full);
}

// dK and dV on the tensor cores: a CTA of 4 warps per (b, KV head, 64
// keys), each warp 16 keys.  A warp takes S^T = K Q^T and dP^T = V dO^T
// (16 keys x 64 query rows), so that P^T and dS^T are in registers in the
// A-fragment layout of dV += P^T dO and dK += dS^T Q.  A warp skips the
// 16-row chunks of queries that see none of its keys (before them, or past
// their window) and adds the chunks that the diagonal or the window's edge
// cuts pair by pair.  kWindow: compiled for window > 0 (kTileCut on a tile
// the mask cuts); without it a tile is the causal diagonal (kTileDiag) or
// kept whole.
template <int D, bool kWindow>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv, int Hq, int Hkv,
                          bool causal, int window, float scale) {
  constexpr int kS = kStride<D>, kTile = kT * kS, kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qs = Vs + kTile;
  __nv_bfloat16* dOs = Qs + kTile;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile);  // lse * log2 e
  float* delta_s = lse_s + kT;

  const int n_bkv = B * Hkv;
  const int kt = blockIdx.x / n_bkv, bkv = blockIdx.x % n_bkv;
  const int b = bkv / Hkv, hk = bkv % Hkv, G = Hq / Hkv;
  const int k0 = kt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const int64_t kv_off = (int64_t(b) * Skv * Hkv + hk) * D;
  const float scale_log2 = scale * kLog2e;

  stage_async<D>(Ks, k + kv_off, k0, kv_stride, Skv);
  stage_async<D>(Vs, v + kv_off, k0, kv_stride, Skv);
  cp_async_commit();

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int kw0 = k0 + warp * 16;  // the warp's first key
  const __nv_bfloat16* Kw = Ks + warp * 16 * kS;
  const __nv_bfloat16* Vw = Vs + warp * 16 * kS;
  const int2 tiles = query_tiles(k0, Sq, causal, window);
  for (int gq = 0; gq < G; ++gq) {
    const int h = hk * G + gq;
    const int64_t q_off = (int64_t(b) * Sq * Hq + h) * D;
    const int64_t row_off = (int64_t(b) * Hq + h) * Sq;
    for (int qt = tiles.x; qt < tiles.y; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the tile before is consumed
      stage_async<D>(Qs, q + q_off, q0, q_stride, Sq);
      stage_async<D>(dOs, dout + q_off, q0, q_stride, Sq);
      cp_async_commit();
      if (threadIdx.x < kT) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Sq ? lse[row_off + row] * kLog2e : INFINITY;
        delta_s[threadIdx.x] = row < Sq ? delta[row_off + row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (kWindow) {
        // the query chunks that see the warp's keys, and those that see all
        const uint2 blocks = warp_blocks(kw0, q0, true, causal, window);
        if (blocks.y == 0xFu) {
          dkdv_tile<D, kTileFull>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s, blocks, warp,
                                  q0, kw0, Sq, Skv, causal, window, scale_log2);
        } else {
          dkdv_tile<D, kTileCut>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s, blocks, warp,
                                 q0, kw0, Sq, Skv, causal, window, scale_log2);
        }
      } else if (causal && q0 == k0) {
        dkdv_tile<D, kTileDiag>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s, uint2{}, warp, q0,
                                kw0, Sq, Skv, causal, window, scale_log2);
      } else {  // past the diagonal, or no mask: every pair kept
        dkdv_tile<D, kTileFull>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s, uint2{}, warp, q0,
                                kw0, Sq, Skv, causal, window, scale_log2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= Skv) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int64_t at = kv_off + int64_t(key) * kv_stride + dt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// dQ on the tensor cores: a CTA of 4 warps per (b, query head, 64 rows),
// each warp 16 rows, over the key tiles its rows see.  A warp skips the
// 16-key chunks that none of its rows sees (after them, or before their
// windows) and adds the chunks that the diagonal or the window's edge cuts
// pair by pair.  kWindow as in the dK/dV kernel.
template <int D, bool kWindow>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int Hq, int Hkv,
                        bool causal, int window, float scale) {
  constexpr int kS = kStride<D>, kTile = kT * kS, kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kTile;
  __nv_bfloat16* Ks = dOs + kTile;
  __nv_bfloat16* Vs = Ks + kTile;

  const int n_bh = B * Hq, n_qt = (Sq + kT - 1) / kT;
  const int qt = n_qt - 1 - blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const int64_t q_off = (int64_t(b) * Sq * Hq + h) * D;
  const int64_t kv_off = (int64_t(b) * Skv * Hkv + hk) * D;
  const float scale_log2 = scale * kLog2e;

  stage_async<D>(Qs, q + q_off, q0, q_stride, Sq);
  stage_async<D>(dOs, dout + q_off, q0, q_stride, Sq);
  cp_async_commit();
  float lse2[2], dlt[2];  // rows g and g + 8 of the warp: lse * log2 e, Delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < Sq ? lse[int64_t(bh) * Sq + row] * kLog2e : INFINITY;
    dlt[r] = row < Sq ? delta[int64_t(bh) * Sq + row] : 0.f;
  }

  float dq_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  const int qw0 = q0 + warp * 16;  // the warp's first row
  const __nv_bfloat16* Qw = Qs + warp * 16 * kS;
  const __nv_bfloat16* dOw = dOs + warp * 16 * kS;
  const int2 tiles = key_tiles(q0, Sq, Skv, causal, window);
  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the tile before is consumed
    stage_async<D>(Ks, k + kv_off, k0, kv_stride, Skv);
    stage_async<D>(Vs, v + kv_off, k0, kv_stride, Skv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kWindow) {
      // the key chunks the warp's rows see, and those they all see whole
      const uint2 blocks = warp_blocks(qw0, k0, false, causal, window);
      if (blocks.y == 0xFu) {
        dq_tile<D, kTileFull>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, blocks, warp, qw0, k0, Sq, Skv,
                              causal, window, scale_log2);
      } else {
        dq_tile<D, kTileCut>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, blocks, warp, qw0, k0, Sq, Skv,
                             causal, window, scale_log2);
      }
    } else if (causal && k0 == q0) {
      dq_tile<D, kTileDiag>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, uint2{}, warp, qw0, k0, Sq, Skv,
                            causal, window, scale_log2);
    } else {  // before the diagonal, or no mask: every pair kept
      dq_tile<D, kTileFull>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, uint2{}, warp, qw0, k0, Sq, Skv,
                            causal, window, scale_log2);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dq + q_off + int64_t(row) * q_stride + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(dq_acc[dt][2 * r] * scale, dq_acc[dt][2 * r + 1] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* lse, const void* dout, void* dq, void* dk, void* dv, void* delta,
                   int B, int Sq, int Skv, int Hq, int Hkv, bool causal, int window,
                   cudaStream_t stream) {
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  constexpr size_t smem = kMma ? mma_smem_bytes<D>() : bwd_smem_bytes<D>();
  constexpr int threads = kMma ? kMmaThreads : kThreads;
  using DkdvFn = void (*)(const T*, const T*, const T*, const T*, const float*, const float*, T*,
                          T*, int, int, int, int, int, bool, int, float);
  using DqFn = void (*)(const T*, const T*, const T*, const T*, const float*, const float*, T*,
                        int, int, int, int, int, bool, int, float);
  DkdvFn dkdv;
  DqFn dqk;
  if constexpr (kMma) {  // the window's tile modes only where there is one
    dkdv = window > 0 ? flash_bwd_dkdv_mma_kernel<D, true> : flash_bwd_dkdv_mma_kernel<D, false>;
    dqk = window > 0 ? flash_bwd_dq_mma_kernel<D, true> : flash_bwd_dq_mma_kernel<D, false>;
  } else {
    dkdv = flash_bwd_dkdv_kernel<T, D>;
    dqk = flash_bwd_dq_kernel<T, D>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = float(pow(double(D), -0.5));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dt = static_cast<float*>(delta);
  const int n_rows = B * Sq * Hq, rows_per_cta = kThreads / 32;
  flash_bwd_delta_kernel<T, D><<<(n_rows + rows_per_cta - 1) / rows_per_cta, kThreads, 0,
                                 stream>>>(static_cast<const T*>(out), gt, dt, n_rows, Sq, Hq);
  const int n_kt = (Skv + kT - 1) / kT, n_qt = (Sq + kT - 1) / kT;
  dkdv<<<n_kt * B * Hkv, threads, smem, stream>>>(qt, kt, vt, gt, lt, dt, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), B, Sq, Skv, Hq, Hkv,
                                                  causal, window, scale);
  dqk<<<n_qt * B * Hq, threads, smem, stream>>>(qt, kt, vt, gt, lt, dt, static_cast<T*>(dq), B,
                                                Sq, Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, const void* out,
                         const void* lse, const void* dout, void* dq, void* dk, void* dv,
                         void* delta, int B, int Sq, int Skv, int Hq, int Hkv, bool causal,
                         int window, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv, causal,
                           window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv, causal,
                           window, s);
    case 80:
      return launch<T, 80>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv, causal,
                           window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                            causal, window, s);
    default: return cudaErrorNotSupported;
  }
}

}  // namespace
}  // namespace repro_torch

// q, out, dout, dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Skv, Hkv, D), all
// contiguous, of one dtype (0 = float32, 1 = bfloat16); lse: (B, Hq, Sq)
// float32 from the forward; delta: a (B, Hq, Sq) float32 workspace.
// causal, window, prefix_len and use_pwl name the forward's mode; exact
// attention with or without the causal mask and with or without a window
// (window > 0 masks keys window or more positions before the query; 0 is
// none) has a backward here, and a prefix, PWL exp, or D outside 32 / 64 /
// 80 / 128 returns cudaErrorNotSupported without a launch.  Returns
// cudaGetLastError() after the three launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int dtype, int causal, int window,
                                   int prefix_len, int use_pwl, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  if (prefix_len != 0 || use_pwl) return cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dim<float>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq,
                               Hkv, causal != 0, window, s);
  }
  if (dtype == 1) {
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv,
                                       Hq, Hkv, causal != 0, window, s);
  }
  return cudaErrorInvalidValue;
}
