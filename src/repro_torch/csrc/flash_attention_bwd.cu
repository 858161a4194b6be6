// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of exact
// attention with GQA, causal or not (Sq may differ from Skv), with or
// without a sliding window or a bidirectional prefix, float32 (SIMT) and
// bfloat16 (tensor cores), D = 32, 64, 80, 128 or 256.
//
// The reference has no backward kernel: its training step differentiates
// repro.models.attention.full_attention / flash_attention with XLA's
// autodiff.  This is the counterpart of that autodiff for the port's
// forward kernel (flash_attention.cu), which hands over each row's
// log-sum-exp lse = m + log l of its scaled scores.  With scale = D^-0.5,
// S = scale Q K^T and a key valid for a query when kpos < Skv, qpos < Sq,
// under the causal mask kpos <= qpos or, with a prefix (prefix_len > 0),
// kpos < prefix_len (the prefix-LM rule cm |= kpos < prefix_len of
// full_attention), and under a window (window > 0) qpos - kpos < window
// (repro.models.attention._chunk_mask):
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
//   else from 0, and from 0 for a tile that holds a prefix key; under a
//   window only to the tile of row k0 + 62 + window); a tile recomputes P
//   and dS and adds P^T dO and dS^T Q to dV and dK, held in registers to
//   the end.
// - dQ: one CTA per (b, query head, 64-row query tile), longest first,
//   over the key tiles that hold a key its rows see (key_tiles: under a
//   window from the tile of key q0 - window + 1; under the causal mask to
//   the tile of its last row, and on to the prefix's last key); it
//   recomputes P and dS and adds dS K to dQ in registers.
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
// adds dS K.  A-fragments of K, V, Q and dO are read by ldmatrix from
// shared memory where they are used, never held.  P and dS are multiplied
// as hi + lo bf16 terms (~2^-17 of the float32 value), as the forward
// multiplies P, so the gradients agree with the float32 plain version
// before their one rounding to bf16.  exp is the SFU's ex2.approx, as in
// the forward.  A warp's share of a tile is compiled apart for each way the
// mask keeps its pairs (kTileFull: every pair, no branch between its
// products; kTileDiag: the causal diagonal, the warp's own 16 x 16 block
// cut; kTileCut: a window's or a prefix's), and each kernel is compiled
// apart with a window (kWindow) and with a prefix (kPrefix), so that a
// call without them runs none of their code.
//
// D 256 (paligemma), bf16: a dK/dV warp's dK and dV of 16 keys over 256
// columns would be 2 x 16 x 256 / 32 = 256 float32 registers a lane, past
// the 255 a thread may hold (at D 128 the kernel holds 128 of them and
// sits at 255 registers).  So two CTAs share a (b, KV head, key tile)
// (kDkdvSplit): each takes S^T and dP^T over all 256 columns and adds P^T
// dO and dS^T Q into its own 128 columns only, the per-lane load of D 128.
// The price is S^T and dP^T taken twice; the gain besides is the grid: at
// paligemma's train shape (B4, one KV head, 20 key tiles) 80 CTAs would
// leave 52 of the 132 SMs idle, 160 do not.  A dQ warp's 16 rows x 256
// columns are 128 float32 registers a lane, as dK + dV at D 128, so dQ
// keeps its columns whole.  Four 64 x 264 bf16 tiles, lse and Delta take
// 135,680 bytes of shared memory: one CTA an SM.
//
// float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): SIMT FMAs (no
// TF32), tiles staged as float32, rows padded by one float against bank
// conflicts; a thread computes a 4 x 4 block of a 64 x 64 score tile.  At D
// 256 four 64 x 257 float32 tiles alone would pass the 232,448 bytes a
// block may take, so the tile is 32 rows / keys there (kSimtTile: 140,288
// bytes) and a thread computes a 2 x 2 block of the 32 x 32 score tile.
//
// NaN: a gradient depends on exactly the (query, key) pairs the mask keeps,
// as in the plain version (kernels/flash_attention.flash_attention_bwd_plain):
// P and dS are selected, not multiplied, to 0 on masked pairs.  On a tile
// that the causal diagonal, the window's lower edge or the prefix's edge
// cuts, the SIMT path adds a pair's term under a select.  The mma path
// takes each warp's four 16 x 16 blocks (16 keys or rows of the warp
// against a 16-row or 16-key chunk of the tile): a block with no kept pair
// is skipped, a block whose every pair is kept goes through mma.sync, and a
// block that the diagonal or a mask's edge cuts is added pair by pair (a
// masked pair's 0 times a NaN row in a product would be NaN).  Without a
// window or a prefix only the diagonal's block is cut; with one, block_kept
// sorts the blocks, since the edge cuts them at any offset (neither a
// window nor a prefix need be a multiple of 16).  So a NaN in dO, Q, K or V
// reaches the gradients of the pairs that see it and no other.  A NaN lse
// (a row that saw a NaN score) makes that row's P NaN on its kept keys.  A
// row that sees no key has lse = +inf: P = 0.  Rows past Sq and keys past
// Skv are staged as zeros and their P and dS selected to 0, so they add
// nothing to a real row's or key's gradient, NaN or not (0 times a staged
// 0); a padded key's or row's own gradient, where a real NaN may reach it,
// is never stored.
//
// Refused: PWL exp and D outside 32 / 64 / 80 / 128 / 256
// (cudaErrorNotSupported); a prefix with a window or without the causal
// mask, as the forward refuses it (cudaErrorInvalidValue).
//
// Build: the 35 kernels of every head dim, dtype and mask take ptxas
// minutes in one process, so the file is compiled as several translation
// units in parallel and linked into one library (kernels/_build.py,
// PARTS): without FLASH_BWD_PART it holds the C entry and the dispatch;
// with FLASH_BWD_PART = 1 .. 8 the kernels and the launches of its share
// of (dtype, D, mask) (INSTANCES at the end).
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {

// the mask a launch is compiled for: the causal mask on or off and nothing
// else (kMaskPlain; float32 takes a window here too, at run time), a
// sliding window (kMaskWindow, bfloat16), a bidirectional prefix
// (kMaskPrefix)
enum { kMaskPlain = 0, kMaskWindow = 1, kMaskPrefix = 2 };

#define FLASH_BWD_LAUNCH_ARGS                                                                 \
  const void *q, const void *k, const void *v, const void *out, const void *lse,            \
      const void *dout, void *dq, void *dk, void *dv, void *delta, int B, int Sq, int Skv,  \
      int Hq, int Hkv, bool causal, int window, int prefix, cudaStream_t stream

// Delta, dK/dV and dQ of one dtype, head dim and mask: three launches on
// `stream`; defined and instantiated in the parts
template <typename T, int D, int kMask>
cudaError_t launch(FLASH_BWD_LAUNCH_ARGS);

}  // namespace repro_torch

#ifdef FLASH_BWD_PART
namespace repro_torch {
namespace {

constexpr int kT = 64;  // query rows of a query tile, keys of a key tile
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may take

// the SIMT kernels' tile: 64 rows / keys, 32 at D 256
template <int D>
constexpr int kSimtTile = D > 128 ? 32 : kT;

template <int D, int TT>
constexpr size_t bwd_smem_bytes() {
  // four TT x D tiles, two TT x TT tiles, lse and Delta of TT rows
  return sizeof(float) * (4 * size_t(TT) * (D + 1) + 2 * size_t(TT) * (TT + 1) + 2 * TT);
}

// the mask keeps the pair: the key at or before the query under the causal
// mask, fewer than window positions before it under a window (window 0:
// none); kPrefix (the causal mask, no window): also a key below prefix.
// The Sq / Skv edges are checked apart.
template <bool kPrefix>
__device__ __forceinline__ bool pair_kept(int qpos, int kpos, bool causal, int window,
                                          int prefix) {
  if constexpr (kPrefix) {
    return kpos <= qpos || kpos < prefix;
  } else {
    return (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
  }
}

// which pairs of rows [r0, r0 + n) against keys [c0, c0 + n) the mask keeps
enum { kNone = 0, kSome = 1, kAll = 2 };
template <bool kPrefix>
__device__ __forceinline__ int block_kept(int r0, int c0, int n, bool causal, int window,
                                          int prefix) {
  const int r1 = r0 + n - 1, c1 = c0 + n - 1;
  if constexpr (kPrefix) {  // whole inside the prefix or below the diagonal
    if (c1 < prefix || c1 <= r0) return kAll;
    return c0 < prefix || c0 <= r1 ? kSome : kNone;
  } else {
    if ((causal && r1 < c0) || (window > 0 && r0 - c1 >= window)) return kNone;
    if ((!causal || c1 <= r0) && (window <= 0 || r1 - c0 < window)) return kAll;
    return kSome;
  }
}

// the query tiles [x, y) of TT rows that hold a row some key of [k0, k0 +
// TT) sees; a prefix key is seen by every row
template <bool kPrefix, int TT>
__device__ __forceinline__ int2 query_tiles(int k0, int Sq, bool causal, int window, int prefix) {
  const int n_qt = (Sq + TT - 1) / TT;
  if constexpr (kPrefix) {
    return make_int2(k0 < prefix ? 0 : k0 / TT, n_qt);
  } else {
    const int hi = window > 0 ? min(n_qt, (k0 + TT - 2 + window) / TT + 1) : n_qt;
    return make_int2(causal ? k0 / TT : 0, hi);
  }
}

// the key tiles [x, y) of TT keys that hold a key some row of [q0, min(q0 +
// TT, Sq)) sees; with a prefix also every tile of a prefix key
template <bool kPrefix, int TT>
__device__ __forceinline__ int2 key_tiles(int q0, int Sq, int Skv, bool causal, int window,
                                          int prefix) {
  const int n_kt = (Skv + TT - 1) / TT;
  int hi = causal ? min(n_kt, (min(q0 + TT, Sq) - 1) / TT + 1) : n_kt;
  if constexpr (kPrefix) hi = max(hi, min(n_kt, (prefix + TT - 1) / TT));
  return make_int2(window > 0 ? max(0, q0 - window + 1) / TT : 0, hi);
}

// rows [row0, row0 + TT) of a matrix with row_stride elements between rows
// into a padded float32 tile; zeros past n_valid
template <typename T, int D, int TT>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int64_t row_stride,
                                      int n_valid) {
  for (int idx = threadIdx.x; idx < TT * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n_valid ? to_float(src[int64_t(row) * row_stride + c]) : 0.f;
  }
}

// TT values of a (.., Sq) float32 row vector from q0 on; `pad` past Sq
template <int TT>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int q0, int Sq,
                                          float pad) {
  if (threadIdx.x < TT) dst[threadIdx.x] = q0 + threadIdx.x < Sq ? src[q0 + threadIdx.x] : pad;
}

// P and dS of a TT-row query tile against a TT-key tile into Ps and dSs
// (row r at r * (TT + 1)): this thread's R = TT / 16 rows ty * R + i and R
// keys tx + 16 j.
template <int D, int TT, bool kPrefix>
__device__ __forceinline__ void probs_and_dscores(const float* Qs, const float* Ks,
                                                  const float* dOs, const float* Vs,
                                                  const float* lse_s, const float* delta_s,
                                                  float* Ps, float* dSs, int q0, int k0, int Sq,
                                                  int Skv, bool causal, int window, int prefix,
                                                  float scale) {
  constexpr int DP = D + 1, TP = TT + 1, R = TT / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], kv[R], ov[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(ty * R + i) * DP + d];
      ov[i] = dOs[(ty * R + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = Ks[(tx + 16 * j) * DP + d];
      vv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      const bool ok =
          qpos < Sq && kpos < Skv && pair_kept<kPrefix>(qpos, kpos, causal, window, prefix);
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      Ps[r * TP + c] = p;
      dSs[r * TP + c] = ok ? p * (dp[i][j] - delta_s[r]) : 0.f;
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

template <typename T, int D, int TT, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int B, int Sq, int Skv, int Hq, int Hkv, bool causal, int window,
                      int prefix, float scale) {
  constexpr int DP = D + 1, CPT = D / 16, TP = TT + 1, R = TT / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TT * DP;
  float* Qs = Vs + TT * DP;
  float* dOs = Qs + TT * DP;
  float* Ps = dOs + TT * DP;
  float* dSs = Ps + TT * TP;
  float* lse_s = dSs + TT * TP;
  float* delta_s = lse_s + TT;

  // the longest CTAs (first key tiles: most query tiles) first
  const int n_bkv = B * Hkv;
  const int kt = blockIdx.x / n_bkv, bkv = blockIdx.x % n_bkv;
  const int b = bkv / Hkv, hk = bkv % Hkv, G = Hq / Hkv;
  const int k0 = kt * TT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const int64_t kv_off = (int64_t(b) * Skv * Hkv + hk) * D;

  stage<T, D, TT>(Ks, k + kv_off, k0, kv_stride, Skv);
  stage<T, D, TT>(Vs, v + kv_off, k0, kv_stride, Skv);

  float dk_acc[R][CPT], dv_acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int2 tiles = query_tiles<kPrefix, TT>(k0, Sq, causal, window, prefix);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t q_off = (int64_t(b) * Sq * Hq + h) * D;
    const int64_t row_off = (int64_t(b) * Hq + h) * Sq;
    for (int qt = tiles.x; qt < tiles.y; ++qt) {
      const int q0 = qt * TT;
      __syncthreads();  // the tile before is consumed
      stage<T, D, TT>(Qs, q + q_off, q0, q_stride, Sq);
      stage<T, D, TT>(dOs, dout + q_off, q0, q_stride, Sq);
      stage_row<TT>(lse_s, lse + row_off, q0, Sq, INFINITY);
      stage_row<TT>(delta_s, delta + row_off, q0, Sq, 0.f);
      __syncthreads();
      probs_and_dscores<D, TT, kPrefix>(Qs, Ks, dOs, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                                        Skv, causal, window, prefix, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows; on a tile that the
      // diagonal or a mask's edge cuts a masked pair adds nothing (a
      // select, so a NaN of its row stays out)
      const bool cut = block_kept<kPrefix>(q0, k0, TT, causal, window, prefix) != kAll;
#pragma unroll 2
      for (int r = 0; r < TT; ++r) {
        float p[R], ds[R], ov[CPT], qv[CPT];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[r * TP + ty * R + i];
          ds[i] = dSs[r * TP + ty * R + i];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          ov[j] = dOs[r * DP + tx + 16 * j];
          qv[j] = Qs[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const bool keep =
              !cut || pair_kept<kPrefix>(q0 + r, k0 + ty * R + i, causal, window, prefix);
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
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int64_t at = kv_off + int64_t(key) * kv_stride + tx + 16 * j;
      dk[at] = from_float<T>(dk_acc[i][j] * scale);
      dv[at] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D, int TT, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int B, int Sq, int Skv,
                    int Hq, int Hkv, bool causal, int window, int prefix, float scale) {
  constexpr int DP = D + 1, CPT = D / 16, TP = TT + 1, R = TT / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TT * DP;
  float* Ks = dOs + TT * DP;
  float* Vs = Ks + TT * DP;
  float* Ps = Vs + TT * DP;
  float* dSs = Ps + TT * TP;
  float* lse_s = dSs + TT * TP;
  float* delta_s = lse_s + TT;

  // the longest CTAs (last query tiles: most key tiles) first
  const int n_bh = B * Hq, n_qt = (Sq + TT - 1) / TT;
  const int qt = n_qt - 1 - blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * TT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t q_stride = int64_t(Hq) * D, kv_stride = int64_t(Hkv) * D;
  const int64_t q_off = (int64_t(b) * Sq * Hq + h) * D;
  const int64_t kv_off = (int64_t(b) * Skv * Hkv + hk) * D;
  const int64_t row_off = int64_t(bh) * Sq;

  stage<T, D, TT>(Qs, q + q_off, q0, q_stride, Sq);
  stage<T, D, TT>(dOs, dout + q_off, q0, q_stride, Sq);
  stage_row<TT>(lse_s, lse + row_off, q0, Sq, INFINITY);
  stage_row<TT>(delta_s, delta + row_off, q0, Sq, 0.f);

  float dq_acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq_acc[i][j] = 0.f;

  const int2 tiles = key_tiles<kPrefix, TT>(q0, Sq, Skv, causal, window, prefix);
  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * TT;
    __syncthreads();  // the tile before is consumed
    stage<T, D, TT>(Ks, k + kv_off, k0, kv_stride, Skv);
    stage<T, D, TT>(Vs, v + kv_off, k0, kv_stride, Skv);
    __syncthreads();
    probs_and_dscores<D, TT, kPrefix>(Qs, Ks, dOs, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq, Skv,
                                      causal, window, prefix, scale);
    __syncthreads();
    // dQ += dS K over the tile's keys; on a tile that the diagonal or a
    // mask's edge cuts a masked pair adds nothing (a select)
    const bool cut = block_kept<kPrefix>(q0, k0, TT, causal, window, prefix) != kAll;
#pragma unroll 2
    for (int c = 0; c < TT; ++c) {
      float ds[R], kv[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty * R + i) * TP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool keep =
            !cut || pair_kept<kPrefix>(q0 + ty * R + i, k0 + c, causal, window, prefix);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float a = fmaf(ds[i], kv[j], dq_acc[i][j]);
          dq_acc[i][j] = keep ? a : dq_acc[i][j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
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

// the CTAs that share a key tile's dK / dV columns, each adding its D /
// split of them (see the header: D 256)
template <int D>
constexpr int kDkdvSplit = D > 128 ? 2 : 1;

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

// acc (16 x DO) += P B over the 16-row chunks kc of the shared tile `b` (64
// rows of stride kStride<D>, DO columns from `b` on) with bit kc of
// `chunks` set: P (16 x 64) from accumulators, multiplied as hi + lo bf16
// terms (~2^-17 of p) against bf16 B, as the forward multiplies P
template <int D, int DO>
__device__ __forceinline__ void mma_pb(float (&acc)[DO / 8][4], const float (&p)[8][4],
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
      for (int dp = 0; dp < DO / 16; ++dp) {
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

// acc (16 x DO) += P B over the 16 x 16 block of chunk KC, pair by pair
// where keep(h, j, c) holds for the warp's row g + 8 h and the chunk's row
// j (the tile's row c = 16 KC + j) of b: a select, so that a masked pair's
// 0 times a NaN of B adds nothing, as the plain version leaves the pair
// out.  P's values of a row are gathered from the 4 lanes of its quad.
template <int D, int DO, int KC, typename Keep>
__device__ __forceinline__ void add_block(float (&acc)[DO / 8][4], const float (&p)[8][4],
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
    for (int dt = 0; dt < DO / 8; ++dt) {
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
template <int D, int DO, typename Keep>
__device__ __forceinline__ void add_diagonal_block(float (&acc)[DO / 8][4],
                                                   const float (&p)[8][4],
                                                   const __nv_bfloat16* b, int warp, Keep keep) {
  switch (warp) {
    case 0: add_block<D, DO, 0>(acc, p, b, keep); break;
    case 1: add_block<D, DO, 1>(acc, p, b, keep); break;
    case 2: add_block<D, DO, 2>(acc, p, b, keep); break;
    default: add_block<D, DO, 3>(acc, p, b, keep); break;
  }
}

// add_block over each chunk with bit KC of `cut` set (warp-uniform)
template <int D, int DO, typename Keep>
__device__ __forceinline__ void add_cut_blocks(float (&acc)[DO / 8][4], const float (&p)[8][4],
                                               const __nv_bfloat16* b, unsigned cut, Keep keep) {
  if (cut & 1u) add_block<D, DO, 0>(acc, p, b, keep);
  if (cut & 2u) add_block<D, DO, 1>(acc, p, b, keep);
  if (cut & 4u) add_block<D, DO, 2>(acc, p, b, keep);
  if (cut & 8u) add_block<D, DO, 3>(acc, p, b, keep);
}

// the 16 x 16 blocks of a warp's 16 rows from w0 against the tile's four
// 16-key chunks from t0 (`by_key`: of its 16 keys from w0 against four
// 16-row chunks from t0): bits of the chunks with a kept pair (.x) and of
// those the mask keeps whole (.y)
template <bool kPrefix>
__device__ __forceinline__ uint2 warp_blocks(int w0, int t0, bool by_key, bool causal,
                                             int window, int prefix) {
  unsigned need = 0, full = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = by_key ? block_kept<kPrefix>(t0 + 16 * c, w0, 16, causal, window, prefix)
                         : block_kept<kPrefix>(w0, t0 + 16 * c, 16, causal, window, prefix);
    need |= unsigned(m != kNone) << c;
    full |= unsigned(m == kAll) << c;
  }
  return make_uint2(need, full);
}

// which pairs of a warp's 16 x 64 share of a tile the mask keeps, each
// mode compiled apart: every pair (kTileFull); the causal diagonal tile
// without a window or a prefix (kTileDiag: the warp's own chunk cut, a
// compile-time rule per warp); under a window or with a prefix, the chunks
// of warp_blocks (kTileCut: cut chunks pair by pair within a lane's span
// of the tile)
enum { kTileFull = 0, kTileDiag = 1, kTileCut = 2 };

// One query tile's share of a dK/dV warp's keys kw0 .. kw0 + 15: P^T and
// dS^T (16 keys x 64 rows) from S^T = K Q^T and dP^T = V dO^T over all D
// columns, then dV += P^T dO and dK += dS^T Q over the DO columns from
// col0.  blocks (kTileCut): the query chunks that see the warp's keys (.x)
// and those that see them all (.y).
template <int D, int DO, int kMode, bool kPrefix>
__device__ __forceinline__ void dkdv_tile(float (&dk_acc)[DO / 8][4], float (&dv_acc)[DO / 8][4],
                                          const __nv_bfloat16* Kw, const __nv_bfloat16* Vw,
                                          const __nv_bfloat16* Qs, const __nv_bfloat16* dOs,
                                          const float* lse_s, const float* delta_s, uint2 blocks,
                                          int warp, int q0, int kw0, int Sq, int Skv, bool causal,
                                          int window, int prefix, int col0, float scale_log2) {
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
      if (kMode == kTileCut) ok = ok && pair_kept<kPrefix>(qpos, key, causal, window, prefix);
      const float p = ok ? ex2_approx(fmaf(s[nt][e], scale_log2, -lse_s[ql])) : 0.f;
      dp[nt][e] = ok ? p * (dp[nt][e] - delta_s[ql]) : 0.f;
      s[nt][e] = p;
    }
  const __nv_bfloat16* dOc = dOs + col0;
  const __nv_bfloat16* Qc = Qs + col0;
  if constexpr (kMode == kTileDiag) {
    // keys 16 warp + g (+ 8) see queries 16 warp + j with j >= g (+ 8)
    auto keep = [g](int h, int j, int) { return j >= g + 8 * h; };
    add_diagonal_block<D, DO>(dv_acc, s, dOc, warp, keep);
    add_diagonal_block<D, DO>(dk_acc, dp, Qc, warp, keep);
  } else if constexpr (kMode == kTileCut) {
    const unsigned cut = need & ~full;
    if (cut) {
      const int first = kw0 + g - q0;
      if constexpr (kPrefix) {
        // key kw0 + g (+ 8) sees query q0 + c for c from key - q0 on, and
        // every query where it lies below the prefix's end
        const int pre = prefix - q0;
        auto keep = [first, pre](int h, int, int c) {
          return first + 8 * h <= c || first + 8 * h < pre;
        };
        add_cut_blocks<D, DO>(dv_acc, s, dOc, cut, keep);
        add_cut_blocks<D, DO>(dk_acc, dp, Qc, cut, keep);
      } else {
        // key kw0 + g (+ 8) sees query q0 + c for c from key - q0 (causal)
        // to below key - q0 + window
        auto keep = [first, causal, window](int h, int, int c) {
          return (!causal || first + 8 * h <= c) && c < first + 8 * h + window;
        };
        add_cut_blocks<D, DO>(dv_acc, s, dOc, cut, keep);
        add_cut_blocks<D, DO>(dk_acc, dp, Qc, cut, keep);
      }
    }
  }
  mma_pb<D, DO>(dv_acc, s, dOc, full);
  mma_pb<D, DO>(dk_acc, dp, Qc, full);
}

// One key tile's share of a dQ warp's rows qw0 .. qw0 + 15: dS (16 rows x
// 64 keys) from S = Q K^T and dP = dO V^T, then dQ += dS K.  blocks and
// kMode as in dkdv_tile, over the tile's 16-key chunks.
template <int D, int kMode, bool kPrefix>
__device__ __forceinline__ void dq_tile(float (&dq_acc)[D / 8][4], const __nv_bfloat16* Qw,
                                        const __nv_bfloat16* dOw, const __nv_bfloat16* Ks,
                                        const __nv_bfloat16* Vs, const float (&lse2)[2],
                                        const float (&dlt)[2], uint2 blocks, int warp, int qw0,
                                        int k0, int Sq, int Skv, bool causal, int window,
                                        int prefix, float scale_log2) {
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
      if (kMode == kTileCut) ok = ok && pair_kept<kPrefix>(row, key, causal, window, prefix);
      const float p = ok ? ex2_approx(fmaf(s[nt][e], scale_log2, -lse2[e >> 1])) : 0.f;
      s[nt][e] = ok ? p * (dp[nt][e] - dlt[e >> 1]) : 0.f;  // dS
    }
  if constexpr (kMode == kTileDiag) {
    // rows 16 warp + g (+ 8) see keys 16 warp + j with j <= g (+ 8)
    add_diagonal_block<D, D>(dq_acc, s, Ks, warp,
                             [g](int h, int j, int) { return j <= g + 8 * h; });
  } else if constexpr (kMode == kTileCut) {
    const unsigned cut = need & ~full;
    if (cut) {
      const int last = qw0 + g - k0;
      if constexpr (kPrefix) {
        // row qw0 + g (+ 8) sees key k0 + c for c up to row - k0, and every
        // key below the prefix's end
        const int pre = prefix - k0;
        auto keep = [last, pre](int h, int, int c) { return c <= last + 8 * h || c < pre; };
        add_cut_blocks<D, D>(dq_acc, s, Ks, cut, keep);
      } else {
        // row qw0 + g (+ 8) sees key k0 + c for c above row - k0 - window and
        // up to row - k0 (causal)
        auto keep = [last, causal, window](int h, int, int c) {
          return (!causal || c <= last + 8 * h) && c > last + 8 * h - window;
        };
        add_cut_blocks<D, D>(dq_acc, s, Ks, cut, keep);
      }
    }
  }
  mma_pb<D, D>(dq_acc, s, Ks, full);
}

// dK and dV on the tensor cores: a CTA of 4 warps per (b, KV head, 64
// keys, share of kDkdvSplit of the columns), each warp 16 keys.  A warp
// takes S^T = K Q^T and dP^T = V dO^T (16 keys x 64 query rows), so that
// P^T and dS^T are in registers in the A-fragment layout of dV += P^T dO
// and dK += dS^T Q.  A warp skips the 16-row chunks of queries that see
// none of its keys (before them, or past their window) and adds the chunks
// that the diagonal or a mask's edge cuts pair by pair.  kWindow / kPrefix:
// compiled for window > 0 / prefix > 0 (kTileCut on a tile the mask cuts);
// without them a tile is the causal diagonal (kTileDiag) or kept whole.
template <int D, bool kWindow, bool kPrefix>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv, int Hq, int Hkv,
                          bool causal, int window, int prefix, float scale) {
  constexpr int kS = kStride<D>, kTile = kT * kS, kSplit = kDkdvSplit<D>, DO = D / kSplit;
  constexpr int kDT = DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qs = Vs + kTile;
  __nv_bfloat16* dOs = Qs + kTile;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile);  // lse * log2 e
  float* delta_s = lse_s + kT;

  // the longest CTAs (first key tiles) first; a key tile's column shares
  // side by side
  const int n_bkv = B * Hkv;
  const int kt = blockIdx.x / (n_bkv * kSplit), rem = blockIdx.x % (n_bkv * kSplit);
  const int bkv = rem / kSplit, col0 = rem % kSplit * DO;
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
  const int2 tiles = query_tiles<kPrefix, kT>(k0, Sq, causal, window, prefix);
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
      if constexpr (kWindow || kPrefix) {
        // the query chunks that see the warp's keys, and those that see all
        const uint2 blocks = warp_blocks<kPrefix>(kw0, q0, true, causal, window, prefix);
        if (blocks.y == 0xFu) {
          dkdv_tile<D, DO, kTileFull, kPrefix>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s,
                                               blocks, warp, q0, kw0, Sq, Skv, causal, window,
                                               prefix, col0, scale_log2);
        } else {
          dkdv_tile<D, DO, kTileCut, kPrefix>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s,
                                              blocks, warp, q0, kw0, Sq, Skv, causal, window,
                                              prefix, col0, scale_log2);
        }
      } else if (causal && q0 == k0) {
        dkdv_tile<D, DO, kTileDiag, false>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s,
                                           uint2{}, warp, q0, kw0, Sq, Skv, causal, window,
                                           prefix, col0, scale_log2);
      } else {  // past the diagonal, or no mask: every pair kept
        dkdv_tile<D, DO, kTileFull, false>(dk_acc, dv_acc, Kw, Vw, Qs, dOs, lse_s, delta_s,
                                           uint2{}, warp, q0, kw0, Sq, Skv, causal, window,
                                           prefix, col0, scale_log2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= Skv) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int64_t at = kv_off + int64_t(key) * kv_stride + col0 + dt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// dQ on the tensor cores: a CTA of 4 warps per (b, query head, 64 rows),
// each warp 16 rows, over the key tiles its rows see.  A warp skips the 16-key chunks that none of its rows sees
// (after them, or before their windows) and adds the chunks that the
// diagonal or a mask's edge cuts pair by pair.  kWindow and kPrefix as in
// the dK/dV kernel.
template <int D, bool kWindow, bool kPrefix>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int Hq, int Hkv,
                        bool causal, int window, int prefix, float scale) {
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
  const int2 tiles = key_tiles<kPrefix, kT>(q0, Sq, Skv, causal, window, prefix);
  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the tile before is consumed
    stage_async<D>(Ks, k + kv_off, k0, kv_stride, Skv);
    stage_async<D>(Vs, v + kv_off, k0, kv_stride, Skv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kWindow || kPrefix) {
      // the key chunks the warp's rows see, and those they all see whole
      const uint2 blocks = warp_blocks<kPrefix>(qw0, k0, false, causal, window, prefix);
      if (blocks.y == 0xFu) {
        dq_tile<D, kTileFull, kPrefix>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, blocks, warp, qw0, k0,
                                       Sq, Skv, causal, window, prefix, scale_log2);
      } else {
        dq_tile<D, kTileCut, kPrefix>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, blocks, warp, qw0, k0,
                                      Sq, Skv, causal, window, prefix, scale_log2);
      }
    } else if (causal && k0 == q0) {
      dq_tile<D, kTileDiag, false>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, uint2{}, warp, qw0, k0, Sq,
                                   Skv, causal, window, prefix, scale_log2);
    } else {  // before the diagonal, or no mask: every pair kept
      dq_tile<D, kTileFull, false>(dq_acc, Qw, dOw, Ks, Vs, lse2, dlt, uint2{}, warp, qw0, k0, Sq,
                                   Skv, causal, window, prefix, scale_log2);
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

}  // namespace

template <typename T, int D, int kMask>
cudaError_t launch(FLASH_BWD_LAUNCH_ARGS) {
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  constexpr bool kWindow = kMask == kMaskWindow, kPrefix = kMask == kMaskPrefix;
  constexpr int TT = kMma ? kT : kSimtTile<D>;
  constexpr size_t smem = kMma ? mma_smem_bytes<D>() : bwd_smem_bytes<D, TT>();
  static_assert(smem <= size_t(kMaxSmem), "a block's shared memory");
  constexpr int threads = kMma ? kMmaThreads : kThreads;
  constexpr int kv_split = kMma ? kDkdvSplit<D> : 1;
  using DkdvFn = void (*)(const T*, const T*, const T*, const T*, const float*, const float*, T*,
                          T*, int, int, int, int, int, bool, int, int, float);
  using DqFn = void (*)(const T*, const T*, const T*, const T*, const float*, const float*, T*,
                        int, int, int, int, int, bool, int, int, float);
  DkdvFn dkdv;
  DqFn dqk;
  if constexpr (kMma) {
    dkdv = flash_bwd_dkdv_mma_kernel<D, kWindow, kPrefix>;
    dqk = flash_bwd_dq_mma_kernel<D, kWindow, kPrefix>;
  } else {
    static_assert(!kWindow, "float32 takes a window at run time");
    dkdv = flash_bwd_dkdv_kernel<T, D, TT, kPrefix>;
    dqk = flash_bwd_dq_kernel<T, D, TT, kPrefix>;
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
  const int n_kt = (Skv + TT - 1) / TT, n_qt = (Sq + TT - 1) / TT;
  dkdv<<<n_kt * B * Hkv * kv_split, threads, smem, stream>>>(
      qt, kt, vt, gt, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), B, Sq, Skv, Hq, Hkv,
      causal, window, prefix, scale);
  dqk<<<n_qt * B * Hq, threads, smem, stream>>>(qt, kt, vt, gt, lt, dt, static_cast<T*>(dq), B,
                                                Sq, Skv, Hq, Hkv, causal, window, prefix, scale);
  return cudaGetLastError();
}

#define FLASH_BWD_INSTANCE(T, D, M) template cudaError_t launch<T, D, M>(FLASH_BWD_LAUNCH_ARGS);
#define FLASH_BWD_FLOAT32(D)                         \
  FLASH_BWD_INSTANCE(float, D, kMaskPlain)           \
  FLASH_BWD_INSTANCE(float, D, kMaskPrefix)
#define FLASH_BWD_BF16(D, M) FLASH_BWD_INSTANCE(__nv_bfloat16, D, M)

// INSTANCES: each part's share, about even in ptxas time (the bf16 kernels
// at D 128 and 256 take the most)
#if FLASH_BWD_PART == 1
FLASH_BWD_FLOAT32(32)
FLASH_BWD_FLOAT32(64)
FLASH_BWD_FLOAT32(80)
FLASH_BWD_FLOAT32(128)
FLASH_BWD_FLOAT32(256)
FLASH_BWD_BF16(32, kMaskPlain)
FLASH_BWD_BF16(32, kMaskWindow)
FLASH_BWD_BF16(32, kMaskPrefix)
#elif FLASH_BWD_PART == 2
FLASH_BWD_BF16(64, kMaskPlain)
FLASH_BWD_BF16(64, kMaskWindow)
FLASH_BWD_BF16(64, kMaskPrefix)
#elif FLASH_BWD_PART == 3
FLASH_BWD_BF16(80, kMaskPlain)
FLASH_BWD_BF16(80, kMaskWindow)
FLASH_BWD_BF16(80, kMaskPrefix)
#elif FLASH_BWD_PART == 4
FLASH_BWD_BF16(128, kMaskPlain)
FLASH_BWD_BF16(128, kMaskPrefix)
#elif FLASH_BWD_PART == 5
FLASH_BWD_BF16(128, kMaskWindow)
#elif FLASH_BWD_PART == 6
FLASH_BWD_BF16(256, kMaskPlain)
#elif FLASH_BWD_PART == 7
FLASH_BWD_BF16(256, kMaskWindow)
#elif FLASH_BWD_PART == 8
FLASH_BWD_BF16(256, kMaskPrefix)
#else
#error "FLASH_BWD_PART is 1 .. 8"
#endif

}  // namespace repro_torch
#else  // the C entry

namespace repro_torch {
namespace {

// the mask's launch of one dtype and head dim: float32 takes a window at
// run time in its plain kernels
template <typename T, int D>
cudaError_t launch_mask(FLASH_BWD_LAUNCH_ARGS) {
  if (prefix > 0)
    return launch<T, D, kMaskPrefix>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq,
                                     Hkv, causal, window, prefix, stream);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (window > 0)
      return launch<T, D, kMaskWindow>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv,
                                       Hq, Hkv, causal, window, prefix, stream);
  }
  return launch<T, D, kMaskPlain>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                                  causal, window, prefix, stream);
}

template <typename T>
cudaError_t dispatch_dim(int D, FLASH_BWD_LAUNCH_ARGS) {
  switch (D) {
    case 32:
      return launch_mask<T, 32>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                                causal, window, prefix, stream);
    case 64:
      return launch_mask<T, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                                causal, window, prefix, stream);
    case 80:
      return launch_mask<T, 80>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                                causal, window, prefix, stream);
    case 128:
      return launch_mask<T, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                                 causal, window, prefix, stream);
    case 256:
      return launch_mask<T, 256>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq, Hkv,
                                 causal, window, prefix, stream);
    default: return cudaErrorNotSupported;
  }
}

}  // namespace
}  // namespace repro_torch

// q, out, dout, dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Skv, Hkv, D), all
// contiguous, of one dtype (0 = float32, 1 = bfloat16); lse: (B, Hq, Sq)
// float32 from the forward; delta: a (B, Hq, Sq) float32 workspace.
// causal, window, prefix_len and use_pwl name the forward's mode; exact
// attention with or without the causal mask, with or without a window
// (window > 0 masks keys window or more positions before the query; 0 is
// none), and with or without a prefix (prefix_len > 0 makes keys below it
// visible to every query; causal only, without a window) has a backward
// here.  PWL exp or D outside 32 / 64 / 80 / 128 / 256 returns
// cudaErrorNotSupported, and a prefix the forward refuses
// cudaErrorInvalidValue, without a launch.  Returns cudaGetLastError()
// after the three launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int dtype, int causal, int window,
                                   int prefix_len, int use_pwl, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      prefix_len < 0 || (prefix_len > 0 && (!causal || window > 0)))
    return cudaErrorInvalidValue;
  if (use_pwl) return cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dim<float>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, Hq,
                               Hkv, causal != 0, window, prefix_len, s);
  }
  if (dtype == 1) {
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv,
                                       Hq, Hkv, causal != 0, window, prefix_len, s);
  }
  return cudaErrorInvalidValue;
}
#endif  // FLASH_BWD_PART
