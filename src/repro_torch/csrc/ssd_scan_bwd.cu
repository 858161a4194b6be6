// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a): dx, ddt,
// da_neg, dB and dC from the gradients of y and of the final state.
//
// The reference has no backward kernel: its training step differentiates
// repro/models/ssm.py:ssd_chunked (the function the Pallas kernel
// repro/kernels/ssd_scan.py:ssd_scan computes) with XLA's autodiff.  This
// is the counterpart of that autodiff for the port's forward kernel
// (ssd_scan.cu), which hands over y and the final state.  Its plain
// version is kernels/ssd_scan.ssd_scan_bwd_plain, the same recursion.
//
// The function, per (batch, head), with a = a_neg[h], u_t = dt_t x_t,
// h_t the (P, N) state after row t and y_t = h_t C_t:
//   g_s   = sum_{t >= s} exp(cs_t - cs_s) dy_t C_t^T
//           + exp(cs_last - cs_s) dstate          (dL/dh_s, (P, N))
//   du_s  = g_s B_s,   dx_s = dt_s du_s
//   dB_s  = sum_h g_s^T u_s,   dC_t = sum_h h_t^T dy_t
//   dcs_t = dy_t . y_t - u_t . du_t   (+ <dstate, h_last> at the last row)
//   da_t  = sum_{t' >= t} dcs_t'      (the gradient of a_t = dt_t a)
//   ddt_s = x_s . du_s + a da_s,   da_neg = sum_{b, s} dt_s da_s.
// Over sub-chunks of kL rows, with cs the cumsum of dt a within the
// sub-chunk, M = (C B^T) o exp(cs_l - cs_m) and W = (dy u^T) o exp(cs_l -
// cs_m) on m <= l (exp taken only there, where the exponent is <= 0: the
// decay reaches ~-180 over 256 rows), G = dL/dh at the sub-chunk's end and
// h0 the state at its start:
//   du = M^T dy + exp(cs_last - cs) o (B G^T)
//   dB = W^T C + exp(cs_last - cs) o (u G)            (one head's share)
//   dC = W B + exp(cs) o (dy h0)                       (one head's share)
//   G  <- exp(cs_last) G + (exp(cs) o dy)^T C
//   h0 <- exp(cs_last) h0 + (dt exp(cs_last - cs) o x)^T B
// Rows past S are staged as zeros (dt = 0 too): they add nothing.
//
// Two launches on one stream, counted as one by the wrapper:
// - ssd_bwd_kernel, a grid of (batch * H, 2) CTAs.  A CTA of the second
//   column walks its (batch, head)'s sub-chunks in reverse, carrying G in
//   shared memory and the running sum of dcs in registers: it writes dx
//   and ddt, its head's share of dB and its share of da_neg.  A CTA of the
//   first column walks them in order, carrying h0 as the forward does, and
//   writes its head's share of dC.  The two walks need nothing of each
//   other, so they run side by side and no chunk states are stored.
// - ssd_bwd_reduce_kernel sums the shares in a fixed order: dB and dC over
//   the heads, da_neg over the batch.  B and C have one group shared by
//   every head, so their gradients are sums across CTAs; the shares go
//   through a float32 workspace (2 * batch * H * S * N + batch * H floats:
//   671 MB at mamba2's train shape b8 S1024 H80 N128) instead of float
//   atomics, so two runs agree bit for bit.
//
// What bounds it on an H100: the function's least work, its recurrent
// form, is ~12 P N FLOP per row and head against ~12 P bytes (bf16 x and
// dx, float32 dy and y): N FLOP per byte, below the bf16 tensor cores'
// balance point (~295), so the card's bound is the bytes (0.154 ms at
// mamba2's train shape b8 S1024 H80 P64 N128, at the H100 SXM data sheet's
// 3.35 TB/s for a card at its 700 W limit).  This first version runs
// float32 FMAs on the SIMT cores throughout (no TF32; bf16 x/B/C widened as
// they are staged), whose balance point (~20) it is far above: there it is
// bound by its operations, 5 P N + 3 kL (P + N) FMAs per row and head
// (~59k at P 64, N 128, kL 32; 1.16 ms at the train shape at 67 TFLOP/s).
// Every product is a register-tiled loop over shared memory (rows padded
// by one float, so row and column walks are free of bank conflicts), 256
// threads a CTA, sub-chunks of 32 rows so that two CTAs reside per SM at
// P 64, N 128 (92 KB of shared memory each).  The tensor cores are later
// work.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kL = 32;  // rows per sub-chunk: one lane a row in the scans
constexpr int kThreads = 256;

// float32 shared memory of one CTA (either walk), offsets in floats
template <int P, int N>
struct Smem {
  static constexpr int PP = P + 1, NP = N + 1, LP = kL + 1;  // padded rows
  static constexpr int kX = 0;                  // x             kL x PP
  static constexpr int kDY = kX + kL * PP;      // dy            kL x PP
  static constexpr int kB = kDY + kL * PP;      // B             kL x NP
  static constexpr int kC = kB + kL * NP;       // C             kL x NP
  static constexpr int kM = kC + kL * NP;       // M             kL x LP
  static constexpr int kW = kM + kL * LP;       // W             kL x LP
  static constexpr int kG = kW + kL * LP;       // G or h0       P x NP
  static constexpr int kVec = kG + P * NP;      // 7 vectors of kL
  static constexpr int kFloats = kVec + 7 * kL;
  static constexpr size_t kBytes = size_t(kFloats) * sizeof(float);
};

// A ROWS x COLS output over the CTA's threads: TX threads along the
// columns (a warp spans whole rows where COLS >= 32), each thread rows ty +
// i TY and columns tx + j TX.
template <int ROWS, int COLS>
struct Tiling {
  static constexpr int TX = COLS < 32 ? COLS : 32;
  static constexpr int TY = kThreads / TX;
  static constexpr int R = ROWS / TY, C = COLS / TX;
  static_assert(TX * TY == kThreads && R * TY == ROWS && C * TX == COLS, "tiling");
};

// acc[i][j] += sum_k a(row_i, k) b(k, col_j), k in [0, K), in order of k
template <int ROWS, int COLS, int K, typename A, typename Bf>
__device__ __forceinline__ void tile_product(
    float (&acc)[Tiling<ROWS, COLS>::R][Tiling<ROWS, COLS>::C], A a, Bf b) {
  using Tl = Tiling<ROWS, COLS>;
  const int ty = threadIdx.x / Tl::TX, tx = threadIdx.x % Tl::TX;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[Tl::R], bv[Tl::C];
#pragma unroll
    for (int i = 0; i < Tl::R; ++i) av[i] = a(ty + i * Tl::TY, k);
#pragma unroll
    for (int j = 0; j < Tl::C; ++j) bv[j] = b(k, tx + j * Tl::TX);
#pragma unroll
    for (int i = 0; i < Tl::R; ++i)
#pragma unroll
      for (int j = 0; j < Tl::C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

struct Ptrs {
  const void *x, *dt, *a_neg, *Bm, *Cm, *y, *state, *dy, *dstate;
  void *dx, *ddt, *dB_part, *dC_part, *da_part;
  int S, H;
  int64_t x_stride, bc_stride;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_kernel(Ptrs g) {
  using Sm = Smem<P, N>;
  constexpr int PP = Sm::PP, NP = Sm::NP, LP = Sm::LP;
  extern __shared__ float smem[];
  float* Xs = smem + Sm::kX;
  float* dYs = smem + Sm::kDY;
  float* Bs = smem + Sm::kB;
  float* Cs = smem + Sm::kC;
  float* Ms = smem + Sm::kM;
  float* Ws = smem + Sm::kW;
  float* Gs = smem + Sm::kG;             // G (reverse walk) or h0 (forward walk)
  float* cs = smem + Sm::kVec;           // cumsum of dt a within the sub-chunk
  float* dts = cs + kL;                  // dt
  float* ecs = dts + kL;                 // exp(cs)
  float* ews = ecs + kL;                 // exp(cs_last - cs)
  float* wts = ews + kL;                 // dt exp(cs_last - cs)
  float* xdu = wts + kL;                 // x . du per row
  float* dcs = xdu + kL;                 // dy . y - u . du per row

  const int S = g.S, H = g.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H, bh = blockIdx.x;
  const bool reverse = blockIdx.y == 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float a = static_cast<const float*>(g.a_neg)[h];
  const int64_t row = int64_t(H) * P;  // elements between rows of dy, y, dx
  const T* xb = static_cast<const T*>(g.x) + int64_t(b) * S * g.x_stride + int64_t(h) * P;
  const T* Bb = static_cast<const T*>(g.Bm) + int64_t(b) * S * g.bc_stride;
  const T* Cb = static_cast<const T*>(g.Cm) + int64_t(b) * S * g.bc_stride;
  const float* dtb = static_cast<const float*>(g.dt) + int64_t(b) * S * H + h;
  const float* dyb = static_cast<const float*>(g.dy) + int64_t(b) * S * row + int64_t(h) * P;
  const float* yb = static_cast<const float*>(g.y) + int64_t(b) * S * row + int64_t(h) * P;
  float* part = static_cast<float*>(reverse ? g.dB_part : g.dC_part) + int64_t(bh) * S * N;

  // sub-chunk t0's rows (zeros past S) into shared memory, C only for the
  // reverse walk; then cs and its exps
  auto stage = [&](int t0, int n_valid) {
    for (int idx = tid; idx < kL * P; idx += kThreads) {
      const int r = idx / P, c = idx % P;
      const bool ok = r < n_valid;
      Xs[r * PP + c] = ok ? to_float(xb[int64_t(t0 + r) * g.x_stride + c]) : 0.f;
      dYs[r * PP + c] = ok ? dyb[int64_t(t0 + r) * row + c] : 0.f;
    }
    for (int idx = tid; idx < kL * N; idx += kThreads) {
      const int r = idx / N, c = idx % N;
      const bool ok = r < n_valid;
      const int64_t at = int64_t(t0 + r) * g.bc_stride + c;
      Bs[r * NP + c] = ok ? to_float(Bb[at]) : 0.f;
      if (reverse) Cs[r * NP + c] = ok ? to_float(Cb[at]) : 0.f;
    }
    if (warp == 0) {  // inclusive scan of dt a, one row a lane
      const float d = lane < n_valid ? dtb[int64_t(t0 + lane) * H] : 0.f;
      float incl = d * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const float last = __shfl_sync(0xffffffffu, incl, 31);  // padded rows add 0
      cs[lane] = incl;
      dts[lane] = d;
      ecs[lane] = expf(incl);
      ews[lane] = expf(last - incl);
      wts[lane] = d * expf(last - incl);
    }
    __syncthreads();
  };

  // W (and, for the reverse walk, M) of the staged sub-chunk
  auto scores = [&] {
    using Tl = Tiling<kL, kL>;
    const int ty = tid / Tl::TX, tx = tid % Tl::TX;
    float d[Tl::R][Tl::C], cb[Tl::R][Tl::C];
    zero(d);
    tile_product<kL, kL, P>(d, [&](int l, int p) { return dYs[l * PP + p]; },
                            [&](int p, int m) { return Xs[m * PP + p]; });
    if (reverse) {
      zero(cb);
      tile_product<kL, kL, N>(cb, [&](int l, int n) { return Cs[l * NP + n]; },
                              [&](int n, int m) { return Bs[m * NP + n]; });
    }
#pragma unroll
    for (int i = 0; i < Tl::R; ++i) {
      const int l = ty + i * Tl::TY;
#pragma unroll
      for (int j = 0; j < Tl::C; ++j) {
        const int m = tx + j * Tl::TX;
        const bool lower = m <= l;
        const float e = lower ? expf(cs[l] - cs[m]) : 0.f;
        Ws[l * LP + m] = lower ? d[i][j] * dts[m] * e : 0.f;
        if (reverse) Ms[l * LP + m] = lower ? cb[i][j] * e : 0.f;
      }
    }
    __syncthreads();
  };

  const int n_sub = (S + kL - 1) / kL;
  const float* dstate = static_cast<const float*>(g.dstate);
  const int64_t st_off = int64_t(bh) * P * N;

  if (!reverse) {
    // ---- in order: h0 and this head's share of dC ----------------------
    for (int i = tid; i < P * NP; i += kThreads) Gs[i] = 0.f;
    for (int sc = 0; sc < n_sub; ++sc) {
      const int t0 = sc * kL, n_valid = min(kL, S - t0);
      __syncthreads();  // the sub-chunk before is consumed
      stage(t0, n_valid);
      scores();
      {  // dC = W B + exp(cs) o (dy h0)
        using Tl = Tiling<kL, N>;
        const int ty = tid / Tl::TX, tx = tid % Tl::TX;
        float wb[Tl::R][Tl::C], yh[Tl::R][Tl::C];
        zero(wb);
        zero(yh);
        tile_product<kL, N, kL>(wb, [&](int l, int m) { return Ws[l * LP + m]; },
                                [&](int m, int n) { return Bs[m * NP + n]; });
        tile_product<kL, N, P>(yh, [&](int l, int p) { return dYs[l * PP + p]; },
                               [&](int p, int n) { return Gs[p * NP + n]; });
#pragma unroll
        for (int i = 0; i < Tl::R; ++i) {
          const int l = ty + i * Tl::TY;
          if (l >= n_valid) continue;
#pragma unroll
          for (int j = 0; j < Tl::C; ++j) {
            part[int64_t(t0 + l) * N + tx + j * Tl::TX] = fmaf(ecs[l], yh[i][j], wb[i][j]);
          }
        }
      }
      __syncthreads();  // h0 is read
      {  // h0 = exp(cs_last) h0 + (dt exp(cs_last - cs) o x)^T B
        using Tl = Tiling<P, N>;
        const int ty = tid / Tl::TX, tx = tid % Tl::TX;
        float acc[Tl::R][Tl::C];
        zero(acc);
        tile_product<P, N, kL>(acc, [&](int p, int m) { return wts[m] * Xs[m * PP + p]; },
                               [&](int m, int n) { return Bs[m * NP + n]; });
        const float decay = ecs[kL - 1];
#pragma unroll
        for (int i = 0; i < Tl::R; ++i)
#pragma unroll
          for (int j = 0; j < Tl::C; ++j) {
            float& st = Gs[(ty + i * Tl::TY) * NP + tx + j * Tl::TX];
            st = fmaf(st, decay, acc[i][j]);
          }
      }
    }
    return;
  }

  // ---- in reverse: dx, ddt, this head's share of dB and of da_neg ------
  float carry = 0.f;  // sum of dcs over the rows after the sub-chunk (warp 0)
  {
    float dot = 0.f;
    for (int i = tid; i < P * NP; i += kThreads) {
      const int p = i / NP, n = i % NP;
      float gv = 0.f;
      if (dstate != nullptr && n < N) {
        gv = dstate[st_off + int64_t(p) * N + n];
        dot = fmaf(gv, static_cast<const float*>(g.state)[st_off + int64_t(p) * N + n], dot);
      }
      Gs[i] = gv;
    }
    dot = warp_sum(dot);
    if (lane == 0) dcs[warp] = dot;
    __syncthreads();
    if (warp == 0) carry = warp_sum(lane < kThreads / 32 ? dcs[lane] : 0.f);
  }
  float da_acc = 0.f;  // sum of dt da over this lane's rows (warp 0)
  T* dxb = static_cast<T*>(g.dx) + int64_t(b) * S * row + int64_t(h) * P;
  float* ddtb = static_cast<float*>(g.ddt) + int64_t(b) * S * H + h;
  for (int sc = n_sub - 1; sc >= 0; --sc) {
    const int t0 = sc * kL, n_valid = min(kL, S - t0);
    __syncthreads();  // the sub-chunk before is consumed
    stage(t0, n_valid);
    scores();
    {  // du = M^T dy + exp(cs_last - cs) o (B G^T); dx = dt du; x . du
      using Tl = Tiling<kL, P>;
      static_assert(Tl::TX == 32, "a warp spans whole rows of du");
      const int ty = tid / Tl::TX, tx = tid % Tl::TX;
      float my[Tl::R][Tl::C], bg[Tl::R][Tl::C];
      zero(my);
      zero(bg);
      tile_product<kL, P, kL>(my, [&](int m, int l) { return Ms[l * LP + m]; },
                              [&](int l, int p) { return dYs[l * PP + p]; });
      tile_product<kL, P, N>(bg, [&](int m, int n) { return Bs[m * NP + n]; },
                             [&](int n, int p) { return Gs[p * NP + n]; });
#pragma unroll
      for (int i = 0; i < Tl::R; ++i) {
        const int m = ty + i * Tl::TY;
        float xd = 0.f;
#pragma unroll
        for (int j = 0; j < Tl::C; ++j) {
          const int p = tx + j * Tl::TX;
          const float du = fmaf(ews[m], bg[i][j], my[i][j]);
          if (m < n_valid) dxb[int64_t(t0 + m) * row + p] = from_float<T>(dts[m] * du);
          xd = fmaf(Xs[m * PP + p], du, xd);
        }
        xd = warp_sum(xd);
        if (lane == 0) xdu[m] = xd;
      }
    }
    {  // dB = W^T C + dt exp(cs_last - cs) o (x G)
      using Tl = Tiling<kL, N>;
      const int ty = tid / Tl::TX, tx = tid % Tl::TX;
      float wc[Tl::R][Tl::C], xg[Tl::R][Tl::C];
      zero(wc);
      zero(xg);
      tile_product<kL, N, kL>(wc, [&](int m, int l) { return Ws[l * LP + m]; },
                              [&](int l, int n) { return Cs[l * NP + n]; });
      tile_product<kL, N, P>(xg, [&](int m, int p) { return Xs[m * PP + p]; },
                             [&](int p, int n) { return Gs[p * NP + n]; });
#pragma unroll
      for (int i = 0; i < Tl::R; ++i) {
        const int m = ty + i * Tl::TY;
        if (m >= n_valid) continue;
#pragma unroll
        for (int j = 0; j < Tl::C; ++j) {
          part[int64_t(t0 + m) * N + tx + j * Tl::TX] = fmaf(wts[m], xg[i][j], wc[i][j]);
        }
      }
    }
    __syncthreads();  // x . du is in shared memory; G is read
    // dcs = dy . y - dt (x . du), a warp a row
    for (int r = warp; r < kL; r += kThreads / 32) {
      float yd = 0.f;
      if (r < n_valid) {
        for (int p = lane; p < P; p += 32) yd = fmaf(dYs[r * PP + p], yb[int64_t(t0 + r) * row + p], yd);
      }
      yd = warp_sum(yd);
      if (lane == 0) dcs[r] = r < n_valid ? yd - dts[r] * xdu[r] : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // da = carry + the reverse inclusive sum of dcs; ddt
      float v = dcs[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float down = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += down;
      }
      const float da = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 0);
      if (lane < n_valid) ddtb[int64_t(t0 + lane) * H] = fmaf(a, da, xdu[lane]);
      da_acc = fmaf(dts[lane], da, da_acc);
    }
    {  // G = exp(cs_last) G + (exp(cs) o dy)^T C
      using Tl = Tiling<P, N>;
      const int ty = tid / Tl::TX, tx = tid % Tl::TX;
      float acc[Tl::R][Tl::C];
      zero(acc);
      tile_product<P, N, kL>(acc, [&](int p, int l) { return ecs[l] * dYs[l * PP + p]; },
                             [&](int l, int n) { return Cs[l * NP + n]; });
      const float decay = ecs[kL - 1];
#pragma unroll
      for (int i = 0; i < Tl::R; ++i)
#pragma unroll
        for (int j = 0; j < Tl::C; ++j) {
          float& gv = Gs[(ty + i * Tl::TY) * NP + tx + j * Tl::TX];
          gv = fmaf(gv, decay, acc[i][j]);
        }
    }
  }
  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) static_cast<float*>(g.da_part)[bh] = da_acc;
  }
}

// dB and dC: the heads' shares summed in order of h; da_neg: the batch's
// shares summed in order of b
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                      const float* __restrict__ da_part, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ da_neg, int batch, int H, int64_t SN) {
  const int64_t n_out = int64_t(batch) * SN;
  for (int64_t idx = int64_t(blockIdx.x) * kThreads + threadIdx.x; idx < n_out;
       idx += int64_t(gridDim.x) * kThreads) {
    const int64_t b = idx / SN, r = idx % SN;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const int64_t at = (b * H + h) * SN + r;
      sb += dB_part[at];
      sc += dC_part[at];
    }
    dB[idx] = from_float<T>(sb);
    dC[idx] = from_float<T>(sc);
  }
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h < H) {
    float s = 0.f;
    for (int b = 0; b < batch; ++b) s += da_part[int64_t(b) * H + h];
    da_neg[h] = s;
  }
}

template <typename T, int P, int N>
cudaError_t run(const Ptrs& g, void* dB, void* dC, void* da_neg, int batch,
                cudaStream_t stream) {
  constexpr size_t smem = Smem<P, N>::kBytes;
  auto fn = ssd_bwd_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  fn<<<dim3(batch * g.H, 2), kThreads, smem, stream>>>(g);
  const int64_t SN = int64_t(g.S) * N, n_out = batch * SN;
  const int blocks = int(std::max<int64_t>(
      std::min<int64_t>((n_out + kThreads - 1) / kThreads, 132 * 16),
      (g.H + kThreads - 1) / kThreads));
  ssd_bwd_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(g.dB_part), static_cast<const float*>(g.dC_part),
      static_cast<const float*>(g.da_part), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(da_neg), batch, g.H, SN);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int N, const Ptrs& g, void* dB, void* dC, void* da, int batch,
                       cudaStream_t s) {
  switch (N) {
    case 16: return run<T, P, 16>(g, dB, dC, da, batch, s);
    case 32: return run<T, P, 32>(g, dB, dC, da, batch, s);
    case 64: return run<T, P, 64>(g, dB, dC, da, batch, s);
    case 128: return run<T, P, 128>(g, dB, dC, da, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(int P, int N, const Ptrs& g, void* dB, void* dC, void* da, int batch,
                       cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<T, 32>(N, g, dB, dC, da, batch, s);
    case 64: return dispatch_n<T, 64>(N, g, dB, dC, da, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// x: (batch, S, H, P), row s of batch i at (i * S + s) * x_stride elements,
// each row's H * P contiguous; B, C: (batch, S, N), rows at bc_stride
// elements, each row's N contiguous; x, B and C of one dtype (0 = float32,
// 1 = bfloat16).  dt: (batch, S, H), a_neg: (H,), y and dy: (batch, S, H,
// P), state and dstate: (batch, H, P, N), all float32 and contiguous, as
// the forward took and gave them; dstate may be null (no gradient of the
// final state; state is then not read).  Writes dx (batch, S, H, P) in x's
// dtype, ddt (batch, S, H) and da_neg (H,) float32, dB and dC (batch, S, N)
// in B's dtype, all contiguous; workspace: 2 * batch * H * S * N + batch *
// H floats.  Returns cudaGetLastError() after the two launches.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a_neg, const void* Bm,
                            const void* Cm, const void* y, const void* state, const void* dy,
                            const void* dstate, void* dx, void* ddt, void* da_neg, void* dB,
                            void* dC, void* workspace, int batch, int S, int H, int P, int N,
                            int x_stride, int bc_stride, int dtype, void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  const int64_t part = int64_t(batch) * H * S * N;
  const Ptrs g{x,  dt,  a_neg, Bm, Cm, y, state, dy, dstate, dx, ddt, ws, ws + part,
               ws + 2 * part, S, H, x_stride, bc_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_p<float>(P, N, g, dB, dC, da_neg, batch, s);
  if (dtype == 1) return dispatch_p<__nv_bfloat16>(P, N, g, dB, dC, da_neg, batch, s);
  return cudaErrorInvalidValue;
}
