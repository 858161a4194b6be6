// SCU row softmax for Hopper (sm_90a), float32 inside.
//
// Replaces the Pallas TPU kernel repro/kernels/pwl_softmax.py
// (pwl_softmax -> _softmax_kernel).  Per row of n values, in the
// reference's order: the max, the SCU's 8-segment PWL exp of x - max (the
// segment's multiply and add rounded separately), the sum, the reciprocal
// 1 / max(sum, 1e-30) (__frcp_rn) and the separately rounded scale e * r,
// output in x's dtype.  A NaN goes through as in the reference: the max,
// the exp and the clamp of the sum keep it (max.NaN, a clip by
// comparisons), so a row that holds a NaN or +inf, or only -inf, comes
// out all NaN.
//
// What bounds it on an H100: 4 to 8 bytes read and written an element
// against ~14 instructions.  At llama3-8b's prefill scores (65,536 rows of
// 512 bf16) the bytes take 0.040 ms at 3.35 TB/s and the instructions
// ~0.013 ms at 4 warp-instructions a clock an SM: bound by bytes once the
// exp is cheap.  The exp takes its segment by index (pwl_exp_indexed: one
// add rounded down puts floor(x) on the integer grid of 1.5 * 2^23, one
// AND gives the index, one 8-byte shared-memory load the slope and the
// intercept), not by the 8-way select chain of common.cuh's pwl_exp (~35
// instructions an element), and equals that chain bit for bit on every
// float32 input (pwl_softmax_exp_mismatches).
//
// PWL exp is not multiplicative (ROADMAP hazard 4): the row max must be
// known before the first exp, so nothing rescales a running sum.  The
// wrapper (kernels/pwl_softmax.route) picks the route by shape; this file
// checks the same limits (route_takes):
//   warp        n <= 1024, the row in registers.  Rows of a multiple of
//               16 bytes (16-byte aligned: the wrapper copies x otherwise)
//               move 16 bytes a lane a load and a store, 1 to 32 lanes a
//               row, 8 warps a CTA (softmax_vec_kernel); other rows, as
//               the decode scores (n = 513), one element a lane a load
//               (softmax_warp_kernel).
//   row         one CTA of 512 threads a row, the row cached in shared
//               memory in x's dtype (up to 224 KB), loaded by 16-byte
//               cp.async: rows enough to fill the card.
//   cluster     few rows: each row split over a thread block cluster of
//               2-16 CTAs, each caching its slice in shared memory; the
//               max and the sum go to every CTA of the cluster through
//               distributed shared memory, one cluster barrier each, so
//               the row is read from device memory once and written once.
//               llama3-8b's vocab row (128,256 float32, 501 KB) takes 16
//               slices of 32 KB.
//   three_pass  rows of more than 16 slices: one CTA a row, three passes
//               over device memory (the exp recomputed, same result).
// A row's slices are 16-byte chunks of the aligned address space; the
// first and last chunk of a row that does not start or end on 16 bytes
// are moved one element at a time.
#include <cmath>
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 16;                  // bytes a lane moves a load or a store
constexpr int kWarpMaxN = 1024;
constexpr int kWarpThreads = 256;
constexpr int kWarpsPerCta = kWarpThreads / 32;
constexpr int kSliceThreads = 512;
constexpr int kSliceMaxBytes = 224 * 1024;  // a CTA's slice in shared memory
constexpr int kMaxCluster = 16;             // non-portable: more than 8
constexpr int kTable = 16;                  // segments 0-7, then copies of 7
constexpr float kXMin = -8.f, kXMax = 0.f;  // the segment edges are -8, -7, ..., 0
// x + this, rounded down, is 1.5 * 2^23 + 8 + floor(x) for x in [-8, 0]
// (the floats in [2^23, 2^24) are the integers), so the low 4 bits of its
// pattern are floor(x) + 8, the segment (8 at x = 0, which is segment 7)
constexpr float kFloorMagic = 12582912.f - kXMin;

enum Route { kRouteWarp = 0, kRouteRow = 1, kRouteCluster = 2, kRouteThreePass = 3 };

template <typename T>
constexpr int kPerChunk = kChunk / int(sizeof(T));

// over `width` neighbouring lanes (a power of two <= 32); all 32 lanes call
__device__ __forceinline__ float group_max(float x, int width) {
  for (int o = width / 2; o > 0; o >>= 1) x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int width) {
  for (int o = width / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The segments' (slope, intercept), read by index from shared memory (a
// per-lane index into the launch argument would serialize).  Entries 8-15
// repeat segment 7: x = 0 gives index 8, and a NaN or x < -8 any index,
// whose result is then NaN or 0 whatever the entry holds.
__device__ __forceinline__ void fill_table(float2* tab, const PwlCoeffs& c) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kTable; ++i) {
      const int s = i < kPwlSegments ? i : kPwlSegments - 1;
      tab[i] = make_float2(c.slope[s], c.intercept[s]);
    }
  }
  __syncthreads();
}

// The PWL exp by segment index: clip above at 0 (a NaN stays NaN), segment
// floor(xc) + 8, one multiply and one add rounded separately, 0 below -8.
// Bit-equal to the select chain _pwl_exp_vec on every float32 x: -inf
// gives 0, +inf the value at 0, NaN NaN.
__device__ __forceinline__ float pwl_exp_indexed(float x, const float2* tab) {
  const float xc = min_nan(x, kXMax);
  const unsigned i = __float_as_uint(__fadd_rd(xc, kFloorMagic)) & (kTable - 1);
  const float2 sb = tab[i];
  const float y = __fadd_rn(__fmul_rn(sb.x, xc), sb.y);
  return x < kXMin ? 0.f : y;
}

// 16 bytes as kPerChunk<T> floats, and back (bf16 rounded to nearest even)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* v) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      v[j] = __uint_as_float(w[j]);
    } else {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(v[j]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- warp route: rows of up to 1024 in registers --------------------------

// 16-byte rows: `lanes` (2^lanes_log2) lanes a row, CPL chunks a lane
// (chunk sub + lanes * j), 32 / lanes rows a warp.
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpThreads)
softmax_vec_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int n,
                   int lanes_log2, PwlCoeffs pwl) {
  constexpr int V = kPerChunk<T>;
  __shared__ float2 tab[kTable];
  fill_table(tab, pwl);
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x % 32;
  const int sub = lane & (lanes - 1);
  const int64_t row =
      ((int64_t(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32) << (5 - lanes_log2)) +
      (lane >> lanes_log2);
  // a row past the end has no chunks, but its lanes still reach the shuffles
  const int chunks = row < rows ? n / V : 0;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * (n / V);
  uint4* orow = reinterpret_cast<uint4*>(out) + row * (n / V);
  uint4 raw[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = sub + j * lanes;
    raw[j] = c < chunks ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
  }
  float v[CPL * V];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    unpack<T>(raw[j], v + j * V);
    if (sub + j * lanes < chunks) {
#pragma unroll
      for (int k = 0; k < V; ++k) m = max_nan(m, v[j * V + k]);
    }
  }
  m = group_max(m, lanes);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (sub + j * lanes < chunks) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[j * V + k] = pwl_exp_indexed(__fsub_rn(v[j * V + k], m), tab);
        s += v[j * V + k];
      }
    }
  }
  s = group_sum(s, lanes);
  const float r = __frcp_rn(max_nan(s, 1e-30f));
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = sub + j * lanes;
    if (c < chunks) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[j * V + k] = __fmul_rn(v[j * V + k], r);
      orow[c] = pack<T>(v + j * V);
    }
  }
}

// Other rows (n * sizeof(T) not a multiple of 16): one warp a row, VPT
// elements a lane, one element a load.
template <typename T, int VPT>
__global__ void __launch_bounds__(kWarpThreads)
softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int n,
                    PwlCoeffs pwl) {
  __shared__ float2 tab[kTable];
  fill_table(tab, pwl);
  const int lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kWarpsPerCta + threadIdx.x / 32;
  if (row >= rows) return;       // the whole warp: no shuffle is left waiting
  const T* xr = x + row * n;
  T* orow = out + row * n;
  float v[VPT];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < n ? to_float(xr[i]) : -INFINITY;
    m = max_nan(m, v[j]);
  }
  m = group_max(m, 32);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < n ? pwl_exp_indexed(__fsub_rn(v[j], m), tab) : 0.f;
    s += v[j];
  }
  s = group_sum(s, 32);
  const float r = __frcp_rn(max_nan(s, 1e-30f));
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + 32 * j;
    if (i < n) orow[i] = from_float<T>(__fmul_rn(v[j], r));
  }
}

// ---- row, cluster and three_pass routes: a row in 16-byte chunks ----------

// Chunk c of a row covers bytes [a0 + 16 c, a0 + 16 c + 16), a0 the row's
// start rounded down to 16 bytes; its elements [lo(c), hi(c)) are the
// row's.  x and out are 16-byte aligned (checked), so both rows have the
// same head.
template <typename T>
struct RowChunks {
  static constexpr int V = kPerChunk<T>;
  int head, n;
  __device__ RowChunks(const T* row, int n_) : n(n_) {
    head = int(reinterpret_cast<uintptr_t>(row) & (kChunk - 1)) / int(sizeof(T));
  }
  __device__ int count() const { return int((int64_t(head) + n + V - 1) / V); }
  __device__ int lo(int c) const { return c == 0 ? head : 0; }
  __device__ int hi(int c) const { return int(min(int64_t(V), int64_t(head) + n - int64_t(c) * V)); }
};

// a row's start rounded down to 16 bytes: chunk 0
__device__ __forceinline__ uintptr_t chunk_base(const void* row) {
  return reinterpret_cast<uintptr_t>(row) & ~uintptr_t(kChunk - 1);
}

// f(j) for the row's elements j of a chunk (all V but at the row's ends)
template <int V, typename F>
__device__ __forceinline__ void each(int lo, int hi, F f) {
  if (lo == 0 && hi == V) {
#pragma unroll
    for (int j = 0; j < V; ++j) f(j);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j >= lo && j < hi) f(j);
    }
  }
}

// Chunk c as floats: from the shared-memory cache (slot c - c0), or from
// device memory (a partial chunk one element at a time).
template <typename T, bool kCached>
__device__ __forceinline__ void read_chunk(const RowChunks<T>& rc, const uint4* xb,
                                           const uint4* cache, int c, int c0, float* v) {
  constexpr int V = kPerChunk<T>;
  if constexpr (kCached) {
    unpack<T>(cache[c - c0], v);
  } else {
    const int lo = rc.lo(c), hi = rc.hi(c);
    if (lo == 0 && hi == V) {
      unpack<T>(__ldg(xb + c), v);
    } else {
      const T* p = reinterpret_cast<const T*>(xb + c);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = j >= lo && j < hi ? to_float(p[j]) : 0.f;
    }
  }
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? group_max(v, 32) : group_sum(v, 32);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kSliceThreads / 32 ? red[lane] : (kMax ? -INFINITY : 0.f);
  v = kMax ? group_max(v, 32) : group_sum(v, 32);
  __syncthreads();
  return v;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Each CTA writes its partial into slot `rank` of every CTA's part[]
// (distributed shared memory), then one cluster barrier (release /
// acquire); each CTA combines the slots in rank order, so all of them get
// the same value.  No CTA reads another's memory, so none has to wait for
// the others before it exits.
template <bool kMax>
__device__ __forceinline__ float cluster_combine(float v, float* part, int cs) {
  if (int(threadIdx.x) < cs) {
    const uint32_t slot = static_cast<uint32_t>(__cvta_generic_to_shared(part + cluster_rank()));
    st_cluster_f32(cluster_map(slot, threadIdx.x), v);
  }
  cluster_sync();
  float t = part[0];
  for (int r = 1; r < cs; ++r) t = kMax ? max_nan(t, part[r]) : t + part[r];
  return t;
}

// One slice of `slice` chunks of a row a CTA.  kCached: the slice is
// cached in shared memory (row: one slice a row; cluster: cs slices a row,
// cs CTAs of one cluster, blockIdx.x = row * cs + rank); else three
// passes over device memory, one slice a row.
template <typename T, bool kCached, bool kCluster>
__global__ void __launch_bounds__(kSliceThreads)
softmax_slice_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int cs, int slice,
                     PwlCoeffs pwl) {
  constexpr int V = kPerChunk<T>;
  extern __shared__ uint4 cache[];
  __shared__ float2 tab[kTable];
  __shared__ float red[kSliceThreads / 32];
  __shared__ float part_max[kMaxCluster], part_sum[kMaxCluster];
  // every CTA of the cluster has started before any writes into another
  if constexpr (kCluster) cluster_arrive_relaxed();
  const int rank = kCluster ? int(blockIdx.x % cs) : 0;
  const int64_t row = kCluster ? blockIdx.x / cs : blockIdx.x;
  const T* xrow = x + row * n;
  const RowChunks<T> rc(xrow, n);
  const uint4* xb = reinterpret_cast<const uint4*>(chunk_base(xrow));
  uint4* ob = reinterpret_cast<uint4*>(chunk_base(out + row * n));
  const int c0 = rank * slice, c1 = min(c0 + slice, rc.count());
  fill_table(tab, pwl);
  if constexpr (kCached) {
    for (int c = c0 + threadIdx.x; c < c1; c += kSliceThreads) {
      const int lo = rc.lo(c), hi = rc.hi(c);
      if (lo == 0 && hi == V) {
        cp_async16(cache + (c - c0), xb + c, true);
      } else {
        const T* p = reinterpret_cast<const T*>(xb + c);
        T* d = reinterpret_cast<T*>(cache + (c - c0));
        for (int j = lo; j < hi; ++j) d[j] = p[j];
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  float m = -INFINITY;
  for (int c = c0 + threadIdx.x; c < c1; c += kSliceThreads) {
    float v[V];
    read_chunk<T, kCached>(rc, xb, cache, c, c0, v);
    each<V>(rc.lo(c), rc.hi(c), [&](int j) { m = max_nan(m, v[j]); });
  }
  m = block_reduce<true>(m, red);
  if constexpr (kCluster) {
    cluster_wait();
    m = cluster_combine<true>(m, part_max, cs);
  }
  float s = 0.f;
  for (int c = c0 + threadIdx.x; c < c1; c += kSliceThreads) {
    float v[V];
    read_chunk<T, kCached>(rc, xb, cache, c, c0, v);
    each<V>(rc.lo(c), rc.hi(c),
            [&](int j) { s += pwl_exp_indexed(__fsub_rn(v[j], m), tab); });
  }
  s = block_reduce<false>(s, red);
  if constexpr (kCluster) s = cluster_combine<false>(s, part_sum, cs);
  const float r = __frcp_rn(max_nan(s, 1e-30f));
  for (int c = c0 + threadIdx.x; c < c1; c += kSliceThreads) {
    float v[V];
    read_chunk<T, kCached>(rc, xb, cache, c, c0, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __fmul_rn(pwl_exp_indexed(__fsub_rn(v[j], m), tab), r);
    const int lo = rc.lo(c), hi = rc.hi(c);
    if (lo == 0 && hi == V) {
      ob[c] = pack<T>(v);
    } else {
      T* p = reinterpret_cast<T*>(ob + c);
      for (int j = lo; j < hi; ++j) p[j] = from_float<T>(v[j]);
    }
  }
}

// ---- host side -----------------------------------------------------------

// chunks a slice holds when a row of n is split into cs: the row spans at
// most ceil(n * esize / 16) + 1 chunks, whatever its alignment
int64_t slice_chunks(int64_t n, int esize, int cs) {
  const int64_t nc = (n * esize + kChunk - 1) / kChunk + 1;
  return (nc + cs - 1) / cs;
}

// The limits of each route (kernels/pwl_softmax.takes mirrors them).
bool route_takes(int route, int cs, int64_t rows, int64_t n, int esize) {
  const bool fits = slice_chunks(n, esize, cs) * kChunk <= kSliceMaxBytes;
  switch (route) {
    case kRouteWarp:
      return cs == 1 && n <= kWarpMaxN;
    case kRouteRow:
      return cs == 1 && fits;
    case kRouteCluster:
      return cs >= 2 && cs <= kMaxCluster && fits && rows * cs < (int64_t(1) << 31);
    case kRouteThreePass:
      return cs == 1;
    default:
      return false;
  }
}

// The warp route's kernel, its argument lanes_log2 and its rows a CTA.
template <typename T>
const void* warp_kernel(int n, int* lanes_log2, int* rows_per_cta) {
  *lanes_log2 = 5;
  *rows_per_cta = kWarpsPerCta;
  if ((int64_t(n) * int(sizeof(T))) % kChunk == 0) {
    const int chunks = n / kPerChunk<T>;
    int l = 0;
    while ((1 << l) < chunks && l < 5) ++l;
    *lanes_log2 = l;
    *rows_per_cta = kWarpsPerCta << (5 - l);
    constexpr int kMaxCpl = kWarpMaxN / kPerChunk<T> / 32;   // 8 float32, 4 bf16
    int cpl = 1;
    while (cpl * 32 < chunks) cpl *= 2;
    switch (cpl) {
      case 1: return reinterpret_cast<const void*>(softmax_vec_kernel<T, 1>);
      case 2: return reinterpret_cast<const void*>(softmax_vec_kernel<T, 2>);
      case 4: return reinterpret_cast<const void*>(softmax_vec_kernel<T, 4>);
      default: return reinterpret_cast<const void*>(softmax_vec_kernel<T, kMaxCpl>);
    }
  }
  *lanes_log2 = -1;   // no such argument
  if (n <= 32) return reinterpret_cast<const void*>(softmax_warp_kernel<T, 1>);
  if (n <= 64) return reinterpret_cast<const void*>(softmax_warp_kernel<T, 2>);
  if (n <= 128) return reinterpret_cast<const void*>(softmax_warp_kernel<T, 4>);
  if (n <= 256) return reinterpret_cast<const void*>(softmax_warp_kernel<T, 8>);
  if (n <= 512) return reinterpret_cast<const void*>(softmax_warp_kernel<T, 16>);
  return reinterpret_cast<const void*>(softmax_warp_kernel<T, 32>);
}

template <typename T>
const void* slice_kernel(int route) {
  if (route == kRouteCluster) return reinterpret_cast<const void*>(softmax_slice_kernel<T, true, true>);
  if (route == kRouteRow) return reinterpret_cast<const void*>(softmax_slice_kernel<T, true, false>);
  return reinterpret_cast<const void*>(softmax_slice_kernel<T, false, false>);
}

// Shared memory above 48 KB, and clusters of more than 8, once a kernel.
cudaError_t allow_slices(const void* kernel, bool cluster) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceMaxBytes);
  if (err == cudaSuccess && cluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

template <typename T>
cudaError_t slice_attributes(int route) {
  static const cudaError_t cached = allow_slices(slice_kernel<T>(kRouteCluster), true);
  static const cudaError_t row = allow_slices(slice_kernel<T>(kRouteRow), false);
  if (route == kRouteCluster) return cached;
  if (route == kRouteRow) return row;
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int rows, int cs, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(rows) * unsigned(cs));
  cfg.blockDim = dim3(kSliceThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of cs CTAs with `smem` bytes each that the card holds at once
// (cudaOccupancyMaxActiveClusters), remembered by (dtype size, cs, smem).
template <typename T>
cudaError_t max_clusters(int cs, int smem, int* out) {
  static std::mutex mu;
  static int keys[64][2];
  static int vals[64];
  static int filled = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    if (keys[i][0] == cs && keys[i][1] == smem) {
      *out = vals[i];
      return cudaSuccess;
    }
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, cs, smem, nullptr, &attr);
  cudaError_t err = slice_attributes<T>(kRouteCluster);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(out, slice_kernel<T>(kRouteCluster), &cfg);
  }
  if (err != cudaSuccess) return err;
  if (filled < 64) {
    keys[filled][0] = cs;
    keys[filled][1] = smem;
    vals[filled++] = *out;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xv, void* ov, int rows, int n, int route, int cs,
                   const PwlCoeffs& pwl, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(ov);
  if (route == kRouteWarp) {
    int lanes_log2, rows_per_cta;
    const void* kernel = warp_kernel<T>(n, &lanes_log2, &rows_per_cta);
    const int64_t grid = (int64_t(rows) + rows_per_cta - 1) / rows_per_cta;
    PwlCoeffs c = pwl;
    void* vec_args[] = {&x, &out, &rows, &n, &lanes_log2, &c};
    void* warp_args[] = {&x, &out, &rows, &n, &c};
    return cudaLaunchKernel(kernel, dim3(unsigned(grid)), dim3(kWarpThreads),
                            lanes_log2 >= 0 ? vec_args : warp_args, 0, s);
  }
  int slice = int(slice_chunks(n, int(sizeof(T)), cs));
  const int smem = route == kRouteThreePass ? 0 : slice * kChunk;
  cudaError_t err = slice_attributes<T>(route);
  if (err != cudaSuccess) return err;
  if (route == kRouteCluster) {
    int fit = 0;
    err = max_clusters<T>(cs, smem, &fit);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorLaunchOutOfResources;   // the cluster does not fit
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(rows, cs, smem, s, &attr);
    return cudaLaunchKernelEx(&cfg, softmax_slice_kernel<T, true, true>, x, out, n, cs, slice,
                              pwl);
  }
  if (route == kRouteRow) {
    softmax_slice_kernel<T, true, false><<<rows, kSliceThreads, smem, s>>>(x, out, n, 1, slice,
                                                                          pwl);
  } else {
    softmax_slice_kernel<T, false, false><<<rows, kSliceThreads, 0, s>>>(x, out, n, 1, slice,
                                                                        pwl);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int route, int cs, int n, int* ctas, int* clusters) {
  *clusters = 0;
  if (route == kRouteWarp) {
    int lanes_log2, rows_per_cta;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, warp_kernel<T>(n, &lanes_log2, &rows_per_cta), kWarpThreads, 0);
  }
  const int smem = route == kRouteThreePass ? 0 : int(slice_chunks(n, int(sizeof(T)), cs)) * kChunk;
  cudaError_t err = slice_attributes<T>(route);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, slice_kernel<T>(route), kSliceThreads,
                                                      smem);
  if (err != cudaSuccess || route != kRouteCluster) return err;
  return max_clusters<T>(cs, smem, clusters);
}

// Over every float32 bit pattern: *bad counts the inputs on which
// pwl_exp_indexed and common.cuh's select chain pwl_exp (the attention
// kernels') differ in any bit; two NaNs count as equal.
__global__ void exp_check_kernel(PwlCoeffs c, unsigned long long* bad) {
  __shared__ float2 tab[kTable];
  fill_table(tab, c);
  unsigned long long chain = 0;
  const uint64_t step = uint64_t(gridDim.x) * blockDim.x;
  for (uint64_t i = uint64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < (uint64_t(1) << 32);
       i += step) {
    const float xv = __uint_as_float(static_cast<uint32_t>(i));
    const float got = pwl_exp_indexed(xv, tab);
    const float want = pwl_exp(xv, c);
    if (!(isnan(got) && isnan(want)) && __float_as_uint(got) != __float_as_uint(want)) ++chain;
  }
  atomicAdd(bad, chain);
}

bool integer_edges(const PwlCoeffs& c) { return c.x_min == kXMin && c.x_max == kXMax; }

}  // namespace
}  // namespace repro_torch

// x, out: (rows, n), contiguous, 16-byte aligned.  dtype 0 = float32, 1 =
// bfloat16.  route: 0 warp, 1 row, 2 cluster, 3 three_pass, with cs CTAs
// a row (a cluster of cs for route 2, else 1), as kernels/pwl_softmax.route
// chose; a plan that route_takes refuses, or coefficients whose segment
// edges are not -8, -7, ..., 0, give cudaErrorInvalidValue, a cluster that
// the card cannot hold cudaErrorLaunchOutOfResources.  One launch; returns
// its error.
extern "C" int pwl_softmax_fwd(const void* x, void* out, int rows, int n, int dtype, int route,
                               int cs, const void* pwl_host, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || n <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % kChunk != 0) {
    return cudaErrorInvalidValue;
  }
  if (!route_takes(route, cs, rows, n, dtype == 0 ? 4 : 2)) return cudaErrorInvalidValue;
  const PwlCoeffs pwl = read_pwl(pwl_host);
  if (!integer_edges(pwl)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, rows, n, route, cs, pwl, s);
  return launch<__nv_bfloat16>(x, out, rows, n, route, cs, pwl, s);
}

// The CTAs of the route's kernel for rows of n that reside on one SM of the
// current card at once, and for route 2 the clusters of cs the card holds.
extern "C" int pwl_softmax_occupancy(int route, int cs, int n, int dtype, int* ctas,
                                     int* clusters) {
  using namespace repro_torch;
  if (n <= 0 || (dtype != 0 && dtype != 1) || !route_takes(route, cs, 1, n, dtype == 0 ? 4 : 2)) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return occupancy<float>(route, cs, n, ctas, clusters);
  return occupancy<__nv_bfloat16>(route, cs, n, ctas, clusters);
}

// bad: one uint64 on the card, zeroed by the caller (see exp_check_kernel).
extern "C" int pwl_softmax_exp_mismatches(const void* pwl_host, void* bad, void* stream) {
  using namespace repro_torch;
  const PwlCoeffs pwl = read_pwl(pwl_host);
  if (!integer_edges(pwl)) return cudaErrorInvalidValue;
  exp_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      pwl, static_cast<unsigned long long*>(bad));
  return cudaGetLastError();
}
