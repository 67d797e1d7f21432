// The two GroupNorm kernels of the GroupNorm studies, over channels-last
// (B, N, C) activations.
//
// (a) Moments. Replaces tools/gn_study.py::_moments_kernel:
//
//   mean[b, c] = sum_n x[b, n, c] / N,   mean2[b, c] = sum_n x[b, n, c]^2 / N
//
// in fp32. What bounds it on the H100: it reads x once (131 MB at the study
// shape, 50 x 4096 x 320 bf16) and does two FMAs per element, so device
// memory bandwidth is the limit. The TPU kernel accumulates across a
// sequential grid axis in its output block; here blocks run in parallel, so
// one block owns (batch row, 32-channel slice) and streams all N rows
// itself: 16-byte loads along C (8 bf16 or 4 fp32 channels a thread), fp32
// sums in registers, then a fixed-order sum over the block's row lanes in
// shared memory. No atomics, so the result does not change from run to run.
//
// (b) Fused GroupNorm + activation. Replaces
// tools/gn_fused_study.py::_gn_kernel, one pass of
//
//   y = act((x - mean_g) * rsqrt(var_g + eps) * scale[c] + bias[c])
//
// with mean_g and var_g = max(E[x^2] - mean_g^2, 0) over the (N, C/G) slab
// of a group, all in fp32, silu(y) = y / (1 + exp(-y)), rounded to the
// operand type. The study's point is one read and one write of x: bound
// by device memory, 26 MB read and written at (5, 4096, 320) bf16. The
// TPU kernel keeps a whole (N, C) slice in VMEM (0.66-2.6 MB at the study
// shapes); an SM has 228 KB, so here the slice is spread over a thread
// block cluster:
//   * one cluster of K CTAs (K <= 16; 16 is the non-portable size) per
//     (batch row, slab of whole groups); each CTA holds a run of
//     ceil(N / K) tokens at the slab's full width, rows of at least 16
//     bytes, contiguous in shared memory;
//   * each thread owns one 16-byte vector lane of the slab's row (8 bf16
//     or 4 fp32 channels) in every L.rl-th row of the run: it copies
//     exactly those vectors into shared memory by cp.async (16 bytes a
//     copy, through L2), so it needs no barrier before it reads them, and
//     sums their per-channel s1, s2 in fp32. (1-D bulk copies of one token
//     row each on an mbarrier took 1.04-1.09x as long issued by every warp
//     and 1.15-1.40x by one warp on the H100: tools/gn_cluster_study.py.)
//   * the threads' sums go to shared memory once; one warp a (moment,
//     group) adds its rows and channels, lane-strided, then in a fixed
//     butterfly. The CTAs exchange their group partials through
//     distributed shared memory (mapa, ld.shared::cluster between two
//     cluster barriers), every CTA adding the ranks' partials in rank
//     order, so all hold the same statistics and a launch is bit-stable,
//     with no atomics;
//   * each thread keeps the scale and shift of its channels in registers
//     (scale and bias read before the loads land) and writes its rows of
//     the resident tile normalised and activated with 16-byte stores. x is
//     read once and written once.
// The launch plan (slab, cluster, rows, threads and shared memory) is
// ops/group_norm.py::_plan's; the C entry refuses a plan whose layout is
// not the kernel's. The kernel attributes (shared memory, non-portable
// cluster size) are set once a process.
//
// (c) The fused kernel of the first port, kept for the device-time
// comparison of tools/gn_device_times.py: one block per (batch row, group)
// reads the group's (N, C/G) slab with 2-byte loads into shared memory and
// refuses a slab larger than a block's shared memory.
#include <cstdint>

#include "common.cuh"

namespace rcdms {
namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 32;  // channels a moments block

// VEC channels in one load (16 bytes for 8 bf16 or 4 fp32)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(const T* __restrict__ x, float* __restrict__ mean,
                   float* __restrict__ mean2, int n, int c) {
  constexpr int kLanesC = kSlice / VEC;         // vectors across the slice
  constexpr int kLanesN = kThreads / kLanesC;   // row lanes
  __shared__ float part[2][kLanesN][kSlice + 1];

  const int tid = threadIdx.x;
  const int vl = tid % kLanesC, rl = tid / kLanesC;
  const int c0 = blockIdx.x * kSlice + vl * VEC;
  const int b = blockIdx.y;
  const bool live = c0 < c;  // c % VEC == 0, so a vector is in or out whole

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (live) {
    const T* p = x + (long)b * n * c + c0;
#pragma unroll 4
    for (int r = rl; r < n; r += kLanesN) {
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(
          p + (long)r * c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_float(v.v[j]);
        s1[j] += f;
        s2[j] += f * f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    part[0][rl][vl * VEC + j] = s1[j];
    part[1][rl][vl * VEC + j] = s2[j];
  }
  __syncthreads();
  if (tid < 2 * kSlice) {
    const int m = tid / kSlice, j = tid % kSlice;
    const int ch = blockIdx.x * kSlice + j;
    float s = 0.f;
    for (int r = 0; r < kLanesN; ++r) s += part[m][r][j];
    if (ch < c) (m ? mean2 : mean)[(long)b * c + ch] = s / (float)n;
  }
}

template <typename T, int VEC>
cudaError_t launch_moments(const void* x, float* mean, float* mean2,
                           int batch, int n, int c, cudaStream_t stream) {
  const dim3 grid((c + kSlice - 1) / kSlice, batch);
  moments_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, mean2, n, c);
  return cudaGetLastError();
}

// 16-byte vectors where c and the pointer allow them, else one channel a
// thread.
template <typename T>
cudaError_t moments_by_width(const void* x, float* mean, float* mean2,
                             int batch, int n, int c, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (c % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_moments<T, kVec>(x, mean, mean2, batch, n, c, s);
  return launch_moments<T, 1>(x, mean, mean2, batch, n, c, s);
}

// ---- (b) fused GroupNorm + activation over a thread block cluster -------

constexpr int kGnMaxThreads = 512;    // _plan's MAX_THREADS
constexpr int kGnSmemMax = 232448;    // shared memory a block may use
constexpr int kGnMaxCluster = 16;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The launch plan's layout (ops/group_norm.py::_layout): a slab of `sg`
// groups, `width` channels, each token row `row_bytes` (a multiple of 16)
// of `vr` 16-byte vectors; `rl` row lanes (a power of two) of `vr`
// threads; `rows` tokens a CTA. Shared memory: the CTA's group partials
// (read by the other CTAs) and the cluster's totals (2 sg fp32 each), the
// threads' per-channel sums (2 x rl x width fp32), then the tile (rows x
// row_bytes) at a 128-byte boundary.
struct GnLayout {
  int width, row_bytes, vr, rl, threads, rows;
  int part, stat, scratch, tile, bytes;
  __host__ __device__ GnLayout(int n, int c, int groups, int sg, int k,
                               int item) {
    width = sg * (c / groups);
    row_bytes = width * item;
    vr = row_bytes / 16;
    rl = 1;
    while (vr > 0 && vr * rl * 2 <= kGnMaxThreads) rl *= 2;
    threads = vr * rl;
    rows = (n + k - 1) / k;
    part = 0;
    stat = part + 8 * sg;
    scratch = round_up(stat + 8 * sg, 16);
    tile = round_up(scratch + 8 * rl * width, 128);
    bytes = tile + rows * row_bytes;
  }
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at shared address `addr` of this CTA's layout in CTA `rank`
// of the cluster
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// 16 bytes of the tile as 8 (bf16) or 4 (fp32) floats, and back
__device__ __forceinline__ void unpack16(const unsigned char* p,
                                         float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const unsigned char* p,
                                         float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// grid (K x slabs, batch), clusters of K along x; `threads` = rl x vr.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kGnMaxThreads)
    gn_act_cluster_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          int n, int c, int groups, int sg, int k,
                          float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char gn_smem[];
  const GnLayout L(n, c, groups, sg, k, sizeof(T));
  const int tid = threadIdx.x;
  const int cg = c / groups;
  const uint32_t rank = cluster_rank();
  const int slab = blockIdx.x / k, b = blockIdx.y;
  const int t0 = rank * L.rows;
  const int rows = max(0, min(L.rows, n - t0));
  const long c0 = (long)slab * L.width;  // the slab's first channel
  const long first = ((long)b * n + t0) * c + c0;  // row r: first + r c
  float* part = reinterpret_cast<float*>(gn_smem + L.part);
  float* stat = reinterpret_cast<float*>(gn_smem + L.stat);
  float* sc1 = reinterpret_cast<float*>(gn_smem + L.scratch);  // [rl][w]
  float* sc2 = sc1 + L.rl * L.width;
  unsigned char* tile = gn_smem + L.tile;

  // thread -> vector lane vl (channels ch0 ... ch0 + VEC - 1 of the slab)
  // and row lane rl (rows rl, rl + L.rl, ... of the run)
  const int vl = tid % L.vr, rl = tid / L.vr;
  const int ch0 = vl * VEC;
  for (int r = rl; r < rows; r += L.rl)
    cp_async16(tile + r * L.row_bytes + vl * 16, x + first + (long)r * c +
                                                     ch0, true);
  cp_async_commit();
  float scl[VEC], bia[VEC];  // read while the rows land
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    scl[e] = scale[c0 + ch0 + e];
    bia[e] = bias[c0 + ch0 + e];
  }

  // ---- per-channel sums of this thread's vectors -------------------------
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.f;
  cp_async_wait<0>();  // this thread's copies landed
  for (int r = rl; r < rows; r += L.rl) {
    float v[VEC];
    unpack16(tile + r * L.row_bytes + vl * 16, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s1[e] += v[e];
      s2[e] += v[e] * v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sc1[rl * L.width + ch0 + e] = s1[e];
    sc2[rl * L.width + ch0 + e] = s2[e];
  }
  __syncthreads();
  // one warp a (moment, group): its lanes add the rows and channels of the
  // group, each every 32nd in order, then a fixed butterfly
  const int warp = tid / 32, lane = tid % 32;
  const int warps = L.threads / 32;  // whole warps (a last partial one idles)
  for (int j = warp; warp < warps && j < 2 * sg; j += warps) {
    const float* src = (j < sg ? sc1 : sc2) + (j % sg) * cg;
    float acc = 0.f;
    int rr = lane / cg, ch = lane % cg;  // element i = rr cg + ch
    for (int i = lane; i < L.rl * cg; i += 32) {
      acc += src[rr * L.width + ch];
      for (ch += 32; ch >= cg; ch -= cg) ++rr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) part[j] = acc;
  }

  // ---- the cluster's totals, every CTA adding the ranks in order --------
  cluster_arrive();
  cluster_wait();
  if (tid < 2 * sg) {
    const uint32_t addr =
        static_cast<uint32_t>(__cvta_generic_to_shared(part + tid));
    float got[kGnMaxCluster];
#pragma unroll
    for (int r = 0; r < kGnMaxCluster; ++r)
      got[r] = r < k ? ld_cluster(addr, r) : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kGnMaxCluster; ++r) acc += got[r];
    stat[tid] = acc;
  }
  __syncthreads();
  cluster_arrive();  // done reading the other CTAs' partials

  // ---- normalise, activate and store this thread's rows -----------------
  const float inv_count = 1.f / ((float)n * (float)cg);
  float mul[VEC], add[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int g = (ch0 + e) / cg;
    const float mean = stat[g] * inv_count;
    const float var = fmaxf(stat[sg + g] * inv_count - mean * mean, 0.f);
    mul[e] = rsqrtf(var + eps) * scl[e];
    add[e] = bia[e] - mean * mul[e];
  }
  T* out = y + first + ch0;
  for (int r = rl; r < rows; r += L.rl) {
    float v[VEC];
    unpack16(tile + r * L.row_bytes + vl * 16, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[e] = v[e] * mul[e] + add[e];
      // SiLU by the approximate exponential and reciprocal (2 ulp): a
      // correctly rounded division made the store loop compute-bound
      if (SILU) v[e] = __fdividef(v[e], 1.f + __expf(-v[e]));
    }
    store16(out + (long)r * c, v);
  }
  cluster_wait();  // no CTA leaves while another may read its partials
}

template <typename T, bool SILU>
cudaError_t launch_gn_cluster(const void* x, const float* scale,
                              const float* bias, void* y, int batch, int n,
                              int c, int groups, float eps, int sg, int k,
                              int rows, int threads, int smem,
                              cudaStream_t stream) {
  auto kernel = gn_act_cluster_kernel<T, SILU>;
  if (sg <= 0 || groups % sg != 0 || k <= 0 || k > kGnMaxCluster ||
      (c * (int)sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  const GnLayout L(n, c, groups, sg, k, sizeof(T));
  if (L.row_bytes % 16 != 0 || L.vr <= 0 || L.vr > kGnMaxThreads ||
      rows != L.rows ||
      threads != L.threads || smem != L.bytes || smem > kGnSmemMax)
    return cudaErrorInvalidValue;
  // once a process: the shared memory a block may take, and clusters of 16
  static const cudaError_t ready = [kernel] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGnSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  if (ready != cudaSuccess) return ready;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * (groups / sg), batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), scale, bias,
      static_cast<T*>(y), n, c, groups, sg, k, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t gn_cluster_by_act(int silu, const void* x, const float* scale,
                              const float* bias, void* y, int batch, int n,
                              int c, int groups, float eps, int sg, int k,
                              int rows, int threads, int smem,
                              cudaStream_t s) {
  if (silu)
    return launch_gn_cluster<T, true>(x, scale, bias, y, batch, n, c, groups,
                                      eps, sg, k, rows, threads, smem, s);
  return launch_gn_cluster<T, false>(x, scale, bias, y, batch, n, c, groups,
                                     eps, sg, k, rows, threads, smem, s);
}

// ---- (c) the first port's fused kernel, one block a group ------------------

constexpr int kGnThreads = 512;

__device__ __forceinline__ float block_sum(float v, float* red) {
  // fixed order: a warp's butterfly, then warp 0 over the warps' sums
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free (an earlier call has read it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kGnThreads / 32; ++w) s += red[w];
  return s;
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kGnThreads)
    gn_act_slab_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y,
                       int n, int c, int groups, float eps) {
  extern __shared__ __align__(16) unsigned char gn_smem[];
  T* slab = reinterpret_cast<T*>(gn_smem);  // [n][cg]
  __shared__ float red[kGnThreads / 32];

  const int cg = c / groups;
  const int g = blockIdx.x, b = blockIdx.y;
  // thread -> (row lane, channel of the group); consecutive threads read
  // consecutive channels, then the next row
  const int lanes_n = kGnThreads / cg;
  const int j = threadIdx.x % cg, r0 = threadIdx.x / cg;
  const bool live = r0 < lanes_n;
  const long base = (long)b * n * c + (long)g * cg + j;

  float s1 = 0.f, s2 = 0.f;
  if (live) {
#pragma unroll 8
    for (int r = r0; r < n; r += lanes_n) {
      const T v = x[base + (long)r * c];
      slab[r * cg + j] = v;
      const float f = to_float(v);
      s1 += f;
      s2 += f * f;
    }
  }
  const float inv_count = 1.f / ((float)n * (float)cg);
  const float mean = block_sum(s1, red) * inv_count;
  const float ex2 = block_sum(s2, red) * inv_count;
  const float var = fmaxf(ex2 - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  if (!live) return;
  const float mul = inv * scale[g * cg + j];
  const float add = bias[g * cg + j] - mean * mul;
#pragma unroll 8
  for (int r = r0; r < n; r += lanes_n) {
    float v = to_float(slab[r * cg + j]) * mul + add;
    if (SILU) v = v * (1.f / (1.f + expf(-v)));
    y[base + (long)r * c] = from_float<T>(v);
  }
}

template <typename T, bool SILU>
cudaError_t launch_gn_slab(const void* x, const float* scale,
                           const float* bias, void* y, int batch, int n,
                           int c, int groups, float eps,
                           cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long bytes = (long)n * (c / groups) * sizeof(T);
  const int reserved = (kGnThreads / 32) * (int)sizeof(float);
  if (bytes + reserved > max_smem) return cudaErrorInvalidValue;
  err = allow_smem(gn_act_slab_kernel<T, SILU>, (int)bytes);
  if (err != cudaSuccess) return err;
  gn_act_slab_kernel<T, SILU>
      <<<dim3(groups, batch), kGnThreads, bytes, stream>>>(
          static_cast<const T*>(x), scale, bias, static_cast<T*>(y), n, c,
          groups, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gn_slab_by_act(int silu, const void* x, const float* scale,
                           const float* bias, void* y, int batch, int n,
                           int c, int groups, float eps, cudaStream_t s) {
  if (silu)
    return launch_gn_slab<T, true>(x, scale, bias, y, batch, n, c, groups,
                                   eps, s);
  return launch_gn_slab<T, false>(x, scale, bias, y, batch, n, c, groups,
                                  eps, s);
}

}  // namespace
}  // namespace rcdms

// x: (batch, n, c), contiguous; mean, mean2: (batch, c) fp32.
extern "C" int rcdms_gn_moments(int dtype, const void* x, void* mean,
                                void* mean2, int batch, int n, int c,
                                void* stream) {
  using namespace rcdms;
  if (batch <= 0 || n <= 0 || c <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m1 = static_cast<float*>(mean);
  float* m2 = static_cast<float*>(mean2);
  if (dtype == kFloat32)
    return moments_by_width<float>(x, m1, m2, batch, n, c, s);
  if (dtype == kBFloat16)
    return moments_by_width<__nv_bfloat16>(x, m1, m2, batch, n, c, s);
  return cudaErrorInvalidValue;
}

// The first port's fused kernel (c). x, y: (batch, n, c), one dtype;
// scale, bias: (c,) fp32; groups divides c and c / groups <= 512. silu: 1
// for silu, 0 for no activation. Refuses (cudaErrorInvalidValue) a group
// slab of n * c / groups elements larger than the shared memory one block
// may use.
extern "C" int rcdms_group_norm_act_slab(int dtype, int silu,
                                         const void* x, const void* scale,
                                         const void* bias, void* y, int batch,
                                         int n, int c, int groups, float eps,
                                         void* stream) {
  using namespace rcdms;
  if (batch <= 0 || n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
      c / groups > kGnThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == kFloat32)
    return gn_slab_by_act<float>(silu, x, sc, bi, y, batch, n, c, groups,
                                 eps, s);
  if (dtype == kBFloat16)
    return gn_slab_by_act<__nv_bfloat16>(silu, x, sc, bi, y, batch, n, c,
                                         groups, eps, s);
  return cudaErrorInvalidValue;
}

// The fused GroupNorm + activation (b). x, y: (batch, n, c), one dtype,
// 16-byte aligned, c * itemsize a multiple of 16; scale, bias: (c,) fp32;
// groups divides c. silu: 1 for silu, 0 for no activation. The plan of
// ops/group_norm.py::_plan: slab_groups groups a slab, clusters of
// `cluster` CTAs, `rows` tokens a CTA, `threads` a CTA and its shared
// memory bytes, which must be the kernel's layout.
extern "C" int rcdms_group_norm_act(int dtype, int silu, const void* x,
                                    const void* scale, const void* bias,
                                    void* y, int batch, int n, int c,
                                    int groups, float eps, int slab_groups,
                                    int cluster, int rows, int threads,
                                    int smem, void* stream) {
  using namespace rcdms;
  if (batch <= 0 || batch > 65535 || n <= 0 || c <= 0 || groups <= 0 ||
      c % groups != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == kFloat32)
    return gn_cluster_by_act<float>(silu, x, sc, bi, y, batch, n, c, groups,
                                    eps, slab_groups, cluster, rows, threads,
                                    smem, s);
  if (dtype == kBFloat16)
    return gn_cluster_by_act<__nv_bfloat16>(silu, x, sc, bi, y, batch, n, c,
                                            groups, eps, slab_groups, cluster,
                                            rows, threads, smem, s);
  return cudaErrorInvalidValue;
}
