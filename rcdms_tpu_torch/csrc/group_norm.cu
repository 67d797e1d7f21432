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
// operand type. The study's point is one read and one write of x. The TPU
// kernel keeps a whole (N, C) slice in VMEM; at the study shapes that is
// 0.66-2.6 MB, beyond one SM's 228 KB. One group's slab is 20-80 KB in bf16,
// so one block per (batch row, group) reads its slab once into shared
// memory, summing the moments on the way, and writes the normalised and
// activated slab from there. A slab larger than the shared memory a block
// may use is refused (cudaErrorInvalidValue), as the study's fits_kernel
// refuses a slice larger than its VMEM budget. Bound by device memory:
// 26 MB read and written at (5, 4096, 320). Rows of C/G = 10-40 channels
// are partial-sector reads; wider loads are later work.
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

// ---- (b) fused GroupNorm + activation -------------------------------------

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
    gn_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int n,
                  int c, int groups, float eps) {
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
cudaError_t launch_gn(const void* x, const float* scale, const float* bias,
                      void* y, int batch, int n, int c, int groups, float eps,
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
  err = allow_smem(gn_act_kernel<T, SILU>, (int)bytes);
  if (err != cudaSuccess) return err;
  gn_act_kernel<T, SILU><<<dim3(groups, batch), kGnThreads, bytes, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), n, c, groups,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gn_by_act(int silu, const void* x, const float* scale,
                      const float* bias, void* y, int batch, int n, int c,
                      int groups, float eps, cudaStream_t s) {
  if (silu)
    return launch_gn<T, true>(x, scale, bias, y, batch, n, c, groups, eps, s);
  return launch_gn<T, false>(x, scale, bias, y, batch, n, c, groups, eps, s);
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

// x, y: (batch, n, c), one dtype; scale, bias: (c,) fp32; groups divides c
// and c / groups <= 512. silu: 1 for silu, 0 for no activation. Refuses
// (cudaErrorInvalidValue) a group slab of n * c / groups elements larger
// than the shared memory one block may use.
extern "C" int rcdms_group_norm_act(int dtype, int silu, const void* x,
                                    const void* scale, const void* bias,
                                    void* y, int batch, int n, int c,
                                    int groups, float eps, void* stream) {
  using namespace rcdms;
  if (batch <= 0 || n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
      c / groups > kGnThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == kFloat32)
    return gn_by_act<float>(silu, x, sc, bi, y, batch, n, c, groups, eps, s);
  if (dtype == kBFloat16)
    return gn_by_act<__nv_bfloat16>(silu, x, sc, bi, y, batch, n, c, groups,
                                    eps, s);
  return cudaErrorInvalidValue;
}
