// Kernel B: temporal (frame-axis) attention on the model's (b, f, n, c)
// layout. At every token n and head, the f <= 8 frames attend to each
// other: s_ij = q_i . k_j * scale over the head's dh channels, a softmax
// over j, and out_i = sum_j p_ij v_j. All arithmetic is fp32.
//
// Replaces rcdms_tpu/ops/frame_attention.py::_kernel_bfnc. The TPU kernel
// turned the per-head dot products into lane-dense elementwise products
// plus a skinny head-segment matmul, with the channel axis padded to 128
// lanes (the `c_pad` contract). None of that is needed here: c is read as
// it is.
//
// What bounds it on the H100: device memory. Per token it reads 3 * f * c
// values and writes f * c, and does O(f^2 * c) arithmetic, a few flops per
// byte. So the design is about coalescing: one warp per (batch, token,
// head), its lanes on consecutive channels, each operand read exactly
// once. Scores are reduced across the warp with shuffles; f is a template
// parameter so the f x f score tile stays in registers.
#include "common.cuh"

namespace rcdms {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int b, int n, int c, int heads, float scale) {
  const int lane = threadIdx.x % 32;
  const long task = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= (long)b * n * heads) return;  // whole warp leaves together
  const int h = task % heads;
  const long bt = task / heads;
  const int t = bt % n;
  const long bi = bt / n;
  const int dh = c / heads;
  const long frame = (long)n * c;  // stride between frames
  const long base = (bi * F * n + t) * (long)c + (long)h * dh;

  float s[F][F];
#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int j = 0; j < F; ++j) s[i][j] = 0.f;

  for (int d = lane; d < dh; d += 32) {
    float qd[F], kd[F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      qd[i] = to_float(q[base + i * frame + d]);
      kd[i] = to_float(k[base + i * frame + d]);
    }
#pragma unroll
    for (int i = 0; i < F; ++i)
#pragma unroll
      for (int j = 0; j < F; ++j) s[i][j] += qd[i] * kd[j];
  }

#pragma unroll
  for (int i = 0; i < F; ++i) {
#pragma unroll
    for (int j = 0; j < F; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
      s[i][j] *= scale;
    }
    float m = s[i][0];
#pragma unroll
    for (int j = 1; j < F; ++j) m = fmaxf(m, s[i][j]);
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      s[i][j] = expf(s[i][j] - m);
      denom += s[i][j];
    }
    const float inv = 1.f / denom;
#pragma unroll
    for (int j = 0; j < F; ++j) s[i][j] *= inv;
  }

  for (int d = lane; d < dh; d += 32) {
    float vd[F];
#pragma unroll
    for (int j = 0; j < F; ++j) vd[j] = to_float(v[base + j * frame + d]);
#pragma unroll
    for (int i = 0; i < F; ++i) {
      float out = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) out += s[i][j] * vd[j];
      o[base + i * frame + d] = from_float<T>(out);
    }
  }
}

template <typename T, int F>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int n, int c, int heads, float scale,
                   cudaStream_t stream) {
  const long tasks = (long)b * n * heads;
  const long blocks = (tasks + kWarps - 1) / kWarps;
  frame_attention_kernel<T, F><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), b, n, c, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int f, int n, int c, int heads, float scale,
                     cudaStream_t s) {
  switch (f) {
    case 1: return launch<T, 1>(q, k, v, o, b, n, c, heads, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, b, n, c, heads, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, b, n, c, heads, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, b, n, c, heads, scale, s);
    case 5: return launch<T, 5>(q, k, v, o, b, n, c, heads, scale, s);
    case 6: return launch<T, 6>(q, k, v, o, b, n, c, heads, scale, s);
    case 7: return launch<T, 7>(q, k, v, o, b, n, c, heads, scale, s);
    case 8: return launch<T, 8>(q, k, v, o, b, n, c, heads, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rcdms

// q, k, v, o: (b, f, n, c) contiguous, c = heads * dh, 1 <= f <= 8.
extern "C" int rcdms_frame_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, int b, int f, int n, int c,
                                         int heads, float scale,
                                         void* stream) {
  using namespace rcdms;
  if (b <= 0 || n <= 0 || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, o, b, f, n, c, heads, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, f, n, c, heads, scale, s);
  return cudaErrorInvalidValue;
}
