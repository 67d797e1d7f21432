// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads its operands as float32 or bfloat16 and does all of its
// arithmetic in float32. A C entry point takes the element type as an int
// (kFloat32 / kBFloat16), launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rcdms {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` (needed above
// 48 KB) and report the error, if any.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace rcdms
