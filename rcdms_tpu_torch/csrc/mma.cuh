// Register-level helpers of the attention kernels A (attention.cu) and E
// (smallk_attention.cu): P packed into the bf16 pairs of wgmma's RS-form A
// fragments, the MUFU's exp2 and a fast reciprocal.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace rcdms {

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 1 / x within 2 ulp, inline (no slow-path call) for x in [2^-126, 2^126]
__device__ __forceinline__ float fast_rcp(float x) {
  return __fdividef(1.f, x);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace rcdms
