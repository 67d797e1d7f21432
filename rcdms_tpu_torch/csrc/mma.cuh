// Warp-level tensor-core helpers of the mma.sync attention kernel E
// (smallk_attention.cu); its bf16 packing and exp2 helpers also serve
// kernel A (attention.cu).
//
// Fragment layouts of mma.sync m16n8k16 (g = lane / 4, t = lane % 4): an
// fp32 accumulator of an n8 tile holds rows g (regs 0, 1) and g + 8 (regs
// 2, 3) at columns 2t, 2t+1; an A fragment (16 x 16) holds rows g / g + 8
// at columns 2t, 2t+1 (regs 0 / 1) and 2t+8, 2t+9 (regs 2 / 3); a B
// fragment (16 x 8) holds rows 2t, 2t+1 (reg 0) and 2t+8, 2t+9 (reg 1) at
// column g. So two neighbouring n8 accumulator tiles, packed to bf16 pairs,
// are as they stand the A fragment of the next product (the C -> A
// identity), and movmatrix's 8 x 8 transpose of a packed accumulator pair
// gives a B fragment.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace rcdms {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i ... 8i+7 give the
// row addresses of matrix i, which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 x 8 bf16 matrix whose row g, columns 2t, 2t+1 this lane holds,
// transposed in registers: the lane gets row g, columns 2t, 2t+1 of the
// transpose.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two halves of a bf16 pair as floats.
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
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
