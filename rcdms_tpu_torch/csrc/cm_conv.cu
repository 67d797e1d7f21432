// The channel-major 3x3 SAME conv of the level-0 conv study, in the padded
// frame layout: the (h + 2) x (w + 2) zero-ringed frame of each channel is
// one row of T >= (h + 2)(w + 2) tokens (row width wp = w + 2), so tap
// (dy, dx) is a plain token offset dy * wp + dx:
//
//   out[b, d, t] = mask[t] * round(bias[d]
//                    + sum_s sum_c w9[s, c, d] * x[b, c, t + TAPS[s]])
//
// x (B, C, T), w9 (9, C, Cout), bias (Cout,), mask (T,), out (B, Cout, T),
// taps s = 3 (dy + 1) + (dx + 1). Sums in fp32, bias added, rounded to the
// operand type, then multiplied by the mask. Taps that read outside [0, T)
// read zero. Where the mask is 0 the kernel writes 0 without computing (the
// ring and tail tokens, which the mask zeroes anyway). shifts = false drops
// the tap offsets (every tap reads x[b, c, t]): the study's pure-product row.
//
// Replaces tools/cm_conv_study.py::_cm_kernel, which multiplies the whole
// (C, T) frame by each tap's weights and rolls the fp32 partial sums (Mosaic
// cannot rotate bf16 operands). Here the shift moves to the operand: each
// tap reads its own x tile at the shifted token coordinate.
//
// What bounds it on the H100: 37.7 GFLOP of real work at the study shape
// (B 5, C = Cout = 320, 64 x 64) against 14.7 MB of x, so the products, not
// device memory, are the limit; the tiles' repeated reads of x and the
// weights come from the 50 MB L2. Two kernels:
//   * tensor cores (bf16; T and Cout multiples of 8, 16-byte aligned x and
//     w9, any C and wp): an implicit GEMM per frame with M = Cout,
//     N = tokens, K = 9 taps x C, taken in stages of one tap x 64 channels.
//     A TMA box cannot start at an odd token of the channel-major x (the
//     H100 raised an illegal instruction for one at a shifted token
//     coordinate, where the unshifted boxes ran right), so a first kernel
//     lays x out token-major once per call, xt (B, G + T, Cp): G = wp + 1
//     zero rows ahead of each frame, the channels padded with zeros to
//     Cp, a multiple of 8 (a TMA row stride is a multiple of 16 bytes).
//     Then a tap's x tile is one box of token rows at row
//     G + t0 + off_s >= 0: the guard rows give the taps that read before
//     token 0, TMA's zero fill those past T, the partial channel chunk and
//     the Cout tail. The GEMM kernel: a block owns 64 mt output channels
//     (mt <= 5, from ops/cm_conv.py::_plan) x 96 tokens, a size chosen for
//     the waves: at the study shape 225 live blocks fill two waves of the
//     132 SMs about as well as 170 blocks of 128 tokens, each a quarter
//     smaller. One producer thread keeps a four-stage ring of TMA loads in
//     flight: per stage mt boxes of w9 ([64 channels][64 Cout], Cout
//     contiguous: MN-major) and two of xt ([48 tokens][64 channels]:
//     K-major). Two consumer warpgroups of 48 tokens each run
//     wgmma.mma_async m64n48k16 (A transposed), mt fp32 accumulator tiles
//     in registers (24 mt a thread, setmaxnreg moving registers from the
//     producer warpgroup to them); the epilogue adds the bias, rounds once,
//     multiplies by the mask and stores bf16 pairs in token order. A block
//     whose 96 tokens are all masked writes zeros and loads nothing.
//   * CUDA cores (fp32, and bf16 shapes the tensor-core kernel does not
//     take): 64 output channels x 64 tokens a block, 4 x 4 outputs a thread,
//     fp32 FMA from a shared-memory window of 8 channels.
#include "common.cuh"
#include "wgmma.cuh"

namespace rcdms {
namespace {

__device__ __forceinline__ int tap_offset(int s, int wp) {
  return (s / 3 - 1) * wp + (s % 3 - 1);
}

// True for every thread when some token of [t0, t0 + bn) has a nonzero mask.
// Needs bn <= blockDim.x.
template <typename T>
__device__ __forceinline__ bool tile_needed(const T* mask, int t0, int bn,
                                            int tokens) {
  const int t = t0 + threadIdx.x;
  const bool live = threadIdx.x < bn && t < tokens && to_float(mask[t]) != 0.f;
  return __syncthreads_or(live);
}

template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, const T* mask,
                                      int d, int t) {
  const float m = to_float(mask[t]);
  if (m == 0.f) return from_float<T>(0.f);
  const float v = to_float(from_float<T>(acc + to_float(bias[d])));
  return from_float<T>(v * m);
}

// ---- the CUDA-core kernel -------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output channels a block
constexpr int kBN = 64;  // tokens a block
constexpr int kKC = 8;   // channels a chunk

template <typename T, bool SHIFTS>
__global__ void __launch_bounds__(kThreads)
    cm_conv_kernel(const T* __restrict__ x, const T* __restrict__ w9,
                   const T* __restrict__ bias, const T* __restrict__ mask,
                   T* __restrict__ out, int c, int cout, int tokens, int wp) {
  extern __shared__ float smem[];
  const int ha = wp + 1;
  const int win = kBN + 2 * ha;
  float* xs = smem;                // [kKC][win]
  float* ws = smem + kKC * win;    // [9][kKC][kBM]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kBN, d0 = blockIdx.y * kBM, b = blockIdx.z;
  const T* xb = x + (long)b * c * tokens;
  T* ob = out + (long)b * cout * tokens;

  if (!tile_needed(mask, t0, kBN, tokens)) {
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int d = d0 + e / kBN, t = t0 + e % kBN;
      if (d < cout && t < tokens) ob[(long)d * tokens + t] = from_float<T>(0.f);
    }
    return;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < c; c0 += kKC) {
    __syncthreads();
    for (int e = tid; e < kKC * win; e += kThreads) {
      const int k = e / win, i = e % win;
      const int ch = c0 + k, t = t0 - ha + i;
      xs[e] = (ch < c && t >= 0 && t < tokens)
                  ? to_float(xb[(long)ch * tokens + t])
                  : 0.f;
    }
    for (int e = tid; e < 9 * kKC * kBM; e += kThreads) {
      const int s = e / (kKC * kBM), k = e / kBM % kKC, m = e % kBM;
      const int ch = c0 + k, d = d0 + m;
      ws[e] = (ch < c && d < cout) ? to_float(w9[((long)s * c + ch) * cout + d])
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < 9; ++s) {
      const int off = ha + (SHIFTS ? tap_offset(s, wp) : 0);
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        float a[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = ws[(s * kKC + k) * kBM + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = xs[k * win + off + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * v[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 16 * i;
    if (d >= cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      if (t < tokens)
        ob[(long)d * tokens + t] = epilogue(acc[i][j], bias, mask, d, t);
    }
  }
}

template <typename T, bool SHIFTS>
cudaError_t launch(const void* x, const void* w9, const void* bias,
                   const void* mask, void* out, int batch, int c, int cout,
                   int tokens, int wp, cudaStream_t stream) {
  const int win = kBN + 2 * (wp + 1);
  const int smem = (kKC * win + 9 * kKC * kBM) * (int)sizeof(float);
  cudaError_t err = allow_smem(cm_conv_kernel<T, SHIFTS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tokens + kBN - 1) / kBN, (cout + kBM - 1) / kBM, batch);
  cm_conv_kernel<T, SHIFTS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w9),
      static_cast<const T*>(bias), static_cast<const T*>(mask),
      static_cast<T*>(out), c, cout, tokens, wp);
  return cudaGetLastError();
}

// ---- the bf16 tensor-core kernel (TMA + wgmma) ---------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBN = 96;        // tokens a block: two warpgroups of 48
constexpr int kTcKC = 64;        // channels a stage: one 128-byte row
constexpr int kTcStages = 4;     // depth of the TMA ring
constexpr int kTcThreads = 384;  // a producer and 2 consumer warpgroups
// Registers a thread of the producer / a consumer warpgroup keeps after
// setmaxnreg: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536 (at 384
// threads ptxas allots at most 168 a thread). Must agree with
// cm_conv.py::_plan.
constexpr int kTcProducerRegs = 40;
constexpr int kTcConsumerRegs = 232;
constexpr int kTcTile = 64 * kTcKC * 2;  // a w9 box [64][64], 8 KB
constexpr int kTcXTile = kTcBN / 2 * kTcKC * 2;  // an xt box [48][64], 6 KB

// x (B, C, T) -> xt (B, G + T, Cp), token-major, rows [0, G) and
// channels [C, Cp) zero: a block moves 64 tokens x 64 channels through
// shared memory, reading 16-byte vectors along tokens and writing them
// along channels (T and Cp multiples of 8), so a warp reads and writes
// whole 128-byte lines. The tile's 16-byte chunks are XOR-swizzled by the
// channel's eighth, so the transposing reads hit 8 different chunks. The
// blocks of the first token tile also zero the guard rows.
__global__ void __launch_bounds__(256)
    cm_conv_relayout_kernel(const bf16* __restrict__ x, bf16* __restrict__ xt,
                            int c, int cp, int tokens, int guard) {
  __shared__ __align__(16) bf16 tile[64][64];  // [channel][token chunks]
  const int t0 = blockIdx.x * 64, c0 = blockIdx.y * 64, b = blockIdx.z;
  const int tid = threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  bf16* ob = xt + (long)b * (guard + tokens) * cp;
  if (blockIdx.x == 0)
    for (int e = tid; e < guard * 8; e += 256) {
      const int ch = c0 + e % 8 * 8;
      if (ch < cp) *reinterpret_cast<uint4*>(ob + (long)(e / 8) * cp + ch) =
          zero;
    }
  const bf16* xb = x + (long)b * c * tokens;
  for (int e = tid; e < 64 * 8; e += 256) {  // 8 lanes along a channel
    const int k = e / 8, v = e % 8, t = t0 + 8 * v;
    uint4 val = zero;
    if (c0 + k < c && t < tokens)
      val = *reinterpret_cast<const uint4*>(xb + (long)(c0 + k) * tokens + t);
    *reinterpret_cast<uint4*>(&tile[k][8 * (v ^ (k >> 3))]) = val;
  }
  __syncthreads();
  for (int e = tid; e < 64 * 8; e += 256) {  // 8 lanes along a token's row
    const int v = e % 8, tt = e / 8, ch = c0 + 8 * v;
    if (t0 + tt >= tokens || ch >= cp) continue;
    __align__(16) bf16 val[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      val[u] = tile[8 * v + u][8 * ((tt >> 3) ^ v) + (tt & 7)];
    *reinterpret_cast<uint4*>(ob + (long)(guard + t0 + tt) * cp + ch) =
        *reinterpret_cast<const uint4*>(val);
  }
}

// Shared memory: a ring of kTcStages stages, each MT w9 boxes and two xt
// boxes (every box 1024-byte aligned in TMA's 128-byte swizzle), then the
// full and empty mbarriers of each stage, plus 1024 bytes to align the
// ring. Must agree with rcdms_tpu_torch/ops/cm_conv.py::_plan.
template <int MT>
struct ConvShape {
  static constexpr int STAGE = MT * kTcTile + 2 * kTcXTile;
  static constexpr int BARS = kTcStages * STAGE;
  static constexpr int BYTES = BARS + 2 * kTcStages * 8 + 1024;
  static_assert(MT >= 1 && MT <= 5, "64 to 320 output channels a block");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// One block: output channels [d0, d0 + 64 MT) x tokens [t0, t0 + 96) of
// frame b. Warpgroup 0 is the producer (one thread issues the TMA loads),
// warpgroups 1 and 2 the consumers (tokens t0 + 48 (wg - 1) ...). Stage
// i of the K loop is tap i % 9 of channel chunk i / 9. The ring's stage s
// is filled when full[s] completes (TMA bytes) and free when empty[s]
// completes (one arrival per consumer warp).
template <int MT>
__global__ void __launch_bounds__(kTcThreads, 1)
    cm_conv_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const bf16* __restrict__ bias,
                      const bf16* __restrict__ mask, bf16* __restrict__ out,
                      int c, int cout, int tokens, int wp, int shifts) {
  // xmap: xt (B, wp + 1 + T, Cp); wmap: w9 (9, C, Cout)
  using S = ConvShape<MT>;
  extern __shared__ unsigned char tc_smem[];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTcBN, d0 = blockIdx.y * 64 * MT;
  const int b = blockIdx.z;
  bf16* ob = out + (long)b * cout * tokens;

  if (!tile_needed(mask, t0, kTcBN, tokens)) {
    for (int e = tid; e < 64 * MT * kTcBN; e += kTcThreads) {
      const int d = d0 + e / kTcBN, t = t0 + e % kTcBN;
      if (d < cout && t < tokens)
        ob[(long)d * tokens + t] = from_float<bf16>(0.f);
    }
    return;
  }

  const uint32_t raw = smem_addr(tc_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + S::BARS;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kTcStages;
  const int warp = tid / 32, lane = tid % 32;
  const int nk = 9 * ((c + kTcKC - 1) / kTcKC);

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup -------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (warp == 0 && lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kTcStages;
        const int tap = i % 9, c0 = i / 9 * kTcKC;
        const int row = wp + 1 + t0 + (shifts ? tap_offset(tap, wp) : 0);
        mbar_wait(empty + 8 * s, ((i / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, S::STAGE);
        const uint32_t st = ring + s * S::STAGE;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          tma_load_3d(st + m * kTcTile, &wmap, d0 + 64 * m, c0, tap,
                      full + 8 * s);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tma_load_3d(st + MT * kTcTile + h * kTcXTile, &xmap, c0,
                      row + kTcBN / 2 * h, b, full + 8 * s);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kTcConsumerRegs));
  const int wg = warp / 4 - 1;
  constexpr int kAcc = kTcBN / 4;  // n48: 24 accumulators a tile
  float acc[MT][kAcc];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[m][j] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % kTcStages;
    mbar_wait(full + 8 * s, (i / kTcStages) & 1);
    const uint32_t st = ring + s * S::STAGE;
    const uint64_t dw = sw128_mn_desc(st);
    const uint64_t dx = sw128_desc(st + MT * kTcTile + wg * kTcXTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKC / 16; ++kk)  // w9: 16 rows; xt: 32 bytes
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wgmma<kTcBN / 2, 1, 0>(acc[m], dw + m * (kTcTile >> 4) + 128 * kk,
                               dx + 2 * kk);
    wgmma_commit();
    if (i > 0) {  // the previous stage's products are done: free it
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kTcStages));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);

  // ---- epilogue: bias, one rounding, mask; bf16 pairs in token order -----
  constexpr int kN8 = kTcBN / 16;  // n8 column blocks of a warpgroup
  const int t_lo = t0 + kTcBN / 2 * wg + 2 * (lane % 4);
  float mk[kN8][2];
#pragma unroll
  for (int j = 0; j < kN8; ++j) {
    const int t = t_lo + 8 * j;  // tokens is even, so t < tokens => t + 1 too
    mk[j][0] = t < tokens ? to_float(mask[t]) : 0.f;
    mk[j][1] = t < tokens ? to_float(mask[t + 1]) : 0.f;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + 64 * m + 16 * (warp % 4) + lane / 4 + 8 * half;
      if (d >= cout) continue;
      const float bd = to_float(bias[d]);
      bf16* row = ob + (long)d * tokens;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const int t = t_lo + 8 * j;
        if (t >= tokens) continue;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float r = to_float(
              from_float<bf16>(acc[m][4 * j + 2 * half + u] + bd));
          v[u] = mk[j][u] == 0.f ? 0.f : r * mk[j][u];
        }
        *reinterpret_cast<__nv_bfloat162*>(row + t) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <int MT>
cudaError_t launch_tc(int shifts, const void* x, const void* w9,
                      const void* bias, const void* mask, void* out,
                      void* xt, int batch, int c, int cout, int tokens,
                      int wp, int smem, cudaStream_t stream) {
  using S = ConvShape<MT>;
  if (smem != S::BYTES) return cudaErrorInvalidValue;
  const int cp = (c + 7) / 8 * 8, rows = wp + 1 + tokens;
  const dim3 rgrid((tokens + 63) / 64, (cp + 63) / 64, batch);
  cm_conv_relayout_kernel<<<rgrid, 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(xt), c, cp, tokens,
      wp + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // xt (B, rows, Cp) and w9 (9, C, Cout), innermost dimension first
  CUtensorMap xmap, wmap;
  const uint64_t xdims[3] = {(uint64_t)cp, (uint64_t)rows, (uint64_t)batch};
  const uint64_t xstrides[2] = {(uint64_t)cp * 2, (uint64_t)cp * rows * 2};
  const uint32_t xbox[3] = {(uint32_t)kTcKC, kTcBN / 2, 1};
  err = make_bf16_map(&xmap, xt, 3, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {(uint64_t)cout, (uint64_t)c, 9};
  const uint64_t wstrides[2] = {(uint64_t)cout * 2, (uint64_t)cout * c * 2};
  const uint32_t wbox[3] = {64, (uint32_t)kTcKC, 1};
  err = make_bf16_map(&wmap, w9, 3, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  err = allow_smem(cm_conv_tc_kernel<MT>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((tokens + kTcBN - 1) / kTcBN,
                  (cout + 64 * MT - 1) / (64 * MT), batch);
  cm_conv_tc_kernel<MT><<<grid, kTcThreads, S::BYTES, stream>>>(
      xmap, wmap, static_cast<const bf16*>(bias),
      static_cast<const bf16*>(mask), static_cast<bf16*>(out), c, cout,
      tokens, wp, shifts);
  return cudaGetLastError();
}

// The block heights (mt) that cm_conv.py::_plan chooses from.
cudaError_t dispatch_tc(int mt, int shifts, const void* x, const void* w9,
                        const void* bias, const void* mask, void* out,
                        void* xt, int batch, int c, int cout, int tokens,
                        int wp, int smem, cudaStream_t s) {
  if (tokens % 8 != 0 || cout % 8 != 0) return cudaErrorInvalidValue;
  switch (mt) {
#define RCDMS_CONV_CASE(MT)                                                  \
  case MT:                                                                   \
    return launch_tc<MT>(shifts, x, w9, bias, mask, out, xt, batch, c, cout, \
                         tokens, wp, smem, s);
    RCDMS_CONV_CASE(1)
    RCDMS_CONV_CASE(2)
    RCDMS_CONV_CASE(3)
    RCDMS_CONV_CASE(4)
    RCDMS_CONV_CASE(5)
#undef RCDMS_CONV_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int shifts, const void* x, const void* w9,
                     const void* bias, const void* mask, void* out, int batch,
                     int c, int cout, int tokens, int wp, cudaStream_t s) {
  if (shifts)
    return launch<T, true>(x, w9, bias, mask, out, batch, c, cout, tokens, wp,
                           s);
  return launch<T, false>(x, w9, bias, mask, out, batch, c, cout, tokens, wp,
                          s);
}

}  // namespace
}  // namespace rcdms

// x: (batch, c, tokens); w9: (9, c, cout); bias: (cout,); mask: (tokens,);
// out: (batch, cout, tokens). All contiguous, one dtype. wp: the padded
// frame's row width (tap offsets dy * wp + dx). shifts: 0 drops the tap
// offsets. mt > 0 takes the tensor-core kernels (bf16; tokens and cout
// multiples of 8, x and w9 16-byte aligned) with blocks of 64 mt output
// channels and smem bytes of shared memory, the plan of
// cm_conv.py::_plan, which must be what the kernel lays out, and xt a
// scratch of (batch, wp + 1 + tokens, c rounded up to 8) bf16, 16-byte
// aligned; mt = 0 the CUDA-core one (xt unused).
extern "C" int rcdms_cm_conv_fwd(int dtype, int mt, int smem, int shifts,
                                 const void* x, const void* w9,
                                 const void* bias, const void* mask, void* out,
                                 void* xt, int batch, int c, int cout,
                                 int tokens, int wp, void* stream) {
  using namespace rcdms;
  if (batch <= 0 || c <= 0 || cout <= 0 || tokens <= 0 || wp <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt > 0) {
    if (dtype != kBFloat16) return cudaErrorInvalidValue;
    return dispatch_tc(mt, shifts, x, w9, bias, mask, out, xt, batch, c,
                       cout, tokens, wp, smem, s);
  }
  if (dtype == kFloat32)
    return dispatch<float>(shifts, x, w9, bias, mask, out, batch, c, cout,
                           tokens, wp, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(shifts, x, w9, bias, mask, out, batch, c,
                                   cout, tokens, wp, s);
  return cudaErrorInvalidValue;
}
