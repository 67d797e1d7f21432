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
// cannot rotate bf16 operands). Here the shift moves to the operand: a block
// loads one token window per channel chunk, its tokens plus a halo of
// ha >= wp + 1 on each side, and takes all nine taps from that one window in
// shared memory, so each x element comes from memory once, not nine times.
//
// What bounds it on the H100: 37.7 GFLOP of real work at the study shape
// (B 5, C = Cout = 320, 64 x 64) against 14.7 MB of x, so the products, not
// device memory, are the limit. Two kernels:
//   * tensor cores (bf16; T and Cout multiples of 8, 16-byte aligned x and
//     w9): an implicit GEMM with M = Cout, N = tokens, K = 9 taps x C, as
//     WMMA 16x16x16 bf16 products with fp32 accumulators. A block of 8 warps
//     owns 160 output channels x 192 tokens (a warp 80 x 48: 5 x 3
//     accumulator fragments). Per 16-channel chunk it stages the window
//     token-major ([token][channel], so a tap's shift picks whole rows and
//     every fragment pointer stays 32-byte aligned) and the chunk's weights
//     of all nine taps; the next chunk's loads (x through registers, since
//     the window is transposed on its way in, the weights by cp.async) are
//     in flight while the current one multiplies.
//   * CUDA cores (fp32, and bf16 shapes the tensor-core kernel does not
//     take): 64 output channels x 64 tokens a block, 4 x 4 outputs a thread,
//     fp32 FMA from a shared-memory window of 8 channels.
#include <mma.h>
#include <type_traits>

#include "common.cuh"

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

// ---- the bf16 tensor-core kernel ------------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kTcBM = 160;          // output channels a block (2 warps x 80)
constexpr int kTcBN = 192;          // tokens a block (4 warps x 48)
constexpr int kTcKC = 16;           // channels a chunk: one WMMA depth
constexpr int kTcLdW = kTcBM + 16;  // bf16 row of a weight tile (32-byte rows)
constexpr int kTcLdO = kTcBN + 8;   // fp32 row of the output staging tile
constexpr int kTcXRegs = 3;         // 16-byte x vectors a thread per chunk

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The halo, rounded up to whole 8-token vectors so the window starts on a
// 16-byte boundary of x.
__host__ __device__ __forceinline__ int tc_halo(int wp) {
  return (wp + 1 + 7) / 8 * 8;
}

// Byte layout of one pipeline stage: the token-major x window [rows][16]
// (32-byte rows) and the weights [9][16][kTcLdW]. Two stages; the output
// staging tile reuses them after the last chunk.
struct TcLayout {
  int rows, x_bytes, stage, total;
  __host__ __device__ explicit TcLayout(int wp) {
    rows = kTcBN + 2 * tc_halo(wp);
    x_bytes = rows * kTcKC * 2;
    stage = x_bytes + 9 * kTcKC * kTcLdW * 2;
    const int staging = kTcBM * kTcLdO * 4;
    total = 2 * stage > staging ? 2 * stage : staging;
  }
};

template <bool SHIFTS>
__global__ void __launch_bounds__(kThreads, 1)
    cm_conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
                      const bf16* __restrict__ bias,
                      const bf16* __restrict__ mask, bf16* __restrict__ out,
                      int c, int cout, int tokens, int wp) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const TcLayout L(wp);
  const int ha = tc_halo(wp);
  const int vecs = L.rows / 8;  // 8-token vectors a window row of x has

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // this warp's 80 x 48 piece
  const int t0 = blockIdx.x * kTcBN, d0 = blockIdx.y * kTcBM, b = blockIdx.z;
  const bf16* xb = x + (long)b * c * tokens;
  bf16* ob = out + (long)b * cout * tokens;

  if (!tile_needed(mask, t0, kTcBN, tokens)) {
    for (int e = tid; e < kTcBM * kTcBN; e += kThreads) {
      const int d = d0 + e / kTcBN, t = t0 + e % kTcBN;
      if (d < cout && t < tokens)
        ob[(long)d * tokens + t] = from_float<bf16>(0.f);
    }
    return;
  }

  auto x_tile = [&](int st) {
    return reinterpret_cast<bf16*>(tc_smem + st * L.stage);
  };
  auto w_tile = [&](int st) {
    return reinterpret_cast<bf16*>(tc_smem + st * L.stage + L.x_bytes);
  };

  // x window of chunk c0 into registers: vector e = (channel e % 16,
  // 8 tokens from e / 16 * 8); lanes 16 apart hold neighbouring vectors of
  // one channel, so a warp reads whole 32-byte sectors.
  uint4 xr[kTcXRegs];
  auto load_x = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kTcXRegs; ++r) {
      const int e = tid + r * kThreads;
      const int k = e % kTcKC, v = e / kTcKC;
      const int ch = c0 + k, t = t0 - ha + v * 8;
      xr[r] = make_uint4(0, 0, 0, 0);
      if (v < vecs && ch < c && t >= 0 && t < tokens)
        xr[r] = *reinterpret_cast<const uint4*>(xb + (long)ch * tokens + t);
    }
  };
  // ... and from registers into the token-major window [row][channel]
  auto store_x = [&](int st) {
    bf16* xt = x_tile(st);
#pragma unroll
    for (int r = 0; r < kTcXRegs; ++r) {
      const int e = tid + r * kThreads;
      const int k = e % kTcKC, v = e / kTcKC;
      if (v >= vecs) continue;
      const unsigned w[4] = {xr[r].x, xr[r].y, xr[r].z, xr[r].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // token 2j in the low half of word j
        bf16* row = xt + (v * 8 + 2 * j) * kTcKC + k;
        row[0] = __ushort_as_bfloat16(static_cast<unsigned short>(w[j]));
        row[kTcKC] =
            __ushort_as_bfloat16(static_cast<unsigned short>(w[j] >> 16));
      }
    }
  };
  // the chunk's weights of all nine taps, [s][k][m], by cp.async
  auto load_w = [&](int c0, int st) {
    bf16* wt = w_tile(st);
    constexpr int kVecs = kTcBM / 8;
    for (int e = tid; e < 9 * kTcKC * kVecs; e += kThreads) {
      const int s = e / (kTcKC * kVecs), k = e / kVecs % kTcKC;
      const int m = e % kVecs * 8;
      const int ch = c0 + k, d = d0 + m;
      const bool ok = ch < c && d < cout;
      cp_async16(wt + (s * kTcKC + k) * kTcLdW + m,
                 ok ? w9 + ((long)s * c + ch) * cout + d : w9, ok);
    }
    cp_async_commit();
  };

  FragC acc[5][3];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_w(0, 0);
  load_x(0);
  store_x(0);
  cp_async_wait<0>();
  __syncthreads();

  const int chunks = (c + kTcKC - 1) / kTcKC;
  for (int ch = 0; ch < chunks; ++ch) {
    const int st = ch & 1;
    const bool next = ch + 1 < chunks;
    if (next) {
      load_w((ch + 1) * kTcKC, st ^ 1);
      load_x((ch + 1) * kTcKC);
    }
    const bf16* xt = x_tile(st);
    const bf16* wt = w_tile(st);
#pragma unroll 1
    for (int s = 0; s < 9; ++s) {
      const int row0 = ha + (SHIFTS ? tap_offset(s, wp) : 0) + wn * 48;
      FragA a[5];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        wmma::load_matrix_sync(a[i], wt + s * kTcKC * kTcLdW + wm * 80 + i * 16,
                               kTcLdW);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, xt + (row0 + j * 16) * kTcKC, kTcKC);
#pragma unroll
        for (int i = 0; i < 5; ++i)
          wmma::mma_sync(acc[i][j], a[i], fb, acc[i][j]);
      }
    }
    if (next) store_x(st ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- bias, rounding, mask: through an fp32 staging tile, so that a row
  // of tokens goes out in order -------------------------------------------
  float* stage_o = reinterpret_cast<float*>(tc_smem);
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wmma::store_matrix_sync(
          stage_o + (wm * 80 + i * 16) * kTcLdO + wn * 48 + j * 16, acc[i][j],
          kTcLdO, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTcBM * kTcBN; e += kThreads) {
    const int m = e / kTcBN, n = e % kTcBN;
    const int d = d0 + m, t = t0 + n;
    if (d < cout && t < tokens)
      ob[(long)d * tokens + t] =
          epilogue(stage_o[m * kTcLdO + n], bias, mask, d, t);
  }
}

template <bool SHIFTS>
cudaError_t launch_tc(const void* x, const void* w9, const void* bias,
                      const void* mask, void* out, int batch, int c, int cout,
                      int tokens, int wp, cudaStream_t stream) {
  if (tokens % 8 != 0 || cout % 8 != 0) return cudaErrorInvalidValue;
  const TcLayout L(wp);
  if ((L.rows / 8) * kTcKC > kTcXRegs * kThreads) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(cm_conv_tc_kernel<SHIFTS>, L.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((tokens + kTcBN - 1) / kTcBN, (cout + kTcBM - 1) / kTcBM,
                  batch);
  cm_conv_tc_kernel<SHIFTS><<<grid, kThreads, L.total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(mask),
      static_cast<bf16*>(out), c, cout, tokens, wp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tensor, int shifts, const void* x, const void* w9,
                     const void* bias, const void* mask, void* out, int batch,
                     int c, int cout, int tokens, int wp, cudaStream_t s) {
  if (tensor) {
    if constexpr (std::is_same<T, bf16>::value) {
      if (shifts)
        return launch_tc<true>(x, w9, bias, mask, out, batch, c, cout, tokens,
                               wp, s);
      return launch_tc<false>(x, w9, bias, mask, out, batch, c, cout, tokens,
                              wp, s);
    }
    return cudaErrorInvalidValue;
  }
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
// frame's row width (tap offsets dy * wp + dx). tensor: 1 for the
// tensor-core kernel (bf16; tokens and cout multiples of 8, x and w9 16-byte
// aligned), 0 for the CUDA-core one. shifts: 0 drops the tap offsets.
extern "C" int rcdms_cm_conv_fwd(int dtype, int tensor, int shifts,
                                 const void* x, const void* w9,
                                 const void* bias, const void* mask, void* out,
                                 int batch, int c, int cout, int tokens,
                                 int wp, void* stream) {
  using namespace rcdms;
  if (batch <= 0 || c <= 0 || cout <= 0 || tokens <= 0 || wp <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(tensor, shifts, x, w9, bias, mask, out, batch, c,
                           cout, tokens, wp, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(tensor, shifts, x, w9, bias, mask, out,
                                   batch, c, cout, tokens, wp, s);
  return cudaErrorInvalidValue;
}
