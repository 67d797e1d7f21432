// Kernels C and D: the fused transformer feed-forward, one templated
// source for both activations.
//
//   C (GEGLU): y = (x W1h^T + b1h) * gelu(x W1g^T + b1g) W2^T + b2
//   D (GELU):  y = gelu(x W1^T + b1) W2^T + b2
//
// with exact (erff) gelu. Weights keep torch's Linear layout: w1 is
// (up, c) with up = 2*inner for GEGLU (hidden half first, gate half
// second), w2 is (c, inner).
//
// Replaces rcdms_tpu/ops/geglu.py::_ff_kernel (C) and ::_ff_gelu_kernel
// (D). Like them, it never writes the (rows, inner) intermediate to device
// memory: a block computes an intermediate tile of BM rows x 64 inner
// columns in shared memory, applies the activation, and at once
// accumulates that tile's share of the second product into registers. Rows
// need no padding: the ragged tail (the prior's 970 rows) is masked.
//
// What bounds it on the H100: an fp32 accumulator for all c output
// columns of 64 rows at c = 2048 is 512 KB, far above the 227 KB of shared
// memory, let alone registers. So a block owns a block of output columns,
// and a wide c is split over column blocks that each recompute the
// intermediate (more up-projection flops, no intermediate in memory). Two
// kernels:
//   * CUDA cores (fp32, and bf16 shapes the tensor-core kernel does not
//     take): 32 rows x 320 output columns a block, fp32 FMA staged through
//     shared memory; bound by the FMA rate and shared-memory reads.
//   * tensor cores (bf16; c and inner multiples of 8, 16-byte aligned x,
//     w1, w2: every FF of the main path): WMMA 16x16x16 bf16 products with
//     fp32 accumulators. A block of 8 warps holds 32 rows x BN = 128 * NC
//     output columns (512 or 640) in accumulator fragments, so a c of 320
//     or 640 needs one column block, 1280 two and 2048 four. Per 64-wide
//     inner chunk: H (32 x 64, and the gate) = x . W1 chunk^T over c in
//     64-deep stages, then bias + activation into a bf16 tile, then
//     acc += tile . W2 chunk^T. Every tile reaches shared memory by
//     cp.async two pipeline items ahead of its use. Each block reads all
//     of W1 for only 32 rows (W1 crosses L2 rows / 32 x column blocks
//     times), and a larger row block needs more accumulator registers
//     than a thread has; on the H100 it is slower than the two cuBLAS
//     products of the plain version (PERF.md). TMA, wgmma and a cluster
//     sharing each W1 tile are later work.
//
// The intermediate is rounded to the input type before the second
// product, as the plain version's is.
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace rcdms {
namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kBI = 64;        // inner columns per intermediate tile
constexpr int kBK = 32;        // c-depth per stage of the first product
constexpr int kBK2 = 16;       // inner-depth per stage of the second

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <int TM, int TN, bool GEGLU>
struct FFShape {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int WS = kBI + 1;  // padded row of a W1 tile
  static constexpr int BS = BN + 1;   // padded row of a W2 tile
  static constexpr int XS_OFF = 0;
  static constexpr int WH_OFF = XS_OFF + BM * kBK;
  static constexpr int WG_OFF = WH_OFF + kBK * WS;
  static constexpr int AS_OFF = WG_OFF + (GEGLU ? kBK * WS : 0);
  static constexpr int BS_OFF = AS_OFF + BM * kBI;
  static constexpr int FLOATS = BS_OFF + kBK2 * BS;
};

template <typename T, int TM, int TN, bool GEGLU>
__global__ void __launch_bounds__(kThreads)
    ff_kernel(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ b1, const T* __restrict__ w2,
              const T* __restrict__ b2, T* __restrict__ y, int rows, int c,
              int inner) {
  using S = FFShape<TM, TN, GEGLU>;
  extern __shared__ float smem[];
  float* xs = smem + S::XS_OFF;  // [BM][kBK]
  float* wh = smem + S::WH_OFF;  // [kBK][WS]   hidden (or only) half of W1
  float* wg = smem + S::WG_OFF;  // [kBK][WS]   gate half of W1 (GEGLU)
  float* as = smem + S::AS_OFF;  // [BM][kBI]   activated intermediate tile
  float* bs = smem + S::BS_OFF;  // [kBK2][BS]  W2 tile, inner-major

  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int row0 = blockIdx.x * S::BM;
  const int col0 = blockIdx.y * S::BN;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

  for (int i0 = 0; i0 < inner; i0 += kBI) {
    // ---- intermediate tile: (BM x kBI) = x (BM x c) . W1 tile^T ----------
    float hh[TM][4];
    float gg[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) hh[r][u] = gg[r][u] = 0.f;

    for (int k0 = 0; k0 < c; k0 += kBK) {
      __syncthreads();
      for (int idx = tid; idx < S::BM * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx % kBK;
        const int gr = row0 + r, gk = k0 + kk;
        xs[idx] = (gr < rows && gk < c) ? to_float(x[(long)gr * c + gk])
                                        : 0.f;
      }
      for (int idx = tid; idx < kBI * kBK; idx += kThreads) {
        const int nn = idx / kBK, kk = idx % kBK;
        const int gi = i0 + nn, gk = k0 + kk;
        const bool ok = gi < inner && gk < c;
        wh[kk * S::WS + nn] = ok ? to_float(w1[(long)gi * c + gk]) : 0.f;
        if (GEGLU)
          wg[kk * S::WS + nn] =
              ok ? to_float(w1[(long)(inner + gi) * c + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float xv = xs[(rg + 16 * r) * kBK + kk];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            hh[r][u] += xv * wh[kk * S::WS + cg + 16 * u];
            if (GEGLU) gg[r][u] += xv * wg[kk * S::WS + cg + 16 * u];
          }
        }
      }
    }

    // ---- bias + activation, rounded to T like the plain version --------
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gi = i0 + cg + 16 * u;
      const bool ok = gi < inner;
      const float bh = ok ? to_float(b1[gi]) : 0.f;
      const float bg = (ok && GEGLU) ? to_float(b1[inner + gi]) : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        float a;
        if (GEGLU) {
          const float hv = to_float(from_float<T>(hh[r][u] + bh));
          const float gv = to_float(from_float<T>(gg[r][u] + bg));
          a = hv * to_float(from_float<T>(gelu_erf(gv)));
        } else {
          a = gelu_erf(to_float(from_float<T>(hh[r][u] + bh)));
        }
        as[(rg + 16 * r) * kBI + cg + 16 * u] =
            ok ? to_float(from_float<T>(a)) : 0.f;
      }
    }

    // ---- acc (BM x BN) += intermediate tile . W2 tile -------------------
    for (int ii0 = 0; ii0 < kBI; ii0 += kBK2) {
      __syncthreads();  // `as` complete / previous W2 tile consumed
      for (int idx = tid; idx < S::BN * kBK2; idx += kThreads) {
        const int nn = idx / kBK2, kk = idx % kBK2;
        const int gcol = col0 + nn, gi = i0 + ii0 + kk;
        bs[kk * S::BS + nn] = (gcol < c && gi < inner)
                                  ? to_float(w2[(long)gcol * inner + gi])
                                  : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kBK2; ++kk) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float av = as[(rg + 16 * r) * kBI + ii0 + kk];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[r][j] += av * bs[kk * S::BS + cg + 16 * j];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + rg + 16 * r;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gcol = col0 + cg + 16 * j;
      if (gcol < c)
        y[(long)gr * c + gcol] =
            from_float<T>(acc[r][j] + to_float(b2[gcol]));
    }
  }
}

template <typename T, int TM, int TN, bool GEGLU>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int rows, int c,
                   int inner, cudaStream_t stream) {
  using S = FFShape<TM, TN, GEGLU>;
  const int smem = S::FLOATS * (int)sizeof(float);
  cudaError_t err = allow_smem(ff_kernel<T, TM, TN, GEGLU>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + S::BM - 1) / S::BM, (c + S::BN - 1) / S::BN);
  ff_kernel<T, TM, TN, GEGLU><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), rows, c, inner);
  return cudaGetLastError();
}

// ---- the bf16 tensor-core kernel ----------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kTcBM = 32;       // rows per block (2 fragment rows)
constexpr int kTcBI = 64;       // inner columns per chunk
constexpr int kTcBK = 64;       // c-depth per stage of the first product
constexpr int kTcLd = 64 + 8;   // bf16 row of an x / W1 / activation tile
constexpr int kTcLdH = 64 + 4;  // fp32 row of the staged H (and gate) tile
constexpr int kTcLdW2 = 32 + 8; // bf16 row of a W2 half-chunk (32 deep)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Byte offsets into shared memory, each 128-byte aligned (WMMA needs
// 32-byte aligned fragment pointers): a ring of three x + W1 stages, the
// fp32 H and gate tiles, the bf16 activation tile and the two W2 halves of
// a chunk. The final per-warp output scratch reuses the stage ring.
template <int NC, bool GEGLU>
struct TcShape {
  static constexpr int BN = 128 * NC;
  static constexpr int XS = kTcBM * kTcLd * 2;             // x stage tile
  static constexpr int WS = kTcBI * kTcLd * 2;             // a W1 stage tile
  static constexpr int STAGE = XS + WS * (GEGLU ? 2 : 1);  // x, W1h[, W1g]
  static constexpr int HF = 3 * STAGE;
  static constexpr int GF = HF + kTcBM * kTcLdH * 4;
  static constexpr int AS = GF + (GEGLU ? kTcBM * kTcLdH * 4 : 0);
  static constexpr int W2 = AS + kTcBM * kTcLd * 2;
  static constexpr int W2_HALF = BN * kTcLdW2 * 2;
  static constexpr int BYTES = W2 + 2 * W2_HALF;
  static_assert(8 * 16 * 16 * 4 <= 3 * STAGE, "per-warp output scratch");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// The block walks one sequence of pipeline items: per 64-wide inner chunk,
// nk = ceil(c / 64) stages of the first product and then the two 32-deep
// halves of the second. While item t computes, the loads of item t + 2 are
// in flight (cp.async), so each load has two items' time to land.
template <int NC, bool GEGLU>
__global__ void __launch_bounds__(kThreads)
    ff_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ y, int rows,
                 int c, int inner) {
  using S = TcShape<NC, GEGLU>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* hf = reinterpret_cast<float*>(tc_smem + S::HF);  // [32][kTcLdH]
  float* gf = reinterpret_cast<float*>(tc_smem + S::GF);  // [32][kTcLdH]
  bf16* as = reinterpret_cast<bf16*>(tc_smem + S::AS);    // [32][kTcLd]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * kTcBM;
  const int col0 = blockIdx.y * S::BN;
  // first product: this warp's 16 x 16 piece of the 32 x 64 H tile
  const int hr = warp / 4, hc = warp % 4;

  const int nk = (c + kTcBK - 1) / kTcBK;
  const int per_chunk = nk + 2;
  const int n_items = (inner + kTcBI - 1) / kTcBI * per_chunk;

  // stage s of the ring: x [32][kTcLd], W1h [64][kTcLd], W1g [64][kTcLd]
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(tc_smem + (s % 3) * S::STAGE);
  };
  auto w2_half = [&](int half) {
    return reinterpret_cast<bf16*>(tc_smem + S::W2 + half * S::W2_HALF);
  };

  // issue the loads of item t (nothing past the end)
  auto issue = [&](int t) {
    if (t >= n_items) return;
    const int i0 = t / per_chunk * kTcBI, j = t % per_chunk;
    if (j < nk) {
      bf16* xs = stage(t / per_chunk * nk + j);
      bf16* wh = xs + kTcBM * kTcLd;
      bf16* wg = wh + kTcBI * kTcLd;
      const int k0 = j * kTcBK;
      {
        const int r = tid / 8, v = (tid % 8) * 8;
        const bool ok = row0 + r < rows && k0 + v < c;
        cp_async16(xs + r * kTcLd + v,
                   ok ? x + (long)(row0 + r) * c + k0 + v : x, ok);
      }
      for (int idx = tid; idx < kTcBI * 8; idx += kThreads) {
        const int n = idx / 8, v = (idx % 8) * 8;
        const bool ok = i0 + n < inner && k0 + v < c;
        const long off = ok ? (long)(i0 + n) * c + k0 + v : 0;
        cp_async16(wh + n * kTcLd + v, w1 + off, ok);
        if (GEGLU)
          cp_async16(wg + n * kTcLd + v, w1 + (long)inner * c + off, ok);
      }
    } else {
      bf16* w2s = w2_half(j - nk);
      for (int idx = tid; idx < S::BN * 4; idx += kThreads) {
        const int n = idx / 4, v = (idx % 4) * 8;
        const int gi = i0 + (j - nk) * 32 + v;
        const bool ok = col0 + n < c && gi < inner;
        cp_async16(w2s + n * kTcLdW2 + v,
                   ok ? w2 + (long)(col0 + n) * inner + gi : w2, ok);
      }
    }
  };

  FragC acc[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) wmma::fill_fragment(acc[r][j], 0.f);
  FragC h_acc, g_acc;

  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();
  for (int t = 0; t < n_items; ++t) {
    issue(t + 2);
    cp_async_commit();
    cp_async_wait<2>();  // item t's group has landed
    __syncthreads();     // ... for every thread's copies
    const int i0 = t / per_chunk * kTcBI, j = t % per_chunk;
    if (j < nk) {
      // ---- H (32 x 64) += x stage . W1 stage^T, and the gate ------------
      const bf16* xs = stage(t / per_chunk * nk + j);
      const bf16* wh = xs + kTcBM * kTcLd;
      const bf16* wg = wh + kTcBI * kTcLd;
      if (j == 0) {
        wmma::fill_fragment(h_acc, 0.f);
        wmma::fill_fragment(g_acc, 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < kTcBK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, xs + hr * 16 * kTcLd + kk, kTcLd);
        wmma::load_matrix_sync(b, wh + hc * 16 * kTcLd + kk, kTcLd);
        wmma::mma_sync(h_acc, a, b, h_acc);
        if (GEGLU) {
          wmma::load_matrix_sync(b, wg + hc * 16 * kTcLd + kk, kTcLd);
          wmma::mma_sync(g_acc, a, b, g_acc);
        }
      }
      if (j == nk - 1) {
        // ---- bias + activation into the bf16 tile, rounded like plain --
        wmma::store_matrix_sync(hf + hr * 16 * kTcLdH + hc * 16, h_acc,
                                kTcLdH, wmma::mem_row_major);
        if (GEGLU)
          wmma::store_matrix_sync(gf + hr * 16 * kTcLdH + hc * 16, g_acc,
                                  kTcLdH, wmma::mem_row_major);
        __syncthreads();
        for (int e = tid; e < kTcBM * kTcBI; e += kThreads) {
          const int r = e / kTcBI, i = e % kTcBI;
          const int gi = i0 + i;
          float a = 0.f;
          if (gi < inner) {
            const float hv = to_float(
                from_float<bf16>(hf[r * kTcLdH + i] + to_float(b1[gi])));
            if (GEGLU) {
              const float gv = to_float(from_float<bf16>(
                  gf[r * kTcLdH + i] + to_float(b1[inner + gi])));
              a = hv * to_float(from_float<bf16>(gelu_erf(gv)));
            } else {
              a = gelu_erf(hv);
            }
          }
          as[r * kTcLd + i] = from_float<bf16>(a);
        }
      }
    } else {
      // ---- acc (32 x BN) += tile half (32 x 32) . W2 half^T -------------
      const int half = j - nk;
      const bf16* w2s = w2_half(half);
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        FragA a0, a1;
        wmma::load_matrix_sync(a0, as + half * 32 + kk, kTcLd);
        wmma::load_matrix_sync(a1, as + 16 * kTcLd + half * 32 + kk, kTcLd);
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          const int cf = warp + 8 * jj;  // this warp's column fragments
          if (col0 + cf * 16 < c) {
            FragB b;
            wmma::load_matrix_sync(b, w2s + cf * 16 * kTcLdW2 + kk, kTcLdW2);
            wmma::mma_sync(acc[0][jj], a0, b, acc[0][jj]);
            wmma::mma_sync(acc[1][jj], a1, b, acc[1][jj]);
          }
        }
      }
    }
    __syncthreads();  // item t's buffers are free for item t + 3's loads
  }
  cp_async_wait<0>();

  // ---- + b2, masked store through a per-warp 16 x 16 fp32 scratch -------
  __syncthreads();  // the stage ring is free for the scratch
  float* scratch = reinterpret_cast<float*>(tc_smem) + warp * 256;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int cf = warp + 8 * jj;
      if (col0 + cf * 16 >= c) continue;
      wmma::store_matrix_sync(scratch, acc[r][jj], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + r * 16 + e / 16;
        const int gcol = col0 + cf * 16 + e % 16;
        if (gr < rows && gcol < c)
          y[(long)gr * c + gcol] =
              from_float<bf16>(scratch[e] + to_float(b2[gcol]));
      }
      __syncwarp();
    }
  }
}

template <int NC, bool GEGLU>
cudaError_t launch_tc(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* y, int rows,
                      int c, int inner, cudaStream_t stream) {
  using S = TcShape<NC, GEGLU>;
  cudaError_t err = allow_smem(ff_tc_kernel<NC, GEGLU>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTcBM - 1) / kTcBM, (c + S::BN - 1) / S::BN);
  ff_tc_kernel<NC, GEGLU><<<grid, kThreads, S::BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y), rows, c, inner);
  return cudaGetLastError();
}

// The column block that needs the fewest blocks across c: 640 wide where
// it tiles c (320, 640, 1280), else 512 (2048).
template <bool GEGLU>
cudaError_t by_width(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* y, int rows, int c,
                     int inner, cudaStream_t s) {
  if (c % 8 != 0 || inner % 8 != 0) return cudaErrorInvalidValue;
  if ((c + 639) / 640 < (c + 511) / 512)
    return launch_tc<5, GEGLU>(x, w1, b1, w2, b2, y, rows, c, inner, s);
  return launch_tc<4, GEGLU>(x, w1, b1, w2, b2, y, rows, c, inner, s);
}

template <typename T, bool GEGLU>
cudaError_t by_kernel(int tensor, const void* x, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* y,
                      int rows, int c, int inner, cudaStream_t s) {
  if (!tensor)
    return launch<T, 2, 20, GEGLU>(x, w1, b1, w2, b2, y, rows, c, inner, s);
  if constexpr (std::is_same<T, bf16>::value)
    return by_width<GEGLU>(x, w1, b1, w2, b2, y, rows, c, inner, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int geglu, int tensor, const void* x, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* y,
                     int rows, int c, int inner, cudaStream_t s) {
  if (geglu)
    return by_kernel<T, true>(tensor, x, w1, b1, w2, b2, y, rows, c, inner,
                              s);
  return by_kernel<T, false>(tensor, x, w1, b1, w2, b2, y, rows, c, inner, s);
}

}  // namespace
}  // namespace rcdms

// x: (rows, c); w1: (up, c) with up = 2*inner (geglu) or inner; b1: (up,);
// w2: (c, inner); b2: (c,); y: (rows, c). All contiguous, one dtype.
// tensor: 1 for the tensor-core kernel (bf16 only; c and inner multiples
// of 8, x / w1 / w2 16-byte aligned), 0 for the CUDA-core one.
extern "C" int rcdms_ff_fwd(int dtype, int geglu, int tensor, const void* x,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, int rows, int c,
                            int inner, void* stream) {
  using namespace rcdms;
  if (rows <= 0 || c <= 0 || inner <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(geglu, tensor, x, w1, b1, w2, b2, y, rows, c,
                           inner, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(geglu, tensor, x, w1, b1, w2, b2, y, rows,
                                   c, inner, s);
  return cudaErrorInvalidValue;
}
