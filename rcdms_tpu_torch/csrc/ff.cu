// Kernels C and D: the transformer feed-forward, one source for both
// activations.
//
//   C (GEGLU): y = (x W1h^T + b1h) * gelu(x W1g^T + b1g) W2^T + b2
//   D (GELU):  y = gelu(x W1^T + b1) W2^T + b2
//
// with exact (erff) gelu. Weights keep torch's Linear layout: w1 is
// (up, c) with up = 2*inner for GEGLU (hidden half first, gate half
// second), w2 is (c, inner).
//
// Replaces rcdms_tpu/ops/geglu.py::_ff_kernel (C) and ::_ff_gelu_kernel
// (D). The TPU kernels never write the (rows, inner) intermediate to HBM:
// VMEM holds a whole row block's intermediate, and HBM writes are what a
// TPU kernel avoids. On the H100 that rule costs more than it saves. A
// block's accumulators for all c output columns do not fit an SM (512 KB
// of fp32 at c = 2048 and 64 rows), so a fused kernel must either re-read
// W1 for every small row block or recompute the up-projection for every
// column block. And every FF of the story stays above the card's 295
// flop/byte line even when its intermediate makes a round trip through
// device memory (C at UNet level 0: 50.3 GFLOP against about 134 MB with
// the 52 MB intermediate written and read back, about 375 flop/byte; D's
// 16 MB intermediate stays in the 50 MB L2). So the products, at the bf16
// tensor-core peak, bound C and D.
//
// Two kernels compute it:
//   * CUDA cores (fp32): the fused form, 32 rows x 320 output columns a
//     block, the intermediate tile in shared memory, fp32 FMA; bound by
//     the FMA rate and shared-memory reads.
//   * tensor cores (bf16; c and inner multiples of 8, x / w1 / w2 16-byte
//     aligned: every FF of the main path): two passes of one GEMM kernel,
//     Y = epilogue(X W^T) with X (M, K) and W (N, K), which the wrapper
//     (rcdms_tpu_torch/ops/geglu.py) launches twice:
//       pass 1  A = act(x W1^T + b1) into a bf16 (rows, inner) buffer;
//               for GEGLU a block loads the hidden rows [n0, n0+BN) and
//               the gate rows [inner+n0, ...) of W1 into two accumulators;
//       pass 2  y = A W2^T + b2.
//     The kernel is Hopper's: a block of 128 rows x BN columns (BN a
//     multiple of 8 up to 256, chosen per call by geglu.py::_plan), one
//     producer warp that keeps TMA loads of X and W tiles (64 deep in K,
//     one 128-byte swizzled row of bf16) in flight in a four-stage ring
//     against mbarriers, and two consumer warpgroups of 64 rows each that
//     run wgmma.mma_async m64nBNk16 on the tiles that have arrived, fp32
//     accumulators in registers. TMA zero-fills the ragged row tail (the
//     prior's 970 rows) and any K tail on load; the epilogue masks rows
//     and columns on store, so no operand is padded. No block re-reads W1
//     for a small row block and none recomputes the up-projection. The
//     mbarrier, TMA, descriptor and wgmma helpers are in wgmma.cuh, shared
//     with the bf16 conv (cm_conv.cu).
//
// Rounding, as the TPU kernels' and the plain version's: pass 1 keeps
// h + b, g + b and the activation in fp32 and rounds h * gelu(g) (GELU:
// gelu(h + b)) once into the bf16 intermediate; pass 2 rounds y + b2 once.
#include "common.cuh"
#include "wgmma.cuh"

namespace rcdms {
namespace {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kBI = 64;        // inner columns per intermediate tile
constexpr int kBK = 32;        // c-depth per stage of the first product
constexpr int kBK2 = 16;       // inner-depth per stage of the second

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

    // ---- bias + activation in fp32, rounded once to T -----------------
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gi = i0 + cg + 16 * u;
      const bool ok = gi < inner;
      const float bh = ok ? to_float(b1[gi]) : 0.f;
      const float bg = (ok && GEGLU) ? to_float(b1[inner + gi]) : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float a = GEGLU ? (hh[r][u] + bh) * gelu_erf(gg[r][u] + bg)
                              : gelu_erf(hh[r][u] + bh);
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


// ---- the bf16 tensor-core GEMM (TMA + wgmma, warp-specialised) ---------

using bf16 = __nv_bfloat16;

constexpr int kGemmBM = 128;     // rows a block: two consumer warpgroups
constexpr int kGemmBK = 64;      // K a stage: one 128-byte row of bf16
constexpr int kGemmStages = 4;   // depth of the TMA ring
constexpr int kGemmThreads = 288;  // 2 consumer warpgroups + 1 producer warp

enum Epilogue : int { kBias = 0, kGelu = 1, kGeglu = 2 };

// Shared memory: a ring of kGemmStages stages, each an X tile (128 x 64)
// and one W tile (BN x 64), two for GEGLU (hidden, gate), every tile in
// TMA's 128-byte swizzle and 1024-byte aligned; then the full and empty
// mbarriers of each stage; plus 1024 bytes to align the ring. Must agree
// with rcdms_tpu_torch/ops/geglu.py::_gemm_plan.
template <int BN, int MODE>
struct GemmShape {
  static constexpr int NW = MODE == kGeglu ? 2 : 1;
  static constexpr int X_BYTES = kGemmBM * kGemmBK * 2;
  static constexpr int W_BYTES = BN * kGemmBK * 2;
  static constexpr int STAGE = X_BYTES + NW * W_BYTES;
  static constexpr int BARS = kGemmStages * STAGE;
  static constexpr int BYTES = BARS + 2 * kGemmStages * 8 + 1024;
  static constexpr int ACC = BN / 2;  // fp32 accumulators a thread, per W
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma takes n = 8 ... 256");
  static_assert(W_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// One block: rows [m0, m0 + 128) x columns [n0, n0 + BN) of Y (M x N).
// Warps 0-7 are two consumer warpgroups (rows m0 + 64 wg ...), warp 8 the
// producer. The ring's stage s is filled when full[s] completes (TMA
// bytes) and free when empty[s] completes (one arrival per consumer
// warp). Accumulator layout of m64nNk16, per warp w of a warpgroup
// (g = lane / 4, t = lane % 4): d[4i], d[4i+1] at row 16w + g, columns
// 8i + 2t, +1; d[4i+2], d[4i+3] at row 16w + g + 8.
template <int BN, int MODE>
__global__ void __launch_bounds__(kGemmThreads, 1)
    ff_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const bf16* __restrict__ bias, bf16* __restrict__ y, int M,
                int N, int K) {
  using S = GemmShape<BN, MODE>;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t raw = smem_addr(gemm_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + S::BARS;       // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kGemmStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kGemmBM;
  const int nk = (K + kGemmBK - 1) / kGemmBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ---------------------------------------
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kGemmStages;
        mbar_wait(empty + 8 * s, ((i / kGemmStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, S::STAGE);
        const uint32_t st = ring + s * S::STAGE;
        tma_load(st, &xmap, i * kGemmBK, m0, full + 8 * s);
        tma_load(st + S::X_BYTES, &wmap, i * kGemmBK, n0, full + 8 * s);
        if (MODE == kGeglu)
          tma_load(st + S::X_BYTES + S::W_BYTES, &wmap, i * kGemmBK, N + n0,
                   full + 8 * s);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int wg = warp / 4;
  float acc[S::ACC];
  float gacc[MODE == kGeglu ? S::ACC : 1];
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (MODE == kGeglu ? S::ACC : 1); ++i) gacc[i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % kGemmStages;
    mbar_wait(full + 8 * s, (i / kGemmStages) & 1);
    const uint32_t st = ring + s * S::STAGE;
    const uint64_t da = sw128_desc(st + wg * 64 * 128);
    const uint64_t dw = sw128_desc(st + S::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      wgmma<BN>(acc, da + 2 * kk, dw + 2 * kk);
      if constexpr (MODE == kGeglu)
        wgmma<BN>(gacc, da + 2 * kk, sw128_desc(st + S::X_BYTES +
                                                S::W_BYTES) + 2 * kk);
    }
    wgmma_commit();
    if (i > 0) {  // the previous stage's products are done: free it
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kGemmStages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(gacc);

  // ---- epilogue: bias, activation, bf16 pairs straight to device memory --
  const int r_lo = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);
    if (col >= N) continue;  // N is even, so col + 1 < N as well
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
    float g0 = 0.f, g1 = 0.f;
    if constexpr (MODE == kGeglu) {
      g0 = __bfloat162float(bias[N + col]);
      g1 = __bfloat162float(bias[N + col + 1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      if (r >= M) continue;
      float v0 = acc[4 * i + 2 * half] + b0;
      float v1 = acc[4 * i + 2 * half + 1] + b1;
      if constexpr (MODE == kGelu) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      } else if constexpr (MODE == kGeglu) {
        v0 *= gelu_erf(gacc[4 * i + 2 * half] + g0);
        v1 *= gelu_erf(gacc[4 * i + 2 * half + 1] + g1);
      }
      // the one rounding of the epilogue
      __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(y + (long)r * N + col) = out;
    }
  }
}

// The TMA map of a row-major (rows, cols) bf16 matrix, read in boxes of
// 64 columns x box_rows rows in the 128-byte swizzle; reads outside the
// matrix return zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)kGemmBK, (uint32_t)box_rows};
  return make_bf16_map(map, ptr, 2, dims, strides, box);
}

template <int BN, int MODE>
cudaError_t launch_gemm(const void* x, const void* w, const void* bias,
                        void* y, int M, int N, int K, int smem,
                        cudaStream_t stream) {
  using S = GemmShape<BN, MODE>;
  if (smem != S::BYTES) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t err = make_map(&xmap, x, M, K, kGemmBM);
  if (err != cudaSuccess) return err;
  err = make_map(&wmap, w, MODE == kGeglu ? 2 * N : N, K, BN);
  if (err != cudaSuccess) return err;
  err = allow_smem(ff_gemm_kernel<BN, MODE>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + kGemmBM - 1) / kGemmBM);
  ff_gemm_kernel<BN, MODE><<<grid, kGemmThreads, S::BYTES, stream>>>(
      xmap, wmap, static_cast<const bf16*>(bias), static_cast<bf16*>(y), M,
      N, K);
  return cudaGetLastError();
}

// The (mode, BN) pairs that geglu.py::_gemm_plan chooses from.
cudaError_t dispatch_gemm(int mode, int bn, const void* x, const void* w,
                          const void* bias, void* y, int M, int N, int K,
                          int smem, cudaStream_t s) {
  if (N % 8 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
#define RCDMS_GEMM_CASE(MODE, BN)                                         \
  if (mode == MODE && bn == BN)                                           \
    return launch_gemm<BN, MODE>(x, w, bias, y, M, N, K, smem, s);
  RCDMS_GEMM_CASE(kGeglu, 64)
  RCDMS_GEMM_CASE(kGeglu, 128)
  RCDMS_GEMM_CASE(kGelu, 128)
  RCDMS_GEMM_CASE(kGelu, 256)
  RCDMS_GEMM_CASE(kBias, 64)
  RCDMS_GEMM_CASE(kBias, 128)
  RCDMS_GEMM_CASE(kBias, 160)
  RCDMS_GEMM_CASE(kBias, 256)
#undef RCDMS_GEMM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rcdms

// fp32, the fused CUDA-core kernel. x: (rows, c); w1: (up, c) with up =
// 2*inner (geglu) or inner; b1: (up,); w2: (c, inner); b2: (c,); y:
// (rows, c). All contiguous float32.
extern "C" int rcdms_ff_fwd(int geglu, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            void* y, int rows, int c, int inner,
                            void* stream) {
  using namespace rcdms;
  if (rows <= 0 || c <= 0 || inner <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geglu)
    return launch<float, 2, 20, true>(x, w1, b1, w2, b2, y, rows, c, inner,
                                      s);
  return launch<float, 2, 20, false>(x, w1, b1, w2, b2, y, rows, c, inner, s);
}

// bf16, one pass of the tensor-core FF: y (M, N) = epilogue(x (M, K) .
// w^T + bias) with mode 0 (bias), 1 (gelu) or 2 (geglu: w is (2N, K), the
// hidden rows first, and bias (2N,)). bn and smem are the plan of
// geglu.py::_gemm_plan; smem must be what the kernel lays out. x and w
// 16-byte aligned (TMA), N and K multiples of 8.
extern "C" int rcdms_ff_gemm(int mode, int bn, int smem, const void* x,
                             const void* w, const void* bias, void* y, int M,
                             int N, int K, void* stream) {
  using namespace rcdms;
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  return dispatch_gemm(mode, bn, x, w, bias, y, M, N, K, smem,
                       static_cast<cudaStream_t>(stream));
}
