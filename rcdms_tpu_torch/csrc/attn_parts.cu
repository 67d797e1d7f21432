// Kernels F, G and H: the parts of a small-head-dim attention block, each
// alone, at SD-1.5 UNet level 0 (B = 80 batch-heads, 4096 x 4096 tokens,
// dh = 40, bf16), in 512-row cells as the TPU studies cut them.
//
//   F attn_scores   S = q k^T (unscaled), each row of S reduced to 128
//                   lane-group sums, out[r, j] = sum_g S[r, 128 g + j];
//                   replaces tools/flash_smallk_study.py::run_isolated's
//                   k_score_base / k_score_nt (with `redsum`).
//   G attn_pv       o = P v, P generated in the kernel as the study's
//                   `gen_p` or read from a (B, 512, Skv) input shared by the
//                   cells of a batch row; replaces k_pv_base, k_pv_narrow,
//                   k_pv_nt and tools/pv_softmax_study.py's k_pv_lanes,
//                   k_pv_std.
//   H attn_softmax  the row softmax of generated P or of an input P * scale
//                   (exp, or exp2 of the pre-scaled argument), reduced to
//                   128 lane-group sums; or the sums of P alone
//                   (reduce_only); replaces run_isolated's k_softmax and
//                   pv_softmax_study.py's k_softmax, k_softmax2, k_noop.
//
// What bounds them on the H100: F and G are 107 GFLOP of bf16 products
// (0.11 ms at 989 TFLOP/s); the input P of G and H is 335 MB (0.10 ms at
// 3.35 TB/s) and the 8 cells of a batch row read the same 4 MB block, so
// the blocks of one batch row run next to each other and the block is
// served from L2; H is 1.342 G exponentials (0.34 ms at about 3.9 T a
// second, MUFU.EX2). F keeps its reduction in WMMA accumulators: the 32
// key groups of a row add into the same 16 x 128 fragments, so S never
// reaches memory. G's output is (B, Sq, 128) fp32, zero past dh where the
// TPU kernels pad. H gives each row to a warp, 4 of the 128 sums to a lane.
#include <mma.h>

#include "common.cuh"

namespace rcdms {
namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using Row = wmma::row_major;
using Col = wmma::col_major;
template <typename L>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, L>;
template <typename L>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, L>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 128;     // rows a block (16 a warp) for F and G
constexpr int kGroup = 128;    // the lane-group width of the reductions
constexpr int kSeedStride = 8 * 128;  // seeds are (B, 8, 128): [b, 0, 0]

// ---- F: scores, reduced over the key groups ------------------------------

// CM: q (B, dh, Sq), k (B, dh, Skv); else q (B, Sq, DP), k (B, Skv, DP).
// Shared-memory tiles: Q [DP][rows] / [rows][DP], K [DP][keys] / [keys][DP].
template <bool CM, int DP>
struct ScoreShape {
  static constexpr int LDQ = CM ? kRows + 8 : DP + 8;
  static constexpr int LDK = CM ? kGroup + 8 : DP + 8;
  static constexpr int QS = 0;
  static constexpr int KS = QS + (CM ? DP * LDQ : kRows * LDQ) * 2;
  static constexpr int BYTES = KS + (CM ? DP * LDK : kGroup * LDK) * 2;
};

template <bool CM, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       float* __restrict__ out, int Sq, int Skv, int dk) {
  using S = ScoreShape<CM, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::QS);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::KS);
  const int tid = threadIdx.x, warp = tid / 32;
  const int b = blockIdx.y, r0 = blockIdx.x * kRows;
  const bf16* qb = q + (long)b * Sq * dk;
  const bf16* kb = k + (long)b * Skv * dk;
  if constexpr (CM)
    load_tile_bf16<DP, kRows, kThreads>(qs, S::LDQ, qb + r0, Sq, dk, kRows,
                                        tid);
  else
    load_tile_bf16<kRows, DP, kThreads>(qs, S::LDQ, qb + (long)r0 * dk, dk,
                                        kRows, dk, tid);
  FragC acc[kGroup / 16];
#pragma unroll
  for (int n = 0; n < kGroup / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int kv0 = 0; kv0 < Skv; kv0 += kGroup) {
    __syncthreads();  // Q stored / the previous K group consumed
    if constexpr (CM)
      load_tile_bf16<DP, kGroup, kThreads>(ks, S::LDK, kb + kv0, Skv, dk,
                                           kGroup, tid);
    else
      load_tile_bf16<kGroup, DP, kThreads>(ks, S::LDK, kb + (long)kv0 * dk,
                                           dk, kGroup, dk, tid);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kGroup / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        if constexpr (CM) {
          FragA<Col> a;
          FragB<Row> bk;
          wmma::load_matrix_sync(a, qs + kk * S::LDQ + warp * 16, S::LDQ);
          wmma::load_matrix_sync(bk, ks + kk * S::LDK + n * 16, S::LDK);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        } else {
          FragA<Row> a;
          FragB<Col> bk;
          wmma::load_matrix_sync(a, qs + warp * 16 * S::LDQ + kk, S::LDQ);
          wmma::load_matrix_sync(bk, ks + n * 16 * S::LDK + kk, S::LDK);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
    }
  }
  float* ob = out + ((long)b * Sq + r0 + warp * 16) * kGroup;
#pragma unroll
  for (int n = 0; n < kGroup / 16; ++n)
    wmma::store_matrix_sync(ob + n * 16, acc[n], kGroup, wmma::mem_row_major);
}

// ---- G: P V --------------------------------------------------------------

// The study's generated probability: bf16((7 r + c) mod 117) times the
// batch row's bf16 scalar, rounded to bf16; r is the row within its cell.
__device__ __forceinline__ float gen_p(int r, int c, float seed) {
  return __bfloat162float(
      __float2bfloat16(static_cast<float>((7 * r + c) % 117) * seed));
}

enum VLayout : int { kTm128 = 0, kTm40 = 1, kCm40 = 2 };
constexpr int kPvKeys = 64;  // keys a P / V tile
constexpr int kLdP = kPvKeys + 8;

template <int VL>
struct PvShape {
  static constexpr int W = VL == kTm128 ? 128 : 48;  // product width
  static constexpr int LDV = VL == kCm40 ? kPvKeys + 8 : W + 8;
  static constexpr int PS = 0;
  static constexpr int VS = PS + kRows * kLdP * 2;
  static constexpr int BYTES =
      VS + (VL == kCm40 ? W * LDV : kPvKeys * LDV) * 2;
};

// One block: kRows rows of one cell of batch row b; p == nullptr generates
// P. v: kTm128 (B, Skv, 128); kTm40 (B, Skv, dh); kCm40 (B, dh, Skv).
template <int VL, bool GEN>
__global__ void __launch_bounds__(kThreads)
    attn_pv_kernel(const bf16* __restrict__ seeds, const bf16* __restrict__ p,
                   const bf16* __restrict__ v, float* __restrict__ out,
                   int Sq, int Skv, int blk, int dh) {
  using S = PvShape<VL>;
  constexpr int W = S::W;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ps = reinterpret_cast<bf16*>(smem + S::PS);  // [kRows][kLdP]
  bf16* vs = reinterpret_cast<bf16*>(smem + S::VS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, r0 = blockIdx.x * kRows;
  const int local0 = r0 % blk;  // the block's first row within its cell
  const float seed = GEN ? __bfloat162float(seeds[(long)b * kSeedStride])
                         : 0.f;
  const bf16* pb = GEN ? nullptr : p + ((long)b * blk + local0) * Skv;
  const int vrow = VL == kTm128 ? 128 : dh;  // token-major row length
  const bf16* vb = v + (long)b * Skv * vrow;
  FragC acc[W / 16];
#pragma unroll
  for (int n = 0; n < W / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int kv0 = 0; kv0 < Skv; kv0 += kPvKeys) {
    __syncthreads();  // the previous tiles consumed
    if constexpr (VL == kCm40)
      load_tile_bf16<W, kPvKeys, kThreads>(vs, S::LDV, vb + kv0, Skv, dh,
                                           kPvKeys, tid);
    else
      load_tile_bf16<kPvKeys, W, kThreads>(vs, S::LDV,
                                           vb + (long)kv0 * vrow, vrow,
                                           kPvKeys, vrow, tid);
    if constexpr (GEN) {
      for (int idx = tid; idx < kRows * kPvKeys / 2; idx += kThreads) {
        const int rr = idx / (kPvKeys / 2), c = (idx % (kPvKeys / 2)) * 2;
        const int r = local0 + rr;
        *reinterpret_cast<__nv_bfloat162*>(ps + rr * kLdP + c) =
            __floats2bfloat162_rn(gen_p(r, kv0 + c, seed),
                                  gen_p(r, kv0 + c + 1, seed));
      }
    } else {
      load_tile_bf16<kRows, kPvKeys, kThreads>(ps, kLdP, pb + kv0, Skv,
                                               kRows, kPvKeys, tid);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < W / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kPvKeys; kk += 16) {
        FragA<Row> a;
        wmma::load_matrix_sync(a, ps + warp * 16 * kLdP + kk, kLdP);
        if constexpr (VL == kCm40) {  // V (key x d) from [d][key]
          FragB<Col> bv;
          wmma::load_matrix_sync(bv, vs + n * 16 * S::LDV + kk, S::LDV);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        } else {
          FragB<Row> bv;
          wmma::load_matrix_sync(bv, vs + kk * S::LDV + n * 16, S::LDV);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
    }
  }
  float* ob = out + ((long)b * Sq + r0 + warp * 16) * kGroup;
#pragma unroll
  for (int n = 0; n < W / 16; ++n)
    wmma::store_matrix_sync(ob + n * 16, acc[n], kGroup, wmma::mem_row_major);
  if constexpr (W < kGroup) {  // the zero pad past the product's width
    constexpr int Z4 = (kGroup - W) / 4;
    for (int idx = lane; idx < 16 * Z4; idx += 32)
      *reinterpret_cast<float4*>(ob + (idx / Z4) * kGroup + W +
                                 (idx % Z4) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---- H: softmax, reduced over the key groups -----------------------------

enum SoftmaxOp : int { kExp = 0, kExp2 = 1, kSumOnly = 2 };
constexpr float kLog2e = 1.4426950408889634f;

// The lane's 4 values of key group g of its row.
template <bool GEN>
__device__ __forceinline__ void row_values(float (&x)[4], const bf16* prow,
                                           int local, int c, float seed,
                                           float scale) {
  if constexpr (GEN) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = gen_p(local, c + i, seed) * scale;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(prow + c);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    x[0] = __low2float(lo) * scale;
    x[1] = __high2float(lo) * scale;
    x[2] = __low2float(hi) * scale;
    x[3] = __high2float(hi) * scale;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One warp a row of (B * Sq); lane owns columns 128 g + 4 lane + [0, 4).
template <int OP, bool GEN>
__global__ void __launch_bounds__(kThreads)
    attn_softmax_kernel(const bf16* __restrict__ seeds,
                        const bf16* __restrict__ p, float* __restrict__ out,
                        int Sq, int Skv, int blk, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * (kThreads / 32) + warp;
  const int b = static_cast<int>(row / Sq);
  const int local = static_cast<int>(row % Sq) % blk;
  const float seed = GEN ? __bfloat162float(seeds[(long)b * kSeedStride])
                         : 0.f;
  const bf16* prow = GEN ? nullptr : p + ((long)b * blk + local) * Skv;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float x[4];
  if constexpr (OP == kSumOnly) {
    for (int c = lane * 4; c < Skv; c += kGroup) {
      row_values<GEN>(x, prow, local, c, seed, 1.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += x[i];
    }
  } else {
    float m = -INFINITY;
    for (int c = lane * 4; c < Skv; c += kGroup) {
      row_values<GEN>(x, prow, local, c, seed, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane * 4; c < Skv; c += kGroup) {
      row_values<GEN>(x, prow, local, c, seed, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = OP == kExp ? __expf(x[i] - m)
                                   : exp2f((x[i] - m) * kLog2e);
        l += e;
        acc[i] += e;
      }
    }
    const float inv = 1.f / warp_sum(l);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= inv;
  }
  *reinterpret_cast<float4*>(out + row * kGroup + lane * 4) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace
}  // namespace rcdms

// F. cm = 1: q (B, dk, Sq), k (B, dk, Skv), dk <= 48 a multiple of 8;
// cm = 0: q (B, Sq, dk), k (B, Skv, dk), dk = 128. out (B, Sq, 128) fp32.
// Sq a multiple of 128, Skv of 128; bf16, contiguous, 16-byte aligned.
extern "C" int rcdms_attn_scores(int cm, const void* q, const void* k,
                                 void* out, int B, int Sq, int Skv, int dk,
                                 void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq % kRows || Skv % kGroup ||
      dk <= 0 || dk % 8)
    return cudaErrorInvalidValue;
  const dim3 grid(Sq / kRows, B);
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (cm) {
    if (dk > 48) return cudaErrorInvalidValue;
    constexpr int bytes = ScoreShape<true, 48>::BYTES;
    err = allow_smem(attn_scores_kernel<true, 48>, bytes);
    if (err != cudaSuccess) return err;
    attn_scores_kernel<true, 48><<<grid, kThreads, bytes, s>>>(qq, kk, o, Sq,
                                                               Skv, dk);
  } else {
    if (dk != 128) return cudaErrorInvalidValue;
    constexpr int bytes = ScoreShape<false, 128>::BYTES;
    err = allow_smem(attn_scores_kernel<false, 128>, bytes);
    if (err != cudaSuccess) return err;
    attn_scores_kernel<false, 128><<<grid, kThreads, bytes, s>>>(
        qq, kk, o, Sq, Skv, dk);
  }
  return cudaGetLastError();
}

// G. p == nullptr: P generated from seeds (B, 8, 128); else p
// (B, blk, Skv). vlayout kTm128: v (B, Skv, 128); kTm40: v (B, Skv, dh);
// kCm40: v (B, dh, Skv); dh <= 48 a multiple of 8. out (B, Sq, 128) fp32.
// blk and Sq multiples of 128, Sq of blk, Skv of 64.
extern "C" int rcdms_attn_pv(int vlayout, const void* seeds, const void* p,
                             const void* v, void* out, int B, int Sq,
                             int Skv, int blk, int dh, void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || blk <= 0 || blk % kRows ||
      Sq % blk || Skv % kPvKeys)
    return cudaErrorInvalidValue;
  if (vlayout != kTm128 && (dh <= 0 || dh > 48 || dh % 8))
    return cudaErrorInvalidValue;
  const bool gen = p == nullptr;
  const dim3 grid(Sq / kRows, B);
  const auto* sd = static_cast<const bf16*>(seeds);
  const auto* pp = static_cast<const bf16*>(p);
  const auto* vv = static_cast<const bf16*>(v);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
#define RCDMS_PV(VL, GEN)                                                   \
  do {                                                                      \
    constexpr int bytes = PvShape<VL>::BYTES;                               \
    err = allow_smem(attn_pv_kernel<VL, GEN>, bytes);                       \
    if (err != cudaSuccess) return err;                                     \
    attn_pv_kernel<VL, GEN><<<grid, kThreads, bytes, s>>>(sd, pp, vv, o,    \
                                                          Sq, Skv, blk, dh); \
  } while (0)
  switch (vlayout) {
    case kTm128:
      if (gen) RCDMS_PV(kTm128, true); else RCDMS_PV(kTm128, false);
      break;
    case kTm40:
      if (gen) RCDMS_PV(kTm40, true); else RCDMS_PV(kTm40, false);
      break;
    case kCm40:
      if (gen) RCDMS_PV(kCm40, true); else RCDMS_PV(kCm40, false);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef RCDMS_PV
  return cudaGetLastError();
}

// H. p == nullptr: P generated from seeds (B, 8, 128); else p
// (B, blk, Skv). op kExp / kExp2: softmax of P * scale, reduced; kSumOnly:
// the reduced sums of P. out (B, Sq, 128) fp32. Skv a multiple of 128, Sq
// of blk, B * Sq of 8.
extern "C" int rcdms_attn_softmax(int op, const void* seeds, const void* p,
                                  void* out, int B, int Sq, int Skv, int blk,
                                  float scale, void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || blk <= 0 || Skv % kGroup ||
      Sq % blk || ((long)B * Sq) % (kThreads / 32))
    return cudaErrorInvalidValue;
  const bool gen = p == nullptr;
  const dim3 grid(static_cast<unsigned>((long)B * Sq / (kThreads / 32)));
  const auto* sd = static_cast<const bf16*>(seeds);
  const auto* pp = static_cast<const bf16*>(p);
  auto* o = static_cast<float*>(out);
#define RCDMS_SM(OP, GEN) \
  attn_softmax_kernel<OP, GEN><<<grid, kThreads, 0, s>>>(sd, pp, o, Sq, Skv, \
                                                        blk, scale)
  switch (op) {
    case kExp:
      if (gen) RCDMS_SM(kExp, true); else RCDMS_SM(kExp, false);
      break;
    case kExp2:
      if (gen) RCDMS_SM(kExp2, true); else RCDMS_SM(kExp2, false);
      break;
    case kSumOnly:
      if (gen) RCDMS_SM(kSumOnly, true); else RCDMS_SM(kSumOnly, false);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef RCDMS_SM
  return cudaGetLastError();
}
