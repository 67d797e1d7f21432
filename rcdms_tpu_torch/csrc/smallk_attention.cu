// Kernel E: one whole attention block of the small-head-dim studies,
// o = softmax(q k^T * scale) v, at SD-1.5 UNet level 0 (B = 80 batch-heads,
// 4096 x 4096 tokens, dh = 40, bf16).
//
// Replaces the Pallas kernels of tools/flash_smallk_study.py::run_variant
// (_kernel_base128, _kernel_slice40, _kernel_nt40, _kernel_nt_t40) and of
// tools/pv_overlap_study.py::run_variant (_kernel_base via _attend,
// _make_split_kernel(2/4), _kernel_dscore). Three choices are template
// parameters:
//   * layout: token-major (B, S, W) operands with W = 128, the score
//     contracting DK = 128 or (slice40) the first 40 columns; or
//     channel-major (B, dh, S) operands and output (nt40, nt_t40, the
//     overlap rows), read as column-major WMMA fragments, so no transpose
//     reaches device memory;
//   * normalisation, the three rounding families of the TPU kernels:
//     kPost     p = exp(s - m) in fp32, l = sum p, o = (bf16 p) v / l;
//     kPre      p = bf16(p / l) before the product, o = p v;
//     kRounded  p = bf16(exp(s - m)), l = the sum of the rounded p,
//               o = (p v) * (1 / l);
//   * schedule: NS sub-blocks of 16 queries a warp whose exponentials are
//     issued beside the previous sub-block's P.V product (split2/4), or the
//     score computed a second time as the transposed tile K Q^T, with
//     P^T fed to a V^T P^T product (dscore).
//
// What bounds it on the H100: the TPU kernels hold a whole 512 x 4096 fp32
// score block in VMEM; an SM has 228 KB. Kernel A (attention.cu) streams
// K/V with an online softmax, which rescales p as the row max grows and so
// rounds p differently from the TPU's exact-max p. Here every block runs
// two passes over K: pass 1 computes the scores for the exact row max m
// (and, for kPre, the online fp32 l that must exist before the product);
// pass 2 computes the scores again, forms p from the exact m as the TPU
// kernel does, and accumulates P V in WMMA accumulators that never need a
// rescale. At dh = 40 a score and its share of P V cost 160 tensor-core
// flops but one MUFU.EX2, so the exponentials bound it (1.342 G of them:
// 0.34 ms at about 3.9 T a second), not the extra score product. dh 40 is
// zero-padded to 48 in shared memory only; base128 contracts all 128
// columns, as its TPU kernel does. Each block holds 128 queries of one
// batch row; K and V tiles of 64 keys pass through shared memory, the
// scores through a warp's fp32 tile (WMMA fragments are opaque), the
// probabilities through a bf16 tile.
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

enum Norm : int { kPost = 0, kPre = 1, kRounded = 2 };

constexpr int kBQ = 128;         // queries a block
constexpr int kBKV = 64;         // keys a K/V tile
constexpr int kLdS = kBKV + 4;   // fp32 row of a score tile
constexpr int kLdP = kBKV + 8;   // bf16 row of a probability tile

// CM: channel-major operands; DP: contraction width in shared memory (dh
// or DK rounded up to 16); W: width of V and o (token-major: the row
// width; channel-major: DP); NS: sub-blocks of 16 queries a warp. A block
// always holds kBQ queries, in 8 / NS warps. Byte offsets are multiples of
// 128.
template <bool CM, int DP, int W, int NS>
struct Shape {
  static constexpr int WARPS = 8 / NS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RW = 16 * NS;                  // queries a warp
  static constexpr int LDQ = CM ? kBQ + 8 : DP + 8;   // [DP][kBQ] / [kBQ][DP]
  static constexpr int LDK = CM ? kBKV + 8 : DP + 8;  // [DP][kBKV] / [kBKV][DP]
  static constexpr int LDV = CM ? kBKV + 8 : W + 8;   // [DP][kBKV] / [kBKV][W]
  static constexpr int LDO = W + 4;                   // fp32 [16][W] staging
  static constexpr int Q_ELEMS = CM ? DP * LDQ : kBQ * LDQ;
  static constexpr int K_ELEMS = CM ? DP * LDK : kBKV * LDK;
  static constexpr int V_ELEMS = CM ? DP * LDV : kBKV * LDV;
  static constexpr int S_FLOATS =  // a warp's: NS score tiles, or staging
      NS * 16 * kLdS > 16 * LDO ? NS * 16 * kLdS : 16 * LDO;
  static constexpr int P_ELEMS = NS * 16 * kLdP;      // a warp's
  static constexpr int QS = 0;
  static constexpr int KS = QS + Q_ELEMS * 2;
  static constexpr int VS = KS + K_ELEMS * 2;
  static constexpr int SS = VS + V_ELEMS * 2;
  static constexpr int PS = SS + WARPS * S_FLOATS * 4;
  static constexpr int BYTES = PS + WARPS * P_ELEMS * 2;
};

// sj[16][kLdS] = Q[qrow, qrow + 16) . K tile^T, as [query][key].
template <bool CM, int DP, int LDQ, int LDK>
__device__ __forceinline__ void score_tile(float* sj, const bf16* qs,
                                           const bf16* ks, int qrow) {
#pragma unroll
  for (int jf = 0; jf < kBKV / 16; ++jf) {
    FragC s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      if constexpr (CM) {  // Q (q x d) from [d][q]; K^T (d x key) from [d][key]
        FragA<Col> a;
        FragB<Row> bk;
        wmma::load_matrix_sync(a, qs + kk * LDQ + qrow, LDQ);
        wmma::load_matrix_sync(bk, ks + kk * LDK + jf * 16, LDK);
        wmma::mma_sync(s, a, bk, s);
      } else {  // Q from [q][d]; K^T (d x key) from [key][d]
        FragA<Row> a;
        FragB<Col> bk;
        wmma::load_matrix_sync(a, qs + qrow * LDQ + kk, LDQ);
        wmma::load_matrix_sync(bk, ks + jf * 16 * LDK + kk, LDK);
        wmma::mma_sync(s, a, bk, s);
      }
    }
    wmma::store_matrix_sync(sj + jf * 16, s, kLdS, wmma::mem_row_major);
  }
}

// dscore: the transposed tile S^T = K tile . Q^T (channel-major), stored
// column-major so that sj reads as [query][key] like score_tile's.
template <int DP, int LDQ, int LDK>
__device__ __forceinline__ void score_tile_t(float* sj, const bf16* qs,
                                             const bf16* ks, int qrow) {
#pragma unroll
  for (int jf = 0; jf < kBKV / 16; ++jf) {
    FragC st;
    wmma::fill_fragment(st, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      FragA<Col> a;   // K (key x d) from [d][key]
      FragB<Row> bq;  // Q^T (d x q) from [d][q]
      wmma::load_matrix_sync(a, ks + kk * LDK + jf * 16, LDK);
      wmma::load_matrix_sync(bq, qs + kk * LDQ + qrow, LDQ);
      wmma::mma_sync(st, a, bq, st);
    }
    wmma::store_matrix_sync(sj + jf * 16, st, kLdS, wmma::mem_col_major);
  }
}

// acc (16 x W) += P_j (16 x kBKV) . V tile.
template <bool CM, int W, int LDV>
__device__ __forceinline__ void pv_tile(FragC (&acc)[W / 16], const bf16* pj,
                                        const bf16* vs) {
#pragma unroll
  for (int n = 0; n < W / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kBKV; kk += 16) {
      FragA<Row> a;
      wmma::load_matrix_sync(a, pj + kk, kLdP);
      if constexpr (CM) {  // V (key x d) from [d][key]
        FragB<Col> bv;
        wmma::load_matrix_sync(bv, vs + n * 16 * LDV + kk, LDV);
        wmma::mma_sync(acc[n], a, bv, acc[n]);
      } else {
        FragB<Row> bv;
        wmma::load_matrix_sync(bv, vs + kk * LDV + n * 16, LDV);
        wmma::mma_sync(acc[n], a, bv, acc[n]);
      }
    }
  }
}

// dscore: acc^T (DP x 16) += V^T (DP x kBKV) . P_j^T (kBKV x 16).
template <int DP, int LDV>
__device__ __forceinline__ void pv_tile_t(FragC (&acc)[DP / 16],
                                          const bf16* pj, const bf16* vs) {
#pragma unroll
  for (int md = 0; md < DP / 16; ++md) {
#pragma unroll
    for (int kk = 0; kk < kBKV; kk += 16) {
      FragA<Row> a;   // V^T from [d][key]
      FragB<Col> bp;  // P^T (key x q) from [q][key]
      wmma::load_matrix_sync(a, vs + md * 16 * LDV + kk, LDV);
      wmma::load_matrix_sync(bp, pj + kk, kLdP);
      wmma::mma_sync(acc[md], a, bp, acc[md]);
    }
  }
}

// The probabilities of this lane's 32 keys of row r (half: which 32),
// rounded to bf16 into pj; lsum gathers l for kPost / kRounded.
template <int NORM>
__device__ __forceinline__ void softmax_tile(const float* sj, bf16* pj,
                                             float scale, float m, float l,
                                             float& lsum, int r, int half) {
  const float* srow = sj + r * kLdS + half * 32;
  bf16* prow = pj + r * kLdP + half * 32;
#pragma unroll
  for (int t = 0; t < 32; t += 2) {
    float p0 = __expf(srow[t] * scale - m);
    float p1 = __expf(srow[t + 1] * scale - m);
    if constexpr (NORM == kPre) {
      p0 = p0 / l;
      p1 = p1 / l;
    }
    const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
    if constexpr (NORM == kPost) {
      lsum += p0;
      lsum += p1;
    }
    if constexpr (NORM == kRounded) {
      lsum += __low2float(pb);
      lsum += __high2float(pb);
    }
    *reinterpret_cast<__nv_bfloat162*>(prow + t) = pb;
  }
}

template <bool CM, int DP, int W, int NORM, int NS, bool DSCORE>
__global__ void __launch_bounds__(Shape<CM, DP, W, NS>::THREADS)
    smallk_attention_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int Sq, int Skv, int dk, float scale) {
  using S = Shape<CM, DP, W, NS>;
  constexpr int NO = W / 16;  // output fragments a sub-block
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::QS);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::KS);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::VS);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* ss = reinterpret_cast<float*>(smem + S::SS) + warp * S::S_FLOATS;
  bf16* ps = reinterpret_cast<bf16*>(smem + S::PS) + warp * S::P_ELEMS;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int wq = warp * S::RW;  // the warp's first query in the block
  const int r = lane / 2;       // this lane's row of a 16-query sub-block
  const int half = lane % 2;    // ... and which half of its keys / output
  // batch row b; channel-major rows are dk (= dh) long
  const long rows = CM ? (long)dk : (long)W;
  const bf16* qb = q + (long)b * Sq * rows;
  const bf16* kb = k + (long)b * Skv * rows;
  const bf16* vb = v + (long)b * Skv * rows;

  if constexpr (CM)
    load_tile_bf16<DP, kBQ, S::THREADS>(qs, S::LDQ, qb + q0, Sq, dk, kBQ,
                                        tid);
  else
    load_tile_bf16<kBQ, DP, S::THREADS>(qs, S::LDQ, qb + (long)q0 * W, W,
                                        kBQ, dk, tid);

  // pass 1: the exact row max m (and, for kPre, the online fp32 l)
  float m[NS], l[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
  for (int kv0 = 0; kv0 < Skv; kv0 += kBKV) {
    __syncthreads();  // Q stored / the previous K tile consumed
    if constexpr (CM)
      load_tile_bf16<DP, kBKV, S::THREADS>(ks, S::LDK, kb + kv0, Skv, dk,
                                           kBKV, tid);
    else
      load_tile_bf16<kBKV, DP, S::THREADS>(ks, S::LDK, kb + (long)kv0 * W, W,
                                           kBKV, dk, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NS; ++j)
      score_tile<CM, DP, S::LDQ, S::LDK>(ss + j * 16 * kLdS, qs, ks,
                                         wq + j * 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float* srow = ss + j * 16 * kLdS + r * kLdS + half * 32;
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < 32; ++t) tmax = fmaxf(tmax, srow[t] * scale);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m[j], tmax);
      if constexpr (NORM == kPre) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < 32; ++t) part += __expf(srow[t] * scale - m_new);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        l[j] = l[j] * __expf(m[j] - m_new) + part;  // 0 * 0 on the first tile
      }
      m[j] = m_new;
    }
    __syncwarp();  // read before the next tile's scores overwrite them
  }

  // pass 2: the scores again, p from the exact m, P V accumulated
  FragC acc[NS][NO];
  float lsum[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    lsum[j] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) wmma::fill_fragment(acc[j][n], 0.f);
  }
  for (int kv0 = 0; kv0 < Skv; kv0 += kBKV) {
    __syncthreads();  // the previous K, V tiles consumed
    if constexpr (CM) {
      load_tile_bf16<DP, kBKV, S::THREADS>(ks, S::LDK, kb + kv0, Skv, dk,
                                           kBKV, tid);
      load_tile_bf16<DP, kBKV, S::THREADS>(vs, S::LDV, vb + kv0, Skv, dk,
                                           kBKV, tid);
    } else {
      load_tile_bf16<kBKV, DP, S::THREADS>(ks, S::LDK, kb + (long)kv0 * W, W,
                                           kBKV, dk, tid);
      load_tile_bf16<kBKV, W, S::THREADS>(vs, S::LDV, vb + (long)kv0 * W, W,
                                          kBKV, W, tid);
    }
    __syncthreads();
    // stage 1: every sub-block's score tile
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if constexpr (DSCORE)
        score_tile_t<DP, S::LDQ, S::LDK>(ss + j * 16 * kLdS, qs, ks,
                                         wq + j * 16);
      else
        score_tile<CM, DP, S::LDQ, S::LDK>(ss + j * 16 * kLdS, qs, ks,
                                           wq + j * 16);
    }
    __syncwarp();
    // stage 2: exp of sub-block j beside the P.V product of sub-block j-1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      softmax_tile<NORM>(ss + j * 16 * kLdS, ps + j * 16 * kLdP, scale, m[j],
                         l[j], lsum[j], r, half);
      if (j > 0) {
        if constexpr (DSCORE)
          pv_tile_t<DP, S::LDV>(acc[j - 1], ps + (j - 1) * 16 * kLdP, vs);
        else
          pv_tile<CM, W, S::LDV>(acc[j - 1], ps + (j - 1) * 16 * kLdP, vs);
      }
      __syncwarp();  // P_j stored before its product
    }
    if constexpr (DSCORE)
      pv_tile_t<DP, S::LDV>(acc[NS - 1], ps + (NS - 1) * 16 * kLdP, vs);
    else
      pv_tile<CM, W, S::LDV>(acc[NS - 1], ps + (NS - 1) * 16 * kLdP, vs);
  }

  // normalise and write each sub-block through the warp's staging tile
  float* stage = ss;  // [16][LDO] fp32, as [query][column]
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float lj = lsum[j] + __shfl_xor_sync(0xffffffffu, lsum[j], 1);
    __syncwarp();  // the score tiles / the previous sub-block read
#pragma unroll
    for (int n = 0; n < NO; ++n)
      wmma::store_matrix_sync(stage + n * 16, acc[j][n], S::LDO,
                              DSCORE ? wmma::mem_col_major
                                     : wmma::mem_row_major);
    __syncwarp();
    float* orow = stage + r * S::LDO + half * (W / 2);
    const float inv = 1.f / lj;
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      if constexpr (NORM == kPost) orow[i] = orow[i] / lj;
      if constexpr (NORM == kRounded) orow[i] = orow[i] * inv;
    }
    __syncwarp();
    const int qj = q0 + wq + j * 16;  // the sub-block's first query
    if constexpr (CM) {
      bf16* ob = o + (long)b * dk * Sq + qj;
      for (int idx = lane; idx < dk * 16; idx += 32) {
        const int d = idx / 16, qq = idx % 16;
        ob[(long)d * Sq + qq] = __float2bfloat16(stage[qq * S::LDO + d]);
      }
    } else {
      bf16* ob = o + ((long)b * Sq + qj) * W;
      constexpr int V8 = W / 8;
      for (int idx = lane; idx < 16 * V8; idx += 32) {
        const int rr = idx / V8, c = (idx % V8) * 8;
        const float* src = stage + rr * S::LDO + c;
        __nv_bfloat162 h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
        *reinterpret_cast<uint4*>(ob + (long)rr * W + c) =
            *reinterpret_cast<const uint4*>(h);
      }
    }
  }
}

template <bool CM, int DP, int W, int NORM, int NS, bool DSCORE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int dk, float scale,
                   cudaStream_t stream) {
  using S = Shape<CM, DP, W, NS>;
  auto kernel = smallk_attention_kernel<CM, DP, W, NORM, NS, DSCORE>;
  cudaError_t err = allow_smem(kernel, S::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Sq / kBQ, B), S::THREADS, S::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, dk, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rcdms

// The studies' variants only; anything else is refused.
//   cm = 0: q, k, v, o (B, S, W), W = 128; the score contracts dk = 40
//           (padded to 48) or 128 columns; norm kPost, split 1.
//   cm = 1: q, o (B, dk, Sq); k, v (B, dk, Skv), dk <= 48 a multiple of 8;
//           norm kPre (split 1) or kRounded (split 1, 2, 4, or dscore).
// Sq a multiple of 128, Skv of 64; bf16, contiguous, 16-byte aligned.
extern "C" int rcdms_smallk_attention(int cm, int norm, int split,
                                      int dscore, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int W, int dk,
                                      float scale, void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq % kBQ || Skv % kBKV || dk <= 0 ||
      dk % 8)
    return cudaErrorInvalidValue;
  if (!cm) {
    if (W != 128 || norm != kPost || split != 1 || dscore)
      return cudaErrorInvalidValue;
    if (dk <= 48)
      return launch<false, 48, 128, kPost, 1, false>(q, k, v, o, B, Sq, Skv,
                                                     dk, scale, s);
    if (dk <= 128)
      return launch<false, 128, 128, kPost, 1, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, s);
    return cudaErrorInvalidValue;
  }
  if (dk > 48 || W != dk) return cudaErrorInvalidValue;
  if (norm == kPre && split == 1 && !dscore)
    return launch<true, 48, 48, kPre, 1, false>(q, k, v, o, B, Sq, Skv, dk,
                                                scale, s);
  if (norm != kRounded) return cudaErrorInvalidValue;
  if (dscore)
    return split == 1 ? launch<true, 48, 48, kRounded, 1, true>(
                            q, k, v, o, B, Sq, Skv, dk, scale, s)
                      : cudaErrorInvalidValue;
  switch (split) {
    case 1:
      return launch<true, 48, 48, kRounded, 1, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, s);
    case 2:
      return launch<true, 48, 48, kRounded, 2, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, s);
    case 4:
      return launch<true, 48, 48, kRounded, 4, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
