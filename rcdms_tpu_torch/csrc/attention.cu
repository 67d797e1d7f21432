// Kernel A: fused multi-head attention forward, softmax(q k^T * scale) v.
//
// Replaces two Pallas kernels of the JAX package that compute the same
// thing in two layouts: rcdms_tpu/ops/flash.py::_nt_kernel (channel-major,
// UNet spatial self- and cross-attention) and ::_attn_kernel (token-major,
// CLIP ViT-bigG self-attention). Here both take the token-major layout that
// the q/k/v projections produce, (B, S, H*dh): a head is a stride, so no
// transpose and no pad is ever written to device memory.
//
// What bounds it on the H100: at the UNet's level 0 (S = 4096, dh = 40) a
// query row meets 4096 keys, and one fp32 score row is 16 KB, so the TPU
// kernel's whole-row softmax cannot live in 227 KB of shared memory. Both
// kernels below stream K/V through shared memory in tiles with an online
// softmax (running max m and sum l per query; the output is rescaled when
// m grows and divided by l once at the end). The ragged last tile is
// masked by Skv, so a 91-token context arrives unpadded. Scores, softmax
// and sums are fp32.
//
// Two kernels compute it:
//   * CUDA cores (fp32, and any dh): one block of 256 threads holds one
//     (batch, head) and 256 / TPQ queries; TPQ lanes share a query, each
//     owning dh / TPQ of its dims, and combine partial dot products with
//     warp shuffles. dh is a template bound (32 ... 256); a smaller runtime
//     dh is masked. Bound by the FMA rate and shared-memory reads.
//   * tensor cores (bf16, dh a multiple of 8; every site of the main path):
//     Q K^T and P V as WMMA 16x16x16 bf16 products with fp32 accumulators,
//     64 queries and 64-key tiles a block, the online softmax between them
//     on the CUDA cores with the scores staged through shared memory. dh
//     is zero-padded to a multiple of 16 in shared memory only. At
//     dh = 40 a score costs more softmax instructions than product flops,
//     so the softmax, not the tensor cores, bounds it; wgmma and keeping
//     the scores in registers are later work.
#include <mma.h>

#include "common.cuh"

namespace rcdms {
namespace {

constexpr int kThreads = 256;
constexpr int kBlockKV = 32;

template <int DH>
struct AttnShape {
  static constexpr int TPQ = DH <= 64 ? 2 : (DH <= 128 ? 4 : 8);
  static constexpr int DPL = DH / TPQ;        // dims per lane
  static constexpr int QPB = kThreads / TPQ;  // queries per block
  static_assert(DH % TPQ == 0, "head-dim bound must split over lanes");
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Sq, int Skv, int dh, float scale) {
  using S = AttnShape<DH>;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kBlockKV][DH]
  float* vs = smem + kBlockKV * DH;  // [kBlockKV][DH]

  const int tid = threadIdx.x;
  const int lane = tid % S::TPQ;
  const int qi = blockIdx.x * S::QPB + tid / S::TPQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const long row = (long)H * dh;
  const T* kp = k + (long)b * Skv * row + (long)h * dh;
  const T* vp = v + (long)b * Skv * row + (long)h * dh;

  float qr[S::DPL];
  float acc[S::DPL];
#pragma unroll
  for (int t = 0; t < S::DPL; ++t) {
    const int d = lane + t * S::TPQ;
    qr[t] = (qi < Sq && d < dh)
                ? to_float(q[((long)b * Sq + qi) * row + (long)h * dh + d]) *
                      scale
                : 0.f;
    acc[t] = 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  for (int kv0 = 0; kv0 < Skv; kv0 += kBlockKV) {
    const int nkv = min(kBlockKV, Skv - kv0);
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kBlockKV * DH; idx += kThreads) {
      const int j = idx / DH;
      const int d = idx % DH;
      float kx = 0.f, vx = 0.f;
      if (j < nkv && d < dh) {
        const long off = (long)(kv0 + j) * row + d;
        kx = to_float(kp[off]);
        vx = to_float(vp[off]);
      }
      ks[idx] = kx;
      vs[idx] = vx;
    }
    __syncthreads();

    float s[kBlockKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < S::DPL; ++t)
        part += qr[t] * ks[j * DH + lane + t * S::TPQ];
#pragma unroll
      for (int off = S::TPQ / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = j < nkv ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: nkv >= 1
    const float corr = expf(m - m_new);      // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int t = 0; t < S::DPL; ++t) acc[t] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int t = 0; t < S::DPL; ++t)
        acc[t] += p * vs[j * DH + lane + t * S::TPQ];
    }
    m = m_new;
  }

  if (qi < Sq) {
    const float inv = 1.f / l;
    T* op = o + ((long)b * Sq + qi) * row + (long)h * dh;
#pragma unroll
    for (int t = 0; t < S::DPL; ++t) {
      const int d = lane + t * S::TPQ;
      if (d < dh) op[d] = from_float<T>(acc[t] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Skv, int dh, float scale,
                   cudaStream_t stream) {
  using S = AttnShape<DH>;
  const int smem = 2 * kBlockKV * DH * (int)sizeof(float);
  cudaError_t err = allow_smem(attention_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + S::QPB - 1) / S::QPB, B * H);
  attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Skv, dh, scale);
  return cudaGetLastError();
}

// ---- the bf16 tensor-core kernel ----------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;  // queries per block, 16 per warp
constexpr int kTcBKV = 64;            // keys per K/V tile
constexpr int kTcLdS = kTcBKV + 4;    // fp32 row of a warp's score tile
constexpr int kTcLdP = kTcBKV + 8;    // bf16 row of a warp's probabilities

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragKt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragV = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// DP: the head dim rounded up to the 16 of a WMMA product (zero-filled in
// shared memory only). Byte offsets, each a multiple of 128.
template <int DP>
struct TcAttnShape {
  static constexpr int LD = DP + 8;   // bf16 row of the Q, K and V tiles
  static constexpr int LDT = DP + 4;  // fp32 row of a warp's P.V tile
  static constexpr int WARP_FLOATS =
      16 * (kTcLdS > LDT ? kTcLdS : LDT);  // scores, then the P.V tile
  static constexpr int QS = 0;
  static constexpr int KS = QS + kTcBQ * LD * 2;
  static constexpr int VS = KS + kTcBKV * LD * 2;
  static constexpr int SS = VS + kTcBKV * LD * 2;
  static constexpr int PS = SS + kTcWarps * WARP_FLOATS * 4;
  static constexpr int BYTES = PS + kTcWarps * 16 * kTcLdP * 2;
};

// One block: kTcBQ queries of one (batch, head); each warp owns 16 of them.
// Per K/V tile: S = Q K^T on the tensor cores into the warp's fp32 tile;
// the online softmax on the CUDA cores, two lanes per query row (its
// running max m and sum l, and half of its output row in registers); P,
// rounded to bf16 as the TPU kernel rounds it, times V on the tensor
// cores; the output row rescaled and accumulated in fp32.
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        int H, int Sq, int Skv, int dh, float scale) {
  using S = TcAttnShape<DP>;
  constexpr int V8 = DP / 8;   // 16-byte vectors in a padded row
  constexpr int HD = DP / 2;   // output columns a lane owns
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem + S::QS);  // [kTcBQ][LD]
  bf16* ks = reinterpret_cast<bf16*>(tc_smem + S::KS);  // [kTcBKV][LD]
  bf16* vs = reinterpret_cast<bf16*>(tc_smem + S::VS);  // [kTcBKV][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* ss = reinterpret_cast<float*>(tc_smem + S::SS) +
              warp * S::WARP_FLOATS;  // [16][kTcLdS], then [16][LDT]
  bf16* ps = reinterpret_cast<bf16*>(tc_smem + S::PS) +
             warp * 16 * kTcLdP;      // [16][kTcLdP]
  const int q0 = blockIdx.x * kTcBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const long row = (long)H * dh;
  const bf16* qp = q + (long)b * Sq * row + (long)h * dh;
  const bf16* kp = k + (long)b * Skv * row + (long)h * dh;
  const bf16* vp = v + (long)b * Skv * row + (long)h * dh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < kTcBQ * V8; idx += kTcThreads) {
    const int r = idx / V8, d = (idx % V8) * 8;
    *reinterpret_cast<uint4*>(qs + r * S::LD + d) =
        (q0 + r < Sq && d < dh)
            ? *reinterpret_cast<const uint4*>(qp + (long)(q0 + r) * row + d)
            : zero;
  }

  const int r = lane / 2;     // this lane's query row within the warp's 16
  const int half = lane % 2;  // ... and which half of its keys and output
  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += kTcBKV) {
    __syncthreads();  // Q stored / the previous K, V tiles consumed
    for (int idx = tid; idx < kTcBKV * V8; idx += kTcThreads) {
      const int j = idx / V8, d = (idx % V8) * 8;
      const bool ok = kv0 + j < Skv && d < dh;
      const long off = (long)(kv0 + j) * row + d;
      *reinterpret_cast<uint4*>(ks + j * S::LD + d) =
          ok ? *reinterpret_cast<const uint4*>(kp + off) : zero;
      *reinterpret_cast<uint4*>(vs + j * S::LD + d) =
          ok ? *reinterpret_cast<const uint4*>(vp + off) : zero;
    }
    __syncthreads();

    // S (16 x 64) = Q (16 x DP) . K tile^T
#pragma unroll
    for (int jf = 0; jf < kTcBKV / 16; ++jf) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        FragA a;
        FragKt bk;
        wmma::load_matrix_sync(a, qs + warp * 16 * S::LD + kk, S::LD);
        wmma::load_matrix_sync(bk, ks + jf * 16 * S::LD + kk, S::LD);
        wmma::mma_sync(s, a, bk, s);
      }
      wmma::store_matrix_sync(ss + jf * 16, s, kTcLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's 32 keys of row r
    float sv[32];
    float tile_max = -INFINITY;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int key = kv0 + half * 32 + t;
      sv[t] = key < Skv ? ss[r * kTcLdS + half * 32 + t] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, sv[t]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);  // finite: key kv0 is real
    const float corr = __expf(m - m_new);    // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const float p = __expf(sv[t] - m_new);  // 0 for masked keys
      sum += p;
      ps[r * kTcLdP + half * 32 + t] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] *= corr;
    __syncwarp();

    // T (16 x DP) = P (16 x 64) . V tile, into the score rows' place
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      FragC t;
      wmma::fill_fragment(t, 0.f);
#pragma unroll
      for (int kk = 0; kk < kTcBKV; kk += 16) {
        FragA a;
        FragV bv;
        wmma::load_matrix_sync(a, ps + kk, kTcLdP);
        wmma::load_matrix_sync(bv, vs + kk * S::LD + n * 16, S::LD);
        wmma::mma_sync(t, a, bv, t);
      }
      wmma::store_matrix_sync(ss + n * 16, t, S::LDT, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] += ss[r * S::LDT + half * HD + i];
    __syncwarp();  // read before the next tile's scores overwrite it
  }

  const int qi = q0 + warp * 16 + r;
  if (qi < Sq) {
    const float inv = 1.f / l;
    bf16* op = o + ((long)b * Sq + qi) * row + (long)h * dh + half * HD;
#pragma unroll
    for (int i = 0; i < HD; ++i)
      if (half * HD + i < dh) op[i] = __float2bfloat16(acc[i] * inv);
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int Sq, int Skv, int dh, float scale,
                      cudaStream_t stream) {
  using S = TcAttnShape<DP>;
  cudaError_t err = allow_smem(attention_tc_kernel<DP>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, B * H);
  attention_tc_kernel<DP><<<grid, kTcThreads, S::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Sq, Skv, dh,
      scale);
  return cudaGetLastError();
}

// dh a multiple of 8 (16-byte rows), padded up to the next instantiated
// width: 40 -> 48, 80, 104 -> 112, 160, 256.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Skv, int dh, float scale,
                        cudaStream_t s) {
  if (dh % 8 != 0) return cudaErrorInvalidValue;
  if (dh <= 48) return launch_tc<48>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 80) return launch_tc<80>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 112)
    return launch_tc<112>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 160)
    return launch_tc<160>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 256)
    return launch_tc<256>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Sq, int Skv, int dh, float scale,
                     cudaStream_t s) {
  if (dh <= 32) return launch<T, 32>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 40) return launch<T, 40>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 80) return launch<T, 80>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 104)
    return launch<T, 104>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 160)
    return launch<T, 160>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rcdms

// q: (B, Sq, H*dh); k, v: (B, Skv, H*dh); o: (B, Sq, H*dh); all contiguous.
// tensor: 1 for the tensor-core kernel (bf16 only; dh a multiple of 8,
// q / k / v 16-byte aligned), 0 for the CUDA-core one.
extern "C" int rcdms_attention_fwd(int dtype, int tensor, const void* q,
                                   const void* k, const void* v, void* o,
                                   int B, int H, int Sq, int Skv, int dh,
                                   float scale, void* stream) {
  using namespace rcdms;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || dh <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor)
    return dtype == kBFloat16
               ? dispatch_tc(q, k, v, o, B, H, Sq, Skv, dh, scale, s)
               : cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  return cudaErrorInvalidValue;
}
