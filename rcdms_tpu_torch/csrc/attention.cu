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
// kernels below stream K/V in tiles with an online softmax (running max m
// and sum l per query; the output is rescaled when m grows and divided by
// l once at the end). The ragged last tile is masked by Skv, so a 91-token
// context arrives unpadded. Scores, softmax and sums are fp32. At dh 40
// there are more exponentials than product flops per score: 40 heads of
// 4096 x 4096 need 0.17 ms of MUFU.EX2 against about 0.11 ms of bf16
// products at peak, so the exponentials, not the tensor cores, set the
// floor.
//
// Two kernels compute it:
//   * CUDA cores (fp32, any dh up to 256): one block of 256 threads holds
//     one (batch, head) and 256 / TPQ queries; TPQ lanes share a query,
//     each owning dh / TPQ of its dims, and combine partial dot products
//     with warp shuffles. dh is a template bound (32 ... 256); a smaller
//     runtime dh is masked. Bound by the FMA rate and shared-memory reads.
//   * tensor cores (bf16, dh a multiple of 8 up to 256; every site of the
//     main path): FlashAttention-2's layout on mma.sync m16n8k16. A block
//     holds 128 queries of one (batch, head) (64 where the padded dh is
//     160 or more), 32 query rows a warp where dh <= 64 (so each K and V
//     fragment a warp loads serves two m16 row tiles), else 16. K and V
//     tiles of 64 keys stream through a cp.async double-buffered ring, so
//     tile j + 1 loads while tile j computes. K is read by ldmatrix, V by
//     ldmatrix.trans; Q's A fragments by ldmatrix too, once where a warp
//     has 16 rows, at every K tile at dh <= 64, where the registers go to
//     a third block an SM instead. The scores stay in the mma accumulators:
//     the online softmax works on them in place (a row's max and sum over
//     the four lanes that share it, two shuffles), one FFMA folds
//     scale * log2(e) into each exponential, and P is repacked from the
//     fp32 score accumulators into bf16 A fragments in registers (the
//     m16n8k16 C -> A layout identity), rounded to bf16 as the TPU kernel
//     rounds it. No score or probability ever reaches shared memory. The
//     score product contracts dh padded to a multiple of 16 (the pad
//     columns of the shared tiles are zeroed once); the output is dh wide,
//     in n = 8 tiles.
#include <cstdint>
#include <type_traits>

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

// ---- the bf16 tensor-core kernel (mma.sync, scores in registers) --------

using bf16 = __nv_bfloat16;

constexpr int kMmaKV = 64;           // keys per K/V tile
constexpr int kKeyTiles = kMmaKV / 8;  // its n8 score tiles

// DP: the contraction width, dh padded to a multiple of 16. NT: the n8
// output tiles held, dh / 8 rounded up to a width the kernel is built for
// (tiles at or past dh / 8 are skipped). BQ: queries a block. MT: m16 row
// tiles a warp; two where DP <= 64, so each K and V fragment a warp loads
// from shared memory serves 32 query rows. Q's A fragments stay in
// registers where a warp holds one row tile up to DP 160; with two, Q is
// read by ldmatrix at every K tile instead, which leaves the registers
// for three blocks an SM at DP 48. Rows of the shared Q, K and V tiles
// are DP + 8 bf16 long, an odd number of 16-byte chunks, so the eight row
// addresses of an ldmatrix fall in eight different bank groups. Must
// agree with rcdms_tpu_torch/ops/flash.py::_plan.
template <int DP, int NT_, int BQ>
struct MmaShape {
  static constexpr int MT = DP <= 64 ? 2 : 1;
  static constexpr int WARPS = BQ / (16 * MT);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = DP + 8;
  static constexpr int KSTEPS = DP / 16;  // k16 steps of the score product
  static constexpr int NT = NT_;
  static constexpr bool QREG = MT == 1 && DP <= 160;
  static constexpr int MIN_BLOCKS = MT == 1 ? 1 : (DP == 48 ? 3 : 2);
  static_assert(8 * NT <= DP, "the output tiles lie inside the padded row");
  static constexpr int K_OFF = BQ * LD * 2;               // Q at 0
  static constexpr int V_OFF = K_OFF + 2 * kMmaKV * LD * 2;  // K: 2 stages
  static constexpr int BYTES = V_OFF + 2 * kMmaKV * LD * 2;  // V: 2 stages
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

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

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block: BQ queries of one (batch, head), 16 * MT a warp. Fragment
// layouts of m16n8k16 (g = lane / 4, t = lane % 4): a score accumulator of
// an n8 tile holds rows g (regs 0, 1) and g + 8 (regs 2, 3) at columns
// 2t, 2t+1; an A fragment holds rows g / g + 8 at columns 2t, 2t+1 (regs
// 0 / 1) and 2t+8, 2t+9 (regs 2 / 3). So the score tiles 2kk and 2kk + 1
// are, as they stand, the A fragment of P for keys 16kk ... 16kk + 15.
template <int DP, int NT, int BQ>
__global__ void __launch_bounds__(MmaShape<DP, NT, BQ>::THREADS,
                                  MmaShape<DP, NT, BQ>::MIN_BLOCKS)
    attention_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int H, int Sq, int Skv, int dh, float scale_log2) {
  using S = MmaShape<DP, NT, BQ>;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);              // [BQ][LD]
  bf16* ks = reinterpret_cast<bf16*>(mma_smem + S::K_OFF);   // [2][64][LD]
  bf16* vs = reinterpret_cast<bf16*>(mma_smem + S::V_OFF);   // [2][64][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const long row = (long)H * dh;
  const bf16* qp = q + (long)b * Sq * row + (long)h * dh;
  const bf16* kp = k + (long)b * Skv * row + (long)h * dh;
  const bf16* vp = v + (long)b * Skv * row + (long)h * dh;

  // Every tile row is DP / 8 chunks of 16 bytes: chunks < dh / 8 come from
  // device memory by cp.async (zero-filled past Sq / Skv: source size 0),
  // the pad chunks are zeroed once here and never written again.
  constexpr int CH = DP / 8;
  const int nt_out = dh / 8;  // n8 output tiles = 16-byte chunks of a row
  for (int idx = tid; idx < (BQ + 4 * kMmaKV) * CH; idx += S::THREADS) {
    if (idx % CH >= nt_out)
      *reinterpret_cast<uint4*>(qs + idx / CH * S::LD + idx % CH * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = tid; idx < BQ * CH; idx += S::THREADS) {
    const int r = idx / CH;
    const int c = idx % CH * 8;
    const bool ok = q0 + r < Sq;
    if (c < dh)
      cp_async16(qs + r * S::LD + c, ok ? qp + (long)(q0 + r) * row + c : q,
                 ok);
  }
  auto load_kv = [&](int kv0, int stage) {
    bf16* kd = ks + stage * kMmaKV * S::LD;
    bf16* vd = vs + stage * kMmaKV * S::LD;
    for (int idx = tid; idx < kMmaKV * CH; idx += S::THREADS) {
      const int r = idx / CH;
      const int c = idx % CH * 8;
      const bool ok = kv0 + r < Skv;
      const long off = ok ? (long)(kv0 + r) * row + c : 0;
      if (c < dh) {
        cp_async16(kd + r * S::LD + c, kp + off, ok);
        cp_async16(vd + r * S::LD + c, vp + off, ok);
      }
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group: Q and the first K/V tile

  const int g = lane / 4;
  const int t4 = lane % 4;
  constexpr int MT = S::MT;
  // per row tile mt of the warp: output accumulators, running max of rows
  // g and g + 8 (m[mt][0], [1]) and this lane's share of their sums
  float oacc[MT][NT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      oacc[mt][n][0] = oacc[mt][n][1] = oacc[mt][n][2] = oacc[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[S::QREG ? S::KSTEPS : 1][4];  // Q fragments (QREG)
  // this lane's ldmatrix row address of the warp's first Q row tile
  const bf16* qa =
      qs + (warp * 16 * MT + lane % 16) * S::LD + (lane / 16) * 8;
  float s[MT][kKeyTiles][4];          // scores of the current K tile
  uint32_t pf[MT][kKeyTiles / 2][4];  // P as A fragments, per 16 keys
  const bf16* kt = ks;  // the current K and V tiles
  const bf16* vt = vs;
  int j = 0;            // the current tile

  // S (16 x 64 a row tile) = Q K^T into n8 accumulator tiles, for every
  // row tile of the warp (each K fragment serves all of them)
  auto scores = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (S::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[kk][i];
        } else {
          ldsm_x4(a[mt], qa + mt * 16 * S::LD + kk * 16);
        }
      }
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {  // key tiles 2np, +1
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * S::LD +
                        kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }
  };

  // the online softmax of row tile mt on its accumulators, into pf[mt]
  auto softmax = [&](auto mtc) {
    constexpr int mt = decltype(mtc)::value;
    const int kv0 = j * kMmaKV;
    if (kv0 + kMmaKV > Skv) {  // keys at or past Skv: -inf before the max
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const int key = kv0 + n * 8 + 2 * t4;
        if (key >= Skv) s[mt][n][0] = s[mt][n][2] = -INFINITY;
        if (key + 1 >= Skv) s[mt][n][1] = s[mt][n][3] = -INFINITY;
      }
    }
    float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
    }
    float ms[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)  // the quad sharing a row
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], off));
      // finite: key kv0 < Skv is live in every row. 0 on the first tile.
      const float corr = fast_exp2((m[mt][hh] - mx[hh]) * scale_log2);
      m[mt][hh] = mx[hh];
      ms[hh] = mx[hh] * scale_log2;
      l[mt][hh] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        oacc[mt][n][2 * hh] *= corr;
        oacc[mt][n][2 * hh + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      const float p0 = fast_exp2(fmaf(s[mt][n][0], scale_log2, -ms[0]));
      const float p1 = fast_exp2(fmaf(s[mt][n][1], scale_log2, -ms[0]));
      const float p2 = fast_exp2(fmaf(s[mt][n][2], scale_log2, -ms[1]));
      const float p3 = fast_exp2(fmaf(s[mt][n][3], scale_log2, -ms[1]));
      l[mt][0] += p0 + p1;  // l from the unrounded p
      l[mt][1] += p2 + p3;
      pf[mt][n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pf[mt][n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
  };

  // O (16 x dh a row tile) += P (16 x 64) . V tile, for every row tile
  auto pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {  // tiles 2np, 2np + 1
        if (2 * np < nt_out) {
          // for an odd dh / 8 the last pair's second tile lies in the
          // zeroed pad (dh + 8 <= DP) and is not used
          uint32_t bv[4];
          ldsm_x4_trans(bv, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                     S::LD +
                                np * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(oacc[mt][2 * np], pf[mt][kk], bv[0], bv[1]);
            if (2 * np + 1 < NT && 2 * np + 1 < nt_out)
              mma_bf16(oacc[mt][(2 * np + 1) % NT], pf[mt][kk], bv[2],
                       bv[3]);
          }
        }
      }
    }
  };

  const int ntiles = (Skv + kMmaKV - 1) / kMmaKV;
  for (j = 0; j < ntiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < ntiles) load_kv((j + 1) * kMmaKV, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) have landed for this thread
    __syncthreads();     // ... and for every thread
    if constexpr (S::QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < S::KSTEPS; ++kk) ldsm_x4(qf[kk], qa + kk * 16);
      }
    }
    kt = ks + stage * kMmaKV * S::LD;
    vt = vs + stage * kMmaKV * S::LD;
    scores();
    softmax(std::integral_constant<int, 0>{});
    if constexpr (MT == 2) softmax(std::integral_constant<int, 1>{});
    pv();
    __syncthreads();  // this stage is free for tile j + 2's loads
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[mt][hh];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / sum;
      const int r = q0 + (warp * MT + mt) * 16 + g + 8 * hh;
      if (r >= Sq) continue;
      bf16* op = o + ((long)b * Sq + r) * row + (long)h * dh + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nt_out)
          *reinterpret_cast<uint32_t*>(op + n * 8) = pack_bf16(
              oacc[mt][n][2 * hh] * inv, oacc[mt][n][2 * hh + 1] * inv);
      }
    }
  }
}

template <int DP, int NT, int BQ>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Sq, int Skv, int dh, float scale,
                       int smem, cudaStream_t stream) {
  using S = MmaShape<DP, NT, BQ>;
  if (smem != S::BYTES || dh > 8 * NT) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attention_mma_kernel<DP, NT, BQ>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  attention_mma_kernel<DP, NT, BQ><<<grid, S::THREADS, S::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Sq, Skv, dh,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The (DP, NT, BQ) triples that flash.py::_plan chooses from.
cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Sq, int Skv, int dh, float scale,
                         int dp, int nt, int bq, int smem, cudaStream_t s) {
  if (dh % 8 != 0) return cudaErrorInvalidValue;
#define RCDMS_MMA_CASE(DP, NT, BQ)                                       \
  if (dp == DP && nt == NT && bq == BQ)                                  \
    return launch_mma<DP, NT, BQ>(q, k, v, o, B, H, Sq, Skv, dh, scale,  \
                                  smem, s);
  RCDMS_MMA_CASE(48, 5, 128)
  RCDMS_MMA_CASE(48, 6, 128)
  RCDMS_MMA_CASE(64, 8, 128)
  RCDMS_MMA_CASE(80, 10, 128)
  RCDMS_MMA_CASE(112, 13, 128)
  RCDMS_MMA_CASE(112, 14, 128)
  RCDMS_MMA_CASE(128, 16, 128)
  RCDMS_MMA_CASE(160, 20, 64)
  RCDMS_MMA_CASE(256, 32, 64)
#undef RCDMS_MMA_CASE
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Sq, int Skv, int dh, float scale,
                         cudaStream_t s) {
  if (dh <= 32)
    return launch<float, 32>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 40)
    return launch<float, 40>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 64)
    return launch<float, 64>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 80)
    return launch<float, 80>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 104)
    return launch<float, 104>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 128)
    return launch<float, 128>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 160)
    return launch<float, 160>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  if (dh <= 256)
    return launch<float, 256>(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rcdms

// q: (B, Sq, H*dh); k, v: (B, Skv, H*dh); o: (B, Sq, H*dh); all contiguous.
// fp32 runs the CUDA-core kernel. bf16 runs the mma.sync kernel with the
// launch plan of flash.py::_plan: the contraction width dp, the output
// tiles nt, queries a block bq, and its shared-memory bytes, which must be
// what the kernel lays out (dh a multiple of 8, q / k / v 16-byte aligned).
extern "C" int rcdms_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Sq, int Skv, int dh, float scale,
                                   int dp, int nt, int bq, int smem,
                                   void* stream) {
  using namespace rcdms;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || dh <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch_mma(q, k, v, o, B, H, Sq, Skv, dh, scale, dp, nt, bq,
                        smem, s);
  if (dtype == kFloat32)
    return dispatch_f32(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  return cudaErrorInvalidValue;
}
