// Kernel E: one whole attention block of the small-head-dim studies,
// o = softmax(q k^T * scale) v, at SD-1.5 UNet level 0 (B = 80 batch-heads,
// 4096 x 4096 tokens, dh = 40, bf16).
//
// Replaces the Pallas kernels of tools/flash_smallk_study.py::run_variant
// (_kernel_base128, _kernel_slice40, _kernel_nt40, _kernel_nt_t40) and of
// tools/pv_overlap_study.py::run_variant (_kernel_base via _attend,
// _make_split_kernel(2/4), _kernel_dscore). Three choices are template
// parameters:
//   * layout: token-major (B, S, 128) operands, the score contracting the
//     first dk = 40 (padded to 48) or all 128 columns, V and o 128 wide; or
//     channel-major (B, dh, S) operands and output (nt40, nt_t40, the
//     overlap rows), read through ldmatrix's transposing form, so no
//     transpose reaches device memory;
//   * normalisation, the three rounding families of the TPU kernels:
//     kPost     p = exp(s - m) in fp32, l = sum p, o = (bf16 p) v / l;
//     kPre      p = bf16(p / l) before the product, o = p v;
//     kRounded  p = bf16(exp(s - m)), l = the sum of the rounded p,
//               o = (p v) * (1 / l);
//   * schedule: NS m16 row tiles of 16 queries a warp, the exponentials of
//     tile j issued between the P.V products of tile j - 1 (split2/4); or
//     the second pass's score computed as the transposed tile S^T = K Q^T,
//     whose probabilities feed O^T += V^T P^T as the B operand (dscore).
//
// What bounds it on the H100: at dh 40 a score and its share of P V cost
// 160 tensor-core flops but one MUFU.EX2, so the exponentials bound it
// (1.342 G of them at B = 80: 0.32 ms at 4.18 T a second). The TPU
// kernels hold a whole 512 x 4096 fp32 score block in VMEM and form p from
// its exact row max; an SM has 228 KB. Kernel A (attention.cu) streams K/V
// with an online softmax, which rescales p as the row max grows and so
// rounds p differently. Here every block of 128 queries runs two passes
// over K: pass 1 computes the scores for the exact row max m (and, for
// kPre, the online fp32 l, whose exponentials the TPU kernel has too);
// pass 2 computes the scores again, forms p from the exact m as the TPU
// kernel does and accumulates P V in fp32 registers that never need a
// rescale. Both passes work on mma.sync m16n8k16 fragments (mma.cuh), as
// kernel A does: the scores stay in the accumulators, a row's max and sum
// reduce over the four lanes that share it, P is repacked into bf16 A
// fragments in registers (for dscore, transposed by movmatrix into B
// fragments), and no score or probability reaches shared memory. A warp
// takes a K tile 16 keys at a time, so only that chunk's scores are live
// beside the output accumulators, and a chunk's K and V fragments serve
// all of the warp's row tiles. K and V tiles of 64 keys stream through a
// two-stage cp.async ring that runs on from pass 1 into pass 2, so a tile
// loads while the one before it computes. The contraction width dk is
// zero-padded to DP in shared memory only (the pad is zeroed once and
// never loaded over).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace rcdms {
namespace {

using bf16 = __nv_bfloat16;

enum Norm : int { kPost = 0, kPre = 1, kRounded = 2 };

constexpr int kBQ = 128;              // queries a block
constexpr int kBKV = 64;              // keys a K/V tile
constexpr int kTokenWidth = 128;      // token-major rows: q, k, v and o

// CM: channel-major operands; DP: the contraction width in shared memory
// (dk padded to 48, or 128); NT: n8 output tiles of a row tile (16 for the
// token-major 128 columns; dk / 8 rounded up to 5 or 6 channel-major); NS:
// m16 row tiles a warp, 8 / NS warps a block; DS: dscore. Token-major
// tiles are [rows][cols + 8], channel-major ones [DP][tokens + 8]: rows an
// odd number of 16-byte chunks long, so the eight row addresses of an
// ldmatrix fall in eight bank groups. Must agree with
// rcdms_tpu_torch/ops/smallk.py::_plan.
template <bool CM, int DP, int NT, int NS, bool DS>
struct SmallkShape {
  static constexpr int WARPS = 8 / NS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KSTEPS = DP / 16;  // k16 steps of the score product
  static constexpr int LDQ = CM ? kBQ + 8 : DP + 8;
  static constexpr int LDK = CM ? kBKV + 8 : DP + 8;
  static constexpr int LDV = CM ? kBKV + 8 : kTokenWidth + 8;
  static constexpr int Q_ELEMS = CM ? DP * LDQ : kBQ * LDQ;
  static constexpr int K_ELEMS = CM ? DP * LDK : kBKV * LDK;  // a stage
  static constexpr int V_ELEMS = CM ? DP * LDV : kBKV * LDV;  // a stage
  static constexpr int K_OFF = Q_ELEMS * 2;                   // Q at 0
  static constexpr int V_OFF = K_OFF + 2 * K_ELEMS * 2;       // 2 stages
  static constexpr int M_OFF = V_OFF + 2 * V_ELEMS * 2;       // 2 stages
  static constexpr int BYTES = M_OFF + (DS ? kBQ * 4 : 0);    // dscore: m
  // Q's A fragments stay in registers where the contraction is narrow
  static constexpr bool QHOLD = KSTEPS <= 3 && !DS;
  // blocks an SM the registers must leave room for: token-major 2 (128
  // registers a thread), channel-major with one row tile a warp 3 (85)
  static constexpr int MIN_BLOCKS = !CM ? 2 : (NS == 1 && !DS ? 3 : 1);
  static_assert(CM ? 8 * NT <= DP : NT * 8 == kTokenWidth, "output tiles");
  static_assert(!DS || (CM && NS == 1), "dscore: channel-major, one tile");
};

template <bool CM, int DP, int NT, int NORM, int NS, bool DS>
__global__ void __launch_bounds__(SmallkShape<CM, DP, NT, NS, DS>::THREADS,
                                  SmallkShape<CM, DP, NT, NS, DS>::MIN_BLOCKS)
    smallk_attention_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int Sq, int Skv, int dk, float scale_log2) {
  using S = SmallkShape<CM, DP, NT, NS, DS>;
  static_assert(!DS || NORM == kRounded, "dscore rounds as nt_t40");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::V_OFF);
  float* msh = reinterpret_cast<float*>(smem + S::M_OFF);  // dscore

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int wq = warp * 16 * NS;  // the warp's first query in the block
  // batch row b: channel-major rows are S long, dk of them; token-major
  // rows 128 wide
  const long width = CM ? (long)dk : (long)kTokenWidth;
  const bf16* qb = q + (long)b * Sq * width;
  const bf16* kb = k + (long)b * Skv * width;
  const bf16* vb = v + (long)b * Skv * width;

  // ---- shared memory: zero the pad once; Q and the first K tile --------
  if constexpr (CM) {  // rows dk ... DP - 1 of Q, and of K and V (2 stages)
    for (int idx = tid; idx < (DP - dk) * (S::LDQ / 8); idx += S::THREADS)
      *reinterpret_cast<uint4*>(qs + (dk + idx / (S::LDQ / 8)) * S::LDQ +
                                idx % (S::LDQ / 8) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    for (int idx = tid; idx < 4 * (DP - dk) * (S::LDK / 8);
         idx += S::THREADS) {
      const int m = idx / ((DP - dk) * (S::LDK / 8));  // K0, K1, V0, V1
      const int r = idx % ((DP - dk) * (S::LDK / 8));
      bf16* base = (m < 2 ? ks : vs) + (m % 2) * S::K_ELEMS;
      *reinterpret_cast<uint4*>(base + (dk + r / (S::LDK / 8)) * S::LDK +
                                r % (S::LDK / 8) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  } else {  // columns dk ... DP - 1 of Q and of K (2 stages): one stride
    constexpr int CH = DP / 8;
    for (int idx = tid; idx < (kBQ + 2 * kBKV) * CH; idx += S::THREADS) {
      if (idx % CH * 8 >= dk)
        *reinterpret_cast<uint4*>(qs + idx / CH * S::LDQ + idx % CH * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if constexpr (CM) {
    for (int idx = tid; idx < dk * (kBQ / 8); idx += S::THREADS) {
      const int d = idx / (kBQ / 8), c = idx % (kBQ / 8) * 8;
      cp_async16(qs + d * S::LDQ + c, qb + (long)d * Sq + q0 + c, true);
    }
  } else {
    constexpr int CH = DP / 8;
    for (int idx = tid; idx < kBQ * CH; idx += S::THREADS) {
      const int r = idx / CH, c = idx % CH * 8;
      if (c < dk)
        cp_async16(qs + r * S::LDQ + c,
                   qb + (long)(q0 + r) * kTokenWidth + c, true);
    }
  }
  // K (and V) tile of keys [kv0, kv0 + 64) into ring stage `stage`
  auto load_kv = [&](int kv0, int stage, bool with_v) {
    bf16* kd = ks + stage * S::K_ELEMS;
    bf16* vd = vs + stage * S::V_ELEMS;
    if constexpr (CM) {
      for (int idx = tid; idx < dk * (kBKV / 8); idx += S::THREADS) {
        const int d = idx / (kBKV / 8), c = idx % (kBKV / 8) * 8;
        const long off = (long)d * Skv + kv0 + c;
        cp_async16(kd + d * S::LDK + c, kb + off, true);
        if (with_v) cp_async16(vd + d * S::LDV + c, vb + off, true);
      }
    } else {
      constexpr int CH = DP / 8;
      for (int idx = tid; idx < kBKV * CH; idx += S::THREADS) {
        const int r = idx / CH, c = idx % CH * 8;
        if (c < dk)
          cp_async16(kd + r * S::LDK + c,
                     kb + (long)(kv0 + r) * kTokenWidth + c, true);
      }
      if (with_v) {
        constexpr int CV = kTokenWidth / 8;
        for (int idx = tid; idx < kBKV * CV; idx += S::THREADS) {
          const int r = idx / CV, c = idx % CV * 8;
          cp_async16(vd + r * S::LDV + c,
                     vb + (long)(kv0 + r) * kTokenWidth + c, true);
        }
      }
    }
  };
  load_kv(0, 0, false);
  cp_async_commit();  // group: Q and pass 1's first K tile

  // ---- fragments ---------------------------------------------------------
  // A fragment of Q rows [r0, r0 + 16), k-step kk
  auto q_frag = [&](uint32_t (&a)[4], int r0, int kk) {
    if constexpr (CM)  // Q^T [d][q]: transposed on the way
      ldsm_x4_trans(a, qs + (kk * 16 + (lane / 16) * 8 + lane % 8) * S::LDQ +
                           r0 + ((lane / 8) % 2) * 8);
    else
      ldsm_x4(a, qs + (r0 + lane % 16) * S::LDQ + kk * 16 + (lane / 16) * 8);
  };
  // B fragments of K^T for keys [n0, n0 + 16), k-step kk: regs 0, 1 the
  // key tile n0 / 8, regs 2, 3 the next one
  auto k_frag = [&](uint32_t (&bk)[4], const bf16* kt, int n0, int kk) {
    if constexpr (CM)  // K^T [d][key]
      ldsm_x4_trans(bk, kt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                 S::LDK +
                            n0 + (lane / 16) * 8);
    else
      ldsm_x4(bk, kt + (n0 + (lane / 16) * 8 + lane % 8) * S::LDK + kk * 16 +
                      ((lane / 8) % 2) * 8);
  };
  // B fragments of V for keys [16 kk, 16 kk + 16): regs 0, 1 the output
  // tile 2 np, regs 2, 3 the tile 2 np + 1
  auto v_frag = [&](uint32_t (&bv)[4], const bf16* vt, int kk, int np) {
    if constexpr (CM)  // V^T [d][key]
      ldsm_x4(bv, vt + (np * 16 + (lane / 16) * 8 + lane % 8) * S::LDV +
                      kk * 16 + ((lane / 8) % 2) * 8);
    else
      ldsm_x4_trans(bv, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                 S::LDV +
                            np * 16 + (lane / 16) * 8);
  };

  // Q's A fragments: held in registers from the first K tile on where the
  // contraction is narrow (DP 48: 12 registers a row tile), else loaded
  // again for each chunk of 16 keys
  uint32_t qf[S::QHOLD ? NS : 1][S::QHOLD ? S::KSTEPS : 1][4];
  // B fragments of K^T for one chunk of 16 keys, shared by the warp's row
  // tiles where it holds more than one
  uint32_t bk[NS > 1 ? S::KSTEPS : 1][4];
  auto load_bk = [&](const bf16* kt, int c16) {
    if constexpr (NS > 1) {
#pragma unroll
      for (int kk = 0; kk < S::KSTEPS; ++kk) k_frag(bk[kk], kt, 16 * c16, kk);
    }
  };
  // the scores of row tile j against keys [16 c16, 16 c16 + 16) of the K
  // tile kt, as two n8 accumulator tiles
  auto score16 = [&](float (&sc)[2][4], const bf16* kt, int c16, int j) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      sc[u][0] = sc[u][1] = sc[u][2] = sc[u][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (S::QHOLD) a[e] = qf[j][kk][e];
        if constexpr (NS > 1) b[e] = bk[kk][e];
      }
      if constexpr (!S::QHOLD) q_frag(a, wq + 16 * j, kk);
      if constexpr (NS == 1) k_frag(b, kt, 16 * c16, kk);
      mma_bf16(sc[0], a, b[0], b[1]);
      mma_bf16(sc[1], a, b[2], b[3]);
    }
  };

  // ---- pass 1: the exact row max (and, for kPre, the online fp32 l) ------
  // per row tile j and row half h (rows g, g + 8): this lane's max of the
  // raw scores over its columns, and its share of l against that max
  float mx[NS][2], l[NS][2];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx[j][0] = mx[j][1] = -INFINITY;
    l[j][0] = l[j][1] = 0.f;
  }

  const int ntiles = Skv / kBKV;
  for (int i = 0; i < ntiles; ++i) {
    const int stage = i & 1;
    // prefetch the next step: pass 1's next K tile, or pass 2's first
    // K and V tiles
    if (i + 1 < ntiles)
      load_kv((i + 1) * kBKV, stage ^ 1, false);
    else
      load_kv(0, stage ^ 1, true);
    cp_async_commit();
    cp_async_wait<1>();  // this step's tile (and Q) landed for this thread
    __syncthreads();     // ... and for every thread
    if constexpr (S::QHOLD) {
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int kk = 0; kk < S::KSTEPS; ++kk)
            q_frag(qf[j][kk], wq + 16 * j, kk);
      }
    }
    const bf16* kt = ks + stage * S::K_ELEMS;
    // one chunk of 16 keys at a time: unrolling the four lets the compiler
    // overlap them at the price of registers (and, at the caps above,
    // spills), and it measured no faster
#pragma unroll 1
    for (int c16 = 0; c16 < kBKV / 16; ++c16) {
      load_bk(kt, c16);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float sc[2][4];
        score16(sc, kt, c16, j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(
              mx[j][h], fmaxf(fmaxf(sc[0][2 * h], sc[0][2 * h + 1]),
                              fmaxf(sc[1][2 * h], sc[1][2 * h + 1])));
          if constexpr (NORM == kPre) {  // 0 * 0 on the first chunk
            const float ms = m_new * scale_log2;
            l[j][h] = l[j][h] * fast_exp2((mx[j][h] - m_new) * scale_log2) +
                      fast_exp2(fmaf(sc[0][2 * h], scale_log2, -ms)) +
                      fast_exp2(fmaf(sc[0][2 * h + 1], scale_log2, -ms)) +
                      fast_exp2(fmaf(sc[1][2 * h], scale_log2, -ms)) +
                      fast_exp2(fmaf(sc[1][2 * h + 1], scale_log2, -ms));
          }
          mx[j][h] = m_new;
        }
      }
    }
    __syncthreads();  // this stage is free for the load two steps on
  }

  // the row's m over the quad of lanes that share it, as the argument
  // m * scale * log2(e) of exp2; for kPre, 1 / l against that m
  float m2[NS][2], inv_l[NS][2];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = mx[j][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      m2[j][h] = m * scale_log2;
      if constexpr (NORM == kPre) {
        float lj = l[j][h] * fast_exp2((mx[j][h] - m) * scale_log2);
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          lj += __shfl_xor_sync(0xffffffffu, lj, off);
        inv_l[j][h] = fast_rcp(lj);
      }
    }
  }

  if constexpr (DS) {
    // ---- pass 2, dscore: S^T = K Q^T, O^T += V^T P^T ---------------------
    // m of the queries this lane holds in the transposed layout: columns
    // 2t, 2t+1 of the query tiles nq = 0, 1
    if (t4 == 0) {
      msh[wq + g] = m2[0][0];
      msh[wq + g + 8] = m2[0][1];
    }
    __syncwarp();
    float mq[2][2];
#pragma unroll
    for (int nq = 0; nq < 2; ++nq) {
      mq[nq][0] = msh[wq + 8 * nq + 2 * t4];
      mq[nq][1] = msh[wq + 8 * nq + 2 * t4 + 1];
    }
    constexpr int MD = DP / 16;  // m16 tiles of the output's channels
    float oacc[MD][2][4], lsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int md = 0; md < MD; ++md)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
        oacc[md][nq][0] = oacc[md][nq][1] = oacc[md][nq][2] =
            oacc[md][nq][3] = 0.f;
    for (int i = 0; i < ntiles; ++i) {
      const int stage = (ntiles + i) & 1;
      if (i + 1 < ntiles) load_kv((i + 1) * kBKV, stage ^ 1, true);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* kt = ks + stage * S::K_ELEMS;
      const bf16* vt = vs + stage * S::V_ELEMS;
      // st[mk][nq]: keys 16 mk + g (+8) x queries 8 nq + 2t, +1
      float st[kBKV / 16][2][4];
#pragma unroll
      for (int mk = 0; mk < kBKV / 16; ++mk)
#pragma unroll
        for (int nq = 0; nq < 2; ++nq)
          st[mk][nq][0] = st[mk][nq][1] = st[mk][nq][2] = st[mk][nq][3] =
              0.f;
#pragma unroll
      for (int kk = 0; kk < S::KSTEPS; ++kk) {
        uint32_t bq[4];  // Q^T (d x q) for the query tiles 0 (regs 0, 1), 1
        ldsm_x4_trans(bq, qs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                   S::LDQ +
                              wq + (lane / 16) * 8);
#pragma unroll
        for (int mk = 0; mk < kBKV / 16; ++mk) {
          uint32_t a[4];  // K (key x d) from K^T [d][key]
          ldsm_x4_trans(a, kt + (kk * 16 + (lane / 16) * 8 + lane % 8) *
                                    S::LDK +
                               mk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(st[mk][0], a, bq[0], bq[1]);
          mma_bf16(st[mk][1], a, bq[2], bq[3]);
        }
      }
      // P^T as B fragments: the rounded p of keys 16 mk + g, queries 2t,
      // 2t+1, transposed to keys 2t, 2t+1 (+8), query g
      uint32_t pb[kBKV / 16][2][2];
#pragma unroll
      for (int mk = 0; mk < kBKV / 16; ++mk) {
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          float p[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            p[c] = fast_exp2(
                fmaf(st[mk][nq][c], scale_log2, -mq[nq][c & 1]));
          const uint32_t lo = pack_bf16(p[0], p[1]);
          const uint32_t hi = pack_bf16(p[2], p[3]);
          lsum[nq][0] += bf16_lo(lo) + bf16_lo(hi);
          lsum[nq][1] += bf16_hi(lo) + bf16_hi(hi);
          pb[mk][nq][0] = movmatrix_trans(lo);
          pb[mk][nq][1] = movmatrix_trans(hi);
        }
      }
#pragma unroll
      for (int md = 0; md < MD; ++md) {
#pragma unroll
        for (int mk = 0; mk < kBKV / 16; ++mk) {
          uint32_t a[4];  // V^T (d x key) from V^T [d][key]
          ldsm_x4(a, vt + (md * 16 + lane % 16) * S::LDV + mk * 16 +
                         (lane / 16) * 8);
          mma_bf16(oacc[md][0], a, pb[mk][0][0], pb[mk][0][1]);
          mma_bf16(oacc[md][1], a, pb[mk][1][0], pb[mk][1][1]);
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    // l of each query over the eight lanes that share its column
    float inv[2][2];
#pragma unroll
    for (int nq = 0; nq < 2; ++nq)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = lsum[nq][e];
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        inv[nq][e] = fast_rcp(s);
      }
    // O^T is channel-major already: pairs of neighbouring queries
    bf16* ob = o + (long)b * dk * Sq + q0 + wq + 2 * t4;
#pragma unroll
    for (int md = 0; md < MD; ++md)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = md * 16 + g + 8 * h;
        if (d >= dk) continue;
#pragma unroll
        for (int nq = 0; nq < 2; ++nq)
          *reinterpret_cast<uint32_t*>(ob + (long)d * Sq + 8 * nq) =
              pack_bf16(oacc[md][nq][2 * h] * inv[nq][0],
                        oacc[md][nq][2 * h + 1] * inv[nq][1]);
      }
  } else {
    // ---- pass 2: the scores again, p from the exact m, P V accumulated ---
    float oacc[NS][NT][4], lsum[NS][2];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      lsum[j][0] = lsum[j][1] = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        oacc[j][n][0] = oacc[j][n][1] = oacc[j][n][2] = oacc[j][n][3] = 0.f;
    }
    // the probabilities of row tile j from the scores sc of 16 keys, as the
    // A fragment pa
    auto softmax = [&](uint32_t (&pa)[4], const float (&sc)[2][4], int j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = fast_exp2(fmaf(sc[u][c], scale_log2, -m2[j][c / 2]));
          if constexpr (NORM == kPre) p[c] *= inv_l[j][c / 2];
        }
        const uint32_t lo = pack_bf16(p[0], p[1]);
        const uint32_t hi = pack_bf16(p[2], p[3]);
        if constexpr (NORM == kPost) {  // l from the unrounded p
          lsum[j][0] += p[0] + p[1];
          lsum[j][1] += p[2] + p[3];
        }
        if constexpr (NORM == kRounded) {  // l from the rounded p
          lsum[j][0] += bf16_lo(lo) + bf16_hi(lo);
          lsum[j][1] += bf16_lo(hi) + bf16_hi(hi);
        }
        pa[2 * u] = lo;
        pa[2 * u + 1] = hi;
      }
    };
    // B fragments of V for one chunk of 16 keys, shared by the warp's row
    // tiles where it holds more than one
    uint32_t bv[NS > 1 ? (NT + 1) / 2 : 1][4];
    auto load_bv = [&](const bf16* vt, int c16) {
      if constexpr (NS > 1) {
#pragma unroll
        for (int np = 0; np < (NT + 1) / 2; ++np) v_frag(bv[np], vt, c16, np);
      }
    };
    // O of row tile j += P (keys [16 c16, 16 c16 + 16)) . V
    auto pv = [&](const uint32_t (&pa)[4], const bf16* vt, int c16, int j) {
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {
        uint32_t b[4];
        if constexpr (NS > 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) b[e] = bv[np][e];
        } else {
          v_frag(b, vt, c16, np);
        }
        mma_bf16(oacc[j][2 * np], pa, b[0], b[1]);
        if (2 * np + 1 < NT) mma_bf16(oacc[j][2 * np + 1], pa, b[2], b[3]);
      }
    };

    for (int i = 0; i < ntiles; ++i) {
      const int stage = (ntiles + i) & 1;
      if (i + 1 < ntiles) load_kv((i + 1) * kBKV, stage ^ 1, true);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* kt = ks + stage * S::K_ELEMS;
      const bf16* vt = vs + stage * S::V_ELEMS;
#pragma unroll 1
      for (int c16 = 0; c16 < kBKV / 16; ++c16) {
        load_bk(kt, c16);
        load_bv(vt, c16);
        // the exponentials of row tile j between the products of tile j - 1
        uint32_t pf[2][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float sc[2][4];
          score16(sc, kt, c16, j);
          softmax(pf[j & 1], sc, j);
          if (j > 0) pv(pf[(j - 1) & 1], vt, c16, j - 1);
        }
        pv(pf[(NS - 1) & 1], vt, c16, NS - 1);
      }
      __syncthreads();
    }
    cp_async_wait<0>();

    // ---- normalise and store, straight from the accumulators -------------
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lj = lsum[j][h];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          lj += __shfl_xor_sync(0xffffffffu, lj, off);
        const float inv = fast_rcp(lj);
        const int r = q0 + wq + 16 * j + g + 8 * h;  // the query
        float f[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = oacc[j][n][2 * h + e];
            f[n][e] = NORM == kPost      ? __fdividef(x, lj)
                      : NORM == kRounded ? x * inv
                                         : x;
          }
        if constexpr (CM) {  // columns d = 8n + 2t, +1 of o (B, dk, Sq)
          bf16* ob = o + (long)b * dk * Sq + r;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int d = 8 * n + 2 * t4;
            if (d < dk) {
              ob[(long)d * Sq] = __float2bfloat16(f[n][0]);
              ob[(long)(d + 1) * Sq] = __float2bfloat16(f[n][1]);
            }
          }
        } else {
          bf16* ob = o + ((long)b * Sq + r) * kTokenWidth + 2 * t4;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<uint32_t*>(ob + 8 * n) =
                pack_bf16(f[n][0], f[n][1]);
        }
      }
    }
  }
}

template <bool CM, int DP, int NT, int NORM, int NS, bool DS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int dk, float scale, int smem,
                   cudaStream_t stream) {
  using S = SmallkShape<CM, DP, NT, NS, DS>;
  if (smem != S::BYTES || dk > DP || (CM && dk > 8 * NT))
    return cudaErrorInvalidValue;
  auto kernel = smallk_attention_kernel<CM, DP, NT, NORM, NS, DS>;
  cudaError_t err = allow_smem(kernel, S::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Sq / kBQ, B), S::THREADS, S::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, dk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// channel-major: dk <= 40 holds 5 output tiles, 48 six
template <int NT>
cudaError_t launch_cm(int norm, int split, int dscore, const void* q,
                      const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int dk, float scale, int smem,
                      cudaStream_t s) {
  if (norm == kPre && split == 1 && !dscore)
    return launch<true, 48, NT, kPre, 1, false>(q, k, v, o, B, Sq, Skv, dk,
                                                scale, smem, s);
  if (norm != kRounded) return cudaErrorInvalidValue;
  if (dscore)
    return split == 1 ? launch<true, 48, NT, kRounded, 1, true>(
                            q, k, v, o, B, Sq, Skv, dk, scale, smem, s)
                      : cudaErrorInvalidValue;
  switch (split) {
    case 1:
      return launch<true, 48, NT, kRounded, 1, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, smem, s);
    case 2:
      return launch<true, 48, NT, kRounded, 2, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, smem, s);
    case 4:
      return launch<true, 48, NT, kRounded, 4, false>(q, k, v, o, B, Sq, Skv,
                                                      dk, scale, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rcdms

// The studies' variants only; anything else is refused.
//   cm = 0: q, k, v, o (B, S, W), W = 128; the score contracts dk <= 48
//           (padded to 48) or dk <= 128 columns; norm kPost, split 1.
//   cm = 1: q, o (B, dk, Sq); k, v (B, dk, Skv), dk <= 48;
//           norm kPre (split 1) or kRounded (split 1, 2, 4, or dscore).
// Sq a multiple of 128, Skv of 64, dk of 8; bf16, contiguous, 16-byte
// aligned. smem: the block's shared-memory bytes from the launch plan of
// smallk.py::_plan, which must be what the kernel lays out.
extern "C" int rcdms_smallk_attention(int cm, int norm, int split,
                                      int dscore, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int W, int dk,
                                      float scale, int smem, void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq % kBQ || Skv % kBKV || dk <= 0 ||
      dk % 8)
    return cudaErrorInvalidValue;
  if (!cm) {
    if (W != kTokenWidth || norm != kPost || split != 1 || dscore)
      return cudaErrorInvalidValue;
    if (dk <= 48)
      return launch<false, 48, 16, kPost, 1, false>(q, k, v, o, B, Sq, Skv,
                                                    dk, scale, smem, s);
    return launch<false, 128, 16, kPost, 1, false>(q, k, v, o, B, Sq, Skv, dk,
                                                   scale, smem, s);
  }
  if (dk > 48 || W != dk) return cudaErrorInvalidValue;
  return dk <= 40 ? launch_cm<5>(norm, split, dscore, q, k, v, o, B, Sq, Skv,
                                 dk, scale, smem, s)
                  : launch_cm<6>(norm, split, dscore, q, k, v, o, B, Sq, Skv,
                                 dk, scale, smem, s);
}
