// Kernel A: fused multi-head attention forward, softmax(q k^T * scale) v.
//
// Replaces two Pallas kernels of the JAX package that compute the same
// thing in two layouts: rcdms_tpu/ops/flash.py::_nt_kernel (channel-major,
// UNet spatial self- and cross-attention) and ::_attn_kernel (token-major,
// CLIP ViT-bigG self-attention). Here both take the token-major layout that
// the q/k/v projections produce, (B, S, H*dh): a head is a stride, so no
// transpose and no pad is ever written to device memory.
//
// What bounds it on the H100: at the UNet's level 0 (40 heads of 4096 x
// 4096, dh 40) a query row meets 4096 keys, and one fp32 score row is 16
// KB, so the TPU kernels' whole-row softmax cannot live in 227 KB of shared
// memory: the kernels below stream K/V in tiles. Scores, softmax and sums
// are fp32. At dh 40 there are more exponentials than product flops per
// score: 671 M exponentials take 0.1605 ms at 4.18 T MUFU.EX2 a second
// (16 an SM a clock, 132 SMs, 1980 MHz; NVIDIA H100 80GB HBM3 at its
// 700.00 W limit), and the bf16 kernel's three products (the scores twice,
// P.V once, dh padded to 48) about as long at 989 TFLOP/s. So the kernel
// can near either floor only where one tile's exponentials run while
// another tile's products run.
//
// Two kernels compute it:
//   * CUDA cores (fp32, any dh up to 256): an online softmax (running max
//     m and sum l per query; the output is rescaled when m grows and
//     divided by l once at the end). One block of 256 threads holds one
//     (batch, head) and 256 / TPQ queries; TPQ lanes share a query, each
//     owning dh / TPQ of its dims, and combine partial dot products with
//     warp shuffles. dh is a template bound (32 ... 256); a smaller
//     runtime dh is masked. Bound by the FMA rate and shared-memory reads.
//   * tensor cores (bf16, dh a multiple of 8 up to 256; every site of the
//     main path): FlashAttention-3's layout on TMA + wgmma, in two passes
//     over K so that P rounds as the TPU kernels round it. Both TPU
//     kernels hold the whole key row: they round P = exp(s - m) to bf16
//     against the row's final maximum m (flash.py:71-73, :152-153), and
//     take the row sum l from the fp32 P (_attn_kernel, CLIP vision) or
//     from the rounded P (_nt_kernel, the UNet's spatial sites), the
//     ROW_SUM template parameter. Pass 1 computes only the scores and the
//     row maximum; pass 2 computes the scores again, forms P from the
//     final m, rounds it to bf16, sums l, and accumulates O with no
//     rescale. A CTA holds 128 queries of one (batch, head): two consumer
//     warpgroups of 64 rows (wgmma's M) and one producer warpgroup, whose
//     registers setmaxnreg hands to the consumers (24 and 240 a thread),
//     and one of whose threads issues every TMA load: Q once, then K
//     tiles (pass 1), then K and V tiles (pass 2), through one ring of
//     full and empty mbarriers that runs on from pass 1 into pass 2. No
//     block-wide barrier runs in the key loop. CTAs run in clusters of
//     two neighbouring query blocks of one (batch, head): each producer
//     loads half the rows of every K and V tile and multicasts them to
//     both CTAs, since at dh 40 (80-byte rows at 16-byte alignment) TMA
//     delivered too few bytes a clock for one CTA to load them all. The
//     tensor maps are 4-D, (dh, H, S, B), in boxes of 64 columns x 1 head
//     x rows x 1 batch, so the pad columns dh ... dp of a box are TMA's
//     zeros, not the next head's, and no box runs into the next batch's
//     rows. S = Q K^T is an SS wgmma (m64 x key tile x dp / 16 k16 steps;
//     the key tile 128 up to dp 80, else 64), its accumulators the scores
//     in registers: a row's max reduces over the four lanes that share it
//     (two shuffles), one FFMA folds scale * log2(e) into each
//     exponential, keys at or past Skv are masked by their index on the
//     last tile (TMA's zero rows would score 0), and P is packed from the
//     fp32 accumulators into bf16 A fragments in registers (the
//     accumulator -> A identity of the RS form, wgmma.cuh), so no score
//     or probability reaches shared memory. O += P V is an RS wgmma, V an
//     MN-major B straight from the ring (n = dp, or 40 at dh 40); l from
//     the rounded P is P . ones on the tensor cores, l from the fp32 P a
//     sum in registers. The overlap: each warpgroup issues the next tile's
//     score product and this tile's P V before it takes the next tile's
//     exponentials (intra-warpgroup), and the two warpgroups take turns
//     issuing their products on two named barriers, so one's exponentials
//     run while the other's products run (ping-pong). The output is scaled
//     by 1 / l (rounded l, as _nt_kernel) or divided by l (fp32 l, as
//     _attn_kernel) and stored from the accumulators, rows past Sq and
//     columns past dh left alone.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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


// ---- the bf16 tensor-core kernel (TMA + wgmma, scores in registers) -----

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 384;  // two consumer warpgroups, one producer
constexpr int kTcQueries = 128;  // queries a block, 64 a consumer warpgroup
constexpr int kCluster = 2;  // CTAs a cluster: neighbouring query blocks
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSmemMax = 232448;  // shared memory a block may take
constexpr int kTurn = 1;  // named barriers kTurn + wg: warpgroup wg's turn
// The two overlaps (header comment); off only in builds that measure them
// (rcdms_tpu_torch/tools/attention_overlap_study.py).
constexpr bool kPingPong = true;
constexpr bool kOverlap = true;

// DP: the contraction width, dh padded to a multiple of 16 (a width the
// kernel is built for), taken as NB boxes of 64 columns, each row of a box
// 128 bytes in TMA's 128-byte swizzle. NV (the kernel's): the width of P V
// and of O, dp or, for dh <= 40, 40. BN: keys a tile. Shared memory from
// its 1024-byte aligned start: Q (a consumer warpgroup's NB boxes of 64
// rows, then the other's), a 1024-byte tile of bf16 ones (the B operand
// of the row sums), the ring of STAGES stages (K's NB boxes of BN rows,
// then V's; as many stages as fit, up to four), then the full and empty
// mbarriers of each stage and one for Q. Must agree with
// rcdms_tpu_torch/ops/flash.py::_plan.
template <int DP, int BN>
struct TcShape {
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int KSTEPS = DP / 16;  // k16 steps of the score product
  static constexpr int Q_WG = NB * 64 * 128;
  static constexpr int Q_BYTES = 2 * Q_WG;
  static constexpr int ONES = Q_BYTES;  // offset of the ones tile
  static constexpr int RING = ONES + 1024;
  static constexpr int BOX = BN * 128;  // one 64-column box of a K/V tile
  static constexpr int HALF = BOX / kCluster;  // the rows one CTA loads
  static constexpr int STAGE = 2 * NB * BOX;
  static constexpr int SREGS = BN / 2;   // score accumulators a thread
  static constexpr int PSTEPS = BN / 16;  // k16 steps of P V
  static constexpr int bytes(int stages) {
    return 1024 + RING + stages * STAGE + 8 * (2 * stages + 1);
  }
  static constexpr int STAGES = bytes(4) <= kSmemMax   ? 4
                                : bytes(3) <= kSmemMax ? 3
                                                       : 2;
  static constexpr int BYTES = bytes(STAGES);
  static_assert(DP % 16 == 0 && DP <= 256 && (BN == 64 || BN == 128), "");
  static_assert(BYTES <= kSmemMax, "");
};

// keys at or past Skv of tile t: -inf, so they take no part in the max
// and their P is 0 (TMA's zero rows would score 0)
template <int BN>
__device__ __forceinline__ void mask_keys(float (&s)[BN / 2], int t,
                                          int Skv, int t4) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int key = t * BN + 8 * i + 2 * t4;
    if (key >= Skv) s[4 * i] = s[4 * i + 2] = -INFINITY;
    if (key + 1 >= Skv) s[4 * i + 1] = s[4 * i + 3] = -INFINITY;
  }
}

// One block: queries q0 ... q0 + 127 of one (batch, head), in a cluster
// with the neighbouring block of the same (batch, head) (a block past Sq
// pads an odd count: it loads and computes, and stores nothing). Warps 0-7
// are the consumer warpgroups (rows q0 + 64 wg ...), warps 8-11 the
// producer. Each CTA's producer loads half the rows of every K and V tile
// and multicasts them to both CTAs, so each tile leaves L2 once for the
// pair; a stage is refilled once both CTAs' consumers have released it
// (each consumer warp arrives on the empty barriers of both).
//
// By the accumulator layout (wgmma.cuh) a thread holds rows g and g + 8 of
// its warp's 16, at columns 8i + 2t, +1; so P's A fragment of keys 16kk
// ... 16kk + 15 is, packed to bf16 pairs, accumulators 8kk ... 8kk + 7.
// Only the last key tile can hold keys at or past Skv: it alone is masked,
// on code paths of its own. ROW_SUM 1 takes l from the rounded P on the
// tensor cores, P . ones (m64n8k16 beside each k16 step of P V: every
// column of the product is the row's sum, in fp32); ROW_SUM 0 sums the
// fp32 P in registers.
template <int DP, int NV, int BN, int ROW_SUM>
__global__ void __launch_bounds__(kTcThreads, 1)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           bf16* __restrict__ o, int H, int Sq, int Skv,
                           int dh, float scale_log2) {
  using T = TcShape<DP, BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t raw = smem_addr(tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ones = base + T::ONES;
  const uint32_t ring = base + T::RING;
  const uint32_t full = ring + STAGES * T::STAGE;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = cluster_ctarank();
  const int q0 = blockIdx.x * kTcQueries;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n = (Skv + BN - 1) / BN;  // key tiles; 2n ring steps
  if (threadIdx.x < 64) {  // the ones tile, 16 bytes a thread
    *reinterpret_cast<uint4*>(tc_smem + (ones - raw) + 16 * threadIdx.x) =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * kCluster);  // each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers are ready for the other's arrivals

  if (warp >= 8) {  // ---- producer -------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(qbar, T::Q_BYTES);
      for (int wg = 0; wg < 2; ++wg)
        for (int c = 0; c < T::NB; ++c)
          tma_load_4d(base + wg * T::Q_WG + c * 64 * 128, &qmap, 64 * c, h,
                      q0 + 64 * wg, b, qbar);
      int s = 0, phase = 0;
      for (int i = 0; i < 2 * n; ++i) {
        const bool with_v = i >= n;
        const int key0 = (with_v ? i - n : i) * BN;
        const uint32_t st = ring + s * T::STAGE;
        const uint32_t half = rank * T::HALF;
        const int row0 = key0 + rank * (BN / kCluster);
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(full + 8 * s, (with_v ? 2 : 1) * T::NB * T::BOX);
        for (int c = 0; c < T::NB; ++c) {
          tma_load_4d_multicast(st + c * T::BOX + half, &kmap, 64 * c, h,
                                row0, b, full + 8 * s, 3);
          if (with_v)
            tma_load_4d_multicast(st + (T::NB + c) * T::BOX + half, &vmap,
                                  64 * c, h, row0, b, full + 8 * s, 3);
        }
        if (++s == STAGES) s = 0, phase ^= 1;
      }
    }
    cluster_sync();  // no CTA leaves while the other may still arrive
    return;
  }

  // ---- consumers --------------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t qa = base + wg * T::Q_WG;
  auto stage = [&](int i) { return ring + (i % STAGES) * T::STAGE; };
  auto wait_full = [&](int i) {
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
  };
  // this warp's reads of ring step i are done: lane r counts them in the
  // CTA of rank r
  auto release = [&](int i) {
    if (lane < kCluster) mbar_arrive_cluster(empty + 8 * (i % STAGES), lane);
  };
  // s = Q K^T of the K tile at st: dp / 16 k16 steps, the first
  // overwriting s; one commit group
  auto scores = [&](float (&s)[T::SREGS], uint32_t st) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < T::KSTEPS; ++kc)
      wgmma<BN>(s, sw128_desc(qa + 64 * 128 * (kc / 4)) + 2 * (kc % 4),
                sw128_desc(st + T::BOX * (kc / 4)) + 2 * (kc % 4), kc > 0);
    wgmma_commit();
  };
  // the ping-pong: wait for this warpgroup's turn to issue products, and
  // hand the turn to the other once they are issued
  auto my_turn = [&]() {
    if constexpr (kPingPong) named_sync(kTurn + wg, 256);
  };
  auto your_turn = [&]() {
    if constexpr (kPingPong) named_arrive(kTurn + (wg ^ 1), 256);
  };
  mbar_wait(qbar, 0);

  // pass 1: the row maxima, this lane's columns first. The next tile's
  // score product is issued before this tile's maximum, into the other
  // bank of accumulators. Every wgmma and wait below runs on a path of its
  // own (the last tiles peeled off the loops), so that ptxas can tell
  // which product is in flight and keeps them asynchronous.
  float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float sa[T::SREGS], sb[T::SREGS];
  auto row_max = [&](float (&s)[T::SREGS], int t, bool last) {
    fence_regs(s);
    release(t);
    if (last) mask_keys<BN>(s, t, Skv, t4);
    float a[2][2] = {{m[0], -INFINITY}, {m[1], -INFINITY}};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      a[0][i % 2] = fmaxf(a[0][i % 2], fmaxf(s[4 * i], s[4 * i + 1]));
      a[1][i % 2] = fmaxf(a[1][i % 2], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    m[0] = fmaxf(a[0][0], a[0][1]);
    m[1] = fmaxf(a[1][0], a[1][1]);
  };
  // tile t's scores are in flight in `cur` and tile t + 1 exists: issue
  // its scores into `next`, wait for `cur`, take its maximum
  auto pass1_step = [&](float (&cur)[T::SREGS], float (&next)[T::SREGS],
                        int t) {
    wait_full(t + 1);
    scores(next, stage(t + 1));
    wgmma_wait<1>();
    row_max(cur, t, false);
  };
  wait_full(0);
  scores(sa, stage(0));
  int t = 0;
  for (; t + 2 < n; t += 2) {
    pass1_step(sa, sb, t);
    pass1_step(sb, sa, t + 1);
  }
  if (t + 1 < n) {  // tiles n - 2 and n - 1
    pass1_step(sa, sb, t);
    wgmma_wait<0>();
    row_max(sb, t + 1, true);
  } else {  // tile n - 1
    wgmma_wait<0>();
    row_max(sa, t, true);
  }
  // the row's max over the quad sharing it; finite: key 0 < Skv is live
  // in every row
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
    ms[r] = m[r] * scale_log2;
  }

  // pass 2: P = exp2(s * scale * log2(e) - m * scale * log2(e)) against
  // the final m, rounded to bf16 A fragments; l; O += P V
  float l[2] = {0.f, 0.f};  // ROW_SUM 0: this lane's share of the sums
  float lacc[4];            // ROW_SUM 1: P . ones, from tile 0's first step
  float oacc[NV / 2];       // written first by tile 0's P V
  uint32_t pf[T::PSTEPS][4];
  // tile t's exponentials, in place (s becomes the fp32 P); l from it
  // where ROW_SUM is 0
  auto exps = [&](float (&s)[T::SREGS], int t, bool last) {
    fence_regs(s);
    if (last) mask_keys<BN>(s, t, Skv, t4);
#pragma unroll
    for (int i = 0; i < T::SREGS; ++i)
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[(i / 2) % 2]));
    if constexpr (!ROW_SUM) {
#pragma unroll
      for (int i = 0; i < T::SREGS; ++i) l[(i / 2) % 2] += s[i];
    }
  };
  // the fp32 P into pf, P V's A fragments (rounded to bf16)
  auto pack = [&](const float (&s)[T::SREGS]) {
#pragma unroll
    for (int kk = 0; kk < T::PSTEPS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pf[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  };
  // O += P V of tile t's V tile: MN-major B, a 64-column atom a box on
  // (the leading byte offset), 16 key rows a k16 step; and where ROW_SUM
  // is 1, l += P . ones. Tile 0's first step overwrites both.
  auto pv = [&](int t) {
    const uint32_t sv = stage(n + t) + T::NB * T::BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::PSTEPS; ++kk) {
      wgmma_rs<NV, 1>(oacc, pf[kk], sw128_mn_desc(sv + 2048 * kk, T::BOX),
                      kk > 0 || t > 0);
      if constexpr (ROW_SUM)
        wgmma_rs<8, 0>(lacc, pf[kk], sw128_desc(ones), kk > 0 || t > 0);
    }
    wgmma_commit();
  };
  // one turn: tile t's P is in pf, and tile t + 1 exists, its scores to
  // go into `next`. Issue them and tile t's P V, hand the turn on, take
  // tile t + 1's exponentials while P V runs (and the other warpgroup's
  // products), then its P, once P V has read pf.
  auto pass2_step = [&](float (&next)[T::SREGS], int t, bool last) {
    wait_full(n + t + 1);
    my_turn();
    scores(next, stage(n + t + 1));
    pv(t);
    your_turn();
    if constexpr (kOverlap) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    exps(next, t + 1, last);
    wgmma_wait<0>();
    fence_regs(pf);
    release(n + t);
    pack(next);
  };
  // the last tile's P V; the second warpgroup keeps its last turn
  auto pass2_last = [&](int t) {
    my_turn();
    pv(t);
    if (wg == 0) your_turn();
    wgmma_wait<0>();
    fence_regs(pf);
    release(n + t);
  };
  // the first tile's scores take a turn of their own; the second
  // warpgroup gives the first the first turn
  if (kPingPong && wg == 1) named_arrive(kTurn, 256);
  wait_full(n);
  my_turn();
  scores(sa, stage(n));
  your_turn();
  wgmma_wait<0>();
  if (n == 1) {
    exps(sa, 0, true);
  } else {
    exps(sa, 0, false);
  }
  pack(sa);
  // tiles t + 1 and t + 2, whose exponentials the loop takes, are not
  // the last
  t = 0;
  for (; t + 3 < n; t += 2) {
    pass2_step(sb, t, false);
    pass2_step(sa, t + 1, false);
  }
  if (t + 2 < n) {  // t = n - 3
    pass2_step(sb, t, false);
    pass2_step(sa, t + 1, true);
    pass2_last(t + 2);
  } else if (t + 1 < n) {  // t = n - 2
    pass2_step(sb, t, true);
    pass2_last(t + 1);
  } else {  // t = n - 1
    pass2_last(t);
  }
  fence_regs(oacc);
  if constexpr (ROW_SUM) fence_regs(lacc);

  // O / l, rows past Sq and columns past dh not stored
  const long row = (long)H * dh;
  const int r0 = q0 + 64 * wg + 16 * (warp % 4) + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    if constexpr (ROW_SUM) {
      sum = lacc[2 * r];  // every column holds the row's sum
    } else {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    const float inv = 1.f / sum;
    const int q = r0 + 8 * r;
    if (q >= Sq) continue;
    bf16* op = o + ((long)b * Sq + q) * row + (long)h * dh + 2 * t4;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      if (8 * i < dh) {
        const float* a = &oacc[4 * i + 2 * r];
        *reinterpret_cast<uint32_t*>(op + 8 * i) =
            ROW_SUM ? pack_bf16(a[0] * inv, a[1] * inv)
                    : pack_bf16(a[0] / sum, a[1] / sum);
      }
    }
  }
  cluster_sync();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A bf16 map of a (B, S, H * dh) tensor as 4-D (dh, H, S, B), read in
// boxes of 64 columns x 1 head x rows x 1 batch.
cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int dh, int rows) {
  const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)H, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)dh * 2, (uint64_t)H * dh * 2,
                               (uint64_t)S * H * dh * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return make_bf16_map(map, ptr, 4, dims, strides, box);
}

template <int DP, int NV, int BN, int ROW_SUM>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int Sq, int Skv, int dh, float scale,
                      int stages, int smem, cudaStream_t stream) {
  using T = TcShape<DP, BN>;
  auto kernel = attention_wgmma_kernel<DP, NV, BN, ROW_SUM>;
  if (stages != T::STAGES || smem != T::BYTES || dh > NV)
    return cudaErrorInvalidValue;
  static const cudaError_t ready = allow_smem(kernel, kSmemMax);  // once
  if (ready != cudaSuccess) return ready;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = head_map(&qmap, q, B, Sq, H, dh, 64);
  if (err == cudaSuccess)
    err = head_map(&kmap, k, B, Skv, H, dh, BN / kCluster);
  if (err == cudaSuccess)
    err = head_map(&vmap, v, B, Skv, H, dh, BN / kCluster);
  if (err != cudaSuccess) return err;
  const int blocks = (Sq + kTcQueries - 1) / kTcQueries;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + kCluster - 1) / kCluster * kCluster, B * H);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, qmap, kmap, vmap,
                           static_cast<bf16*>(o), H, Sq, Skv, dh,
                           scale * 1.4426950408889634f);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The (dp, nv, key tile) triples that flash.py::_plan chooses from, each
// with l from the rounded P (row_sum 1) or the fp32 P (0).
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Skv, int dh, float scale,
                        int dp, int nv, int bn, int bq, int stages,
                        int cluster, int row_sum, int smem, cudaStream_t s) {
  if (dh % 8 != 0 || bq != kTcQueries || cluster != kCluster ||
      B * H > 65535 ||
      (row_sum != 0 && row_sum != 1) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
#define RCDMS_TC_CASE(DP, NV, BN)                                           \
  if (dp == DP && nv == NV && bn == BN)                                     \
    return row_sum ? launch_tc<DP, NV, BN, 1>(q, k, v, o, B, H, Sq, Skv, dh, \
                                              scale, stages, smem, s)       \
                   : launch_tc<DP, NV, BN, 0>(q, k, v, o, B, H, Sq, Skv, dh, \
                                              scale, stages, smem, s);
  RCDMS_TC_CASE(48, 40, 128)
  RCDMS_TC_CASE(48, 48, 128)
  RCDMS_TC_CASE(64, 64, 128)
  RCDMS_TC_CASE(80, 80, 128)
  RCDMS_TC_CASE(112, 112, 64)
  RCDMS_TC_CASE(128, 128, 64)
  RCDMS_TC_CASE(160, 160, 64)
  RCDMS_TC_CASE(256, 256, 64)
#undef RCDMS_TC_CASE
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
// fp32 runs the CUDA-core kernel. bf16 runs the TMA + wgmma kernel with
// the launch plan of flash.py::_plan: the contraction width dp, the
// output width nv, the key tile bn, queries a block bq, the ring's stages,
// CTAs a cluster, the row-sum family (1: l from the rounded P, 0: from the
// fp32 P), and its shared-memory bytes, which must be what the kernel lays
// out (dh a multiple of 8, q / k / v / o 16-byte aligned, B * H at most
// 65535).
extern "C" int rcdms_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Sq, int Skv, int dh, float scale,
                                   int dp, int nv, int bn, int bq,
                                   int stages, int cluster, int row_sum,
                                   int smem, void* stream) {
  using namespace rcdms;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || dh <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch_tc(q, k, v, o, B, H, Sq, Skv, dh, scale, dp, nv, bn, bq,
                       stages, cluster, row_sum, smem, s);
  if (dtype == kFloat32)
    return dispatch_f32(q, k, v, o, B, H, Sq, Skv, dh, scale, s);
  return cudaErrorInvalidValue;
}
