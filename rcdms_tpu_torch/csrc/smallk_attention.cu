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
//     overlap rows);
//   * normalisation, the three rounding families of the TPU kernels:
//     kPost     p = exp(s - m) in fp32, l = sum p, o = (bf16 p) v / l;
//     kPre      p = bf16(p / l) before the product, o = p v;
//     kRounded  p = bf16(exp(s - m)), l = the sum of the rounded p,
//               o = (p v) * (1 / l);
//   * schedule (SCHED), what runs beside the exponentials of a key tile:
//     0 (base, nt_t40 and the flash study's rows) nothing: a warpgroup
//       issues its products, waits for them all, then takes the
//       exponentials (the other warpgroup runs as the warp schedulers
//       let it);
//     1 (split2: two parts, the exponentials of one beside the product of
//       the other) the two consumer warpgroups take turns to issue their
//       products on two named barriers (kernel A's ping-pong), so one
//       warpgroup's exponentials run while the other's products run;
//     2 (split4: four parts, two a warpgroup) the ping-pong, and each
//       warpgroup issues its next tile's score product and this tile's P V
//       before this tile's exponentials, so its own products run beside
//       them too (kernel A's schedule);
//     and dscore (DS): the second pass's score computed as the transposed
//     tile S^T = K Q^T, keys as wgmma's M. wgmma reads its B operand only
//     from shared memory, so P^T, rounded to bf16, is staged there (two
//     buffers a warpgroup, in TMA's 128-byte swizzle) for O^T += V^T P^T,
//     V^T padded to M = 64 rows; the staging, a warpgroup barrier a tile,
//     is what the row measures on this card. Row 48 of each V^T box is a
//     row of ones that TMA never writes, so O^T's row 48 is l, the sum of
//     the rounded P^T, as the TPU kernel's ones product.
//   `split` changes no number: every schedule does the same products in
//   the same order.
//
// What bounds it on the H100: at dh 40 a score and its share of P V cost
// 160 tensor-core flops but one MUFU.EX2, so the exponentials bound it
// (1.342 G of them at B = 80: 0.32 ms at 4.18 T a second; kPre takes two a
// score, its online l in pass 1, so 0.64 ms). The TPU kernels hold a whole
// 512 x 4096 fp32 score block in VMEM and form p from its exact row max;
// an SM has 228 KB. So every block of 128 queries (one batch row) runs two
// passes over K, on TMA + wgmma as kernel A (attention.cu): pass 1
// computes the scores for the exact row max m (and, for kPre, the online
// fp32 l); pass 2 computes the scores again, forms p from the exact m as
// the TPU kernel does, and accumulates P V in fp32 registers that never
// need a rescale. Two consumer warpgroups take 64 queries each (wgmma's
// M); the producer warpgroup, whose registers setmaxnreg hands to the
// consumers (24 and 240 a thread), issues every TMA load from one thread:
// Q once, then K tiles (pass 1), then K and V tiles (pass 2), through one
// ring of full and empty mbarriers that runs on from pass 1 into pass 2.
// No block-wide barrier runs in the key loop. S = Q K^T is an SS wgmma
// (m64 x key tile x 48 or 128 / 16 k16 steps), the scores stay in the
// accumulators, a row's max reduces over the four lanes that share it, one
// FFMA folds scale * log2(e) into each exponential, and P is packed into
// bf16 A fragments in registers (the RS form, wgmma.cuh): no score or
// probability reaches shared memory outside dscore. l from the rounded P
// is P . ones on the tensor cores, l from the fp32 P a sum in registers.
// Layouts, as TMA boxes in the 128-byte swizzle:
//   * channel-major: 3-D maps (S, dh, B) with the tokens innermost, boxes
//     of 64 tokens x 48 rows, so dh is padded to k48 by TMA's zeros (the
//     map's extent is dh) and nothing is padded in device memory. Q and K
//     are MN-major operands of the score product; V is a K-major B of
//     P V at n40 (dh <= 40) or n48; a key tile is 128 keys (two boxes),
//     keys past Skv read zero and are masked by index. The output goes
//     through the warpgroup's Q tile, transposed, to 128-byte rows of
//     o (B, dh, Sq).
//   * token-major: 3-D maps (128, S, B) whose column extent is dk for Q
//     and K, so box columns past dk are zeros (a 64-column box at dk <= 48,
//     two at 128); V is an MN-major B at n128; key tiles of 64; the output
//     is stored from the accumulators.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"  // pack_bf16, fast_exp2, fast_rcp
#include "wgmma.cuh"

namespace rcdms {
namespace {

using bf16 = __nv_bfloat16;

enum Norm : int { kPost = 0, kPre = 1, kRounded = 2 };

constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kQueries = 128;  // queries a block, 64 a consumer warpgroup
constexpr int kWidth = 128;    // token-major rows: q, k, v and o
constexpr int kCmRows = 48;    // channel-major box rows: dh padded to k48
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // shared memory a block may take
constexpr int kTurn = 1;      // named barriers 1, 2: warpgroup wg's turn
constexpr int kGroupBar = 3;  // named barriers 3, 4: warpgroup wg alone

// CM: channel-major; DP: the contraction width (48, or 128 token-major);
// DS: dscore. Shared memory from its 1024-byte aligned start: Q (a
// consumer warpgroup's boxes, then the other's), a 1024-byte tile of bf16
// ones (the B operand of the row sums), dscore's P^T buffers (two a
// warpgroup, BN keys x 64 queries), the ring of STAGES stages (K's boxes,
// then V's two), dscore's 128 fp32 (m, then 1 / l, a query), then the
// full and empty mbarriers of each stage and one for Q. dscore's V boxes
// are 64 rows, rows 48-63 set once (row 48 ones). Must agree with
// rcdms_tpu_torch/ops/smallk.py::_plan.
template <bool CM, int DP, bool DS>
struct EShape {
  static constexpr int BN = CM ? 128 : 64;  // keys a tile
  static constexpr int KSTEPS = DP / 16;    // k16 steps of the score
  static constexpr int NB = CM ? 1 : (DP + 63) / 64;  // token-major boxes
  static constexpr int Q_WG = CM ? kCmRows * 128 : NB * 64 * 128;
  static constexpr int K_BOX = CM ? kCmRows * 128 : BN * 128;
  static constexpr int K_TILE = CM ? 2 * K_BOX : NB * K_BOX;
  static constexpr int V_TX = CM ? kCmRows * 128 : BN * 128;  // TMA bytes
  static constexpr int V_BOX = DS ? 64 * 128 : V_TX;
  static constexpr int STAGE = K_TILE + 2 * V_BOX;
  static constexpr int ONES = 2 * Q_WG;
  static constexpr int PT = ONES + 1024;
  static constexpr int PT_BUF = BN * 128;  // 64 queries of 2 bytes a key
  static constexpr int RING = PT + (DS ? 4 * PT_BUF : 0);
  static constexpr int MROWS = DS ? kQueries * 4 : 0;
  static constexpr int SREGS = BN / 2;    // score accumulators a thread
  static constexpr int PSTEPS = BN / 16;  // k16 steps of P V
  static constexpr int bytes(int stages) {
    return 1024 + RING + stages * STAGE + MROWS + 8 * (2 * stages + 1);
  }
  static constexpr int STAGES = bytes(kMaxStages) <= kSmemMax ? kMaxStages
                                : bytes(3) <= kSmemMax        ? 3
                                                              : 2;
  static constexpr int BYTES = bytes(STAGES);
  static_assert(CM ? DP == 48 : DP == 48 || DP == 128, "contraction");
  static_assert(!DS || CM, "dscore: channel-major");
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

// One block: queries q0 ... q0 + 127 of batch row b. Warps 0-7 are the
// consumer warpgroups (queries q0 + 64 wg ...), warps 8-11 the producer.
// NV: the width of P V (40, 48 or 128; dscore 64, V^T's padded rows).
// By the accumulator layout (wgmma.cuh) a thread holds rows g and g + 8 of
// its warp's 16, at columns 8i + 2t, +1; so P's A fragment of keys 16kk
// ... 16kk + 15 is, packed to bf16 pairs, accumulators 8kk ... 8kk + 7.
template <bool CM, int DP, int NV, int NORM, int SCHED, bool DS>
__global__ void __launch_bounds__(kThreads, 1)
    smallk_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        bf16* __restrict__ o, int Sq, int Skv, int dh,
                        float scale_log2) {
  using T = EShape<CM, DP, DS>;
  constexpr int STAGES = T::STAGES;
  constexpr int BN = T::BN;
  constexpr bool kPingPong = SCHED >= 1;
  constexpr bool kOverlap = SCHED >= 2;
  static_assert(!DS || (NORM == kRounded && SCHED == 0 && NV == 64),
                "dscore rounds as nt_t40");
  static_assert(CM ? (DS || NV == 40 || NV == 48) : NV == kWidth, "nv");
  extern __shared__ unsigned char e_smem[];
  const uint32_t raw = smem_addr(e_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = e_smem + (base - raw);
  const uint32_t ones = base + T::ONES;
  const uint32_t ring = base + T::RING;
  const uint32_t mrows = ring + STAGES * T::STAGE;
  const uint32_t full = mrows + T::MROWS;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kQueries, b = blockIdx.y;
  const int n = (Skv + BN - 1) / BN;  // key tiles; 2n ring steps
  const uint4 ones4 = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                 0x3F803F80u);
  if (threadIdx.x < 64)  // the ones tile, 16 bytes a thread
    *reinterpret_cast<uint4*>(gbase + T::ONES + 16 * threadIdx.x) = ones4;
  if constexpr (DS) {  // rows 48-63 of every V^T box: row 48 ones
    for (int i = threadIdx.x; i < STAGES * 2 * 128; i += kThreads) {
      const int box = i / 128, c = i % 128;
      *reinterpret_cast<uint4*>(gbase + T::RING + (box / 2) * T::STAGE +
                                T::K_TILE + (box % 2) * T::V_BOX +
                                kCmRows * 128 + 16 * c) =
          c < 8 ? ones4 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer -------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(qbar, 2 * T::Q_WG);
      for (int wg = 0; wg < 2; ++wg) {
        if constexpr (CM) {
          tma_load_3d(base + wg * T::Q_WG, &qmap, q0 + 64 * wg, 0, b, qbar);
        } else {
          for (int c = 0; c < T::NB; ++c)
            tma_load_3d(base + wg * T::Q_WG + c * 64 * 128, &qmap, 64 * c,
                        q0 + 64 * wg, b, qbar);
        }
      }
      int s = 0, phase = 0;
      for (int i = 0; i < 2 * n; ++i) {
        const bool with_v = i >= n;
        const int key0 = (with_v ? i - n : i) * BN;
        const uint32_t st = ring + s * T::STAGE, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(bar, T::K_TILE + (with_v ? 2 * T::V_TX : 0));
        for (int h = 0; h < 2; ++h) {
          if constexpr (CM) {  // K and V: two boxes of 64 keys
            tma_load_3d(st + h * T::K_BOX, &kmap, key0 + 64 * h, 0, b, bar);
            if (with_v)
              tma_load_3d(st + T::K_TILE + h * T::V_BOX, &vmap, key0 + 64 * h,
                          0, b, bar);
          } else {  // K: NB boxes of 64 columns; V: two
            if (h < T::NB)
              tma_load_3d(st + h * T::K_BOX, &kmap, 64 * h, key0, b, bar);
            if (with_v)
              tma_load_3d(st + T::K_TILE + h * T::V_BOX, &vmap, 64 * h, key0,
                          b, bar);
          }
        }
        if (++s == STAGES) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers --------------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t qa = base + wg * T::Q_WG;
  auto stage = [&](int i) { return ring + (i % STAGES) * T::STAGE; };
  auto wait_full = [&](int i) {
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
  };
  // this warp's reads of ring step i are done
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty + 8 * (i % STAGES));
  };
  // s = Q K^T of the K tile at st: DP / 16 k16 steps, the first
  // overwriting s; one commit group
  auto scores = [&](float (&s)[T::SREGS], uint32_t st) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < T::KSTEPS; ++kc) {
      if constexpr (CM)  // a k16 step: 16 rows of 128 bytes on
        wgmma<BN, 1, 1>(s, sw128_mn_desc(qa + 2048 * kc),
                        sw128_mn_desc(st + 2048 * kc, T::K_BOX), kc > 0);
      else  // a k16 step: 32 bytes along the row, a box every 64 columns
        wgmma<BN, 0, 0>(s, sw128_desc(qa + 64 * 128 * (kc / 4)) + 2 * (kc % 4),
                        sw128_desc(st + T::K_BOX * (kc / 4)) + 2 * (kc % 4),
                        kc > 0);
    }
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

  // pass 1: the row maxima (kPre: and the online l), this lane's columns
  // first. The next tile's score product is issued before this tile's
  // maximum, into the other bank of accumulators. Every wgmma and wait
  // below runs on a path of its own (the last tiles peeled off the loops),
  // so that ptxas can tell which product is in flight and keeps them
  // asynchronous.
  float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float l[2] = {0.f, 0.f};  // kPre: this lane's l against its m; kPost
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
    const float mn[2] = {fmaxf(a[0][0], a[0][1]), fmaxf(a[1][0], a[1][1])};
    if constexpr (NORM == kPre) {  // 0 * 0 on the first tile
      const float ms[2] = {mn[0] * scale_log2, mn[1] * scale_log2};
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] *= fast_exp2((m[r] - mn[r]) * scale_log2);
#pragma unroll
      for (int i = 0; i < T::SREGS; ++i)
        l[(i / 2) % 2] += fast_exp2(fmaf(s[i], scale_log2, -ms[(i / 2) % 2]));
    }
    m[0] = mn[0];
    m[1] = mn[1];
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
  // the row's max over the quad sharing it, as the argument m * scale *
  // log2(e) of exp2; finite: key 0 < Skv is live in every row. kPre: 1 / l
  // against that max.
  float ms[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = m[r];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    ms[r] = mr * scale_log2;
    if constexpr (NORM == kPre) {
      float lr = l[r] * fast_exp2((m[r] - mr) * scale_log2);
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        lr += __shfl_xor_sync(0xffffffffu, lr, off);
      inv_l[r] = fast_rcp(lr);
    }
  }

  if constexpr (DS) {
    // ---- pass 2, dscore: S^T = K Q^T, O^T += V^T P^T --------------------
    // m of the 16 queries this lane holds in the transposed layout:
    // columns 8i + 2t, +1
    float* const msh = reinterpret_cast<float*>(gbase + (mrows - base)) +
                       64 * wg;
    if (t4 == 0) {
      msh[16 * w + g] = ms[0];
      msh[16 * w + g + 8] = ms[1];
    }
    named_sync(kGroupBar + wg, 128);
    float mq[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mq[i][0] = msh[8 * i + 2 * t4];
      mq[i][1] = msh[8 * i + 2 * t4 + 1];
    }
    // st[mk]: keys 64 mk + 16 w + g (+8) x queries 8i + 2t, +1; oacc: rows
    // d = 16 w + g (+8) of O^T (row 48: l) x the same queries
    float st[2][32], oacc[32];
    for (int tt = 0; tt < n; ++tt) {
      const uint32_t sk = stage(n + tt);
      const uint32_t pt = base + T::PT + (2 * wg + (tt & 1)) * T::PT_BUF;
      unsigned char* const ptg = gbase + (pt - base);
      wait_full(n + tt);
      wgmma_fence();
#pragma unroll
      for (int mk = 0; mk < 2; ++mk)
#pragma unroll
        for (int kc = 0; kc < T::KSTEPS; ++kc)
          wgmma<64, 1, 1>(st[mk], sw128_mn_desc(sk + mk * T::K_BOX + 2048 * kc),
                          sw128_mn_desc(qa + 2048 * kc), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();  // the scores, and tile tt - 1's P V
      fence_regs(st[0]);
      fence_regs(st[1]);
      if (tt > 0) release(n + tt - 1);
      // P^T rounded to bf16 into this tile's buffer: key row r, queries
      // 8i ... 8i + 7 in the 16-byte chunk i ^ (r mod 8) (TMA's swizzle,
      // which the MN-major descriptor reads); keys past Skv are 0
#pragma unroll
      for (int mk = 0; mk < 2; ++mk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * mk + 16 * w + g + 8 * h;
          const bool live = tt * BN + r < Skv;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p0 = fast_exp2(
                fmaf(st[mk][4 * i + 2 * h], scale_log2, -mq[i][0]));
            const float p1 = fast_exp2(
                fmaf(st[mk][4 * i + 2 * h + 1], scale_log2, -mq[i][1]));
            *reinterpret_cast<uint32_t*>(ptg + r * 128 + 16 * (i ^ g) +
                                         4 * t4) =
                live ? pack_bf16(p0, p1) : 0u;
          }
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // every warp's P^T is written, and every warp has seen tile tt - 2's
      // P V, the last reader of this buffer, done
      named_sync(kGroupBar + wg, 128);
      const uint32_t sv = sk + T::K_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::PSTEPS; ++kk)
        wgmma<64, 0, 1>(oacc, sw128_desc(sv + T::V_BOX * (kk / 4)) +
                                  2 * (kk % 4),
                        sw128_mn_desc(pt + 2048 * kk), kk > 0 || tt > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(oacc);
    release(2 * n - 1);
    // 1 / l from row 48 (warp 3, g = 0) to every lane of the warpgroup
    if (w == 3 && g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        msh[8 * i + 2 * t4] = 1.f / oacc[4 * i];
        msh[8 * i + 2 * t4 + 1] = 1.f / oacc[4 * i + 1];
      }
    }
    named_sync(kGroupBar + wg, 128);
    // O^T is channel-major already: pairs of neighbouring queries
    bf16* const ob = o + (long)b * dh * Sq + q0 + 64 * wg + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * w + g + 8 * h;
      if (d >= dh) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(ob + (long)d * Sq + 8 * i) = pack_bf16(
            oacc[4 * i + 2 * h] * msh[8 * i + 2 * t4],
            oacc[4 * i + 2 * h + 1] * msh[8 * i + 2 * t4 + 1]);
    }
  } else {
    // ---- pass 2: P against the final m, rounded to bf16 A fragments; l;
    // O += P V --------------------------------------------------------------
    float lacc[4];       // kRounded: P . ones, from tile 0's first step
    float oacc[NV / 2];  // written first by tile 0's P V
    uint32_t pf[T::PSTEPS][4];
    // tile t's exponentials, in place (s becomes the fp32 P, kPre's
    // already over l); kPost: l from it
    auto exps = [&](float (&s)[T::SREGS], int t, bool last) {
      fence_regs(s);
      if (last) mask_keys<BN>(s, t, Skv, t4);
#pragma unroll
      for (int i = 0; i < T::SREGS; ++i) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[(i / 2) % 2]));
        if constexpr (NORM == kPre) s[i] *= inv_l[(i / 2) % 2];
        if constexpr (NORM == kPost) l[(i / 2) % 2] += s[i];
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
    // O += P V of tile t's V tile, 16 keys a k16 step: channel-major V a
    // K-major B (32 bytes along its rows a step, a box every 64 keys),
    // token-major an MN-major B (16 rows a step, the second 64-column
    // box one V_BOX on); kRounded: l += P . ones. Tile 0's first step
    // overwrites both.
    auto pv = [&](int t) {
      const uint32_t sv = stage(n + t) + T::K_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::PSTEPS; ++kk) {
        if constexpr (CM)
          wgmma_rs<NV, 0>(oacc, pf[kk],
                          sw128_desc(sv + T::V_BOX * (kk / 4)) + 2 * (kk % 4),
                          kk > 0 || t > 0);
        else
          wgmma_rs<NV, 1>(oacc, pf[kk],
                          sw128_mn_desc(sv + 2048 * kk, T::V_BOX),
                          kk > 0 || t > 0);
        if constexpr (NORM == kRounded)
          wgmma_rs<8, 0>(lacc, pf[kk], sw128_desc(ones), kk > 0 || t > 0);
      }
      wgmma_commit();
    };
    // one turn: tile t's P is in pf, and tile t + 1 exists, its scores to
    // go into `next`. Issue them and tile t's P V, hand the turn on, take
    // tile t + 1's exponentials (kOverlap: while P V runs), then its P,
    // once P V has read pf.
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
    if constexpr (NORM == kRounded) fence_regs(lacc);

    // O * (1 / l) (kRounded), O / l (kPost) or O (kPre)
    float sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = l[r];
      if constexpr (NORM == kRounded) {
        sum[r] = 1.f / lacc[2 * r];  // every column holds the row's sum
      } else if constexpr (NORM == kPost) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      }
    }
    auto out = [&](float a, int r) {
      return NORM == kRounded ? a * sum[r] : NORM == kPost ? a / sum[r] : a;
    };
    if constexpr (CM) {
      // through this warpgroup's Q tile, once every warp has seen its last
      // reader done: [d][64 queries], then 128-byte rows of o (B, dh, Sq)
      bf16* const stg = reinterpret_cast<bf16*>(gbase + wg * T::Q_WG);
      named_sync(kGroupBar + wg, 128);
#pragma unroll
      for (int i = 0; i < NV / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            stg[(8 * i + 2 * t4 + e) * 64 + 16 * w + g + 8 * r] =
                __float2bfloat16(out(oacc[4 * i + 2 * r + e], r));
      named_sync(kGroupBar + wg, 128);
      const int tid = threadIdx.x - 128 * wg;
      for (int c = tid; c < dh * 8; c += 128)
        *reinterpret_cast<uint4*>(o + ((long)b * dh + c / 8) * Sq + q0 +
                                  64 * wg + 8 * (c % 8)) =
            *reinterpret_cast<const uint4*>(stg + c / 8 * 64 + 8 * (c % 8));
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* const op =
            o + ((long)b * Sq + q0 + 64 * wg + 16 * w + g + 8 * r) * kWidth +
            2 * t4;
#pragma unroll
        for (int i = 0; i < NV / 8; ++i)
          *reinterpret_cast<uint32_t*>(op + 8 * i) =
              pack_bf16(out(oacc[4 * i + 2 * r], r),
                        out(oacc[4 * i + 2 * r + 1], r));
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A bf16 map of a (B, rows, pitch) tensor read as (B, rows, cols), cols
// <= pitch innermost (what lies past cols reads zero), in boxes of 64
// columns x box_rows x 1.
cudaError_t map_3d(CUtensorMap* map, const void* ptr, int B, int rows,
                   int cols, int pitch, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)pitch * 2,
                               (uint64_t)pitch * rows * 2};
  const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
  return make_bf16_map(map, ptr, 3, dims, strides, box);
}

template <bool CM, int DP, int NV, int NORM, int SCHED, bool DS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int dk, float scale, int dp,
                   int nv, int bn, int stages, int smem, cudaStream_t s) {
  using T = EShape<CM, DP, DS>;
  auto kernel = smallk_wgmma_kernel<CM, DP, NV, NORM, SCHED, DS>;
  if (dp != DP || nv != NV || bn != T::BN || stages != T::STAGES ||
      smem != T::BYTES || dk > DP)
    return cudaErrorInvalidValue;
  static const cudaError_t ready = allow_smem(kernel, kSmemMax);  // once
  if (ready != cudaSuccess) return ready;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err;
  if constexpr (CM) {  // (B, dk, S): 64 tokens x 48 rows
    err = map_3d(&qmap, q, B, dk, Sq, Sq, kCmRows);
    if (err == cudaSuccess) err = map_3d(&kmap, k, B, dk, Skv, Skv, kCmRows);
    if (err == cudaSuccess) err = map_3d(&vmap, v, B, dk, Skv, Skv, kCmRows);
  } else {  // (B, S, 128): Q and K to column dk, V whole; 64 rows
    err = map_3d(&qmap, q, B, Sq, dk, kWidth, 64);
    if (err == cudaSuccess) err = map_3d(&kmap, k, B, Skv, dk, kWidth, 64);
    if (err == cudaSuccess)
      err = map_3d(&vmap, v, B, Skv, kWidth, kWidth, 64);
  }
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Sq / kQueries, B), kThreads, smem, s>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), Sq, Skv, dk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// channel-major at n40 (dk <= 40) or n48: every norm and schedule
template <int NV>
cudaError_t launch_cm(int norm, int split, const void* q, const void* k,
                      const void* v, void* o, int B, int Sq, int Skv, int dk,
                      float scale, int dp, int nv, int bn, int stages,
                      int smem, cudaStream_t s) {
#define RCDMS_E_CM(NORM, SCHED)                                              \
  launch<true, 48, NV, NORM, SCHED, false>(q, k, v, o, B, Sq, Skv, dk, scale, \
                                           dp, nv, bn, stages, smem, s)
  if (norm == kPre) return split == 1 ? RCDMS_E_CM(kPre, 0)
                                      : cudaErrorInvalidValue;
  if (norm != kRounded) return cudaErrorInvalidValue;
  switch (split) {
    case 1:
      return RCDMS_E_CM(kRounded, 0);
    case 2:
      return RCDMS_E_CM(kRounded, 1);
    case 4:
      return RCDMS_E_CM(kRounded, 2);
    default:
      return cudaErrorInvalidValue;
  }
#undef RCDMS_E_CM
}

}  // namespace
}  // namespace rcdms

// The studies' variants only; anything else is refused.
//   cm = 0: q, k, v, o (B, S, W), W = 128; the score contracts dk <= 48
//           (padded to 48) or 128 columns; norm kPost, split 1.
//   cm = 1: q, o (B, dk, Sq); k, v (B, dk, Skv), dk <= 48;
//           norm kPre (split 1) or kRounded (split 1, 2, 4, or dscore).
// Sq a multiple of 128, Skv of 64, dk of 8, B at most 65535; bf16,
// contiguous, 16-byte aligned. dp, nv, bn, stages, smem: the launch plan of
// smallk.py::_plan (contraction width, P V's width, keys a tile, the
// ring's stages, shared-memory bytes), which must be the kernel's.
extern "C" int rcdms_smallk_attention(int cm, int norm, int split,
                                      int dscore, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int W, int dk,
                                      float scale, int dp, int nv, int bn,
                                      int stages, int smem, void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || Sq <= 0 || Skv <= 0 || Sq % kQueries ||
      Skv % 64 || dk <= 0 || dk % 8 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  if (!cm) {
    if (W != kWidth || norm != kPost || split != 1 || dscore ||
        (dk > 48 && dk != kWidth))
      return cudaErrorInvalidValue;
    if (dk <= 48)
      return launch<false, 48, kWidth, kPost, 0, false>(
          q, k, v, o, B, Sq, Skv, dk, scale, dp, nv, bn, stages, smem, s);
    return launch<false, 128, kWidth, kPost, 0, false>(
        q, k, v, o, B, Sq, Skv, dk, scale, dp, nv, bn, stages, smem, s);
  }
  if (dk > kCmRows || W != dk) return cudaErrorInvalidValue;
  if (dscore)
    return norm == kRounded && split == 1
               ? launch<true, 48, 64, kRounded, 0, true>(
                     q, k, v, o, B, Sq, Skv, dk, scale, dp, nv, bn, stages,
                     smem, s)
               : cudaErrorInvalidValue;
  return dk <= 40 ? launch_cm<40>(norm, split, q, k, v, o, B, Sq, Skv, dk,
                                  scale, dp, nv, bn, stages, smem, s)
                  : launch_cm<48>(norm, split, q, k, v, o, B, Sq, Skv, dk,
                                  scale, dp, nv, bn, stages, smem, s);
}
