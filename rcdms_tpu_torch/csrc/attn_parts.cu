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
// What bounds them on the H100: F and G are 107 GFLOP of bf16 products at
// dh 40 (0.11 ms at 989 TFLOP/s; 343 GFLOP, 0.35 ms, at width 128); their
// (B, Sq, 128) fp32 outputs are 168 MB (0.05 ms at 3.35 TB/s); the input P
// of G and H is 335 MB (0.10 ms) and the 8 cells of a batch row read the
// same 4 MB block. H's exp rows are 1.342 G exponentials, every cell's
// (0.32 ms at 4.18 T a second on MUFU.EX2: 16 an SM a clock, 132 SMs,
// 1980 MHz); its reduce_only row is bytes, P once and the output (0.15
// ms). An SM issues 128 lane operations a clock, so the MUFU binds only
// where an element costs at most 8 instructions in all.
//
// F and G are TMA + wgmma kernels. A block owns 128 rows: two consumer
// warpgroups of 64 rows, each one m64 fp32 accumulator tile in registers,
// and one producer warp that keeps a ring of TMA tiles (128-byte swizzle)
// in flight on mbarriers. ops/smallk.py::_scores_plan / _pv_plan fix the
// ring's stages and the shared memory; the C entries refuse a plan that
// differs from the kernel's layout, and set the kernels' shared-memory
// attribute once a process.
//   F: the reduction over key groups is the product's own K loop: out[r, j]
//      = sum over (g, d) of q[r, d] k[128 g + j, d], so the groups of a row
//      add into one 64 x 128 accumulator as one chain of m64n128k16, and S
//      never exists. Q's tile is loaded once; a ring stage is one key group.
//      dh is padded with zeros to a multiple of 16: the tensor maps are 3-D
//      (B, dh, S), so a channel-major box's rows past dh lie outside the
//      tensor, where TMA reads zeros (not the next batch row's channels).
//   G: o = P v in k16 steps over the keys, n = 128 (tm128) or 40 / 48 (dh
//      <= 40 / 48; V's columns or rows past dh read zero, as in F).
//      Generated P goes to the tensor cores from registers, in wgmma's
//      A-fragment layout (the RS form): a block first tabulates the 117
//      values bf16(x * seed) as bf16 pairs (each the plain version's fp32
//      product rounded to bf16 once), then each thread walks the index
//      x = (7 r + c) mod 117 of its two rows 64 columns a stage (an add and
//      a conditional subtract) and reads its 16 fragment registers of the
//      stage's 4 k16 steps from the table; the 4 products go out as one
//      group. Input P arrives in the ring beside V, as K-major [64 rows][64
//      keys] tiles; the cells of a batch row run next to each other (grid x
//      fastest), so its 4 MB P block is read from L2. Every cell is
//      computed: P is neither presummed nor copied across cells.
//   Both stage their accumulators through shared memory (the ring, once
//   every product is done) and write whole 512-byte output rows, zeros
//   past n, with streaming stores.
// H: a block owns local rows of one batch row for up to 8 cells at once,
// a warp a (cell, row). Each P row is read once a block (one 1-D TMA bulk
// copy into a double-buffered row of shared memory) or generated once (a
// table of the seed's 117 products and an incremental index, no `%` an
// element), and each warp makes its own two passes over it: the max on
// bf16 pairs (__hmax2, two elements an instruction), then one FFMA and one
// MUFU.EX2 an element, 8 sums a lane, l at the end from the lanes' sums.
// ops/smallk.py::_softmax_plan fixes the cells and rows a block and the
// shared memory, and refuses a row that does not fit it.
#include "common.cuh"
#include "wgmma.cuh"

namespace rcdms {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 128;    // the lane-group width of the reductions
constexpr int kSeedStride = 8 * 128;  // seeds are (B, 8, 128): [b, 0, 0]

// ---- F and G: the tile kernels' shared parts ------------------------------

constexpr int kTileThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kTileRows = 128;     // rows a block, 64 a consumer warpgroup
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;   // shared memory a block may take

// The epilogue stages each consumer warp's 16 rows x N fp32 at a row
// stride of S floats, S mod 32 = 8 or 24, so that the float2 stores of the
// accumulator layout fall in 32 banks a half warp.
template <int N>
struct Staging {
  static constexpr int S = (N % 32 == 8 || N % 32 == 24) ? N : N + 8;
  static constexpr int BYTES = 8 * 16 * S * 4;
};

// Shared memory of a tile kernel, from its 1024-byte aligned start: `fixed`
// bytes (F's Q tiles) and the ring of `stages` x `stage` bytes, both under
// the epilogue's staging; then the full and empty mbarriers of each stage
// and one for Q; plus 1024 bytes to align. Must agree with
// ops/smallk.py::_tile_smem.
__host__ __device__ constexpr int tile_data(int fixed, int stage, int stages,
                                            int staging) {
  return fixed + stages * stage > staging ? fixed + stages * stage : staging;
}
__host__ __device__ constexpr int tile_bytes(int fixed, int stage, int stages,
                                             int staging) {
  return 1024 + tile_data(fixed, stage, stages, staging) +
         8 * (2 * stages + 1);
}

__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(empty + 8 * stages, 1);  // F's Q
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Every consumer warp's products are done: the ring may stage the output.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Write a consumer warp's 16 rows of N accumulator columns (the m64
// layout's rows 16 w ..., wgmma.cuh) to out_rows[r * 128 + c], zeros at
// columns N ... 127, through `stage`, this warp's Staging<N> slice: float2
// stores in the accumulator layout, then one 512-byte output row a warp
// store (float4 a lane, streaming past L2's kept inputs).
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           float* stage, float* out_rows,
                                           int lane) {
  constexpr int S = Staging<N>::S;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    *reinterpret_cast<float2*>(stage + g * S + 8 * i + 2 * t) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(stage + (g + 8) * S + 8 * i + 2 * t) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncwarp();
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * lane < N)
      v = *reinterpret_cast<const float4*>(stage + r * S + 4 * lane);
    __stcs(reinterpret_cast<float4*>(out_rows + r * kGroup + 4 * lane), v);
  }
}

// ---- F: scores, reduced over the key groups ------------------------------

// CM: q (B, dh, Sq), k (B, dh, Skv), dh taken in KC k16 steps (zeros past
// dh); else q (B, Sq, 128), k (B, Skv, 128), KC = 8. A consumer
// warpgroup's Q tile: CM one box [16 KC d][64 r] (MN-major A), else two
// boxes [64 r][64 d] (K-major A, d 0-63 then 64-127). A ring stage, one
// key group, is two boxes: CM [16 KC d][64 j] (MN-major B; the second
// box, j 64-127, one K_BOX on: the descriptor's leading byte offset),
// else [128 j][64 d] (K-major B).
template <bool CM, int KC>
struct ScoreTiles {
  static constexpr int Q_WG = CM ? 16 * KC * 128 : 2 * 64 * 128;
  static constexpr int Q_BYTES = 2 * Q_WG;
  static constexpr int K_BOX = CM ? 16 * KC * 128 : kGroup * 128;
  static constexpr int STAGE = 2 * K_BOX;
  static_assert(CM ? KC >= 1 && KC <= 3 : KC == 8, "dh <= 48 or 128");
};

// One block: rows [r0, r0 + 128) of batch row b. Warps 0-7 are the
// consumer warpgroups (rows r0 + 64 wg ...), warp 8 the producer.
template <bool CM, int KC>
__global__ void __launch_bounds__(kTileThreads, 2)
    attn_scores_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       float* __restrict__ out, int Sq, int Skv,
                       int stages) {
  using T = ScoreTiles<CM, KC>;
  extern __shared__ unsigned char tile_smem[];
  const uint32_t raw = smem_addr(tile_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + T::Q_BYTES;
  const uint32_t full =
      base + tile_data(T::Q_BYTES, T::STAGE, stages, Staging<kGroup>::BYTES);
  const uint32_t empty = full + 8 * stages;
  const uint32_t qbar = empty + 8 * stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, r0 = blockIdx.x * kTileRows;
  const int groups = Skv / kGroup;
  init_ring(full, empty, stages);

  if (warp == 8) {  // ---- producer ---------------------------------------
    if (lane == 0) {
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int wg = 0; wg < 2; ++wg) {
        if constexpr (CM) {
          tma_load_3d(base + wg * T::Q_WG, &qmap, r0 + 64 * wg, 0, b, qbar);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load_3d(base + wg * T::Q_WG + h * 64 * 128, &qmap, 64 * h,
                        r0 + 64 * wg, b, qbar);
        }
      }
      for (int g = 0; g < groups; ++g) {
        const int s = g % stages;
        mbar_wait(empty + 8 * s, ((g / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, T::STAGE);
        const uint32_t st = ring + s * T::STAGE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (CM)
            tma_load_3d(st + h * T::K_BOX, &kmap, kGroup * g + 64 * h, 0, b,
                        full + 8 * s);
          else
            tma_load_3d(st + h * T::K_BOX, &kmap, 64 * h, kGroup * g, b,
                        full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumers: one chain of m64n128k16 over (group, k16 of dh) --------
  const int wg = warp / 4;
  const uint32_t qa = base + wg * T::Q_WG;
  float acc[kGroup / 2];
#pragma unroll
  for (int i = 0; i < kGroup / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int g = 0; g < groups; ++g) {
    const int s = g % stages;
    mbar_wait(full + 8 * s, (g / stages) & 1);
    const uint32_t st = ring + s * T::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if constexpr (CM)  // a k16 step: 16 rows of 128 bytes on
        wgmma<kGroup, 1, 1>(acc, sw128_mn_desc(qa + 2048 * kc),
                            sw128_mn_desc(st + 2048 * kc, T::K_BOX));
      else  // a k16 step: 32 bytes along the row, a box every 64 columns
        wgmma<kGroup, 0, 0>(
            acc, sw128_desc(qa + 64 * 128 * (kc / 4)) + 2 * (kc % 4),
            sw128_desc(st + T::K_BOX * (kc / 4)) + 2 * (kc % 4));
    }
    wgmma_commit();
    if (g > 0) {  // the previous group's products are done: free its stage
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % stages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  consumers_sync();
  float* stage = reinterpret_cast<float*>(tile_smem + (base - raw)) +
                 warp * 16 * Staging<kGroup>::S;
  store_rows<kGroup>(acc, stage,
                     out + ((long)b * Sq + r0 + 16 * warp) * kGroup, lane);
}

// ---- G: P V --------------------------------------------------------------

enum VLayout : int { kTm128 = 0, kTm40 = 1, kCm40 = 2 };
constexpr int kPvKeys = 64;  // keys a ring stage: four k16 steps

// Generated P's table, ahead of the ring: kPairs bf16 pairs (P(x mod 117),
// P(x + 1 mod 117)), P(x) = bf16(x * seed), so that a stage reads columns
// c + 16 k, c + 16 k + 1 and c + 16 k + 8, + 9 (k < 4) at x + 16 k and
// x + 16 k + 8 without a wrap between them.
constexpr int kPairs = 117 + 48 + 8;
constexpr int kTableBytes = 1024;  // kPairs * 4, the ring kept 1024-aligned

// A ring stage: input P's two boxes [64 rows][64 keys] (K-major A, one a
// consumer warpgroup; none for generated P), then V: tm128 two boxes [64
// keys][64 n] (MN-major B, the second V_BOX on), tm40 one [64 keys][64 n]
// (n past dh outside the tensor: zeros), cm40 one [N d][64 keys] (K-major
// B, rows past dh zeros).
template <int VL, int N, bool GEN>
struct PvTiles {
  static constexpr int FIXED = GEN ? kTableBytes : 0;
  static constexpr int P_BYTES = GEN ? 0 : 2 * 64 * 128;
  static constexpr int V_BOX =
      VL == kCm40 ? (N * 128 + 1023) / 1024 * 1024 : kPvKeys * 128;
  static constexpr int STAGE = P_BYTES + (VL == kTm128 ? 2 : 1) * V_BOX;
  static constexpr int TB = VL == kCm40 ? 0 : 1;
  static_assert(VL == kTm128 ? N == 128 : N == 40 || N == 48, "n");
};

// V's descriptor at k16 step kk of the stage whose V starts at sv.
template <int VL, int V_BOX>
__device__ __forceinline__ uint64_t v_desc(uint32_t sv, int kk) {
  if constexpr (VL == kCm40) return sw128_desc(sv) + 2 * kk;
  return sw128_mn_desc(sv + 2048 * kk, V_BOX);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// One block: rows [r0, r0 + 128) of batch row b, inside one cell (blk a
// multiple of 128). Warps 0-7 are the consumer warpgroups, warp 8 the
// producer. pmap: input P (B, blk, Skv); vmap: V in its layout. At n128
// the 64 accumulators and two banks of generated fragments need more than
// the 112 registers of two blocks an SM (ptxas spilled there).
template <int VL, int N, bool GEN>
__global__ void __launch_bounds__(kTileThreads, N <= 48 ? 2 : 1)
    attn_pv_kernel(const __grid_constant__ CUtensorMap pmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const bf16* __restrict__ seeds, float* __restrict__ out,
                   int Sq, int Skv, int blk, int stages) {
  using T = PvTiles<VL, N, GEN>;
  extern __shared__ unsigned char tile_smem[];
  const uint32_t raw = smem_addr(tile_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + T::FIXED;
  const uint32_t full =
      base + tile_data(T::FIXED, T::STAGE, stages, Staging<N>::BYTES);
  const uint32_t empty = full + 8 * stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, r0 = blockIdx.x * kTileRows;
  const int local0 = r0 % blk;  // the block's first row within its cell
  const int steps = Skv / kPvKeys;
  uint32_t* table = reinterpret_cast<uint32_t*>(tile_smem + (base - raw));
  if (GEN && threadIdx.x < kPairs) {  // published by init_ring's barrier
    const float seed = __bfloat162float(seeds[(long)b * kSeedStride]);
    const int x = threadIdx.x % 117, y = (threadIdx.x + 1) % 117;
    table[threadIdx.x] = as_u32(__floats2bfloat162_rn(
        static_cast<float>(x) * seed, static_cast<float>(y) * seed));
  }
  init_ring(full, empty, stages);

  if (warp == 8) {  // ---- producer ---------------------------------------
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        mbar_wait(empty + 8 * s, ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, T::STAGE);
        const uint32_t st = ring + s * T::STAGE, sv = st + T::P_BYTES;
        if constexpr (!GEN) {
#pragma unroll
          for (int wg = 0; wg < 2; ++wg)
            tma_load_3d(st + wg * 64 * 128, &pmap, kPvKeys * i,
                        local0 + 64 * wg, b, full + 8 * s);
        }
        if constexpr (VL == kCm40) {
          tma_load_3d(sv, &vmap, kPvKeys * i, 0, b, full + 8 * s);
        } else {
          tma_load_3d(sv, &vmap, 0, kPvKeys * i, b, full + 8 * s);
          if constexpr (VL == kTm128)
            tma_load_3d(sv + T::V_BOX, &vmap, 64, kPvKeys * i, b,
                        full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if constexpr (GEN) {
    // This thread's A fragments of a stage: rows r, r + 8 of its cell,
    // columns 2t, 2t+1 and 2t+8, 2t+9 of each of the 4 k16 steps
    // (wgmma.cuh's RS layout), read from the table at x + 16 k and x + 16 k
    // + 8, x = (7 r + c) mod 117 at the stage's first column; then x walks
    // 64 columns: an add and a conditional subtract. The stage's 4 products
    // go out as one group; two fragment banks alternate, so a bank is
    // written only once the group two stages back, which read it, is done.
    const int g = lane / 4, t = lane % 4;
    const int r = local0 + 16 * warp + g;
    int x[2] = {(7 * r + 2 * t) % 117, (7 * (r + 8) + 2 * t) % 117};
    uint32_t frag[2][kPvKeys / 16][4];
    auto run_stage = [&](int i, uint32_t(&f)[kPvKeys / 16][4]) {
      const int s = i % stages;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r (f[k][0], f[k][2]), r + 8
#pragma unroll
        for (int k = 0; k < kPvKeys / 16; ++k) {
          f[k][h] = table[x[h] + 16 * k];
          f[k][h + 2] = table[x[h] + 16 * k + 8];
        }
        x[h] += kPvKeys;
        if (x[h] >= 117) x[h] -= 117;
      }
      const uint32_t sv = ring + s * T::STAGE;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kPvKeys / 16; ++k)
        wgmma_rs<N, T::TB>(acc, f[k], v_desc<VL, T::V_BOX>(sv, k));
      wgmma_commit();
      if (i > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
      }
    };
    int i = 0;
    for (; i + 1 < steps; i += 2) {
      run_stage(i, frag[0]);
      run_stage(i + 1, frag[1]);
    }
    if (i < steps) run_stage(i, frag[0]);
  } else {
    for (int i = 0; i < steps; ++i) {
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      const uint32_t st = ring + s * T::STAGE;
      const uint64_t pa = sw128_desc(st + warp / 4 * 64 * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPvKeys / 16; ++kk)
        wgmma<N, 0, T::TB>(acc, pa + 2 * kk,
                           v_desc<VL, T::V_BOX>(st + T::P_BYTES, kk));
      wgmma_commit();
      if (i > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  consumers_sync();
  float* stage = reinterpret_cast<float*>(table) + warp * 16 * Staging<N>::S;
  store_rows<N>(acc, stage, out + ((long)b * Sq + r0 + 16 * warp) * kGroup,
                lane);
}

// ---- H: softmax, reduced over the key groups -----------------------------

enum SoftmaxOp : int { kExp = 0, kExp2 = 1, kSumOnly = 2 };
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowWarps = 8;     // warps an H block at most
constexpr int kGenPairs = 123;   // pairs (x, x + 1) of the table, x < 117 + 6
constexpr int kGenTable = 512;   // the table's bytes
static_assert(kGroup == 32 * 4, "a lane writes 4 of a row's 128 sums");

// H's shared memory: `stages` rows of Skv bf16 (16-byte aligned at the
// start), then generated P's pair table, or input P's full and empty
// mbarriers of each row buffer. Must agree with
// ops/smallk.py::_softmax_smem.
__host__ __device__ constexpr long softmax_bytes(bool gen, int stages,
                                                 int skv) {
  return 2L * stages * skv + (gen ? kGenTable : 16 * stages);
}

// 2^x on the MUFU alone: .ftz keeps ptxas from wrapping it in the scaling
// of the denormal range (an e below 2^-126 of the row's largest is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}

template <bool MIN>
__device__ __forceinline__ float warp_extreme(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MIN ? fminf(x, y) : fmaxf(x, y);
  }
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A warp's pass over a row in shared memory, `pairs` pairs of key groups
// and an odd last group: each lane takes 16 bytes (8 bf16) a pair, lanes
// 0-15 from group 2k and lanes 16-31 from group 2k + 1, so a lane's 8
// columns are 8 (lane % 16) ... + 7 of every group it reads; the odd group
// goes to lanes 0-15.
template <typename Take>
__device__ __forceinline__ void row_pass(const uint4* row, int pairs,
                                         bool odd, int lane, Take take) {
#pragma unroll 4
  for (int k = 0; k < pairs; ++k) take(row[32 * k + lane]);
  if (odd && lane < 16) take(row[32 * pairs + lane]);
}

// The row's largest bf16 (MIN: smallest), as a float: __hmax2 (__hmin2) on
// bf16 pairs, two elements an instruction, then across the warp.
template <bool MIN>
__device__ __forceinline__ float row_extreme(const uint4* row, int pairs,
                                             bool odd, int lane) {
  const uint32_t inf = MIN ? 0x7F807F80u : 0xFF80FF80u;  // +-inf pairs
  __nv_bfloat162 m0 = as_bf2(inf), m1 = m0;
  auto pick = [](__nv_bfloat162 a, uint32_t b) {
    return MIN ? __hmin2(a, as_bf2(b)) : __hmax2(a, as_bf2(b));
  };
  row_pass(row, pairs, odd, lane, [&](uint4 v) {
    m0 = pick(m0, v.x);
    m1 = pick(m1, v.y);
    m0 = pick(m0, v.z);
    m1 = pick(m1, v.w);
  });
  m0 = pick(m0, as_u32(m1));
  const float lo = __low2float(m0), hi = __high2float(m0);
  return warp_extreme<MIN>(MIN ? fminf(lo, hi) : fmaxf(lo, hi));
}

// The lane's 8 column sums over the row's groups: of e = 2^(x a + mb), one
// FFMA and one MUFU.EX2 an element, or (SUM) of x itself. A bf16 pair
// unpacks to two floats by a shift and a mask.
template <bool SUM>
__device__ __forceinline__ void row_sums(float (&acc)[8], const uint4* row,
                                         int pairs, bool odd, int lane,
                                         float a, float mb) {
  row_pass(row, pairs, odd, lane, [&](uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(w[i] << 16);
      const float hi = __uint_as_float(w[i] & 0xFFFF0000u);
      if constexpr (SUM) {
        acc[2 * i] += lo;
        acc[2 * i + 1] += hi;
      } else {
        acc[2 * i] += ex2(fmaf(lo, a, mb));
        acc[2 * i + 1] += ex2(fmaf(hi, a, mb));
      }
    }
  });
}

// One block: `rows` consecutive local rows of batch row b = blockIdx.z
// from blockIdx.x * rows on (none past blk), for the cpb cells of cell
// group blockIdx.y: warp w computes cell blockIdx.y * cpb + w (none past
// `cells`). The rows go one after the other through `stages` (2, or 1
// where two rows do not fit) row buffers. Each row is read (one 1-D TMA
// bulk copy on the buffer's full mbarrier, issued by thread 0, which
// reuses a buffer once its empty mbarrier has every warp's arrival) or
// generated (by the block's threads, then __syncthreads) once, and every
// warp makes its own pass over it: its max (min for a negative scale) on
// bf16 pairs, then e = 2^(x a - m a), a = scale log2 e, for exp and exp2
// alike, summed a lane, then l over the warp at the end. Every (batch,
// cell, row) is one warp's: nothing is shared across cells but the row in
// shared memory.
template <bool SUM, bool GEN>
__global__ void __launch_bounds__(kRowWarps * 32, 4)
    attn_softmax_kernel(const bf16* __restrict__ seeds,
                        const bf16* __restrict__ p, float* __restrict__ out,
                        int cells, int Skv, int blk, int rows, int stages,
                        float scale) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cell = blockIdx.y * (blockDim.x / 32) + warp, b = blockIdx.z;
  const int first = blockIdx.x * rows;
  const int n = min(rows, blk - first);  // the block's rows
  const int chunks = Skv / 8;            // 16-byte chunks a row
  uint4* ring = reinterpret_cast<uint4*>(row_smem);
  unsigned char* tail = row_smem + 2L * stages * Skv;
  const uint32_t full = smem_addr(tail), empty = full + 8 * stages;
  uint32_t* table = reinterpret_cast<uint32_t*>(tail);
  if constexpr (GEN) {  // pairs (P(x mod 117), P(x + 1 mod 117))
    const float seed = __bfloat162float(seeds[(long)b * kSeedStride]);
    for (int k = threadIdx.x; k < kGenPairs; k += blockDim.x)
      table[k] = as_u32(__floats2bfloat162_rn(
          static_cast<float>(k % 117) * seed,
          static_cast<float>((k + 1) % 117) * seed));
  } else if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int groups = Skv / kGroup, pairs = groups / 2;
  const bool odd = groups % 2;
  const float a = scale * kLog2e;
  auto compute = [&](const uint4* row, int local) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float inv = 1.f;
    if constexpr (SUM) {
      row_sums<true>(acc, row, pairs, odd, lane, 0.f, 0.f);
    } else {
      const float m = scale < 0.f ? row_extreme<true>(row, pairs, odd, lane)
                                  : row_extreme<false>(row, pairs, odd, lane);
      row_sums<false>(acc, row, pairs, odd, lane, a, -m * a);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) l += acc[i];
      inv = 1.f / warp_sum(l);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    // lane l < 16 writes columns 8 l ... + 3 (float4 2 l), lane l + 16
    // the next 4 (float4 2 l + 1)
    const bool hi = lane >= 16;
    const float4 o = make_float4(
        (hi ? acc[4] : acc[0]) * inv, (hi ? acc[5] : acc[1]) * inv,
        (hi ? acc[6] : acc[2]) * inv, (hi ? acc[7] : acc[3]) * inv);
    __stcs(reinterpret_cast<float4*>(
               out + (((long)b * cells + cell) * blk + local) * kGroup) +
               2 * (lane % 16) + hi,
           o);
  };

  if constexpr (GEN) {
    // Generated P: chunk j (columns 8 j ... + 7) of local row r holds the
    // table's pairs x, x + 2, x + 4, x + 6, x = (7 r + 8 j) mod 117. Thread
    // t takes chunks t, t + threads, ...: x walks 8 * threads mod 117 a
    // chunk and 7 a row, each with one conditional subtract.
    const int step = 8 * blockDim.x % 117;
    int xr = (7 * first + 8 * threadIdx.x) % 117;
    for (int i = 0; i < n; ++i) {
      uint4* buf = ring + (i % stages) * chunks;
      int x = xr;
      for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
        buf[j] = make_uint4(table[x], table[x + 2], table[x + 4],
                            table[x + 6]);
        x += step;
        if (x >= 117) x -= 117;
      }
      xr += 7;
      if (xr >= 117) xr -= 117;
      __syncthreads();
      if (cell < cells) compute(buf, first + i);
      if (stages == 1) __syncthreads();  // before the next write
    }
  } else {
    const bool producer = threadIdx.x == 0;
    auto issue = [&](int i) {  // row i of the block into buffer i % stages
      const int s = i % stages;
      mbar_expect_tx(full + 8 * s, 2 * Skv);
      bulk_load(smem_addr(ring + s * chunks),
                p + ((long)b * blk + first + i) * Skv, 2 * Skv, full + 8 * s);
    };
    if (producer)
      for (int i = 0; i < min(stages, n); ++i) issue(i);
    for (int i = 0; i < n; ++i) {
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      if (cell < cells) compute(ring + s * chunks, first + i);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (producer && i + stages < n) {
        mbar_wait(empty + 8 * s, (i / stages) & 1);
        issue(i + stages);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A bf16 map of a (B, rows, cols) tensor, cols innermost, in boxes of
// box_cols x box_rows x 1.
cudaError_t map_3d(CUtensorMap* map, const void* ptr, int B, int rows,
                   int cols, int box_cols, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)cols * 2,
                               (uint64_t)cols * rows * 2};
  const uint32_t box[3] = {(uint32_t)box_cols, (uint32_t)box_rows, 1};
  return make_bf16_map(map, ptr, 3, dims, strides, box);
}

template <bool CM, int KC>
cudaError_t launch_scores(const void* q, const void* k, float* out, int B,
                          int Sq, int Skv, int dk, int stages, int smem,
                          cudaStream_t s) {
  using T = ScoreTiles<CM, KC>;
  if (smem != tile_bytes(T::Q_BYTES, T::STAGE, stages,
                         Staging<kGroup>::BYTES))
    return cudaErrorInvalidValue;
  static const cudaError_t ready =
      allow_smem(attn_scores_kernel<CM, KC>, kSmemMax);  // once a process
  if (ready != cudaSuccess) return ready;
  CUtensorMap qmap, kmap;
  cudaError_t err =
      CM ? map_3d(&qmap, q, B, dk, Sq, 64, 16 * KC)
         : map_3d(&qmap, q, B, Sq, dk, 64, 64);
  if (err == cudaSuccess)
    err = CM ? map_3d(&kmap, k, B, dk, Skv, 64, 16 * KC)
             : map_3d(&kmap, k, B, Skv, dk, 64, kGroup);
  if (err != cudaSuccess) return err;
  attn_scores_kernel<CM, KC>
      <<<dim3(Sq / kTileRows, B), kTileThreads, smem, s>>>(qmap, kmap, out,
                                                           Sq, Skv, stages);
  return cudaGetLastError();
}

template <int VL, int N, bool GEN>
cudaError_t launch_pv(const void* seeds, const void* p, const void* v,
                      float* out, int B, int Sq, int Skv, int blk, int dh,
                      int stages, int smem, cudaStream_t s) {
  using T = PvTiles<VL, N, GEN>;
  if (smem != tile_bytes(T::FIXED, T::STAGE, stages, Staging<N>::BYTES))
    return cudaErrorInvalidValue;
  static const cudaError_t ready =
      allow_smem(attn_pv_kernel<VL, N, GEN>, kSmemMax);  // once a process
  if (ready != cudaSuccess) return ready;
  CUtensorMap pmap = {}, vmap;
  cudaError_t err = GEN ? cudaSuccess
                        : map_3d(&pmap, p, B, blk, Skv, kPvKeys, 64);
  if (err == cudaSuccess)
    err = VL == kCm40 ? map_3d(&vmap, v, B, dh, Skv, kPvKeys, N)
                      : map_3d(&vmap, v, B, Skv, dh, 64, kPvKeys);
  if (err != cudaSuccess) return err;
  attn_pv_kernel<VL, N, GEN><<<dim3(Sq / kTileRows, B), kTileThreads, smem,
                               s>>>(pmap, vmap,
                                    static_cast<const bf16*>(seeds), out, Sq,
                                    Skv, blk, stages);
  return cudaGetLastError();
}

template <int VL, int N>
cudaError_t pv_by_source(const void* seeds, const void* p, const void* v,
                         float* out, int B, int Sq, int Skv, int blk, int dh,
                         int stages, int smem, cudaStream_t s) {
  if (p == nullptr)
    return launch_pv<VL, N, true>(seeds, p, v, out, B, Sq, Skv, blk, dh,
                                  stages, smem, s);
  return launch_pv<VL, N, false>(seeds, p, v, out, B, Sq, Skv, blk, dh,
                                 stages, smem, s);
}

template <bool SUM, bool GEN>
cudaError_t launch_softmax(dim3 grid, int threads, int smem, cudaStream_t s,
                           const void* seeds, const void* p, float* out,
                           int cells, int Skv, int blk, int rows,
                           int stages, float scale) {
  static const cudaError_t ready =
      allow_smem(attn_softmax_kernel<SUM, GEN>, kSmemMax);  // once a process
  if (ready != cudaSuccess) return ready;
  attn_softmax_kernel<SUM, GEN><<<grid, threads, smem, s>>>(
      static_cast<const bf16*>(seeds), static_cast<const bf16*>(p), out,
      cells, Skv, blk, rows, stages, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rcdms

// F. cm = 1: q (B, dk, Sq), k (B, dk, Skv), dk <= 48 a multiple of 8,
// taken in kp = dk rounded up to 16; cm = 0: q (B, Sq, dk), k (B, Skv,
// dk), dk = kp = 128. out (B, Sq, 128) fp32. Sq a multiple of 128, Skv of
// 128; bf16, contiguous, 16-byte aligned. stages and smem: the plan of
// ops/smallk.py::_scores_plan, which must be the kernel's layout.
extern "C" int rcdms_attn_scores(int cm, int kp, int stages, int smem,
                                 const void* q, const void* k, void* out,
                                 int B, int Sq, int Skv, int dk,
                                 void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq % kTileRows || Skv % kGroup ||
      dk <= 0 || dk % 8 || stages < 2 || stages > kMaxStages ||
      !aligned16(q) || !aligned16(k) || !aligned16(out))
    return cudaErrorInvalidValue;
  auto* o = static_cast<float*>(out);
  if (!cm)
    return dk == kGroup && kp == kGroup
               ? launch_scores<false, 8>(q, k, o, B, Sq, Skv, dk, stages,
                                         smem, s)
               : cudaErrorInvalidValue;
  if (dk > 48 || kp != (dk + 15) / 16 * 16) return cudaErrorInvalidValue;
  switch (kp / 16) {
    case 1:
      return launch_scores<true, 1>(q, k, o, B, Sq, Skv, dk, stages, smem, s);
    case 2:
      return launch_scores<true, 2>(q, k, o, B, Sq, Skv, dk, stages, smem, s);
    default:
      return launch_scores<true, 3>(q, k, o, B, Sq, Skv, dk, stages, smem, s);
  }
}

// G. p == nullptr: P generated from seeds (B, 8, 128); else p
// (B, blk, Skv). vlayout kTm128: v (B, Skv, 128), n = 128; kTm40: v
// (B, Skv, dh); kCm40: v (B, dh, Skv); dh <= 48 a multiple of 8, n = 40
// (dh <= 40) or 48. out (B, Sq, 128) fp32, zero past dh. blk and Sq
// multiples of 128, Sq of blk, Skv of 64; v, p and out 16-byte aligned.
// stages and smem: the plan of ops/smallk.py::_pv_plan, which must be the
// kernel's layout.
extern "C" int rcdms_attn_pv(int vlayout, int n, int stages, int smem,
                             const void* seeds, const void* p,
                             const void* v, void* out, int B, int Sq,
                             int Skv, int blk, int dh, void* stream) {
  using namespace rcdms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || blk <= 0 || blk % kTileRows ||
      Sq % blk || Skv % kPvKeys || stages < 2 || stages > kMaxStages ||
      (p == nullptr && seeds == nullptr) || !aligned16(v) ||
      !aligned16(out) || (p != nullptr && !aligned16(p)))
    return cudaErrorInvalidValue;
  auto* o = static_cast<float*>(out);
  if (vlayout == kTm128)
    return n == 128 && dh == 128
               ? pv_by_source<kTm128, 128>(seeds, p, v, o, B, Sq, Skv, blk,
                                           dh, stages, smem, s)
               : cudaErrorInvalidValue;
  if ((vlayout != kTm40 && vlayout != kCm40) || dh <= 0 || dh > 48 ||
      dh % 8 || n != (dh <= 40 ? 40 : 48))
    return cudaErrorInvalidValue;
#define RCDMS_PV(VL, N)                                                     \
  return pv_by_source<VL, N>(seeds, p, v, o, B, Sq, Skv, blk, dh, stages,   \
                             smem, s)
  if (vlayout == kTm40) {
    if (n == 40) RCDMS_PV(kTm40, 40);
    RCDMS_PV(kTm40, 48);
  }
  if (n == 40) RCDMS_PV(kCm40, 40);
  RCDMS_PV(kCm40, 48);
#undef RCDMS_PV
}

// H. p == nullptr: P generated from seeds (B, 8, 128); else p (B, blk,
// Skv), 16-byte aligned. op kExp / kExp2: the softmax of P * scale,
// reduced; kSumOnly: the reduced sums of P. out (B, cells * blk, 128)
// fp32, 16-byte aligned. Skv a multiple of 128. cpb, rows, stages and
// smem: the plan of ops/smallk.py::_softmax_plan, which must be the
// kernel's layout.
extern "C" int rcdms_attn_softmax(int op, int cpb, int rows, int stages,
                                  int smem, const void* seeds, const void* p,
                                  void* out, int B, int cells, int Skv,
                                  int blk, float scale, void* stream) {
  using namespace rcdms;
  const bool gen = p == nullptr;
  if (B <= 0 || B > 65535 || cells <= 0 || Skv <= 0 || Skv % kGroup ||
      blk <= 0 || cpb < 1 || cpb > kRowWarps || rows < 1 || stages < 1 ||
      stages > 2 || (cells + cpb - 1) / cpb > 65535 || smem > kSmemMax ||
      smem != softmax_bytes(gen, stages, Skv) ||
      (gen && seeds == nullptr) || (!gen && !aligned16(p)) ||
      !aligned16(out) || (op != kExp && op != kExp2 && op != kSumOnly))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((blk + rows - 1) / rows),
                  static_cast<unsigned>((cells + cpb - 1) / cpb),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
#define RCDMS_SM(SUM, GEN)                                                \
  return launch_softmax<SUM, GEN>(grid, 32 * cpb, smem, s, seeds, p, o,   \
                                  cells, Skv, blk, rows, stages, scale)
  if (op == kSumOnly) {
    if (gen) RCDMS_SM(true, true);
    RCDMS_SM(true, false);
  }
  if (gen) RCDMS_SM(false, true);
  RCDMS_SM(false, false);
#undef RCDMS_SM
}
