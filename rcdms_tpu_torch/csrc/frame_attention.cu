// Kernel B: temporal (frame-axis) attention on the model's (b, f, n, c)
// layout. At every token n and head, the f <= 8 frames attend to each
// other: s_ij = q_i . k_j * scale over the head's dh channels, a softmax
// over j, and out_i = sum_j p_ij v_j.
//
// Replaces rcdms_tpu/ops/frame_attention.py::_kernel_bfnc. The TPU kernel
// turned the per-head dot products into lane-dense elementwise products
// plus a skinny head-segment matmul, with the channel axis padded to 128
// lanes (the `c_pad` contract). None of that is needed here: c is read as
// it is. Rounding follows the TPU kernel's (:82-103): in bf16 the scale,
// q_i * scale and every per-channel product (q_i * scale) * k_j are
// rounded to bf16 and a head's products summed in fp32; the softmax
// (max, exp, sum, reciprocal) and P.V are fp32, and the output is rounded
// once. fp32 takes fp32 products and applies the scale to the sums.
//
// What bounds it on the H100: device memory. Per token it reads 3 f c
// values and writes f c, about one flop a byte. Two kernels:
//   * tiled (bf16, dh a multiple of 8, 16-byte aligned operands: every
//     site of the main path), with the launch plan of
//     ops/frame_attention.py::_plan. A persistent grid; each block walks
//     over tiles of `tokens` whole token rows (or one token and `group`
//     heads), whose rows in each frame are contiguous. One thread issues
//     3 f 1-D TMA bulk copies a tile (cp.async.bulk, completing on an
//     mbarrier) into a ring of two stages, so tile t + 1 loads while t
//     computes: every operand byte is read once, 16 bytes at a time,
//     with no thread spent on the copy. One thread for each (token, head,
//     query frame i) and channel slice (`split` threads share a head
//     wider than 40 channels, taking every split-th 16-byte chunk)
//     reduces its scores from shared memory with no shuffle: 16-byte
//     loads, bf16x2 products (__hmul2), fp32 sums; the f threads of a
//     (token, head) read the same k_j / v_j words, which broadcast. The
//     split threads add their partial scores through shared memory. The
//     output overwrites the thread's own q_i chunks, and one thread bulk
//     copies the tile's rows back to device memory.
//   * general (fp32, and bf16 shapes the tiled kernel does not take): one
//     warp a (batch, token, head), its lanes on consecutive channels,
//     scores reduced across the warp with shuffles.
// f is a template parameter, so the f x f score tile stays in registers.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace rcdms {
namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// the general kernel

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int b, int n, int c, int heads, float scale) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const int lane = threadIdx.x % 32;
  const long task = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= (long)b * n * heads) return;  // whole warp leaves together
  const int h = task % heads;
  const long bt = task / heads;
  const int t = bt % n;
  const long bi = bt / n;
  const int dh = c / heads;
  const long frame = (long)n * c;  // stride between frames
  const long base = (bi * F * n + t) * (long)c + (long)h * dh;
  const bf16 scale_bf = __float2bfloat16(scale);

  float s[F][F];
#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int j = 0; j < F; ++j) s[i][j] = 0.f;

  for (int d = lane; d < dh; d += 32) {
    if constexpr (kBf16) {  // q * scale and each product rounded to bf16
      bf16 qd[F], kd[F];
#pragma unroll
      for (int i = 0; i < F; ++i) {
        qd[i] = __hmul(q[base + i * frame + d], scale_bf);
        kd[i] = k[base + i * frame + d];
      }
#pragma unroll
      for (int i = 0; i < F; ++i)
#pragma unroll
        for (int j = 0; j < F; ++j)
          s[i][j] += __bfloat162float(__hmul(qd[i], kd[j]));
    } else {
      float qd[F], kd[F];
#pragma unroll
      for (int i = 0; i < F; ++i) {
        qd[i] = to_float(q[base + i * frame + d]);
        kd[i] = to_float(k[base + i * frame + d]);
      }
#pragma unroll
      for (int i = 0; i < F; ++i)
#pragma unroll
        for (int j = 0; j < F; ++j) s[i][j] += qd[i] * kd[j];
    }
  }

#pragma unroll
  for (int i = 0; i < F; ++i) {
#pragma unroll
    for (int j = 0; j < F; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
      if constexpr (!kBf16) s[i][j] *= scale;
    }
    float m = s[i][0];
#pragma unroll
    for (int j = 1; j < F; ++j) m = fmaxf(m, s[i][j]);
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      s[i][j] = expf(s[i][j] - m);
      denom += s[i][j];
    }
    const float inv = 1.f / denom;
#pragma unroll
    for (int j = 0; j < F; ++j) s[i][j] *= inv;
  }

  for (int d = lane; d < dh; d += 32) {
    float vd[F];
#pragma unroll
    for (int j = 0; j < F; ++j) vd[j] = to_float(v[base + j * frame + d]);
#pragma unroll
    for (int i = 0; i < F; ++i) {
      float out = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) out += s[i][j] * vd[j];
      o[base + i * frame + d] = from_float<T>(out);
    }
  }
}

template <typename T, int F>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int n, int c, int heads, float scale,
                   cudaStream_t stream) {
  const long tasks = (long)b * n * heads;
  const long blocks = (tasks + kWarps - 1) / kWarps;
  frame_attention_kernel<T, F><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), b, n, c, heads, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tiled bf16 kernel

constexpr int kTiledMaxThreads = 512;  // _plan's MAX_THREADS
constexpr int kStages = 2;             // _plan's STAGES

// The shared-memory layout of a plan (ops/frame_attention.py::_plan):
// kStages stages of [q, k, v][f] frame slots of `frame_stride` bytes, the
// partial scores of split threads (threads x f fp32), one mbarrier a stage.
struct TiledLayout {
  int width;         // channels of a tile row: group * dh
  int frame_stride;  // bytes of a frame slot
  int stage;         // bytes of a stage
  int partials;      // offset of the partial scores
  int bars;          // offset of the mbarriers
  int bytes;         // the whole
  int threads;
  __host__ __device__ TiledLayout(int f, int dh, int tokens, int group,
                                  int split) {
    width = group * dh;
    const int row = tokens * width * 2;
    frame_stride = (row + 127) / 128 * 128 + 16 * split % 128;
    stage = 3 * f * frame_stride;
    threads = tokens * group * f * split;
    partials = kStages * stage;
    bars = partials + (split > 1 ? threads * f * 4 : 0);
    bytes = bars + 8 * kStages;
  }
};

// 1-D TMA from shared memory back to device memory, in this thread's bulk
// group (the load is wgmma.cuh's bulk_load).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have read their shared memory
// (READ) or have completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// bf16x2 as two floats, added in order into acc
__device__ __forceinline__ void add_pair(float& acc, uint32_t x) {
  acc += __uint_as_float(x << 16);
  acc += __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

template <int F>
__global__ void __launch_bounds__(kTiledMaxThreads)
    frame_attention_tiled_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 bf16* __restrict__ o, int n, int c, int dh,
                                 int tokens, int group, int split, int tiles,
                                 float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  const TiledLayout L(F, dh, tokens, group, split);
  const int tid = threadIdx.x;
  const uint32_t base = smem_addr(fa_smem);
  const uint32_t bar0 = base + L.bars;
  float* partials = reinterpret_cast<float*>(fa_smem + L.partials);

  // this thread: token tl of the tile, head hl of its group, query frame i,
  // slice s of the head's 16-byte chunks
  const int s = tid % split;
  const int i = tid / split % F;
  const int hl = tid / (split * F) % group;
  const int tl = tid / (split * F * group);
  const int chunks = dh / 8;
  const int heads_groups = c / L.width;  // tiles a token row
  const int token_tiles = (n + tokens - 1) / tokens;
  // the element offset of each thread's head segment in a frame slot
  const int seg = tl * L.width + hl * dh;

  // tile -> batch, first token, head group; its rows in each frame are
  // contiguous: `rows` x `width` elements from element offset `off` of
  // frame 0 of (q, k, v), frame stride n c
  auto locate = [&](int tile, long& off, int& rows) {
    const int hg = tile % heads_groups;
    const int tt = tile / heads_groups % token_tiles;
    const int bi = tile / (heads_groups * token_tiles);
    const int t0 = tt * tokens;
    rows = min(tokens, n - t0);
    off = ((long)bi * F * n + t0) * c + (long)hg * L.width;
  };
  auto issue = [&](int tile, int stage) {
    long off;
    int rows;
    locate(tile, off, rows);
    const uint32_t bytes = rows * L.width * 2;
    const uint32_t bar = bar0 + 8 * stage;
    mbar_expect_tx(bar, 3 * F * bytes);
    const bf16* src[3] = {q, k, v};
#pragma unroll
    for (int op = 0; op < 3; ++op)
#pragma unroll
      for (int fr = 0; fr < F; ++fr)
        bulk_load(base + stage * L.stage + (op * F + fr) * L.frame_stride,
                  src[op] + off + (long)fr * n * c, bytes, bar);
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && blockIdx.x < tiles) issue(blockIdx.x, 0);

  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
  const uint32_t scale_bf = *reinterpret_cast<const uint32_t*>(&scale2);
  for (int it = 0;; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    if (tile >= tiles) break;
    const int stage = it & 1;
    if (tid == 0 && tile + (int)gridDim.x < tiles) {
      // the other stage held tile it - 1: its reads are done (the
      // barrier at the end of it - 1), its store must have read it
      bulk_wait_all<true>();
      issue(tile + gridDim.x, stage ^ 1);
    }
    mbar_wait(bar0 + 8 * stage, (it >> 1) & 1);

    unsigned char* sb = fa_smem + stage * L.stage;
    auto slot = [&](int op, int fr) {
      return reinterpret_cast<bf16*>(sb + (op * F + fr) * L.frame_stride) +
             seg;
    };
    bf16* qi = slot(0, i);

    float sc[F];
#pragma unroll
    for (int j = 0; j < F; ++j) sc[j] = 0.f;
    for (int ch = s; ch < chunks; ch += split) {
      uint4 qv = *reinterpret_cast<const uint4*>(qi + ch * 8);
      const uint32_t qs[4] = {hmul2(qv.x, scale_bf), hmul2(qv.y, scale_bf),
                              hmul2(qv.z, scale_bf), hmul2(qv.w, scale_bf)};
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const uint4 kv = *reinterpret_cast<const uint4*>(slot(1, j) + ch * 8);
        add_pair(sc[j], hmul2(qs[0], kv.x));
        add_pair(sc[j], hmul2(qs[1], kv.y));
        add_pair(sc[j], hmul2(qs[2], kv.z));
        add_pair(sc[j], hmul2(qs[3], kv.w));
      }
    }
    if (split > 1) {  // the split threads of a (token, head, i), one warp
#pragma unroll
      for (int j = 0; j < F; ++j) partials[j * L.threads + tid] = sc[j];
      __syncwarp();
      const int first = tid - s;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        float sum = 0.f;
        for (int r = 0; r < split; ++r)
          sum += partials[j * L.threads + first + r];
        sc[j] = sum;
      }
    }
    float m = sc[0];
#pragma unroll
    for (int j = 1; j < F; ++j) m = fmaxf(m, sc[j]);
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      sc[j] = expf(sc[j] - m);
      denom += sc[j];
    }
    const float inv = 1.f / denom;
#pragma unroll
    for (int j = 0; j < F; ++j) sc[j] *= inv;

    for (int ch = s; ch < chunks; ch += split) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const uint4 vv = *reinterpret_cast<const uint4*>(slot(2, j) + ch * 8);
        const uint32_t w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * e] = fmaf(sc[j], __uint_as_float(w[e] << 16), acc[2 * e]);
          acc[2 * e + 1] =
              fmaf(sc[j], __uint_as_float(w[e] & 0xffff0000u), acc[2 * e + 1]);
        }
      }
      // only this thread reads these q_i chunks: the output takes them
      *reinterpret_cast<uint4*>(qi + ch * 8) =
          make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                     pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
    }
    // the outputs, written through the generic proxy, are read by the
    // bulk copy (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      long off;
      int rows;
      locate(tile, off, rows);
      const uint32_t bytes = rows * L.width * 2;
#pragma unroll
      for (int fr = 0; fr < F; ++fr)
        bulk_store(o + off + (long)fr * n * c,
                   base + stage * L.stage + fr * L.frame_stride, bytes);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all<false>();
}

template <int F>
cudaError_t launch_tiled(const void* q, const void* k, const void* v,
                         void* o, int b, int n, int c, int heads, float scale,
                         int tokens, int group, int split, int smem,
                         int grid, cudaStream_t stream) {
  const int dh = c / heads;
  const TiledLayout L(F, dh, tokens, group, split);
  if (tokens <= 0 || group <= 0 || split <= 0 || split > 32 || grid <= 0 ||
      dh % 8 != 0 || dh > 512 || heads % group != 0 ||
      (tokens > 1 && group != heads) || smem != L.bytes ||
      L.threads > kTiledMaxThreads)
    return cudaErrorInvalidValue;
  const long tiles = (long)b * ((n + tokens - 1) / tokens) * (heads / group);
  if (tiles > (1l << 30)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(frame_attention_tiled_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  frame_attention_tiled_kernel<F><<<grid, L.threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), n, c, dh, tokens,
      group, split, (int)tiles, scale);
  return cudaGetLastError();
}

// tokens > 0: the tiled kernel with the plan (bf16 only); else the general
// kernel in the operands' type
template <typename T, int F>
cudaError_t launch_any(const void* q, const void* k, const void* v, void* o,
                       int b, int n, int c, int heads, float scale,
                       int tokens, int group, int split, int smem, int grid,
                       cudaStream_t s) {
  if (tokens == 0) return launch<T, F>(q, k, v, o, b, n, c, heads, scale, s);
  if constexpr (std::is_same<T, bf16>::value)
    return launch_tiled<F>(q, k, v, o, b, n, c, heads, scale, tokens, group,
                           split, smem, grid, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int f, int n, int c, int heads, float scale,
                     int tokens, int group, int split, int smem, int grid,
                     cudaStream_t s) {
#define RCDMS_FRAMES_CASE(F)                                             \
  case F:                                                                \
    return launch_any<T, F>(q, k, v, o, b, n, c, heads, scale, tokens,   \
                            group, split, smem, grid, s);
  switch (f) {
    RCDMS_FRAMES_CASE(1)
    RCDMS_FRAMES_CASE(2)
    RCDMS_FRAMES_CASE(3)
    RCDMS_FRAMES_CASE(4)
    RCDMS_FRAMES_CASE(5)
    RCDMS_FRAMES_CASE(6)
    RCDMS_FRAMES_CASE(7)
    RCDMS_FRAMES_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RCDMS_FRAMES_CASE
}

}  // namespace
}  // namespace rcdms

// q, k, v, o: (b, f, n, c) contiguous, c = heads * dh, 1 <= f <= 8.
// tokens > 0 runs the tiled bf16 kernel with the plan of
// ops/frame_attention.py::_plan (tokens, group, split, its shared-memory
// bytes, which must be what the kernel lays out, and the grid; q, k, v, o
// 16-byte aligned); tokens == 0 the general kernel.
extern "C" int rcdms_frame_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, int b, int f, int n, int c,
                                         int heads, float scale, int tokens,
                                         int group, int split, int smem,
                                         int grid, void* stream) {
  using namespace rcdms;
  if (b <= 0 || n <= 0 || heads <= 0 || c % heads != 0 || tokens < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, o, b, f, n, c, heads, scale, tokens,
                           group, split, smem, grid, s);
  if (dtype == kBFloat16)
    return dispatch<bf16>(q, k, v, o, b, f, n, c, heads, scale, tokens, group,
                          split, smem, grid, s);
  return cudaErrorInvalidValue;
}
