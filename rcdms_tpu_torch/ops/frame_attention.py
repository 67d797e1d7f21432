"""Kernel B: temporal (frame-axis) attention on the model's (b, f, n, c)
layout — the port's counterpart of
`rcdms_tpu/ops/frame_attention.py::frame_attention_bfnc`.

At every token n and head, the f <= 8 frames attend to each other. Unlike
the TPU kernel, the channel axis is taken as it is: no 128-lane pad.

`frame_attention` dispatches on where its operands lie: on the CPU it runs
`frame_attention_plain`; on a CUDA device it launches `csrc/
frame_attention.cu` or raises. bf16 with dh a multiple of 8 up to 512 and
16-byte aligned q, k, v (every site of the main path) takes the tiled
kernel with the launch plan of `_plan`: a persistent grid whose blocks
each walk over tiles of whole token rows (or of one token and a group of
heads), copied into shared memory by 1-D TMA bulk copies through a ring
of two stages, one thread for each (token, head, query frame) and
channel slice, and the output written back by bulk copies from shared
memory. Every other shape, and fp32, takes the general kernel (one warp a
(token, head)); neither falls back to the plain version.
`frame_attention.launches` counts launches, `frame_attention.tiled_launches`
those that took the tiled kernel. Where autograd records it, the same
forward runs inside a `torch.autograd.Function` whose backward
differentiates `frame_attention_reference` (`ops/_grad.py`).
"""

from __future__ import annotations

import functools

import torch

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops._grad import differentiable

MAX_FRAMES = 8
SMS = 132                  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472           # bytes of shared memory an SM holds for blocks
BLOCK_RESERVED = 1024      # bytes the runtime keeps for each block
STAGES = 2                 # the ring of q, k, v tiles
STAGE_MAX = 40 * 1024      # bytes of q, k, v a stage holds at most
MAX_CHUNKS = 5             # 16-byte chunks of a head a thread takes at most
MAX_THREADS = 512          # threads a block (the kernel's launch bound)
MAX_TILED_DH = 512         # the widest head the tiled kernel takes
MIN_TILES = 2 * SMS        # tiles a plan leaves, where it can


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _takes(dh: int) -> bool:
    """The head dims of the tiled kernel: multiples of 8 up to
    MAX_TILED_DH (so the threads that split a head share a warp and one
    (token, head) of all f frames fits a stage)."""
    return dh % 8 == 0 and 0 < dh <= MAX_TILED_DH


@functools.lru_cache(maxsize=256)
def _plan(b: int, f: int, n: int, c: int, heads: int) -> dict:
    """Launch plan of the tiled bf16 kernel for q, k, v (b, f, n, c) with
    `heads` heads of dh = c / heads channels.

    `split` threads share each (token, head, query frame): the fewest
    (a power of two) that leave each at most MAX_CHUNKS 16-byte chunks of
    the head. A tile is `tokens` whole token rows (the largest of 8, 4, 2, 1
    whose q, k, v fit STAGE_MAX and that leaves MIN_TILES tiles), else one
    token and `group` heads (the most that fit and leave MIN_TILES tiles;
    at least one). Its frame rows are then contiguous, so a stage is 3 f
    bulk copies. Two tiles an SM rather than one: on the card, more
    blocks in flight beat a longer walk through the ring at the story's
    small shapes. `threads` = tokens x group x f x split.
    Shared memory (`smem`): STAGES stages of 3 f frame slots of
    `frame_stride` bytes (the tile's rows rounded up to 128 bytes, plus
    16 x split mod 128 so that the f frames' chunks fall in other banks),
    the split threads' partial scores (threads x f fp32 where split > 1),
    and one mbarrier a stage. `grid`: the tiles, at most as many blocks as
    fit on the SMs at once (`blocks_per_sm`); each block walks over tiles
    blockIdx, + grid, ... Raises ValueError for a shape the kernel does not
    take."""
    if not 1 <= f <= MAX_FRAMES or min(b, n, c, heads) <= 0 \
            or c % heads or not _takes(c // heads):
        raise ValueError(f"the tiled frame attention takes 1..{MAX_FRAMES} "
                         f"frames and a head dim that is a multiple of 8 up "
                         f"to {MAX_TILED_DH}, got b {b}, f {f}, n {n}, c {c}, "
                         f"heads {heads}")
    dh = c // heads
    split = 1
    while _cdiv(dh // 8, split) > MAX_CHUNKS:
        split *= 2
    per_head = 3 * f * dh * 2  # bytes of one (token, head) a stage

    def fits(tokens, group):
        return (tokens * group * per_head <= STAGE_MAX
                and tokens * group * f * split <= MAX_THREADS)

    tokens = next((t for t in (8, 4, 2) if fits(t, heads)
                   and b * _cdiv(n, t) >= MIN_TILES), 1)
    group = heads
    if tokens == 1:
        groups = [g for g in range(heads, 0, -1) if heads % g == 0
                  and fits(1, g)]
        group = next((g for g in groups
                      if b * n * (heads // g) >= MIN_TILES), groups[-1])
    threads = tokens * group * f * split
    row = tokens * group * dh * 2
    frame_stride = _cdiv(row, 128) * 128 + 16 * split % 128
    stage = 3 * f * frame_stride
    partials = threads * f * 4 if split > 1 else 0
    smem = STAGES * stage + partials + 8 * STAGES
    tiles = b * _cdiv(n, tokens) * (heads // group)
    blocks_per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED),
                        2048 // (32 * _cdiv(threads, 32)), 32)
    return dict(tokens=tokens, group=group, split=split, threads=threads,
                frame_stride=frame_stride, smem=smem, tiles=tiles,
                blocks_per_sm=blocks_per_sm,
                grid=min(tiles, SMS * blocks_per_sm))


def _split_frames(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, f, n, c) -> (b, n, heads, f, dh)."""
    b, f, n, c = t.shape
    return t.reshape(b, f, n, heads, c // heads).permute(0, 2, 3, 1, 4)


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B, result in q.dtype.

    fp32: fp32 scores s_ij = q_i . k_j * scale, softmax over j, P.V.
    bf16 rounds where `rcdms_tpu/ops/frame_attention.py::_kernel_bfnc`
    rounds (:82-84): the scale, q_i * scale and each per-channel product
    (q_i * scale) * k_j are rounded to bf16, and a head's products summed
    in fp32; then, as there (:85-103), the fp32 max, exp, sum, reciprocal
    and P.V, with one rounding of the output."""
    b, f, n, c = q.shape
    split = functools.partial(_split_frames, heads=heads)
    if q.dtype == torch.float32:
        p = torch.softmax(torch.matmul(split(q), split(k).transpose(-1, -2))
                          * scale, dim=-1)
    else:
        qs = split(q * torch.tensor(scale, dtype=q.dtype))
        # (b, n, heads, f_i, f_j, dh): each product rounded to q.dtype
        s = (qs.unsqueeze(-2) * split(k).unsqueeze(-3)).float().sum(-1)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e * (1.0 / e.sum(-1, keepdim=True))
    o = torch.matmul(p, split(v).float()).permute(0, 3, 1, 2, 4)
    return o.reshape(b, f, n, c).to(q.dtype)


def frame_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, heads: int,
                              scale: float) -> torch.Tensor:
    """The function B's backward differentiates,
    `rcdms_tpu/ops/frame_attention.py::_bfnc_xla_reference` (:106-112,
    through `_xla_reference` :50-65): fp32 scores and softmax across the
    frames, the probabilities cast to q.dtype, a q.dtype product with v."""
    s = torch.matmul(_split_frames(q.float(), heads),
                     _split_frames(k.float(), heads).transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(q.dtype)
    o = torch.matmul(p, _split_frames(v, heads)).permute(0, 3, 1, 2, 4)
    return o.reshape(q.shape)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float | None = None) -> torch.Tensor:
    """q, k, v: (b, f, n, c) with c = heads * dh; attention across f at
    every token. scale defaults to dh ** -0.5. Differentiable: gradients of
    `frame_attention_reference` (`ops/_grad.py`)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or q.shape[-1] % heads:
        raise ValueError(f"frame_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"heads {heads}")
    b, f, n, c = q.shape
    if scale is None:
        scale = (c // heads) ** -0.5
    return differentiable(
        functools.partial(_frame_attention, heads=heads, scale=scale),
        functools.partial(frame_attention_reference, heads=heads,
                          scale=scale), q, k, v)


def _frame_attention(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """B's forward: the plain version on the CPU, a kernel on a card."""
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, heads, scale)
    b, f, n, c = q.shape
    dtype = _build.cuda_operands("frame_attention", q, k, v)
    if q.numel() == 0:  # an empty block of a split story: nothing to launch
        return torch.empty_like(q)
    if not 1 <= f <= MAX_FRAMES:
        raise ValueError(f"frame_attention: {f} frames, kernel takes 1..8")
    out = torch.empty_like(q)
    tiled = (q.dtype == torch.bfloat16 and _takes(c // heads)
             and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    plan = (_plan(b, f, n, c, heads) if tiled
            else dict(tokens=0, group=0, split=0, smem=0, grid=0))
    code = _build.library().lib.rcdms_frame_attention_fwd(
        dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, f, n, c, heads, float(scale), plan["tokens"], plan["group"],
        plan["split"], plan["smem"], plan["grid"], _build.stream(q))
    _build.check(code, "rcdms_frame_attention_fwd")
    frame_attention.launches += 1
    frame_attention.tiled_launches += int(tiled)
    return out


frame_attention.launches = 0
frame_attention.tiled_launches = 0
