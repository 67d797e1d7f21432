"""Kernel A: fused multi-head attention, softmax(q k^T * scale) v.

The port's counterpart of both attention kernels of `rcdms_tpu/ops/flash.py`
(`flash_attention_nt`, channel-major, and `flash_attention`, token-major):
they compute the same function, so on Hopper there is one kernel
(`csrc/attention.cu`). Operands are token-major with the heads side by side
in the channel axis, exactly as the q/k/v projections emit them:

    q: (..., Sq, H*dh)   k, v: (..., Skv, H*dh)   ->   (..., Sq, H*dh)

with identical leading dims. No padding: the kernel masks a ragged Skv
(91 caption tokens).

`flash_attention` dispatches on where its operands lie: on the CPU it runs
`attention_plain`; on a CUDA device it launches a kernel or raises: bf16
runs the TMA + `wgmma` kernel with the launch plan of `_plan` (dh a
multiple of 8 up to 256, 16-byte aligned operands: every site of the main
path), fp32 the CUDA-core kernel (dh up to 256). `flash_attention.launches`
counts launches. Where autograd records it (an operand requires grad, grad
mode on), the same forward runs inside a `torch.autograd.Function` whose
backward differentiates `attention_reference` (`ops/_grad.py`).

In bf16 the two TPU kernels round alike (P = exp(s - max) to bf16 before
P.V) but take the row sum l from different P: `_nt_kernel` from the rounded
P, `_attn_kernel` from the fp32 P. Each call site names its family with
`row_sum` ("rounded": the UNet's spatial sites, which the JAX package sends
to `_nt_kernel`; "fp32": the CLIP vision tower's, which go to
`_attn_kernel`), and the plain version and the `wgmma` kernel follow it:
the kernel makes two passes over K, the first for the row's maximum, so
that it rounds P against the row's final maximum as both TPU kernels do,
and takes l from the rounded or the fp32 P by a template parameter that
the plan carries.
"""

from __future__ import annotations

import functools
import math

import torch

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops._grad import differentiable

MAX_HEAD_DIM = 256
ROW_SUMS = ("rounded", "fp32")
# contraction widths the wgmma kernel is built for (dh padded up to one,
# a multiple of 16), each with its key tile: 128 keys up to dp 80, 64
# above, so that two banks of score accumulators, P's fragments and the
# output accumulators fit a consumer thread's registers
KEY_TILES = {48: 128, 64: 128, 80: 128, 112: 64, 128: 64, 160: 64, 256: 64}
NARROW_OUTPUT = 40  # P V's width where dh <= 40 (UNet level 0), below dp 48
QUERIES = 128       # queries a block: two consumer warpgroups of 64 rows
CLUSTER = 2         # blocks a cluster, sharing each K/V tile by multicast
THREADS = 384       # the two consumer warpgroups and a producer warpgroup
CONSUMER_REGS = 240  # registers a consumer thread, after setmaxnreg
BOX_COLUMNS = 64    # columns of a TMA box: one 128-byte swizzled row
ONES_BYTES = 1024   # the tile of bf16 ones, the B operand of the row sums
MAX_STAGES = 4
SMEM_MAX = 232448   # shared memory a block may take on the H100
MAX_GRID_Y = 65535  # blocks along y: one a (batch, head)


def _plan(dh: int, row_sum: str) -> dict:
    """Launch plan of the bf16 TMA + `wgmma` kernel for head dim dh and the
    site's `row_sum` family (`row_sum`: 1 for "rounded", 0 for "fp32",
    the kernel's template parameter): the contraction width `dp` (dh
    padded up to the next width the kernel is built for), the width `nv`
    of P V and of the output accumulators (dp, or 40 where dh is at most
    40; columns past dh are not stored), the key tile `bn`, taken as
    `boxes` TMA boxes of 64 columns, queries a block (`bq`, two consumer
    warpgroups of 64) and threads a block, blocks a `cluster` (each loads
    half of every K and V tile for both), the ring's `stages` (the most of
    at most four that fit), and the block's shared memory (`smem`: 1024
    bytes to align, the Q tile, a 1024-byte tile of ones for the row sums,
    the ring of K and V tiles, the full and empty mbarriers of each stage
    and Q's). Raises ValueError for a dh the kernel does not take."""
    if dh <= 0 or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the bf16 kernel takes a head dim "
                         f"that is a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {dh}")
    if row_sum not in ROW_SUMS:
        raise ValueError(f"flash_attention: row_sum {row_sum!r}, not one "
                         f"of {ROW_SUMS}")
    dp = next(w for w in KEY_TILES if w >= dh)
    bn, boxes, stages, smem = _layout(dp)
    return dict(dp=dp, nv=NARROW_OUTPUT if dh <= NARROW_OUTPUT else dp,
                bn=bn, boxes=boxes, bq=QUERIES, threads=THREADS,
                cluster=CLUSTER, stages=stages, smem=smem,
                row_sum=int(row_sum == "rounded"))


@functools.cache
def _layout(dp: int) -> tuple:
    """(key tile, boxes, stages, shared-memory bytes) of contraction
    width dp: the deepest ring of at most MAX_STAGES that fits."""
    bn = KEY_TILES[dp]
    boxes = -(-dp // BOX_COLUMNS)
    row_bytes = 2 * BOX_COLUMNS * boxes
    q_bytes, stage = QUERIES * row_bytes, 2 * bn * row_bytes

    def smem(stages):
        return (1024 + q_bytes + ONES_BYTES + stages * stage
                + 8 * (2 * stages + 1))

    stages = max(n for n in range(2, MAX_STAGES + 1) if smem(n) <= SMEM_MAX)
    return bn, boxes, stages, smem(stages)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., S, H*dh) -> (..., H, S, dh)."""
    return t.reshape(t.shape[:-1] + (heads, t.shape[-1] // heads)
                     ).transpose(-3, -2)



def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float, *,
                    row_sum: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A, result in q.dtype. fp32: fp32
    scores, softmax and product. bf16 rounds as the TPU kernels do: the
    unnormalised P = exp(s - max) is rounded to bf16 before the fp32 P.V,
    and the row sum l comes, by `row_sum`, from the rounded P ("rounded":
    `rcdms_tpu/ops/flash.py::_nt_kernel` :153-163, the UNet's spatial
    sites, output times 1 / l) or from the fp32 P ("fp32": `_attn_kernel`
    :70-75, the CLIP vision sites, output over l)."""
    if row_sum not in ROW_SUMS:
        raise ValueError(f"attention: row_sum {row_sum!r}, not one of "
                         f"{ROW_SUMS}")
    qh, kh, vh = (_split_heads(t.float(), heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if q.dtype == torch.float32:
        o = torch.matmul(torch.softmax(s, dim=-1), vh)
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        pr = p.to(q.dtype).float()
        o = torch.matmul(pr, vh)
        o = (o * (1.0 / pr.sum(-1, keepdim=True)) if row_sum == "rounded"
             else o / p.sum(-1, keepdim=True))
    return o.transpose(-3, -2).reshape(q.shape).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """The function A's backward differentiates, at both families' sites:
    `rcdms_tpu/ops/flash.py::_nt_xla_reference` (:173-194, the UNet's) and
    `::_xla_reference` (:79-85, CLIP's) compute it alike: fp32 scores and
    softmax, the probabilities cast to q.dtype, a q.dtype product with v."""
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), vh)
    return o.transpose(-3, -2).reshape(q.shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float | None = None, *,
                    row_sum: str) -> torch.Tensor:
    """Fused attention over token-major, head-interleaved operands (see the
    module docstring). scale defaults to dh ** -0.5; `row_sum` names the
    TPU kernel family whose bf16 rounding the site follows
    (`attention_plain`). Differentiable: gradients of
    `attention_reference` (`ops/_grad.py`)."""
    c = q.shape[-1]
    if c % heads or k.shape[-1] != c or v.shape != k.shape \
            or q.shape[:-2] != k.shape[:-2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"heads {heads}")
    dh = c // heads
    if scale is None:
        scale = dh ** -0.5
    if row_sum not in ROW_SUMS:
        raise ValueError(f"flash_attention: row_sum {row_sum!r}, not one "
                         f"of {ROW_SUMS}")
    return differentiable(
        functools.partial(_attention, heads=heads, scale=scale,
                          row_sum=row_sum),
        functools.partial(attention_reference, heads=heads, scale=scale),
        q, k, v)


def _attention(q, k, v, heads: int, scale: float,
               row_sum: str) -> torch.Tensor:
    """A's forward: the plain version on the CPU, the kernel on a card."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, heads, scale, row_sum=row_sum)
    dh = q.shape[-1] // heads
    dtype = _build.cuda_operands("flash_attention", q, k, v)
    if q.numel() == 0:  # an empty block of a split map: nothing to launch
        return torch.empty_like(q)
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} > {MAX_HEAD_DIM}")
    sq, skv = q.shape[-2], k.shape[-2]
    batch = math.prod(q.shape[:-2])
    plan = dict(dp=0, nv=0, bn=0, bq=0, stages=0, cluster=0, row_sum=0,
                smem=0)
    if q.dtype == torch.bfloat16:
        plan = _plan(dh, row_sum)
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: the bf16 kernel takes "
                             "16-byte aligned q, k, v")
        if batch * heads > MAX_GRID_Y:
            raise ValueError(f"flash_attention: the bf16 kernel takes at "
                             f"most {MAX_GRID_Y} (batch, head) pairs, got "
                             f"{batch * heads}")
    out = torch.empty_like(q)
    code = _build.library().lib.rcdms_attention_fwd(
        dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        batch, heads, sq, skv, dh, float(scale), plan["dp"], plan["nv"],
        plan["bn"], plan["bq"], plan["stages"], plan["cluster"],
        plan["row_sum"], plan["smem"], _build.stream(q))
    _build.check(code, "rcdms_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
