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
runs the `mma.sync` kernel with the launch plan of `_plan` (dh a multiple
of 8 up to 256, 16-byte aligned operands: every site of the main path),
fp32 the CUDA-core kernel (dh up to 256). `flash_attention.launches`
counts launches. Where autograd records it (an operand requires grad, grad
mode on), the same forward runs inside a `torch.autograd.Function` whose
backward differentiates `attention_reference` (`ops/_grad.py`).

In bf16 the two TPU kernels round alike (P = exp(s - max) to bf16 before
P.V) but take the row sum l from different P: `_nt_kernel` from the rounded
P, `_attn_kernel` from the fp32 P. Each call site names its family with
`row_sum` ("rounded": the UNet's spatial sites, which the JAX package sends
to `_nt_kernel`; "fp32": the CLIP vision tower's, which go to
`_attn_kernel`), and the plain version and the `mma.sync` kernel follow
it: the kernel makes two passes over K, the first for the row's maximum,
so that it rounds P against the row's final maximum as both TPU kernels
do, and takes l from the rounded or the fp32 P by a template parameter
that the plan carries.
"""

from __future__ import annotations

import functools
import math

import torch

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops._grad import differentiable

MAX_HEAD_DIM = 256
ROW_SUMS = ("rounded", "fp32")
KV_TILE = 64  # keys a K/V tile of the mma kernel
# contraction widths the mma kernel is built for (dh padded up to one),
# each with the output tile counts it is built for (dh / 8 rounded up)
OUTPUT_TILES = {48: (5, 6), 64: (8,), 80: (10,), 112: (13, 14), 128: (16,),
                160: (20,), 256: (32,)}


def _plan(dh: int, row_sum: str) -> dict:
    """Launch plan of the bf16 `mma.sync` kernel for head dim dh and the
    site's `row_sum` family (`row_sum`: 1 for "rounded", 0 for "fp32",
    the kernel's template parameter): the
    contraction width `dp` (dh padded to a multiple of 16, to the next
    width the kernel is built for), the output's n8 tiles (`n_tiles`,
    dh / 8 for every head dim of the main path: no pad on the output
    side; else rounded up to a count the kernel is built for, the extra
    tiles skipped), queries a block (`bq`: 128, or 64
    from dp 160, where Q's fragments and the output accumulators fill the
    registers), query rows a warp (`rows_per_warp`: two m16 tiles up to dp
    64, so a K or V fragment serves both; one above) and threads a block,
    and the block's shared memory
    (`smem`: the Q tile and two stages of K and V tiles, rows dp + 8 bf16
    long). Raises ValueError for a dh the kernel does not take."""
    if dh <= 0 or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the bf16 kernel takes a head dim "
                         f"that is a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {dh}")
    if row_sum not in ROW_SUMS:
        raise ValueError(f"flash_attention: row_sum {row_sum!r}, not one "
                         f"of {ROW_SUMS}")
    dp = next(w for w in OUTPUT_TILES if w >= dh)
    n_tiles = next(n for n in OUTPUT_TILES[dp] if 8 * n >= dh)
    bq = 128 if dp <= 128 else 64
    rows_per_warp = 32 if dp <= 64 else 16
    smem = (bq + 4 * KV_TILE) * (dp + 8) * 2
    return dict(dp=dp, n_tiles=n_tiles, bq=bq, rows_per_warp=rows_per_warp,
                threads=32 * bq // rows_per_warp, smem=smem,
                row_sum=int(row_sum == "rounded"))


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
    plan = dict(dp=0, n_tiles=0, bq=0, row_sum=0, smem=0)
    if q.dtype == torch.bfloat16:
        plan = _plan(dh, row_sum)
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: the bf16 kernel takes "
                             "16-byte aligned q, k, v")
    sq, skv = q.shape[-2], k.shape[-2]
    batch = math.prod(q.shape[:-2])
    out = torch.empty_like(q)
    code = _build.library().lib.rcdms_attention_fwd(
        dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        batch, heads, sq, skv, dh, float(scale), plan["dp"],
        plan["n_tiles"], plan["bq"], plan["row_sum"], plan["smem"],
        _build.stream(q))
    _build.check(code, "rcdms_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
