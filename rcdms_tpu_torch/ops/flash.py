"""Kernel A: fused multi-head attention, softmax(q k^T * scale) v.

The port's counterpart of both attention kernels of `rcdms_tpu/ops/flash.py`
(`flash_attention_nt`, channel-major, and `flash_attention`, token-major):
they compute the same function, so on Hopper there is one kernel
(`csrc/attention.cu`). Operands are token-major with the heads side by side
in the channel axis, exactly as the q/k/v projections emit them:

    q: (..., Sq, H*dh)   k, v: (..., Skv, H*dh)   ->   (..., Sq, H*dh)

with identical leading dims. No padding: the kernel masks a ragged Skv
(91 caption tokens) and any dh up to 256.

`flash_attention` dispatches on where its operands lie: on the CPU it runs
`attention_plain`; on a CUDA device it launches the kernel or raises: the
tensor-core kernel for bf16 with dh a multiple of 8 and 16-byte aligned
operands (every site of the main path), the CUDA-core one otherwise.
`flash_attention.launches` counts launches.
"""

from __future__ import annotations

import math

import torch

from rcdms_tpu_torch.ops import _build

MAX_HEAD_DIM = 256


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., S, H*dh) -> (..., H, S, dh)."""
    return t.reshape(t.shape[:-1] + (heads, -1)).transpose(-3, -2)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel A: fp32 scores, softmax and product,
    result in q.dtype."""
    qh, kh, vh = (_split_heads(t.float(), heads) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    o = torch.matmul(p, vh).transpose(-3, -2)
    return o.reshape(q.shape).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float | None = None) -> torch.Tensor:
    """Fused attention over token-major, head-interleaved operands (see the
    module docstring). scale defaults to dh ** -0.5."""
    c = q.shape[-1]
    if c % heads or k.shape[-1] != c or v.shape != k.shape \
            or q.shape[:-2] != k.shape[:-2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"heads {heads}")
    dh = c // heads
    if scale is None:
        scale = dh ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, heads, scale)
    dtype = _build.cuda_operands("flash_attention", q, k, v)
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} > {MAX_HEAD_DIM}")
    tensor = (q.dtype == torch.bfloat16 and dh % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    sq, skv = q.shape[-2], k.shape[-2]
    batch = math.prod(q.shape[:-2])
    out = torch.empty_like(q)
    code = _build.library().lib.rcdms_attention_fwd(
        dtype, int(tensor), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), batch, heads, sq, skv, dh, float(scale),
        _build.stream(q))
    _build.check(code, "rcdms_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
