"""Kernel B: temporal (frame-axis) attention on the model's (b, f, n, c)
layout — the port's counterpart of
`rcdms_tpu/ops/frame_attention.py::frame_attention_bfnc`.

At every token n and head, the f <= 8 frames attend to each other. Unlike
the TPU kernel, the channel axis is taken as it is: no 128-lane pad.

`frame_attention` dispatches on where its operands lie: on the CPU it runs
`frame_attention_plain`; on a CUDA device it launches `csrc/
frame_attention.cu` or raises. `frame_attention.launches` counts launches.
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops import _build

MAX_FRAMES = 8


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B, all fp32, result in q.dtype."""
    b, f, n, c = q.shape

    def split(t):  # (b, f, n, c) -> (b, n, heads, f, dh)
        return t.float().reshape(b, f, n, heads, c // heads).permute(
            0, 2, 3, 1, 4)

    p = torch.softmax(torch.matmul(split(q), split(k).transpose(-1, -2))
                      * scale, dim=-1)
    o = torch.matmul(p, split(v)).permute(0, 3, 1, 2, 4)
    return o.reshape(b, f, n, c).to(q.dtype)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float | None = None) -> torch.Tensor:
    """q, k, v: (b, f, n, c) with c = heads * dh; attention across f at
    every token. scale defaults to dh ** -0.5."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or q.shape[-1] % heads:
        raise ValueError(f"frame_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"heads {heads}")
    b, f, n, c = q.shape
    if scale is None:
        scale = (c // heads) ** -0.5
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, heads, scale)
    dtype = _build.cuda_operands("frame_attention", q, k, v)
    if not 1 <= f <= MAX_FRAMES:
        raise ValueError(f"frame_attention: {f} frames, kernel takes 1..8")
    out = torch.empty_like(q)
    code = _build.library().lib.rcdms_frame_attention_fwd(
        dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, f, n, c, heads, float(scale), _build.stream(q))
    _build.check(code, "rcdms_frame_attention_fwd")
    frame_attention.launches += 1
    return out


frame_attention.launches = 0
