"""Opt-in w8a8 int8 inference — the counterpart of `rcdms_tpu/ops/quant.py`
(mode state, per-tensor activation and per-channel weight quantization)
and of the JAX package's int8 3x3 conv (`core/layers.py::_taps9_conv_int8`).

Strictly opt-in and inference-only (`--quantize int8` on the inference
CLIs, `RCDMS_QUANT=int8`, or `set_quant_mode("int8")`): the default path
is untouched and the weights stay as loaded. This changes the numbers.

`int8_conv3x3` is the 3x3, stride-1, padding-1 conv of the story UNet in
int8: the activation quantized once a call (per-tensor scale), the weight
per output channel (cached per module by the caller), the nine taps summed
in int32 as one product over an im2col of the int8 activation, and one
fp32 epilogue with the bias. The product (`int_matmul`) is exact: on the
CPU an int32 matmul; on a card `torch._int_mm` (cuBLASLt), a library
product, as the JAX package computes this conv in XLA, not in a Pallas
kernel. `_int_mm` takes an int8 (M, K) activation with M > 16 and K a
multiple of 8, and an int8 (K, N) weight with N a multiple of 8, both
row-major here (a column-major weight can give wrong sums in some cuBLASLt
versions); `int_matmul` raises on any other operand and never falls back
to a float product.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.core import spatial

_QUANT_MODE: Optional[str] = os.environ.get("RCDMS_QUANT") or None

_VALID = (None, "int8")


def set_quant_mode(mode: Optional[str]) -> None:
    """`None` (exact, default) or `"int8"` (w8a8 dynamic quantization on
    the paths that opted in: the UNet's 3x3 convs)."""
    if mode not in _VALID:
        raise ValueError(f"quant mode {mode!r} not in {_VALID}")
    global _QUANT_MODE
    _QUANT_MODE = mode


def get_quant_mode() -> Optional[str]:
    return _QUANT_MODE


def int8_enabled() -> bool:
    return _QUANT_MODE == "int8"


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric dynamic quantization: (int8 values, fp32 scalar
    scale) with x ~= values * scale. An all-zero tensor gets scale 1/127
    (of the 1e-30 floor), not a division by zero. A tensor split by a
    `spatial.spatial` block (rows, frames or CFG branches) takes the
    maximum over the ranks that hold it whole (`spatial.whole_group`), the
    whole tensor's."""
    xf = x.float()
    # 0, MAX's identity, where this rank's block is empty
    amax = xf.abs().amax() if xf.numel() else xf.new_zeros(())
    amax = spatial.all_reduce_max(amax, spatial.whole_group())
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor,
                    out_axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization: amax over every axis but
    `out_axis`. Returns (int8 weights, fp32 scales shaped like the out
    axis). An all-zero channel stays exactly zero."""
    wf = w.float()
    out_axis %= w.dim()
    axes = tuple(i for i in range(w.dim()) if i != out_axis)
    amax = wf.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(w.shape[out_axis])


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ int8 (K, N) -> int32 (M, N): on the CPU an int32
    matmul; on a card `torch._int_mm`, whose operand rules (module
    docstring) are checked here; anything else raises."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 \
            or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int_matmul: int8 (M, K) @ (K, N), got "
                         f"{a.dtype} {tuple(a.shape)} @ {b.dtype} "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return torch.mm(a.to(torch.int32), b.to(torch.int32))
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"int_matmul: operands on {a.device} and "
                         f"{b.device}")
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or k % 8 or n % 8 or not (a.is_contiguous()
                                         and b.is_contiguous()):
        raise ValueError(f"int_matmul: torch._int_mm takes row-major "
                         f"(M > 16, K % 8 == 0) @ (K, N % 8 == 0), got "
                         f"({m}, {k}) @ ({k}, {n})")
    return torch._int_mm(a, b)


def conv_weight_int8(weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (Cout, Cin, 3, 3) conv weight as the row-major int8 (9 Cin, N)
    matrix of the im2col product (rows tap-major: dy, dx, then Cin; N is
    Cout padded with zero columns to a multiple of 8, as `_int_mm` needs:
    the UNet's conv_out has Cout 4) and its (Cout,) fp32 scales."""
    q, scale = quantize_weight(weight, out_axis=0)
    cout = weight.shape[0]
    qw = q.permute(2, 3, 1, 0).reshape(-1, cout)
    return F.pad(qw, (0, -cout % 8)).contiguous(), scale


def int8_conv3x3(x: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], dtype, *,
                 haloed: bool = False) -> torch.Tensor:
    """3x3 stride-1 SAME conv of channels-last x (N, h, w, Cin) with the
    int8 weight of `conv_weight_int8`: the activation quantized once, the
    nine taps' int32 sums in one exact product, then acc * (s_x * s_w) +
    bias in fp32, cast to `dtype`. Returns (N, h, w, Cout). `haloed`: x
    carries a row above and below already (a row block of a split
    feature map, `spatial.halo`), so only the columns are padded and
    the output has h - 2 rows."""
    q, s_x = quantize_act(x)
    qp = F.pad(q, (0, 0, 1, 1) if haloed else (0, 0, 1, 1, 1, 1))
    n, h, w, c = qp.shape[0], qp.shape[1] - 2, qp.shape[2] - 2, qp.shape[3]
    if n * max(h, 0) * w == 0:  # an empty block of a split map
        return x.new_empty((n, max(h, 0), w, w_scale.numel()), dtype=dtype)
    cols = torch.cat([qp[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)
    acc = int_matmul(cols.reshape(n * h * w, 9 * c), qw)
    out = acc[:, :w_scale.numel()].float() * (s_x * w_scale)
    if bias is not None:
        out = out + bias.float()
    int8_conv3x3.calls += 1
    return out.to(dtype).reshape(n, h, w, -1)


int8_conv3x3.calls = 0
