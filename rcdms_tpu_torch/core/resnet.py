"""Residual conv blocks and up/down sampling over (b, f, h, w, c) stories —
the counterpart of `rcdms_tpu/core/resnet.py` (the reference's
ResnetBlock3D, Downsample3D and Upsample3D, per frame)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rcdms_tpu_torch.core.layers import FrameConv, GroupNorm


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv3x3 -> (+time emb) -> GN -> SiLU -> conv3x3, with a
    1x1 shortcut when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = FrameConv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv2 = FrameConv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (FrameConv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            # temb is fp32 (the time MLP's); silu in fp32, then the input
            # cast to the projection's dtype, as flax's Dense casts it
            proj = self.time_emb_proj
            t = proj(F.silu(temb).to(proj.weight.dtype))
            h = h + t.reshape(t.shape[:1] + (1,) * (h.dim() - 2)
                              + t.shape[1:])
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv per frame (rows split over a `spatial` group take
    one row of the rank above)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = FrameConv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 spatial upsample + 3x3 conv per frame."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = FrameConv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = x.dim()
        y = x.repeat_interleave(2, dim=nd - 3).repeat_interleave(2, dim=nd - 2)
        return self.conv(y)
