"""Stage-2 story UNet — the counterpart of `rcdms_tpu/models/unet3d.py`:
SD-v1.5's UNet inflated over the 5-frame story axis, a temporal module
after every spatial transformer (and at the levels without one), and a
9-channel input [noisy latents | mask | masked-source latents].

Module names follow diffusers' UNet (`down_blocks.l.{resnets, attentions,
motion_modules, downsamplers}`, `mid_block`, `up_blocks`), the names
`rcdms_tpu/io/convert.py::convert_rcdms_unet3d` reads.

`cfg.remat` checkpoints each down and up sub-block (resnet, spatial and
temporal modules) while autograd records, as `nn.remat(_SubBlock)` does in
the JAX package: its activations are recomputed in the backward pass.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rcdms_tpu_torch.configs import StoryUNetConfig
from rcdms_tpu_torch.core.attention import SpatialTransformer
from rcdms_tpu_torch.core.layers import (
    FrameConv,
    GroupNorm,
    TimestepEmbedding,
    sinusoidal_time_embedding,
)
from rcdms_tpu_torch.core.resnet import Downsample, ResnetBlock, Upsample
from rcdms_tpu_torch.core.temporal import TemporalModule


class _Level(nn.Module):
    """One down or up level: n x (resnet -> [spatial] -> [temporal]) and an
    optional resampler (`downsamplers.0` / `upsamplers.0`)."""

    def __init__(self, cfg: StoryUNetConfig, in_channels: list, out: int,
                 temb: int, use_cross: bool, resample: str | None):
        super().__init__()
        heads = cfg.num_attention_heads
        self.remat = cfg.remat
        self.resnets = nn.ModuleList([
            ResnetBlock(c_in, out, temb, cfg.norm_groups, cfg.norm_eps)
            for c_in in in_channels])
        self.attentions = nn.ModuleList([
            SpatialTransformer(out, heads, out // heads,
                               cfg.cross_attention_dim, cfg.norm_groups)
            for _ in in_channels] if use_cross else [])
        self.motion_modules = nn.ModuleList([
            TemporalModule(out, cfg.temporal) for _ in in_channels]
            if cfg.use_temporal else [])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample(out)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample(out)])

    def sub_block(self, j: int, x, temb, context):
        """resnet j -> [spatial j] -> [temporal j], checkpointed under
        `remat` while autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._sub_block, j, x, temb, context,
                              use_reentrant=False)
        return self._sub_block(j, x, temb, context)

    def _sub_block(self, j: int, x, temb, context):
        x = self.resnets[j](x, temb)
        if len(self.attentions):
            x = self.attentions[j](x, context)
        if len(self.motion_modules):
            x = self.motion_modules[j](x)
        return x


class StoryUNet(nn.Module):
    """forward(sample (b, f, h, w, 9), timesteps (b,), context
    (b, f, T, cross_attention_dim)) -> (b, f, h, w, 4) epsilon, as
    `decode(*encode(sample, temb, context), temb, context)` under
    `temb = time_embed(timesteps, dtype)`: the split the story sampler's
    encoder propagation reuses."""

    def __init__(self, cfg: StoryUNetConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_channels
        ch0, n = chans[0], len(chans)
        temb = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.conv_in = FrameConv(cfg.in_channels, ch0, 3, padding=1)

        skips = [ch0]
        self.down_blocks = nn.ModuleList()
        prev = ch0
        for level, ch in enumerate(chans):
            ins = [prev] + [ch] * (cfg.layers_per_block - 1)
            last = level == n - 1
            self.down_blocks.append(_Level(
                cfg, ins, ch, temb, cfg.cross_attn_levels[level],
                None if last else "down"))
            skips += [ch] * (cfg.layers_per_block + (0 if last else 1))
            prev = ch

        mid = chans[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([
            ResnetBlock(mid, mid, temb, cfg.norm_groups, cfg.norm_eps)
            for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([SpatialTransformer(
            mid, cfg.num_attention_heads, mid // cfg.num_attention_heads,
            cfg.cross_attention_dim, cfg.norm_groups)])
        self.mid_block.motion_modules = nn.ModuleList(
            [TemporalModule(mid, cfg.temporal)]
            if cfg.use_temporal and cfg.temporal_mid_block else [])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chans))
        rev_cross = list(reversed(cfg.cross_attn_levels))
        h_ch = mid
        for level, ch in enumerate(rev):
            ins = []
            for _ in range(cfg.layers_per_block + 1):
                ins.append(h_ch + skips.pop())
                h_ch = ch
            self.up_blocks.append(_Level(
                cfg, ins, ch, temb, rev_cross[level],
                None if level == n - 1 else "up"))

        self.conv_norm_out = GroupNorm(cfg.norm_groups, ch0, cfg.norm_eps)
        self.conv_out = FrameConv(ch0, cfg.out_channels, 3, padding=1)
        self.encode_calls = 0

    def time_embed(self, timesteps: torch.Tensor, dtype) -> torch.Tensor:
        """(b,) -> (b, ch0 * 4) fp32: the sinusoid rounded to `dtype`, then
        the fp32 time MLP, as the JAX package computes it."""
        t = sinusoidal_time_embedding(timesteps, self.cfg.block_channels[0])
        return self.time_embedding(t.to(dtype))

    def encode(self, sample: torch.Tensor, temb: torch.Tensor,
               context: torch.Tensor):
        """conv_in and the down path -> (bottleneck h, skip stack). Counts
        its calls in `encode_calls`."""
        self.encode_calls += 1
        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                h = blk.sub_block(j, h, temb, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        return h, skips

    def decode(self, h: torch.Tensor, skips, temb: torch.Tensor,
               context: torch.Tensor) -> torch.Tensor:
        """The mid block, the up path and the output head; reads the skip
        stack without consuming it, so a cached encoding decodes again."""
        skips = list(skips)
        mb = self.mid_block
        h = mb.resnets[0](h, temb)
        h = mb.attentions[0](h, context)
        if len(mb.motion_modules):
            h = mb.motion_modules[0](h)
        h = mb.resnets[1](h, temb)

        for blk in self.up_blocks:
            for j in range(len(blk.resnets)):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = blk.sub_block(j, h, temb, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        temb = self.time_embed(timesteps, sample.dtype)
        return self.decode(*self.encode(sample, temb, context), temb, context)
