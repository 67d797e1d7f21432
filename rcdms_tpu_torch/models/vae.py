"""SD-v1.5 AutoencoderKL — the counterpart of `rcdms_tpu/models/vae.py`,
over channels-last images (n, h, w, c). Module names are diffusers'
(`encoder.down_blocks.l.resnets.j`, `mid_block.attentions.0.group_norm`,
`quant_conv`, ...), the names `convert_sd_vae` reads.

The mid-block attention (one head of dim 512 at full width) stays plain
PyTorch, as it stays XLA in the JAX package.

Within `core.spatial.spatial(rows=plan)` each image holds this rank's
block of rows (`RowPlan`: uneven, maybe empty): the convs and GroupNorms
split as `core/layers.py` says, the mid-block attention gathers K and V,
and the encoder's (0, 1) padded stride-2 conv takes the row after its
block from the rank that holds it (zeros after the last real row stand
for the pad).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rcdms_tpu_torch.configs import VAEConfig
from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.attention import spatial_kv
from rcdms_tpu_torch.core.layers import Conv, GroupNorm
from rcdms_tpu_torch.ops.attention import multihead_attention


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, 1e-6)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch, 1e-6)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over h*w at the bottleneck."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, c)
        q = self.to_q(y)
        k, v, queries = spatial_kv(q, self.to_k(y), self.to_v(y), True, w)
        o = multihead_attention(q, k, v, 1, row_sum="fp32", queries=queries)
        return x + self.to_out[0](o).reshape(x.shape)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttnBlock(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


def encoder_downsample(conv: Conv, h: torch.Tensor) -> torch.Tensor:
    """SD's Downsample2D: an asymmetric (0, 1) pad, then the VALID stride-2
    `conv`. Rows split by a `spatial` row plan take the row after their
    block from the rank that holds it; the rank that holds the last real
    row gets zeros, the bottom pad, and pads its columns alone."""
    plan = spatial.row_plan()
    if plan is None:
        return conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
    return conv.run_haloed(F.pad(spatial.halo(h, 1, 0, 1, plan),
                                 (0, 0, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_channels, cfg.norm_groups
        self.conv_in = Conv(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for level, ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([
                VAEResnetBlock(prev if j == 0 else ch, ch, g)
                for j in range(cfg.layers_per_block)])
            if level != len(chans) - 1:
                down = nn.Module()
                down.conv = Conv(ch, ch, 3, stride=2, padding=0)
                blk.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(blk)
            prev = ch
        self.mid_block = _MidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], 1e-6)
        self.conv_out = Conv(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = encoder_downsample(blk.downsamplers[0].conv, h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_channels)), cfg.norm_groups
        self.conv_in = Conv(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for level, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([
                VAEResnetBlock(prev if j == 0 else ch, ch, g)
                for j in range(cfg.layers_per_block + 1)])
            if level != len(rev) - 1:
                up = nn.Module()
                up.conv = Conv(ch, ch, 3, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
            prev = ch
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = blk.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    """encode(x (n, H, W, 3)) -> (mean, logvar) latents; decode(z) -> image.
    `sample_latent` takes its noise explicitly; callers apply
    `scaling_factor` (0.18215)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = cfg.latent_channels
        self.quant_conv = Conv(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv(lc, lc, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    @staticmethod
    def sample_latent(mean: torch.Tensor, logvar: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
        return mean + torch.exp(0.5 * logvar) * noise
