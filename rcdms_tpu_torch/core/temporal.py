"""Temporal (cross-frame) attention module — the counterpart of
`rcdms_tpu/core/temporal.py` (the reference's motion module). The story axis
stays explicit: tokens (b, f, n, c), feature maps (b, f, h, w, c); every
temporal attention runs across f at each token through kernel B.

State-dict names follow the reference's VanillaTemporalModule
(`temporal_transformer.{norm|prior_norm, proj_in, transformer_blocks.k.
{norms.l, attention_blocks.l, ff_norm, ff}, proj_out}`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import TemporalConfig
from rcdms_tpu_torch.core.attention import Attention
from rcdms_tpu_torch.core.layers import (
    FeedForward,
    GroupNorm,
    LayerNorm,
    temporal_positional_encoding,
)


class TemporalTransformerBlock(nn.Module):
    """N x (LN -> +PE -> temporal self-attn -> +res) -> LN -> FF -> +res.
    The PE enters q, k and v (it is added to the normed states)."""

    def __init__(self, dim: int, cfg: TemporalConfig):
        super().__init__()
        self.cfg = cfg
        n = cfg.attn_layers_per_block
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(n)])
        self.attention_blocks = nn.ModuleList([
            Attention(dim, cfg.num_heads, dim // cfg.num_heads,
                      frame_axis=True) for _ in range(n)])
        self.ff_norm = LayerNorm(dim)
        self.ff = FeedForward(dim, "geglu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = None
        if self.cfg.use_positional_encoding:
            f = x.shape[1]
            pe = temporal_positional_encoding(
                self.cfg.max_frames, x.shape[-1],
                device=x.device)[:f, None, :].to(x.dtype)
        for norm, attn in zip(self.norms, self.attention_blocks):
            h = norm(x)
            if pe is not None:
                h = h + pe
            x = x + attn(h)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3D(nn.Module):
    def __init__(self, channels: int, cfg: TemporalConfig, prior_mode: bool):
        super().__init__()
        self.prior_mode = prior_mode
        if prior_mode:
            self.prior_norm = LayerNorm(channels)
        else:
            self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, cfg)
            for _ in range(cfg.num_blocks)])
        self.proj_out = nn.Linear(channels, channels)


class TemporalModule(nn.Module):
    """Norm -> proj_in -> blocks -> proj_out -> +residual. prior_mode=True
    takes tokens (b, f, n, c) with a LayerNorm in; otherwise feature maps
    (b, f, h, w, c) with a GroupNorm(32) in. With zero_init_output the
    output projection starts at zero, so the module starts as identity."""

    def __init__(self, channels: int, cfg: TemporalConfig,
                 prior_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.temporal_transformer = TemporalTransformer3D(channels, cfg,
                                                          prior_mode)

    def flax_init_(self, generator: torch.Generator) -> None:
        if self.cfg.zero_init_output:
            nn.init.zeros_(self.temporal_transformer.proj_out.weight)
            nn.init.zeros_(self.temporal_transformer.proj_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tt = self.temporal_transformer
        if tt.prior_mode:
            h = tt.prior_norm(x)
        else:
            b, f, hh, ww, c = x.shape
            h = tt.norm(x).reshape(b, f, hh * ww, c)
        h = tt.proj_in(h)
        for block in tt.transformer_blocks:
            h = block(h)
        return tt.proj_out(h).reshape(x.shape) + x
