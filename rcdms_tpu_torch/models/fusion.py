"""Stage-2 conditioning fusion — the counterpart of
`rcdms_tpu/models/fusion.py`: the seen-frame ("fine") and unseen-frame
("semantic") cross-attention stacks. Both run on every frame and a `where`
picks per frame, so routing is batched and shape-static.

State-dict names are the reference's (`text_fc`, `vis_fc`,
`multihead_attn.{in_proj_weight, in_proj_bias, out_proj}` under
`seen_module.` / `unseen_module.`), as `convert_fusion_stack` reads them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from rcdms_tpu_torch.configs import FusionConfig
from rcdms_tpu_torch.core.layers import lecun_normal_
from rcdms_tpu_torch.ops.attention import multihead_attention


class PackedMultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed q/k/v projection,
    all biased), computed by the port's attention routing."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def flax_init_(self, generator: torch.Generator) -> None:
        """As the JAX package's three separate q/k/v Dense layers."""
        for w in self.in_proj_weight.data.chunk(3):
            lecun_normal_(w, generator)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        o = multihead_attention(F.linear(x, wq, bq), F.linear(context, wk, bk),
                                F.linear(context, wv, bv), self.heads,
                                row_sum="rounded")
        return self.out_proj(o)


class CrossFeatureStack(nn.Module):
    """text_fc / vis_fc projections, then attention with the text tokens as
    queries and the visual features as keys and values."""

    def __init__(self, cfg: FusionConfig, vis_dim: int):
        super().__init__()
        self.text_fc = nn.Linear(cfg.text_dim, cfg.hidden_dim)
        self.vis_fc = nn.Linear(vis_dim, cfg.hidden_dim)
        self.multihead_attn = PackedMultiheadAttention(cfg.hidden_dim,
                                                       cfg.num_heads)

    def forward(self, vis: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        return self.multihead_attn(self.text_fc(text), self.vis_fc(vis))


class FusionModule(nn.Module):
    """image_tokens (b, f, n_vis, seen_vis_dim), image_proj
    (b, f, unseen_vis_dim), text_hidden (b, f, T, text_dim), frame_known
    (b, f) bool -> (b, f, T, hidden) UNet context."""

    def __init__(self, cfg: FusionConfig):
        super().__init__()
        self.seen_module = CrossFeatureStack(cfg, cfg.seen_vis_dim)
        self.unseen_module = CrossFeatureStack(cfg, cfg.unseen_vis_dim)

    def forward(self, image_tokens, image_proj, text_hidden, frame_known):
        seen = self.seen_module(image_tokens, text_hidden)
        unseen = self.unseen_module(image_proj[:, :, None, :], text_hidden)
        return torch.where(frame_known.bool()[:, :, None, None], seen, unseen)
