"""Attention stack of the port — the counterpart of
`rcdms_tpu/core/attention.py`: multi-head (self, cross and frame-axis)
attention, the BasicTransformerBlock and the spatial transformer.

State-dict names are diffusers' (`to_q`, `to_out.0`, `transformer_blocks`,
...), the names `rcdms_tpu/io/convert.py` reads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from rcdms_tpu_torch.core.layers import FeedForward, GroupNorm, LayerNorm
from rcdms_tpu_torch.ops.attention import multihead_attention
from rcdms_tpu_torch.ops.frame_attention import frame_attention


class Attention(nn.Module):
    """to_q / to_k / to_v (optional bias) -> attention -> to_out.0.

    frame_axis=False: x (..., S, dim), optional context (..., Skv, ctx_dim)
    with the same leading dims, optional additive mask; routed by
    `ops.attention.multihead_attention` (kernel A for long unmasked
    queries). frame_axis=True: x (b, f, n, dim), attention across f at every
    token (kernel B)."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, qkv_bias: bool = False,
                 frame_axis: bool = False):
        super().__init__()
        inner = heads * head_dim
        ctx = context_dim or query_dim
        self.heads = heads
        self.frame_axis = frame_axis
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # a bf16 projection of an fp32 stream (the prior's) takes its input
        # rounded, as flax's Dense casts it
        x = x.to(self.to_q.weight.dtype)
        ctx = x if context is None else context.to(x.dtype)
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if self.frame_axis:
            if context is not None or mask is not None:
                raise ValueError("frame-axis attention is self-attention "
                                 "without a mask")
            o = frame_attention(q, k, v, self.heads)
        else:
            o = multihead_attention(q, k, v, self.heads, mask,
                                    row_sum="rounded")
        return self.to_out[0](o)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> [LN -> cross-attn] -> LN -> FF, all residual. The
    residual stream keeps its input's dtype: fp32 in the prior of a bf16
    model (each branch rounded to the model dtype, then added), as the JAX
    package's promotion gives it."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None,
                 activation: str = "geglu", attention_bias: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=attention_bias)
        self.use_cross = context_dim is not None
        if self.use_cross:
            self.norm2 = LayerNorm(dim)
            self.attn2 = Attention(dim, heads, head_dim, context_dim,
                                   qkv_bias=attention_bias)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, activation)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), mask=mask)
        if self.use_cross:
            x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


def _squeeze_1x1_(state_dict: dict, keys) -> None:
    """SD1.5 checkpoints store these projections as 1x1 convs
    (out, in, 1, 1); the port holds them as Linear (out, in)."""
    for key in keys:
        w = state_dict.get(key)
        if w is not None and w.dim() == 4:
            state_dict[key] = w[:, :, 0, 0]


class SpatialTransformer(nn.Module):
    """Spatial self+cross attention over each frame's h*w tokens (diffusers
    Transformer2DModel with 1x1 projections): GroupNorm -> proj_in ->
    blocks -> proj_out -> +residual. x (b, f, h, w, c); context
    (b, f, T, ctx_dim)."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, norm_groups: int = 32,
                 num_layers: int = 1):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, context_dim)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, channels)
        self._register_load_state_dict_pre_hook(
            lambda sd, prefix, *_: _squeeze_1x1_(
                sd, (prefix + "proj_in.weight", prefix + "proj_out.weight")))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(b, f, hh * ww, c))
        for block in self.transformer_blocks:
            h = block(h, context=context)
        return self.proj_out(h).reshape(x.shape) + x
