"""CLIP text and vision towers with projections — the counterpart of
`rcdms_tpu/models/clip.py`, written by hand with HF transformers' module
names (`text_model.embeddings.token_embedding`, `encoder.layers.i.
{self_attn.q_proj, mlp.fc1, layer_norm1}`, `vision_model.pre_layrnorm`, ...)
so that `convert_clip_text` / `convert_clip_vision` read their state dicts.

Text: causal mask, pooling at the first EOS token (robust to the resized
vocab). Vision: `last_hidden_state` without the post-LayerNorm, which
applies only to the pooled CLS token feeding the projection. The vision
self-attention (257 tokens, unmasked) runs on kernel A; the masked text
attention stays plain.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rcdms_tpu_torch.configs import CLIPTextConfig, CLIPVisionConfig
from rcdms_tpu_torch.core.layers import Conv, LayerNorm
from rcdms_tpu_torch.ops.attention import multihead_attention


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(name)


class _SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        o = multihead_attention(self.q_proj(x), self.k_proj(x),
                                self.v_proj(x), self.heads, mask,
                                row_sum="fp32")
        return self.out_proj(o)


class _MLP(nn.Module):
    def __init__(self, width: int, act: str):
        super().__init__()
        self.act = _act(act)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, act: str):
        super().__init__()
        self.layer_norm1 = LayerNorm(width)
        self.self_attn = _SelfAttention(width, heads)
        self.layer_norm2 = LayerNorm(width)
        self.mlp = _MLP(width, act)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, act: str):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(width, heads, act)
                                     for _ in range(layers)])

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.width)

    def flax_init_(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.position_embedding.weight)


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg.width, cfg.num_heads, cfg.num_layers,
                                cfg.hidden_act)
        self.final_layer_norm = LayerNorm(cfg.width)


class CLIPTextEncoder(nn.Module):
    """input_ids (b, T) -> (last_hidden_state (b, T, width) after the final
    LayerNorm, text_embeds (b, projection_dim))."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)
        self.text_projection = nn.Linear(cfg.width, cfg.projection_dim,
                                         bias=False)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        t = input_ids.shape[1]
        h = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[:t])
        causal = torch.full((t, t), torch.finfo(torch.float32).min,
                            device=h.device).triu(1)
        h = tm.final_layer_norm(tm.encoder(h, causal))
        eos = torch.argmax((input_ids == self.cfg.eos_token_id).int(), dim=-1)
        pooled = h[torch.arange(h.shape[0], device=h.device), eos]
        return h, self.text_projection(pooled)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.patch_embedding = Conv(3, cfg.width, cfg.patch_size,
                                    stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_pos, cfg.width)

    def flax_init_(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.class_embedding)
        nn.init.zeros_(self.position_embedding.weight)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b = pixels.shape[0]
        patches = self.patch_embedding(pixels).flatten(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        pos = self.position_embedding.weight
        return torch.cat([cls, patches], dim=1) + pos


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.width)  # HF's historical spelling
        self.encoder = _Encoder(cfg.width, cfg.num_heads, cfg.num_layers,
                                cfg.hidden_act)
        self.post_layernorm = LayerNorm(cfg.width)


class CLIPVisionEncoder(nn.Module):
    """pixels (b, H, W, 3), CLIP-preprocessed -> (last_hidden_state
    (b, 1+N, width), image_embeds (b, projection_dim))."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.width, cfg.projection_dim,
                                           bias=False)

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        vm = self.vision_model
        h = vm.encoder(vm.pre_layrnorm(vm.embeddings(pixels)))
        pooled = vm.post_layernorm(h[:, 0])
        return h, self.visual_projection(pooled)
