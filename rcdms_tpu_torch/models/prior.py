"""Stage-1 frame prior — the counterpart of `rcdms_tpu/models/prior.py`:
denoises the CLIP image embeddings of the story's frames, conditioned on
all captions and the known frames, with a temporal module after every
transformer block.

Per-frame token sequence (97 = 91 caption tokens + 6):

    [ text hidden (T) | text embed | known-image embed | mask embed |
      time embed | noisy embed x_t | learned prd token ]

under a causal mask plus the caption padding mask; the prediction is read
from the prd token. The spatial attention is masked, so it stays plain;
the temporal modules run on kernel B and every FF on kernels C/D.

Module names follow the reference's MyPriorTransformer, whose one
`transformer_blocks` list interleaves attention blocks (even indices) and
temporal modules (odd), as `convert_rcdms_prior` reads it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import PriorConfig
from rcdms_tpu_torch.core.attention import BasicTransformerBlock
from rcdms_tpu_torch.core.layers import (
    LayerNorm,
    TimestepEmbedding,
    sinusoidal_time_embedding,
)
from rcdms_tpu_torch.core.temporal import TemporalModule

NEG_INF = -10000.0  # the reference's additive-mask value


class FramePrior(nn.Module):
    """forward(x_t (b, f, d), timesteps (b, f), text_embed (b, f, d),
    text_hidden (b, f, T, d), image_embed (b, f, d), mask_embed (b, f, d),
    text_mask (b, f, T) bool) -> (b, f, d) predicted clean embeddings."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        self.cfg = cfg
        inner, d = cfg.inner_dim, cfg.embedding_dim
        self.time_embedding = TimestepEmbedding(inner, inner)
        self.encoder_hidden_states_proj = nn.Linear(d, inner)
        self.embedding_proj = nn.Linear(d, inner)
        self.embedding_proj1 = nn.Linear(d, inner)
        self.embedding_proj2 = nn.Linear(d, inner)
        self.proj_in = nn.Linear(d, inner)
        self.prd_embedding = nn.Parameter(torch.zeros(1, 1, inner))
        self.positional_embedding = nn.Parameter(
            torch.zeros(1, cfg.seq_len, inner))
        blocks = []
        for _ in range(cfg.num_layers):
            blocks.append(BasicTransformerBlock(
                inner, cfg.num_heads, cfg.head_dim, activation="gelu",
                attention_bias=True))
            blocks.append(TemporalModule(inner, cfg.temporal, prior_mode=True)
                          if cfg.use_temporal else nn.Identity())
        self.transformer_blocks = nn.ModuleList(blocks)
        self.norm_out = LayerNorm(inner)
        self.proj_to_clip_embeddings = nn.Linear(inner, d)

    def flax_init_(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.prd_embedding)
        nn.init.zeros_(self.positional_embedding)

    def forward(self, x_t, timesteps, text_embed, text_hidden, image_embed,
                mask_embed, text_mask):
        cfg = self.cfg
        b, f, _ = x_t.shape
        inner, seq = cfg.inner_dim, cfg.seq_len
        dtype = x_t.dtype

        # the time MLP is fp32, so h (and with it the residual stream of
        # every block) is fp32 in a bf16 model, as jnp's promotion makes it
        t_emb = sinusoidal_time_embedding(timesteps.reshape(b * f), inner)
        t_emb = self.time_embedding(t_emb.to(dtype)).reshape(b, f, 1, inner)
        h = torch.cat([
            self.encoder_hidden_states_proj(text_hidden),
            self.embedding_proj(text_embed)[:, :, None],
            self.embedding_proj1(image_embed)[:, :, None],
            self.embedding_proj2(mask_embed)[:, :, None],
            t_emb,
            self.proj_in(x_t)[:, :, None],
            self.prd_embedding.to(dtype).expand(b, f, 1, inner),
        ], dim=2) + self.positional_embedding.to(dtype)

        causal = torch.full((seq, seq), NEG_INF, device=h.device).triu(1)
        pad = (1.0 - text_mask.float()) * NEG_INF  # (b, f, T)
        pad = nn.functional.pad(pad, (0, seq - cfg.num_text_tokens))
        mask = pad[:, :, None, None, :] + causal   # (b, f, 1, seq, seq)

        for i in range(0, len(self.transformer_blocks), 2):
            h = self.transformer_blocks[i](h, mask=mask)
            h = self.transformer_blocks[i + 1](h)
        out = self.proj_to_clip_embeddings
        return out(self.norm_out(h)[:, :, -1].to(out.weight.dtype))

    def normalize(self, emb: torch.Tensor) -> torch.Tensor:
        """The training target: (emb - clip_mean) / clip_std."""
        return (emb - self.cfg.clip_mean) / self.cfg.clip_std

    def denormalize(self, latents: torch.Tensor) -> torch.Tensor:
        """`post_process_latents`: latents * clip_std + clip_mean."""
        return latents * self.cfg.clip_std + self.cfg.clip_mean
