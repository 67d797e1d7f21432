"""Stage-2 sampler — the counterpart of `rcdms_tpu/sample/story_sampler.py`:
the story latents come from the UNet under DDIM (eta = 0) and
classifier-free guidance 2.0, with the two CFG branches run one after the
other (the JAX package's single-chip default) and the 9-channel input
[noisy | mask | masked-source latents] built each step. The fused
conditioning is computed once, outside the loop.

The initial latents are explicit (`init_latents`, raw randn) or drawn from
a `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from rcdms_tpu_torch.core.schedulers import DDIMSchedule, cfg_combine
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.sample.prior_sampler import draw_noise


class StoryConditioning(NamedTuple):
    text_hidden: torch.Tensor     # (b, f, T, text_dim) caption states
    text_hidden_u: torch.Tensor   # unconditional branch ("" captions)
    image_tokens: torch.Tensor    # (b, f, 257, 1664) CLIP tokens
    image_proj: torch.Tensor      # (b, f, 1280) stage-1 embeds
    frame_known: torch.Tensor     # (b, f) bool
    masked_latents: torch.Tensor  # (b, f, h8, w8, 4) VAE-encoded sources
    mask_label: torch.Tensor      # (b, f, h8, w8, 1) {0,1} masks


@dataclass(frozen=True)
class StorySampler:
    unet: StoryUNet
    fusion: FusionModule
    schedule: DDIMSchedule = field(
        default_factory=DDIMSchedule.stage2_inference)
    num_steps: int = 20
    guidance_scale: float = 2.0

    @torch.no_grad()
    def __call__(self, cond: StoryConditioning,
                 init_latents: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Returns (b, f, h8, w8, 4) fp32 latents (still VAE-scaled)."""
        b, f, h8, w8, _ = cond.masked_latents.shape
        dev = cond.masked_latents.device
        dtype = cond.text_hidden.dtype
        contexts = [self.fusion(cond.image_tokens, cond.image_proj,
                                cond.text_hidden, cond.frame_known)]
        do_cfg = self.guidance_scale > 1.0
        if do_cfg:
            contexts.insert(0, self.fusion(cond.image_tokens, cond.image_proj,
                                           cond.text_hidden_u,
                                           cond.frame_known))
        if init_latents is None:
            init_latents = draw_noise((b, f, h8, w8, 4), generator, dev)
        latents = init_latents.float()  # the schedule's init sigma is 1
        side = torch.cat([cond.mask_label, cond.masked_latents], dim=-1)

        ts = self.schedule.timesteps(self.num_steps)
        prev_ts = self.schedule.prev_timesteps(self.num_steps)
        for t, prev_t in zip(ts.tolist(), prev_ts.tolist()):
            x = torch.cat([latents, side.float()], dim=-1).to(dtype)
            tb = torch.full((b,), t, dtype=torch.int64, device=dev)
            preds = [self.unet(x, tb, ctx).float() for ctx in contexts]
            pred = (cfg_combine(preds[0], preds[1], self.guidance_scale)
                    if do_cfg else preds[0])
            latents = self.schedule.step(pred, t, prev_t, latents)
        return latents
