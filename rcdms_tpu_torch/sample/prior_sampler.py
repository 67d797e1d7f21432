"""Stage-1 sampler — the counterpart of `rcdms_tpu/sample/prior_sampler.py`:
denoise the frames' CLIP image embeddings with the frame prior under
classifier-free guidance (batch-doubled [uncond | cond]) and the UnCLIP
scheduler.

Noise is explicit: pass `init_latents` (b, f, d) and `step_noise`
(num_steps, b, f, d), as the JAX sampler takes them, or a
`torch.Generator` that draws them (init first, then one draw per step).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from rcdms_tpu_torch.core.schedulers import UnCLIPSchedule, cfg_combine
from rcdms_tpu_torch.models.prior import FramePrior


class PriorConditioning(NamedTuple):
    """CFG-paired conditioning; `*_u` is the unconditional ("" caption)
    branch. Image and mask embeddings are shared by both branches."""

    text_embed: torch.Tensor    # (b, f, d)
    text_hidden: torch.Tensor   # (b, f, T, d)
    text_mask: torch.Tensor     # (b, f, T) bool
    text_embed_u: torch.Tensor
    text_hidden_u: torch.Tensor
    text_mask_u: torch.Tensor
    image_embed: torch.Tensor   # (b, f, d) known-frame embeds (black if none)
    mask_embed: torch.Tensor    # (b, f, d) white/black mask-image embeds


def draw_noise(shape, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """fp32 standard normal noise from `generator` (required)."""
    if generator is None:
        raise ValueError("pass explicit noise or a torch.Generator")
    return torch.randn(shape, generator=generator, device=device)


@dataclass(frozen=True)
class PriorSampler:
    model: FramePrior
    schedule: UnCLIPSchedule = field(default_factory=UnCLIPSchedule)
    num_steps: int = 20
    guidance_scale: float = 2.0

    @torch.no_grad()
    def __call__(self, cond: PriorConditioning,
                 init_latents: Optional[torch.Tensor] = None,
                 step_noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Returns (b, f, d) denormalized embeddings, fp32."""
        b, f, _ = cond.text_embed.shape
        d = self.model.cfg.embedding_dim
        dev = cond.text_embed.device
        dtype = cond.text_embed.dtype
        if init_latents is None:
            init_latents = draw_noise((b, f, d), generator, dev)
        latents = init_latents.float()  # the schedule's init sigma is 1
        do_cfg = self.guidance_scale > 1.0

        def pair(u, c):
            return torch.cat([u, c]) if do_cfg else c

        args = (pair(cond.text_embed_u, cond.text_embed),
                pair(cond.text_hidden_u, cond.text_hidden),
                pair(cond.image_embed, cond.image_embed),
                pair(cond.mask_embed, cond.mask_embed))
        text_mask = pair(cond.text_mask_u, cond.text_mask)
        ts = self.schedule.timesteps(self.num_steps)
        prev_ts = self.schedule.prev_timesteps(self.num_steps)
        for i, (t, prev_t) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
            x = pair(latents, latents).to(dtype)
            tb = torch.full(x.shape[:2], t, dtype=torch.int64, device=dev)
            pred = self.model(x, tb, args[0], args[1], args[2], args[3],
                              text_mask).float()
            if do_cfg:
                pred = cfg_combine(*pred.chunk(2), self.guidance_scale)
            noise = (step_noise[i].float() if step_noise is not None
                     else draw_noise(latents.shape, generator, dev))
            latents = self.schedule.step(pred, t, prev_t, latents, noise)
        return self.model.denormalize(latents)
