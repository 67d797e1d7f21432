"""Stage-1 sampler — the counterpart of `rcdms_tpu/sample/prior_sampler.py`:
denoise the frames' CLIP image embeddings with the frame prior under
classifier-free guidance (batch-doubled [uncond | cond]) and the UnCLIP
scheduler.

Noise is explicit: pass `init_latents` (b, f, d) and `step_noise`
(num_steps, b, f, d), as the JAX sampler takes them, or a
`torch.Generator` that `draw` draws them from (init first, then one draw
a step).

`autoregressive` is the reference's `--autoreg` protocol: one full
sampling pass per frame, each committing its frame's prediction.

`mesh` (`train.sharding.inference_mesh`, `--shard-story`): the frames
split over the ranks of one CFG branch (`branch_group`, the JAX
sampler's ('frame', 'space'), padded as GSPMD pads them: a rank may hold
none), whose per-frame attention is local and whose temporal modules
trade frames for tokens over that group (`core.spatial.spatial`). With
CFG and a cfg axis of 2, the ranks of cfg index c run branch c alone
(uncond 0, cond 1) and exchange their predictions of the same frames
over the cfg group for the guidance mix. The embeddings are gathered
whole at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import torch

from rcdms_tpu_torch.core import spatial
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
    mesh: object = None

    @torch.no_grad()
    def __call__(self, cond: PriorConditioning,
                 init_latents: Optional[torch.Tensor] = None,
                 step_noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Returns (b, f, d) denormalized embeddings, fp32."""
        b, f, _ = cond.text_embed.shape
        dev = cond.text_embed.device
        dtype = cond.text_embed.dtype
        if init_latents is None and step_noise is None:
            init_latents, step_noise = self.draw(b, f, generator)
        elif init_latents is None or step_noise is None:
            raise ValueError("pass both init_latents and step_noise, or "
                             "neither and a generator")
        do_cfg = self.guidance_scale > 1.0
        split_cfg = self.mesh is not None and self.mesh.split_cfg(do_cfg)
        branch = (self.mesh.branch_group if self.mesh is not None
                  else spatial.ONE_RANK)
        frames = spatial.FrameSplit(branch, f)
        table = spatial.blocks(f, branch.size)

        def pair(u, c):
            if split_cfg:
                return (u, c)[self.mesh.c]
            return torch.cat([u, c]) if do_cfg else c

        def local_pair(u, c):  # of this rank's frames
            return pair(spatial.narrow(u, 1, branch, table),
                        spatial.narrow(c, 1, branch, table))

        # the schedule's init sigma is 1
        latents = spatial.narrow(init_latents.float(), 1, branch, table)
        step_noise = spatial.narrow(step_noise, 2, branch, table)
        args = (local_pair(cond.text_embed_u, cond.text_embed),
                local_pair(cond.text_hidden_u, cond.text_hidden),
                local_pair(cond.image_embed, cond.image_embed),
                local_pair(cond.mask_embed, cond.mask_embed))
        text_mask = local_pair(cond.text_mask_u, cond.text_mask)
        ts = self.schedule.timesteps(self.num_steps)
        prev_ts = self.schedule.prev_timesteps(self.num_steps)
        for i, (t, prev_t) in enumerate(zip(ts.tolist(), prev_ts.tolist())):
            x = pair(latents, latents).to(dtype)
            tb = torch.full(x.shape[:2], t, dtype=torch.int64, device=dev)
            with spatial.spatial(frames=frames):
                pred = self.model(x, tb, args[0], args[1], args[2],
                                  args[3], text_mask).float()
            if split_cfg:
                pred = cfg_combine(*spatial.gather_list(
                    pred, self.mesh.cfg_group), self.guidance_scale)
            elif do_cfg:
                pred = cfg_combine(*pred.chunk(2), self.guidance_scale)
            latents = self.schedule.step(pred, t, prev_t, latents,
                                         step_noise[i].float())
        return self.model.denormalize(spatial.gather(latents, 1, branch,
                                                     table))

    def draw(self, b: int, f: int, generator: Optional[torch.Generator]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One pass's noise from `generator`, on the model's device: the
        init (b, f, d), then one (b, f, d) draw a step, stacked to
        (num_steps, b, f, d)."""
        shape = (b, f, self.model.cfg.embedding_dim)
        dev = next(self.model.parameters()).device
        init = draw_noise(shape, generator, dev)
        return init, torch.stack([draw_noise(shape, generator, dev)
                                  for _ in range(self.num_steps)])

    def draw_passes(self, b: int, f: int,
                    generator: Optional[torch.Generator]
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The noise of `autoregressive`'s f passes: one `draw` a pass."""
        return [self.draw(b, f, generator) for _ in range(f)]

    @torch.no_grad()
    def autoregressive(self, cond: PriorConditioning,
                       white_mask_embed: torch.Tensor,
                       frame_known: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[list] = None) -> torch.Tensor:
        """One-frame-at-a-time generation (`PriorSampler.autoregressive` of
        the JAX package): after pass i, frame i's predicted embedding is
        committed as a known-frame condition, and its mask embed flipped to
        `white_mask_embed` (b, d), unless frame i was known. `frame_known`
        (b, f) defaults to the frames whose mask embed equals the white
        one. `noise`: f pairs (init (b, f, d), steps (num_steps, b, f, d)),
        one a pass; else `draw_passes` draws them from `generator`.

        Returns (b, f, d) embeddings in `cond.image_embed`'s dtype: the
        known frames' conditions unchanged, the others predicted."""
        b, f = cond.image_embed.shape[:2]
        if noise is None:
            noise = self.draw_passes(b, f, generator)
        image_embed = cond.image_embed.clone()
        mask_embed = cond.mask_embed.clone()
        white = white_mask_embed.to(mask_embed.dtype)
        known = (frame_known.bool() if frame_known is not None else
                 torch.isclose(mask_embed, white[:, None, :]).all(-1))
        result = image_embed.clone()
        for i in range(f):
            c = cond._replace(image_embed=image_embed.clone(),
                              mask_embed=mask_embed.clone())
            pred = self(c, *noise[i])
            commit = ~known[:, i, None]
            new = torch.where(commit, pred[:, i].to(image_embed.dtype),
                              image_embed[:, i])
            result[:, i] = new
            image_embed[:, i] = new
            mask_embed[:, i] = torch.where(commit, white, mask_embed[:, i])
        return result
