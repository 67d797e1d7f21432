"""Stage-2 sampler — the counterpart of `rcdms_tpu/sample/story_sampler.py`:
the story latents come from the UNet under DDIM and classifier-free
guidance 2.0, with the 9-channel input [noisy | mask | masked-source
latents] built each step. The fused conditioning is computed once, outside
the loop.

Options, as the JAX sampler's fields:
  * `sequential_cfg` (default): the two CFG branches run one after the
    other (the JAX package's single-chip default); False runs one UNet
    call on the CFG-doubled batch [uncond | cond], side inputs doubled;
  * `eta` > 0: stochastic DDIM, one noise draw a step;
  * `encoder_propagation` k >= 2: the UNet's down path runs only on steps
    i with i % k == 0; each CFG branch keeps its own cached (h, skips),
    and the decoder runs every step under that step's time embedding.
    This changes the numbers; k <= 1 (default 0) is the exact path.

The initial latents and the step noise are explicit (`init_latents`, raw
randn; `step_noise` (num_steps, b, f, h8, w8, 4)) or drawn from a
`torch.Generator` by `draw`: the init first, then, with eta > 0, one draw
a step.

`mesh` (`train.sharding.inference_mesh`, `--shard-story`): the inputs
and the output stay whole on every rank. Each rank keeps its block of
frames over the mesh's frame group and its block of latent rows over its
space group (`core.spatial`: uneven blocks, as GSPMD pads them), under
`core.spatial.spatial`: the UNet's temporal modules trade frames for
tokens over the frame group, its other layers split rows. With CFG and a
cfg axis of 2, the ranks of cfg index c run branch c alone (uncond 0,
cond 1) and exchange their predictions over the cfg group; without CFG
both run the one branch. The fusion contexts (per frame), the side
input, the noise and the encoder propagation's cache are local frames
and rows too; the latents are gathered whole at the end. An int8 conv's
activation scale is the maximum over the ranks of its CFG branch, or
over every rank where one process would batch both branches
(`sequential_cfg=False`), the tensor one process quantizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.schedulers import DDIMSchedule, cfg_combine
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.sample.prior_sampler import draw_noise
from rcdms_tpu_torch.utils.logging import span


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
    eta: float = 0.0
    sequential_cfg: bool = True
    encoder_propagation: int = 0
    mesh: object = None

    def _unet(self, x, t: int, ctx, cache, is_key: bool):
        """One UNet call at timestep t -> (prediction fp32, cache). With
        encoder propagation the down path runs only when `is_key`, else
        the cached encoding is decoded under this step's embedding."""
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        with span("unet"):
            if self.encoder_propagation < 2:
                pred = self.unet(x, tb, ctx)
            else:
                temb = self.unet.time_embed(tb, x.dtype)
                if is_key:
                    cache = self.unet.encode(x, temb, ctx)
                pred = self.unet.decode(*cache, temb, ctx)
        return pred.float(), cache

    @torch.no_grad()
    def __call__(self, cond: StoryConditioning,
                 init_latents: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Returns (b, f, h8, w8, 4) fp32 latents (still VAE-scaled)."""
        b, f, h8, w8, _ = cond.masked_latents.shape
        dtype = cond.text_hidden.dtype
        do_cfg = self.guidance_scale > 1.0
        mesh = self.mesh
        levels = len(self.unet.cfg.block_channels)
        space = frames = whole = spatial.ONE_RANK
        split_cfg = mesh is not None and mesh.split_cfg(do_cfg)
        if mesh is not None:
            space, frames = mesh.space_group, mesh.frame_group
            spatial.check_rows(h8, levels, space, "the UNet's latent rows")
            # the ranks that hold a UNet call's whole input in one process:
            # one CFG branch, or both where one process batches them
            whole = (mesh.all if split_cfg and not self.sequential_cfg
                     else mesh.branch_group)
        rows = spatial.RowPlan(space, h8, w8, levels)
        split = spatial.FrameSplit(frames, f)
        frame_table = spatial.blocks(f, frames.size)
        row_table = rows.blocks(w8)

        def local(x, frame_axis, maps=False):
            """This rank's frames of x, and its rows where x holds maps."""
            x = spatial.narrow(x, frame_axis, frames, frame_table)
            return (spatial.narrow(x, frame_axis + 1, space, row_table)
                    if maps else x)

        hidden = ([cond.text_hidden_u, cond.text_hidden] if do_cfg
                  else [cond.text_hidden])
        if split_cfg:  # this rank's branch alone
            hidden = [hidden[mesh.c]]
        contexts = [self.fusion(local(cond.image_tokens, 1),
                                local(cond.image_proj, 1), local(th, 1),
                                local(cond.frame_known, 1))
                    for th in hidden]
        if init_latents is None and step_noise is None:
            init_latents, step_noise = self.draw((b, f, h8, w8, 4),
                                                 generator)
        elif init_latents is None:
            raise ValueError("pass init_latents with step_noise, or neither "
                             "and a generator")
        if self.eta > 0.0 and step_noise is None:
            raise ValueError("eta > 0 needs step_noise with init_latents")
        # the schedule's init sigma is 1
        latents = local(init_latents.float(), 1, maps=True)
        side = local(torch.cat([cond.mask_label, cond.masked_latents],
                               dim=-1).float(), 1, maps=True)
        if step_noise is not None:
            step_noise = local(step_noise, 2, maps=True)
        batched = do_cfg and not self.sequential_cfg and not split_cfg
        if batched:
            contexts = [torch.cat(contexts)]
            side = torch.cat([side, side])
        caches = [None] * len(contexts)

        k = self.encoder_propagation
        ts = self.schedule.timesteps(self.num_steps)
        prev_ts = self.schedule.prev_timesteps(self.num_steps)
        with spatial.step_loop():
            for i, (t, prev_t) in enumerate(zip(ts.tolist(),
                                                prev_ts.tolist())):
                with span("story.step"):
                    lat = (torch.cat([latents, latents]) if batched
                           else latents)
                    x = torch.cat([lat, side], dim=-1).to(dtype)
                    preds = []
                    with spatial.spatial(rows, split, whole):
                        for j, ctx in enumerate(contexts):
                            pred, caches[j] = self._unet(
                                x, t, ctx, caches[j], k < 2 or i % k == 0)
                            preds.append(pred)
                    if batched:
                        preds = list(preds[0].chunk(2))
                    elif split_cfg:
                        preds = spatial.gather_list(preds[0], mesh.cfg_group)
                    pred = (cfg_combine(preds[0], preds[1],
                                        self.guidance_scale)
                            if do_cfg else preds[0])
                    noise = step_noise[i].float() if self.eta > 0.0 else None
                    latents = self.schedule.step(pred, t, prev_t, latents,
                                                 eta=self.eta, noise=noise)
        latents = spatial.gather(latents, 2, space, row_table)
        return spatial.gather(latents, 1, frames, frame_table)

    def draw(self, shape, generator: Optional[torch.Generator]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The noise of one call from `generator`, on the UNet's device:
        the init latents of `shape` (b, f, h8, w8, 4), then, with eta > 0,
        one draw a step stacked to (num_steps,) + shape (else None)."""
        dev = self.unet.conv_in.weight.device
        init = draw_noise(shape, generator, dev)
        steps = (torch.stack([draw_noise(shape, generator, dev)
                              for _ in range(self.num_steps)])
                 if self.eta > 0.0 else None)
        return init, steps
