"""Stage-2 training: epsilon-prediction MSE on story latents, the story
UNet and the fusion stacks trained together, the port's counterpart of
`rcdms_tpu/train/stage2.py`.

The latents are noised at one timestep a story (DDPM scaled_linear
0.00085 -> 0.012) with an offset a channel of a frame; the fusion stacks
build the UNet's context, and the UNet takes [noisy | mask_label |
masked_latents] in the channel-last latent layout. `encode_batch` is the
frozen towers' pass (VAE encode with posterior noise, SD text, bigG
vision) under `torch.no_grad`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import OptimizerConfig
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.core.schedulers import DDPMSchedule
from rcdms_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.models.vae import VAE
from rcdms_tpu_torch.sample.pipeline import PipelineConfigs, for_inference
from rcdms_tpu_torch.sample.prior_sampler import draw_noise
from rcdms_tpu_torch.train.distributed import keep_rows
from rcdms_tpu_torch.train.loop import TrainNoise
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.train_state import TrainState


class Stage2Batch(NamedTuple):
    latents: torch.Tensor         # (b, f, h8, w8, 4) VAE(target) * 0.18215
    masked_latents: torch.Tensor  # (b, f, h8, w8, 4) VAE(source) * 0.18215
    mask_label: torch.Tensor      # (b, f, h8, w8, 1)
    image_tokens: torch.Tensor    # (b, f, 257, 1664)
    image_proj: torch.Tensor      # (b, f, 1280)
    text_hidden: torch.Tensor     # (b, f, T, 768)
    frame_known: torch.Tensor     # (b, f) bool


class Stage2Trainer(nn.Module):
    """The UNet and the fusion stacks (the trainable set) and the stage-2
    loss."""

    def __init__(self, unet: StoryUNet, fusion: FusionModule,
                 schedule: Optional[DDPMSchedule] = None,
                 noise_offset: float = 0.1):
        super().__init__()
        self.unet = unet
        self.fusion = fusion
        self.schedule = schedule or DDPMSchedule.stage2_train()
        self.noise_offset = noise_offset

    def draw_noise(self, batch: Stage2Batch,
                   generator: Optional[torch.Generator]) -> TrainNoise:
        b, f, _, _, c = batch.latents.shape
        return TrainNoise.draw(
            generator, batch.latents.shape,
            (b, f, 1, 1, c) if self.noise_offset else None, (b,),
            self.schedule.num_train_timesteps, batch.latents.device)

    def loss_fn(self, batch: Stage2Batch, noise: TrainNoise) -> torch.Tensor:
        """Mean squared error of the predicted noise. The fusion stacks'
        and the UNet's inputs are rounded to their dtype, as flax's Dense
        and Conv round them."""
        eps = noise.noise
        if self.noise_offset:
            eps = eps + self.noise_offset * noise.offset
        noisy = self.schedule.add_noise(batch.latents, eps, noise.t)
        dtype = self.unet.conv_in.weight.dtype
        context = self.fusion(batch.image_tokens.to(dtype),
                              batch.image_proj.to(dtype),
                              batch.text_hidden.to(dtype), batch.frame_known)
        x = torch.cat([noisy, batch.mask_label.to(noisy.dtype),
                       batch.masked_latents.to(noisy.dtype)], dim=-1)
        pred = self.unet(x.to(dtype), noise.t, context)
        return torch.mean((pred.float() - eps.float()) ** 2)


@torch.no_grad()
def encode_batch(vae: VAE, text_encoder: CLIPTextEncoder,
                 vision_encoder: CLIPVisionEncoder, raw: dict,
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 vae_scale: float = 0.18215) -> Stage2Batch:
    """The frozen towers' pass over a raw protocol batch: input_ids
    (b, f, T), reference_clip (b, f, 224, 224, 3), target and source
    pixels (b, f, H, W, 3) in [-1, 1], frame_known (b, f). The target's and
    the source's posteriors are sampled on `noise` (two fp32 standard
    normals of the latents' (b f, h8, w8, 4)), else on noise drawn from
    `generator`, target first, each drawn for the global batch of a
    process group, this rank keeping its rows (`distributed.keep_rows`).
    mask_label is rebuilt at latent resolution from frame_known."""
    ids = raw["input_ids"]
    b, f, t = ids.shape
    hidden, _ = text_encoder(ids.reshape(b * f, t))
    ref = raw["reference_clip"]
    tokens, embeds = vision_encoder(ref.reshape((b * f,) + ref.shape[2:]).to(
        vision_encoder.visual_projection.weight.dtype))

    def vae_encode(x, eps):
        mean, logvar = vae.encode(x.reshape((b * f,) + x.shape[2:]).to(
            vae.quant_conv.weight.dtype))
        if eps is None:
            eps = keep_rows(lambda s: draw_noise(s, generator, mean.device),
                            mean.shape)
        z = VAE.sample_latent(mean, logvar, eps) * vae_scale
        return z.reshape((b, f) + z.shape[1:])

    noise = noise or (None, None)
    latents = vae_encode(raw["target"], noise[0])
    h8, w8 = latents.shape[2:4]
    known = raw["frame_known"]
    return Stage2Batch(
        latents=latents,
        masked_latents=vae_encode(raw["source"], noise[1]),
        mask_label=known[:, :, None, None, None].to(latents.dtype).expand(
            b, f, h8, w8, 1),
        image_tokens=tokens.reshape((b, f) + tokens.shape[1:]),
        image_proj=embeds.reshape(b, f, -1),
        text_hidden=hidden.reshape(b, f, t, -1),
        frame_known=known)


def build_trainer(configs: PipelineConfigs,
                  optimizer: OptimizerConfig = OptimizerConfig(),
                  dtype=torch.bfloat16, noise_offset: float = 0.1,
                  seed: int = 0, device="cuda"
                  ) -> Tuple[TrainState, Tuple[VAE, CLIPTextEncoder,
                                               CLIPVisionEncoder]]:
    """Stage 2's state (UNet and fusion trained, compute in `dtype` over
    fp32 masters) and its frozen towers (VAE, SD text, bigG vision; in
    `dtype`, for `encode_batch`), with seeded random weights drawn like
    flax's initializers, on `device`."""
    device = torch.device(device)
    with device:
        trainer = Stage2Trainer(StoryUNet(configs.unet),
                                FusionModule(configs.fusion),
                                noise_offset=noise_offset)
        towers = (VAE(configs.vae), CLIPTextEncoder(configs.text_s2),
                  CLIPVisionEncoder(configs.vision))
    generator = torch.Generator(device).manual_seed(seed)
    for module in (trainer,) + towers:
        init_like_flax_(module, generator)
    state = TrainState.create(trainer, make_optimizer(optimizer), dtype)
    return state, tuple(for_inference(m, dtype) for m in towers)
