"""Stage-1 training: denoise the frames' CLIP image embeddings with the
frame prior, the port's counterpart of `rcdms_tpu/train/stage1.py`.

The target is the normalized embedding of every real frame; the prior
predicts it (DDPM 'sample' prediction, squaredcos_cap_v2) from its noised
version at an independent timestep per frame, with a per-frame scalar
noise offset. `encode_batch` is the frozen towers' pass (bigG text and
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
from rcdms_tpu_torch.models.prior import FramePrior
from rcdms_tpu_torch.sample.pipeline import PipelineConfigs, for_inference
from rcdms_tpu_torch.train.loop import TrainNoise
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.train_state import TrainState


class Stage1Batch(NamedTuple):
    """The frozen towers' outputs that feed the prior (`encode_batch`)."""

    target_embed: torch.Tensor  # (b, f, d) CLIP embeds of every real frame
    source_embed: torch.Tensor  # (b, f, d) CLIP embeds of known/black frames
    mask_embed: torch.Tensor    # (b, f, d) CLIP embeds of the mask images
    text_embed: torch.Tensor    # (b, f, d)
    text_hidden: torch.Tensor   # (b, f, T, d)
    text_mask: torch.Tensor     # (b, f, T) bool


class Stage1Trainer(nn.Module):
    """The prior (the trainable set) and the stage-1 loss."""

    def __init__(self, prior: FramePrior,
                 schedule: Optional[DDPMSchedule] = None,
                 noise_offset: float = 0.1):
        super().__init__()
        self.prior = prior
        self.schedule = schedule or DDPMSchedule.stage1_train()
        self.noise_offset = noise_offset

    def draw_noise(self, batch: Stage1Batch,
                   generator: Optional[torch.Generator]) -> TrainNoise:
        b, f, d = batch.target_embed.shape
        return TrainNoise.draw(
            generator, (b, f, d), (b, f, 1) if self.noise_offset else None,
            (b, f), self.schedule.num_train_timesteps,
            batch.target_embed.device)

    def loss_fn(self, batch: Stage1Batch, noise: TrainNoise) -> torch.Tensor:
        """Mean squared error of the predicted normalized embeddings. The
        prior's inputs are rounded to its dtype, as flax's Dense rounds
        them."""
        target = self.prior.normalize(batch.target_embed)
        eps = noise.noise
        if self.noise_offset:
            eps = eps + self.noise_offset * noise.offset
        noisy = self.schedule.add_noise(target, eps, noise.t)
        dtype = self.prior.proj_in.weight.dtype
        pred = self.prior(
            noisy.to(dtype), noise.t, batch.text_embed.to(dtype),
            batch.text_hidden.to(dtype), batch.source_embed.to(dtype),
            batch.mask_embed.to(dtype), batch.text_mask)
        return torch.mean((pred.float() - target.float()) ** 2)


def _encode_images(vision: CLIPVisionEncoder, x: torch.Tensor
                   ) -> torch.Tensor:
    b, f = x.shape[:2]
    _, embeds = vision(x.reshape((b * f,) + x.shape[2:]).to(
        vision.visual_projection.weight.dtype))
    return embeds.reshape(b, f, -1)


@torch.no_grad()
def encode_batch(text_encoder: CLIPTextEncoder,
                 vision_encoder: CLIPVisionEncoder, raw: dict) -> Stage1Batch:
    """The frozen towers' pass over a raw protocol batch (the keys of
    `data/protocol.py`): input_ids (b, f, T), text_mask (b, f, T), and the
    CLIP-preprocessed reference_clip, source_clip and mask_clip
    (b, f, 224, 224, 3)."""
    ids = raw["input_ids"]
    b, f, t = ids.shape
    hidden, embeds = text_encoder(ids.reshape(b * f, t))
    return Stage1Batch(
        target_embed=_encode_images(vision_encoder, raw["reference_clip"]),
        source_embed=_encode_images(vision_encoder, raw["source_clip"]),
        mask_embed=_encode_images(vision_encoder, raw["mask_clip"]),
        text_embed=embeds.reshape(b, f, -1),
        text_hidden=hidden.reshape(b, f, t, -1),
        text_mask=raw["text_mask"])


def build_trainer(configs: PipelineConfigs,
                  optimizer: OptimizerConfig = OptimizerConfig(
                      grad_clip_norm=10.0),
                  dtype=torch.bfloat16, noise_offset: float = 0.1,
                  seed: int = 0, device="cuda"
                  ) -> Tuple[TrainState, Tuple[CLIPTextEncoder,
                                               CLIPVisionEncoder]]:
    """Stage 1's state (the prior trained, compute in `dtype` over fp32
    masters) and its frozen towers (bigG text, bigG vision; in `dtype`,
    for `encode_batch`), with seeded random weights drawn like flax's
    initializers, on `device`."""
    device = torch.device(device)
    with device:
        trainer = Stage1Trainer(FramePrior(configs.prior),
                                noise_offset=noise_offset)
        towers = (CLIPTextEncoder(configs.text_s1),
                  CLIPVisionEncoder(configs.vision))
    generator = torch.Generator(device).manual_seed(seed)
    for module in (trainer,) + towers:
        init_like_flax_(module, generator)
    state = TrainState.create(trainer, make_optimizer(optimizer), dtype)
    return state, tuple(for_inference(m, dtype) for m in towers)
