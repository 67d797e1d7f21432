"""Two-stage story pipeline — the counterpart of
`rcdms_tpu/sample/pipeline.py`: captions + known frames -> 5-frame story.

Stage 1 encodes the captions (bigG text tower) and the known frames (bigG
vision tower) and samples the unknown frames' CLIP embeddings with the
frame prior. Stage 2 encodes the captions again (SD text tower), encodes
the known frames' pixels with the VAE, samples the story latents with the
UNet, and decodes them frame by frame.

`generate` takes a per-request `torch.Generator` or explicit `StoryNoise`;
`StoryNoise.draw` draws one request's noise as `generate` would draw it,
and `StoryNoise.cat` stacks requests into a batch, so a request gets the
same noise alone and inside a batch. `generate_stage1_autoreg` is the
stage-1-only autoregressive protocol. Public tensors keep the JAX
package's layouts ((b, f, H, W, 3) images, (b, f, T) token ids).

With a `mesh` (`train.sharding.inference_mesh`, `--shard-story`) one
story is split over the ranks of a process group: the towers split their
b*f batch of captions and images over every rank and all-gather their
outputs (a rank may hold none, as GSPMD pads 5 frames over 4 or 8 ranks;
it still joins the gather), the samplers split their CFG branches, frames
and latent rows (`sample/*_sampler.py`), and the VAE encodes and decodes
a block of image rows on each rank (`core.spatial.RowPlan` over every
rank: uneven blocks, whole granules of its stride-2 levels), whose
results are all-gathered. `precompute_cond_cache` stays whole. The noise
is drawn whole on every rank from the same generator, each rank keeping
its frames and rows, and `generate` returns whole frames and embeds on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    FusionConfig,
    PriorConfig,
    StoryUNetConfig,
    TemporalConfig,
    VAEConfig,
)
from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.core.schedulers import DDIMSchedule
from rcdms_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.prior import FramePrior
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.models.vae import VAE
from rcdms_tpu_torch.sample.prior_sampler import (
    PriorConditioning,
    PriorSampler,
    draw_noise,
)
from rcdms_tpu_torch.sample.story_sampler import (
    StoryConditioning,
    StorySampler,
)


class StoryInputs(NamedTuple):
    """tokens_s1 / tokens_s1_u: (b, f, T) caption ids (and "" uncond) for the
    stage-1 (bigG) tower; tokens_s2 / tokens_s2_u: the same for the stage-2
    (SD) tower. source_clip / mask_clip: (b, f, 224, 224, 3) CLIP-
    preprocessed known frames (black where unknown) and white/black mask
    images. source_pixels: (b, f, H, W, 3) in [-1, 1]. frame_known:
    (b, f) bool."""

    tokens_s1: torch.Tensor
    tokens_s1_u: torch.Tensor
    tokens_s2: torch.Tensor
    tokens_s2_u: torch.Tensor
    source_clip: torch.Tensor
    mask_clip: torch.Tensor
    source_pixels: torch.Tensor
    frame_known: torch.Tensor


class CondCache(NamedTuple):
    """Story-independent conditioning, computed once per loaded model:
    the uncond caption through both text towers and the white/black mask
    images through the vision tower (`precompute_cond_cache`)."""

    s1_hidden_u: torch.Tensor  # (T1, d1)
    s1_embed_u: torch.Tensor   # (d1,)
    s2_hidden_u: torch.Tensor  # (T2, d2)
    white_embed: torch.Tensor  # (d,)
    black_embed: torch.Tensor  # (d,)


class StoryNoise(NamedTuple):
    """Every random draw of one `generate` call, fp32 standard normal; the
    story sampler's step noise only where it has eta > 0."""

    prior_init: torch.Tensor   # (b, f, d)
    prior_steps: torch.Tensor  # (num_steps, b, f, d)
    vae: torch.Tensor          # (b*f, h8, w8, 4)
    story_init: torch.Tensor   # (b, f, h8, w8, 4)
    story_steps: Optional[torch.Tensor] = None  # (num_steps, b, f, h8, w8, 4)

    @classmethod
    def draw(cls, pipeline: "StoryPipeline", b: int,
             generator: Optional[torch.Generator], image_size
             ) -> "StoryNoise":
        """The noise of one `pipeline.generate` call on a batch of b
        stories of `image_size` pixels (an int or (H, W)), drawn from
        `generator` in this order: the prior sampler's (`draw`: init, one
        draw a step), the VAE's, the story sampler's (`draw`: init and,
        with eta > 0, one draw a step)."""
        cfg = pipeline.configs
        f = cfg.prior.num_frames
        hh, ww = ((image_size, image_size) if isinstance(image_size, int)
                  else image_size)
        down = 2 ** (len(cfg.vae.block_channels) - 1)
        lat = (b, f, hh // down, ww // down, 4)
        prior = pipeline.prior_sampler.draw(b, f, generator)
        vae = draw_noise((b * f,) + lat[2:], generator, pipeline.device)
        return cls(*prior, vae,
                   *pipeline.story_sampler.draw(lat, generator))

    @classmethod
    def cat(cls, noises) -> "StoryNoise":
        """Requests' noise stacked along b, in order."""
        noises = list(noises)
        steps = [n.story_steps for n in noises]
        return cls(torch.cat([n.prior_init for n in noises]),
                   torch.cat([n.prior_steps for n in noises], dim=1),
                   torch.cat([n.vae for n in noises]),
                   torch.cat([n.story_init for n in noises]),
                   None if steps[0] is None else torch.cat(steps, dim=1))


@dataclasses.dataclass(frozen=True)
class PipelineConfigs:
    text_s1: CLIPTextConfig
    text_s2: CLIPTextConfig
    vision: CLIPVisionConfig
    vae: VAEConfig
    prior: PriorConfig
    unet: StoryUNetConfig
    fusion: FusionConfig


def full_configs(max_text_len: int = 91, vocab_size: int = 49412,
                 temporal_zero_init: bool = True) -> PipelineConfigs:
    """The repository's full-width configs (Flintstones by default: 91
    caption tokens, vocab 49412). temporal_zero_init=False starts the
    temporal modules' output projections random instead of zero, so that
    random weights exercise the temporal attention end to end."""
    temporal = TemporalConfig(zero_init_output=temporal_zero_init)
    return PipelineConfigs(
        text_s1=CLIPTextConfig.bigg(max_text_len, vocab_size),
        text_s2=CLIPTextConfig.sd15(max_text_len, vocab_size),
        vision=CLIPVisionConfig(),
        vae=VAEConfig(),
        prior=PriorConfig(num_text_tokens=max_text_len, temporal=temporal),
        unet=StoryUNetConfig(temporal=temporal),
        fusion=FusionConfig())


def tiny_configs(unet_channels: Optional[tuple] = None) -> PipelineConfigs:
    """The configs of the JAX package's `build_tiny_pipeline` (5 frames)."""
    prior = PriorConfig.tiny()
    ukw = {"block_channels": unet_channels} if unet_channels else {}
    unet = StoryUNetConfig.tiny(**ukw)
    fusion = FusionConfig.tiny(hidden_dim=unet.cross_attention_dim,
                               text_dim=unet.cross_attention_dim,
                               unseen_vis_dim=prior.embedding_dim)
    t = prior.num_text_tokens
    return PipelineConfigs(
        text_s1=CLIPTextConfig.tiny(max_positions=t,
                                    width=prior.embedding_dim,
                                    projection_dim=prior.embedding_dim),
        text_s2=CLIPTextConfig.tiny(max_positions=t,
                                    width=unet.cross_attention_dim,
                                    projection_dim=unet.cross_attention_dim),
        vision=CLIPVisionConfig.tiny(width=fusion.seen_vis_dim,
                                     projection_dim=prior.embedding_dim),
        vae=VAEConfig.tiny(), prior=prior, unet=unet, fusion=fusion)


def padding_mask(tokens: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """True for real tokens: everything up to and including the first EOS
    (all True where a row has no EOS)."""
    is_eos = tokens == eos_token_id
    eos_pos = torch.argmax(is_eos.int(), dim=-1)
    idx = torch.arange(tokens.shape[-1], device=tokens.device)
    mask = idx <= eos_pos[..., None]
    return torch.where(is_eos.any(-1, keepdim=True), mask,
                       torch.ones_like(mask))


# the towers of a pipeline: attribute (the JAX package's parameter key) ->
# module class, built from the config of the same name
_TOWERS = {"text_s1": CLIPTextEncoder, "text_s2": CLIPTextEncoder,
           "vision": CLIPVisionEncoder, "vae": VAE, "prior": FramePrior,
           "unet": StoryUNet, "fusion": FusionModule}


class StoryPipeline(nn.Module):
    """The five towers (text_s1, text_s2, vision, vae, prior, unet, fusion —
    the JAX package's parameter keys) and the two samplers."""

    vae_scale = 0.18215  # SD's latent scaling factor

    def __init__(self, configs: PipelineConfigs, num_steps: int = 20,
                 guidance_scale: float = 2.0,
                 schedule: Optional[DDIMSchedule] = None,
                 towers: Optional[Mapping[str, nn.Module]] = None,
                 eta: float = 0.0, encoder_propagation: int = 0,
                 sequential_cfg: bool = True, mesh=None):
        """`towers`: prebuilt towers by name (the CLIs' builders, a loaded
        checkpoint); the others are built from `configs`. `schedule`
        replaces the stage-2 DDIM schedule (a `--config` YAML's). `eta`,
        `encoder_propagation` and `sequential_cfg` are the story
        sampler's options (`sample/story_sampler.py`); `mesh` splits each
        story over the ranks of a group (module docstring)."""
        super().__init__()
        self.configs = configs
        self.mesh = mesh
        towers = towers or {}
        for name, cls in _TOWERS.items():
            setattr(self, name, towers[name] if name in towers
                    else cls(getattr(configs, name)))
        self.prior_sampler = PriorSampler(self.prior, num_steps=num_steps,
                                          guidance_scale=guidance_scale,
                                          mesh=mesh)
        self.story_sampler = StorySampler(
            self.unet, self.fusion,
            schedule=schedule or DDIMSchedule.stage2_inference(),
            num_steps=num_steps, guidance_scale=guidance_scale, eta=eta,
            sequential_cfg=sequential_cfg,
            encoder_propagation=encoder_propagation, mesh=mesh)

    def with_sampler(self, **options) -> "StoryPipeline":
        """A pipeline over these towers, with this one's steps, guidance,
        schedule and mesh, and the story sampler's `options` (`eta`,
        `encoder_propagation`, `sequential_cfg`)."""
        s = self.story_sampler
        return StoryPipeline(self.configs, num_steps=s.num_steps,
                             guidance_scale=s.guidance_scale,
                             schedule=s.schedule,
                             towers=dict(self.named_children()),
                             mesh=self.mesh, **options).eval()

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _split_batch(self, tower, batch: torch.Tensor):
        """`tower`'s outputs of the (n, ...) `batch`; with a mesh each rank
        runs its block of the n (maybe none) and the outputs are
        all-gathered whole."""
        everyone = self._everyone()
        table = spatial.blocks(batch.shape[0], everyone.size)
        outs = tower(spatial.narrow(batch, 0, everyone, table))
        return tuple(spatial.gather(o, 0, everyone, table) for o in outs)

    def _encode_text(self, encoder, tokens: torch.Tensor):
        b, f, t = tokens.shape
        hidden, embeds = self._split_batch(encoder, tokens.reshape(b * f, t))
        return hidden.reshape(b, f, t, -1), embeds.reshape(b, f, -1)

    def _encode_images(self, images: torch.Tensor):
        b, f = images.shape[:2]
        tokens, embeds = self._split_batch(
            self.vision,
            images.reshape((b * f,) + images.shape[2:]).to(self.dtype))
        return (tokens.reshape((b, f) + tokens.shape[1:]),
                embeds.reshape(b, f, -1))

    @torch.no_grad()
    def precompute_cond_cache(self, tokens_u_s1: torch.Tensor,
                              tokens_u_s2: torch.Tensor,
                              white_clip: torch.Tensor,
                              black_clip: torch.Tensor) -> CondCache:
        """tokens_u_s1/s2: (T,) uncond caption ids; white_clip/black_clip:
        (c, c, 3) CLIP-preprocessed constant mask images."""
        h1, e1 = self.text_s1(tokens_u_s1[None])
        h2, _ = self.text_s2(tokens_u_s2[None])
        _, emb = self.vision(torch.stack([white_clip, black_clip])
                             .to(self.dtype))
        return CondCache(h1[0], e1[0], h2[0], emb[0], emb[1])

    @torch.no_grad()
    def generate(self, inputs: StoryInputs,
                 cond_cache: Optional[CondCache] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[StoryNoise] = None):
        """Returns (frames in [0, 1] (b, f, H, W, 3) fp32, stage-1 embeds
        (b, f, d) fp32). Random draws come from `noise` if given, else
        `StoryNoise.draw` draws them from `generator`.

        With a `cond_cache`, `inputs.mask_clip` and `inputs.tokens_s2_u`
        are not read: the mask embeds are the cache's white/black embeds
        picked by `frame_known`, and the uncond hidden states and embeds
        are the cache's (the protocol's invariants,
        `data/protocol.py::build_story_example`). The mask of the stage-1
        uncond states still comes from `inputs.tokens_s1_u`, as the
        reference builds it."""
        b, f = inputs.frame_known.shape
        if noise is None:
            noise = StoryNoise.draw(self, b, generator,
                                    tuple(inputs.source_pixels.shape[2:4]))
        known = inputs.frame_known.bool()
        eos1 = self.configs.text_s1.eos_token_id

        # ---- stage 1 --------------------------------------------------------
        th_c, te_c = self._encode_text(self.text_s1, inputs.tokens_s1)
        src_tokens, src_embed = self._encode_images(inputs.source_clip)
        if cond_cache is None:
            th_u, te_u = self._encode_text(self.text_s1, inputs.tokens_s1_u)
            _, mask_embed = self._encode_images(inputs.mask_clip)
            th2_u, _ = self._encode_text(self.text_s2, inputs.tokens_s2_u)
        else:
            th_u = cond_cache.s1_hidden_u.expand((b, f) + th_c.shape[2:])
            te_u = cond_cache.s1_embed_u.expand(te_c.shape)
            mask_embed = torch.where(known[..., None], cond_cache.white_embed,
                                     cond_cache.black_embed)
            th2_u = None
        cond1 = PriorConditioning(
            text_embed=te_c, text_hidden=th_c,
            text_mask=padding_mask(inputs.tokens_s1, eos1),
            text_embed_u=te_u, text_hidden_u=th_u,
            text_mask_u=padding_mask(inputs.tokens_s1_u, eos1),
            image_embed=src_embed, mask_embed=mask_embed)
        pred_embeds = self.prior_sampler(cond1, noise.prior_init,
                                         noise.prior_steps)
        image_proj = torch.where(known[..., None], src_embed,
                                 pred_embeds.to(src_embed.dtype))

        # ---- stage 2 --------------------------------------------------------
        th2_c, _ = self._encode_text(self.text_s2, inputs.tokens_s2)
        if th2_u is None:
            th2_u = cond_cache.s2_hidden_u.expand(th2_c.shape)
        px = inputs.source_pixels
        mean, logvar = self._encode_pixels(
            px.reshape((b * f,) + px.shape[2:]).to(self.dtype))
        masked = VAE.sample_latent(mean.float(), logvar.float(),
                                   noise.vae.float()) * self.vae_scale
        masked = masked.reshape((b, f) + masked.shape[1:])
        h8, w8 = masked.shape[2:4]
        mask_label = known[:, :, None, None, None].float().expand(
            b, f, h8, w8, 1)
        cond2 = StoryConditioning(
            text_hidden=th2_c, text_hidden_u=th2_u, image_tokens=src_tokens,
            image_proj=image_proj, frame_known=known,
            masked_latents=masked, mask_label=mask_label)
        latents = self.story_sampler(cond2, noise.story_init,
                                     step_noise=noise.story_steps)

        # ---- decode one frame at a time (bounds the decoder's memory) -------
        z = (latents / self.vae_scale).reshape((b * f,) + latents.shape[2:])
        plan = self._vae_plan(z.shape[1], z.shape[2], 1,
                              len(self.configs.vae.block_channels) - 1)
        z = spatial.narrow(z, 1, plan.group, plan.blocks(z.shape[2]))
        with spatial.spatial(plan):
            frames = torch.cat([self.vae.decode(zi[None].to(self.dtype))
                                .float() for zi in z])
        frames = spatial.gather(frames, 1, plan.group,
                                plan.blocks(frames.shape[2]))
        frames = frames.reshape((b, f) + frames.shape[1:])
        return (frames / 2 + 0.5).clamp(0.0, 1.0), pred_embeds

    def _everyone(self) -> spatial.RowGroup:
        """Every rank of the mesh (one rank without a mesh)."""
        return self.mesh.all if self.mesh is not None else spatial.ONE_RANK

    def _vae_plan(self, rows: int, cols: int, levels: int, up: int = 0
                  ) -> spatial.RowPlan:
        """The VAE's rows of a `rows` x `cols` map split over every rank:
        `levels` resolutions down from it (the encoder) or `up` above it
        (the decoder)."""
        return spatial.RowPlan(self._everyone(), rows, cols, levels, up)

    def _encode_pixels(self, px: torch.Tensor):
        """VAE (mean, logvar) of (n, H, W, 3) pixels; with a mesh each
        rank encodes a block of rows, and the latents are all-gathered
        whole."""
        if self.mesh is None:
            return self.vae.encode(px)
        plan = self._vae_plan(px.shape[1], px.shape[2],
                              len(self.configs.vae.block_channels))
        with spatial.spatial(plan):
            mean, logvar = self.vae.encode(
                spatial.narrow(px, 1, plan.group, plan.blocks(px.shape[2])))
        both = spatial.gather(torch.stack([mean, logvar]), 2, plan.group,
                              plan.blocks(mean.shape[2]))
        return both[0], both[1]

    @torch.no_grad()
    def generate_stage1_autoreg(self, inputs: StoryInputs,
                                white_clip: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                noise: Optional[list] = None
                                ) -> torch.Tensor:
        """Stage-1-only autoregressive generation (the reference's
        `--autoreg` protocol): one full prior sampling pass per frame;
        after pass i, frame i's predicted embedding becomes a known-image
        condition and its mask embed the white image's, unless frame i
        was known. `white_clip`: (c, c, 3) CLIP-preprocessed white image.
        `noise`: the passes' noise, else `PriorSampler.draw_passes` draws
        it from `generator`. Returns (b, f, d) embeddings."""
        eos1 = self.configs.text_s1.eos_token_id
        th_c, te_c = self._encode_text(self.text_s1, inputs.tokens_s1)
        th_u, te_u = self._encode_text(self.text_s1, inputs.tokens_s1_u)
        _, src_embed = self._encode_images(inputs.source_clip)
        _, mask_embed = self._encode_images(inputs.mask_clip)
        _, white_embed = self.vision(white_clip[None].to(self.dtype))
        cond1 = PriorConditioning(
            text_embed=te_c, text_hidden=th_c,
            text_mask=padding_mask(inputs.tokens_s1, eos1),
            text_embed_u=te_u, text_hidden_u=th_u,
            text_mask_u=padding_mask(inputs.tokens_s1_u, eos1),
            image_embed=src_embed, mask_embed=mask_embed)
        b = src_embed.shape[0]
        return self.prior_sampler.autoregressive(
            cond1, white_embed.expand(b, -1), inputs.frame_known, generator,
            noise)


def build_pipeline(configs: PipelineConfigs, device, dtype=torch.float32,
                   seed: int = 0, num_steps: int = 20,
                   **sampler_options) -> StoryPipeline:
    """A pipeline with seeded random weights drawn like flax's initializers
    (no checkpoint), on `device` in `dtype`, ready for inference.
    `sampler_options`: `StoryPipeline`'s `eta`, `encoder_propagation`,
    `sequential_cfg`."""
    device = torch.device(device)
    with device:
        pipe = StoryPipeline(configs, num_steps=num_steps, **sampler_options)
    init_like_flax_(pipe, torch.Generator(device).manual_seed(seed))
    return for_inference(pipe, dtype)


def for_inference(module: nn.Module, dtype=torch.float32) -> nn.Module:
    """`module` in `dtype` (norm parameters stay fp32), in eval mode,
    without gradients, and channels-last on a card."""
    module = module.to(dtype).eval().requires_grad_(False)
    if next(module.parameters()).device.type == "cuda":
        module = module.to(memory_format=torch.channels_last)
    return module


def tiny_inputs(configs: PipelineConfigs, seed: int = 0) -> StoryInputs:
    """Example inputs shaped like the JAX `build_tiny_pipeline`'s: frame 0
    known, token rows with an EOS at position 3, random source frames."""
    f = configs.prior.num_frames
    t = configs.prior.num_text_tokens
    cimg, img = configs.vision.image_size, 32
    ids = torch.zeros(1, f, t, dtype=torch.int64)
    ids[:, :, 3] = configs.text_s1.eos_token_id
    g = torch.Generator().manual_seed(seed)
    return StoryInputs(
        tokens_s1=ids, tokens_s1_u=ids, tokens_s2=ids, tokens_s2_u=ids,
        source_clip=torch.randn(1, f, cimg, cimg, 3, generator=g),
        mask_clip=torch.zeros(1, f, cimg, cimg, 3),
        source_pixels=torch.zeros(1, f, img, img, 3),
        frame_known=(torch.arange(f) < 1)[None])


def build_tiny_pipeline(seed: int = 0, num_steps: int = 2,
                        **sampler_options):
    """Tiny random-weight pipeline and example inputs on the CPU (the
    counterpart of the JAX `build_tiny_pipeline`, for tests and smoke
    runs); `sampler_options` as `build_pipeline`'s."""
    configs = tiny_configs()
    pipe = build_pipeline(configs, "cpu", torch.float32, seed, num_steps,
                          **sampler_options)
    return pipe, tiny_inputs(configs, seed)
