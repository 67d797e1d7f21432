"""End-to-end quality delta of the opt-in w8a8 int8 mode: the port's
counterpart of `tools/int8_quality.py`, with its flags (--tiny, --encprop)
and its JSON, key for key, plus --device and, on a card, "card".

The stage-2 sampler at full width (the SD-1.5-scale `StoryUNet` and fusion
stacks of `full_configs`: 512 px, 5 frames, 20 DDIM steps, CFG 2.0, bf16,
batch 1), with seeded random weights and seeded conditioning at the JAX
bench's shapes (91 text tokens, 257 vision tokens, frame 0 known, mask
ones), runs three times: bf16 at seed 42, bf16 at seed 43 (an unrelated
story, the floor) and int8 (`ops/quant.py`) at seed 42; with --encprop
also encoder propagation k = 2 at seed 42. Every story decodes through one
seeded SD VAE decoder in bf16. The report:

  * int8_vs_bf16: the latents' relative RMS and per-frame cosine, the
    decoded frames' SSIM per frame, min and mean;
  * unrelated_bf16_noise_floor: the same between seeds 42 and 43, so the
    int8 delta reads between "identical" (1.0) and "unrelated";
  * encprop2_vs_bf16 (with --encprop), as int8_vs_bf16.

Weights, as the JAX tool draws them: every >= 2-d weight N(0,
1/sqrt(fan_in)), including the temporal modules' zero-initialised output
projections, so the temporal path contributes as in a trained model; norm
scales 1; every 1-d bias 0; then everything rounded to bf16. The fan-in
is the JAX kernel's leading axes' product: for a torch weight, its
(out, in, ...) layout's every axis but the first (a Linear's in, a conv's
in * kh * kw). The weights are rounded to bf16 before the int8 route
quantizes them, so int8 quantizes the bf16 values, as the JAX tool does;
the one model serves every run (its int8 weights are made at the cast,
with the int8 mode on, and the bf16 runs have it off).

Random weights make the DDIM trajectory less contractive than trained
ones, so the delta is a conservative bound; the parity gate
(`tools/parity_check.py`) measures it on real weights.

    python -m rcdms_tpu_torch.tools.int8_quality --encprop      # card
    python -m rcdms_tpu_torch.tools.int8_quality --tiny --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rcdms_tpu_torch.configs import (
    FusionConfig,
    StoryUNetConfig,
    VAEConfig,
)
from rcdms_tpu_torch.cli.common import device_of
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.models.vae import VAE
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.sample.eval import ssim
from rcdms_tpu_torch.sample.pipeline import for_inference, full_configs
from rcdms_tpu_torch.sample.story_sampler import (
    StoryConditioning,
    StorySampler,
)

TINY_UNET_CHANNELS = (64, 128)  # Cin % 64 == 0: the int8 convs engage
SEEDS = (42, 43)                # the story's, and the unrelated floor's
WEIGHT_SEED = 0                 # the UNet's, fusion's and conditioning's
VAE_SEED = 7                    # the decoder's weights


class Rig(NamedTuple):
    """The sampler over the seeded bf16 UNet and fusion stacks, its
    conditioning, the seeded bf16 VAE and the report's config name."""

    sampler: StorySampler
    cond: StoryConditioning
    vae: VAE
    config: str


def randomize_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """The JAX tool's weights (module docstring), drawn in the order of
    `named_parameters` on the parameters' device and rounded to bf16."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                w = torch.randn(p.shape, generator=generator,
                                device=p.device) / math.sqrt(p[0].numel())
            elif name.endswith("weight"):  # a norm's scale
                w = torch.ones_like(p)
            else:
                w = torch.zeros_like(p)
            p.copy_(w.to(torch.bfloat16))


def build(tiny: bool, device) -> Rig:
    """The rig on `device`: at full width (module docstring), or `tiny`
    (the tiny UNet at channels (64, 128) and its fusion stacks, 8 x 8
    latents, 9 vision tokens, 7 text tokens, 3 steps)."""
    device = torch.device(device)
    if tiny:
        ucfg = StoryUNetConfig.tiny(block_channels=TINY_UNET_CHANNELS)
        fcfg = FusionConfig.tiny(hidden_dim=ucfg.cross_attention_dim,
                                 text_dim=ucfg.cross_attention_dim)
        vcfg = VAEConfig.tiny()
        hw, n_vis, t, steps = 8, 9, 7, 3
    else:
        configs = full_configs()
        ucfg, fcfg, vcfg = configs.unet, configs.fusion, VAEConfig()
        hw, n_vis, t, steps = 512 // 8, 257, 91, 20
    g = torch.Generator(device).manual_seed(WEIGHT_SEED)
    with device:
        unet, fusion, vae = StoryUNet(ucfg), FusionModule(fcfg), VAE(vcfg)
    randomize_(unet, g)
    randomize_(fusion, g)
    init_like_flax_(vae, torch.Generator(device).manual_seed(VAE_SEED))
    # the int8 route's weights are quantized from the (bf16-valued) fp32
    # weights at the cast; the exact path never reads them
    quant.set_quant_mode("int8")
    try:
        unet = for_inference(unet, torch.bfloat16)
    finally:
        quant.set_quant_mode(None)
    fusion = for_inference(fusion, torch.bfloat16)
    vae = for_inference(vae, torch.bfloat16)

    b, f = 1, ucfg.num_frames
    cg = torch.Generator().manual_seed(WEIGHT_SEED)

    def randn(*shape):
        return torch.randn(shape, generator=cg).to(device, torch.bfloat16)

    known = torch.zeros(b, f, dtype=torch.bool)
    known[:, 0] = True
    cond = StoryConditioning(
        text_hidden=randn(b, f, t, fcfg.text_dim),
        text_hidden_u=randn(b, f, t, fcfg.text_dim),
        image_tokens=randn(b, f, n_vis, fcfg.seen_vis_dim),
        image_proj=randn(b, f, fcfg.unseen_vis_dim),
        frame_known=known.to(device),
        masked_latents=randn(b, f, hw, hw, 4),
        mask_label=torch.ones(b, f, hw, hw, 1, dtype=torch.bfloat16,
                              device=device))
    sampler = StorySampler(unet, fusion, num_steps=steps, guidance_scale=2.0)
    config = "tiny" if tiny else f"full ({hw * 8}px, {f}f, {steps} steps)"
    return Rig(sampler, cond, vae, config)


def sample(rig: Rig, seed: int, prop: int = 0) -> np.ndarray:
    """One story's latents (b, f, h8, w8, 4) as fp32 numpy, its initial
    noise from a generator seeded `seed` on the UNet's device, under the
    current quant mode; `prop` k >= 2 runs encoder propagation k."""
    sampler = rig.sampler
    if prop:
        sampler = dataclasses.replace(sampler, encoder_propagation=prop)
    dev = sampler.unet.conv_in.weight.device
    lat = sampler(rig.cond, generator=torch.Generator(dev).manual_seed(seed))
    return lat.float().cpu().numpy()


@torch.no_grad()
def to_frames(rig: Rig, lat: np.ndarray) -> np.ndarray:
    """Latents (b, f, h8, w8, 4) -> (b * f, H, W, 3) frames in [0, 1]
    through the bf16 decoder, one frame at a time."""
    vae = rig.vae
    dev = vae.post_quant_conv.weight.device
    z = torch.from_numpy(lat.reshape((-1,) + lat.shape[2:])
                         / vae.cfg.scaling_factor).to(dev)
    img = torch.cat([vae.decode(zi[None].to(torch.bfloat16)).float()
                     for zi in z]).cpu().numpy()
    return np.clip(img * 0.5 + 0.5, 0.0, 1.0)  # [-1, 1] -> [0, 1]


def latent_metrics(a: np.ndarray, b: np.ndarray):
    """(relative RMS of b - a, cosine of each frame's latents)."""
    per_frame_cos = []
    for f in range(a.shape[1]):
        x, y = a[:, f].ravel(), b[:, f].ravel()
        per_frame_cos.append(float(
            np.dot(x, y) / (np.linalg.norm(x) * np.linalg.norm(y)
                            + 1e-12)))
    rel_rms = float(np.sqrt(((a - b) ** 2).mean())
                    / np.sqrt((a ** 2).mean() + 1e-12))
    return rel_rms, per_frame_cos


def frame_ssims(a: np.ndarray, b: np.ndarray) -> list:
    return [float(ssim(a[f], b[f])) for f in range(a.shape[0])]


def delta(lat_a, frames_a, lat_b, frames_b) -> dict:
    """The report's row of story b against story a: latent metrics and
    frame SSIMs."""
    rel, cos = latent_metrics(lat_a, lat_b)
    sims = frame_ssims(frames_a, frames_b)
    return {
        "latent_rel_rms": round(rel, 4),
        "latent_cos_per_frame": [round(c, 4) for c in cos],
        "ssim_per_frame": [round(s, 4) for s in sims],
        "ssim_min": round(min(sims), 4),
        "ssim_mean": round(float(np.mean(sims)), 4),
    }


def report(rig: Rig, encprop: bool = False, card: Optional[str] = None,
           around: Callable = lambda name: contextlib.nullcontext()
           ) -> dict:
    """The runs and the JAX tool's JSON. `around(name)` is entered around
    each sampler run ("bf16", "bf16_unrelated", "int8", "encprop2"),
    e.g. to count its kernel launches. Raises where int8 or k = 2 gives
    the bf16 latents bit for bit (the mode did not engage)."""
    quant.set_quant_mode(None)
    with around("bf16"):
        lat_bf16 = sample(rig, SEEDS[0])
    with around("bf16_unrelated"):
        lat_bf16_k2 = sample(rig, SEEDS[1])
    quant.set_quant_mode("int8")
    try:
        with around("int8"):
            lat_int8 = sample(rig, SEEDS[0])
    finally:
        quant.set_quant_mode(None)
    if np.array_equal(lat_bf16, lat_int8):
        raise AssertionError("int8 mode did not engage (identical outputs)")
    lat_prop = None
    if encprop:
        with around("encprop2"):
            lat_prop = sample(rig, SEEDS[0], prop=2)
        if np.array_equal(lat_bf16, lat_prop):
            raise AssertionError("encoder propagation did not engage "
                                 "(identical outputs)")

    frames_bf16 = to_frames(rig, lat_bf16)
    rel_u, cos_u = latent_metrics(lat_bf16, lat_bf16_k2)
    ssim_u = frame_ssims(frames_bf16, to_frames(rig, lat_bf16_k2))
    out = {
        "config": rig.config,
        "int8_vs_bf16": delta(lat_bf16, frames_bf16, lat_int8,
                               to_frames(rig, lat_int8)),
        "unrelated_bf16_noise_floor": {
            "latent_rel_rms": round(rel_u, 4),
            "latent_cos_mean": round(float(np.mean(cos_u)), 4),
            "ssim_mean": round(float(np.mean(ssim_u)), 4),
        },
    }
    if lat_prop is not None:
        out["encprop2_vs_bf16"] = delta(lat_bf16, frames_bf16, lat_prop,
                                         to_frames(rig, lat_prop))
    if card is not None:
        out["card"] = card
    return out


def run(tiny: bool = False, encprop: bool = False, device="cuda") -> dict:
    """Build the rig on `device` and return its report; on a card the
    report names it (nvidia-smi's name and power limit)."""
    device = torch.device(device)
    card = None
    if device.type == "cuda":
        from rcdms_tpu_torch.tools import card_line

        card = card_line()
    return report(build(tiny, device), encprop, card)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny UNet (the size; the device is --device's)")
    ap.add_argument("--encprop", action="store_true",
                    help="also measure --encoder-propagation 2 against "
                         "exact bf16 on the same noise")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda never falls back to the CPU")
    args = ap.parse_args(argv)
    out = run(args.tiny, args.encprop, device_of(args))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
