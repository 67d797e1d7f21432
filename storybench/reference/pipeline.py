"""The plain reference of one RCDMs story: captions and known frames in,
five frames and the stage-1 frame embeddings out, in float32.

Stage 1 samples the frames' CLIP image embeddings with the prior under the
UnCLIP scheduler (20 steps, classifier-free guidance 2.0, the batch doubled
[uncond | cond]); stage 2 samples the story latents with the UNet under
DDIM (20 steps, eta 0, guidance 2.0, the two branches one after the other)
and decodes them frame by frame with the VAE. All noise is given.

Nothing here is cached between calls: the unconditional caption and the
mask images go through the towers on every call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from storybench.reference.model import Story


def _cosine_betas(n: int = 1000) -> np.ndarray:
    def bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    ts = np.arange(n, dtype=np.float64)
    return np.minimum(1.0 - bar((ts + 1) / n) / bar(ts / n), 0.999)


def _acp(table: np.ndarray, t: int) -> float:
    return float(table[t]) if t >= 0 else 1.0


class UnCLIP:
    """diffusers' UnCLIPScheduler as Kandinsky 2.2's prior sets it:
    squaredcos_cap_v2 betas, 'sample' prediction clipped to 10, fixed
    small log variance, trailing timesteps."""

    def __init__(self):
        self.betas = _cosine_betas()
        self.acp = np.cumprod(1.0 - self.betas)

    def timesteps(self, n: int) -> list:
        ratio = 999 / (n - 1)
        ts = (np.arange(n) * ratio).round()[::-1].astype(np.int64).tolist()
        return list(zip(ts, ts[1:] + [ts[-1] - 1]))

    def step(self, x0, t: int, prev: int, x, noise):
        a_t, a_p = _acp(self.acp, t), _acp(self.acp, prev)
        beta = float(self.betas[t]) if prev == t - 1 else 1.0 - a_t / a_p
        x0 = x0.clamp(-10.0, 10.0)
        mean = (math.sqrt(a_p) * beta / (1 - a_t) * x0
                + math.sqrt(1 - beta) * (1 - a_p) / (1 - a_t) * x)
        if t <= 0:
            return mean
        var = max((1 - a_p) / (1 - a_t) * beta, 1e-20)
        return mean + math.sqrt(var) * noise


class DDIM:
    """diffusers' DDIMScheduler as SD-1.5 sets it for sampling: linear
    0.00085 -> 0.012 betas, epsilon prediction, x0 clipped to 1, leading
    timesteps, alpha 1 before the start, eta 0."""

    def __init__(self):
        betas = np.linspace(0.00085, 0.012, 1000, dtype=np.float64)
        self.acp = np.cumprod(1.0 - betas)

    def timesteps(self, n: int) -> list:
        ts = (np.arange(n) * (1000 // n)).round()[::-1].astype(np.int64)
        return [(int(t), int(t) - 1000 // n) for t in ts]

    def step(self, eps, t: int, prev: int, x):
        a_t, a_p = _acp(self.acp, t), _acp(self.acp, prev)
        x0 = ((x - math.sqrt(1 - a_t) * eps) / math.sqrt(a_t)).clamp(-1, 1)
        eps = (x - math.sqrt(a_t) * x0) / math.sqrt(1 - a_t)
        return math.sqrt(a_p) * x0 + math.sqrt(1 - a_p) * eps


def padding_mask(ids, eos: int):
    """True up to and including the first EOS (all True without one)."""
    is_eos = ids == eos
    first = torch.argmax(is_eos.int(), dim=-1)
    keep = torch.arange(ids.shape[-1], device=ids.device) <= first[..., None]
    return torch.where(is_eos.any(-1, keepdim=True), keep,
                       torch.ones_like(keep))


def _towers(tower, x, lead):
    hidden, embeds = tower(x.reshape((-1,) + x.shape[len(lead):]))
    return (hidden.reshape(lead + hidden.shape[1:]),
            embeds.reshape(lead + embeds.shape[1:]))


@torch.no_grad()
def generate(model: Story, cfg: dict, inputs: dict, noise: dict,
             steps: int, guidance: float):
    """`inputs`: tokens_s1, tokens_s1_u, tokens_s2, tokens_s2_u (b, f, T)
    ids; source_clip, mask_clip (b, f, 224, 224, 3); source_pixels
    (b, f, H, W, 3) in [-1, 1]; frame_known (b, f) bool. `noise`:
    prior_init (b, f, d), prior_steps (steps, b, f, d), vae (b f, h8, w8,
    4), story_init (b, f, h8, w8, 4). Returns (frames (b, f, H, W, 3) in
    [0, 1], stage-1 embeddings (b, f, d))."""
    known = inputs["frame_known"].bool()
    b, f = known.shape
    lead = (b, f)
    eos1 = cfg["text_s1"]["eos_token_id"]

    # stage 1
    th_c, te_c = _towers(model.text_s1, inputs["tokens_s1"], lead)
    th_u, te_u = _towers(model.text_s1, inputs["tokens_s1_u"], lead)
    src_tokens, src_embed = _towers(model.vision, inputs["source_clip"], lead)
    _, mask_embed = _towers(model.vision, inputs["mask_clip"], lead)
    mask_c = padding_mask(inputs["tokens_s1"], eos1)
    mask_u = padding_mask(inputs["tokens_s1_u"], eos1)
    sched = UnCLIP()
    x = noise["prior_init"].float()
    args = (torch.cat([te_u, te_c]), torch.cat([th_u, th_c]),
            torch.cat([src_embed, src_embed]),
            torch.cat([mask_embed, mask_embed]), torch.cat([mask_u, mask_c]))
    for i, (t, prev) in enumerate(sched.timesteps(steps)):
        xx = torch.cat([x, x])
        tb = torch.full(xx.shape[:2], t, dtype=torch.int64, device=x.device)
        u, c = model.prior(xx, tb, *args).chunk(2)
        x = sched.step(u + guidance * (c - u), t, prev, x,
                       noise["prior_steps"][i].float())
    embeds = x * cfg["prior"]["clip_std"] + cfg["prior"]["clip_mean"]
    image_proj = torch.where(known[..., None], src_embed, embeds)

    # stage 2
    th2_c, _ = _towers(model.text_s2, inputs["tokens_s2"], lead)
    th2_u, _ = _towers(model.text_s2, inputs["tokens_s2_u"], lead)
    scale = cfg["vae"]["scaling_factor"]
    px = inputs["source_pixels"].float()
    mean, logvar = model.vae.encode(px.reshape((b * f,) + px.shape[2:]))
    masked = (mean + torch.exp(0.5 * logvar) * noise["vae"].float()) * scale
    masked = masked.reshape(lead + masked.shape[1:])
    h8, w8 = masked.shape[2:4]
    side = torch.cat([known[:, :, None, None, None].float().expand(
        b, f, h8, w8, 1), masked], dim=-1)
    contexts = [model.fusion(src_tokens, image_proj, th, known)
                for th in (th2_u, th2_c)]
    ddim = DDIM()
    lat = noise["story_init"].float()
    for t, prev in ddim.timesteps(steps):
        xin = torch.cat([lat, side], dim=-1)
        tb = torch.full((b,), t, dtype=torch.int64, device=lat.device)
        u, c = (model.unet(xin, tb, ctx) for ctx in contexts)
        lat = ddim.step(u + guidance * (c - u), t, prev, lat)
    z = (lat / scale).reshape((b * f,) + lat.shape[2:])
    frames = torch.cat([model.vae.decode(zi[None]) for zi in z])
    frames = frames.reshape(lead + frames.shape[1:])
    return (frames / 2 + 0.5).clamp(0.0, 1.0), embeds
