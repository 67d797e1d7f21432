"""The one traffic generator: stories and arrival times drawn from the run's
seed and a mix file's parameters (`mixes/<name>.json`).

A story is five captions of seeded lengths (a BOS, word ids, an EOS, EOS
padding, as the port's tokenizers write them), its known frames (smooth
random images: pixels in [-1, 1] and their CLIP-normalized 224-pixel
copies; unknown frames black), the mask images (white where known, black
where not), the mix's one negative prompt (the empty caption), and its own
noise seed. Every story is drawn from a generator of its own, keyed by the
run's seed and its index, so a story is the same whatever batch it lands
in, and every seed gives the same sizes and work in another order.

The noise of a story is drawn from its seed as the port's server draws a
request's (`StoryNoise.draw` over `torch.Generator(device).manual_seed`):
prior init (f, d), one prior draw a step, the VAE's (f, h8, w8, 4), the
story latents' (f, h8, w8, 4), all float32 standard normal.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

BOS, EOS = 49406, 49407
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each (seed, tags)."""
    key = ":".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def _clip_normalize(img01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, device=img01.device)
    std = torch.tensor(CLIP_STD, device=img01.device)
    return (img01 - mean) / std


def mask_images(cfg: dict, device) -> tuple:
    """The CLIP-normalized white and black mask images, (c, c, 3)."""
    c = cfg["vision"]["image_size"]
    return tuple(_clip_normalize(torch.full((3,), v, device=device))
                 .expand(c, c, 3) for v in (1.0, 0.0))


def caption_row(g: torch.Generator, length: int, tokens: int, vocab: int,
                device) -> torch.Tensor:
    """[BOS, length - 2 word ids, EOS, EOS padding] of `tokens` ids; word
    ids avoid BOS and EOS."""
    words = torch.randint(0, vocab - 2, (length - 2,), generator=g,
                          device=device)
    words = words + 2 * (words >= BOS)
    row = torch.full((tokens,), EOS, dtype=torch.int64, device=device)
    row[0] = BOS
    row[1:length - 1] = words
    return row


def uncond_row(tokens: int, device) -> torch.Tensor:
    """The empty negative prompt: BOS, EOS, EOS padding."""
    row = torch.full((tokens,), EOS, dtype=torch.int64, device=device)
    row[0] = BOS
    return row


def story(cfg: dict, mix: dict, seed: int, index: int, device) -> dict:
    """Story `index` of the run: its inputs as (1, f, ...) tensors on
    `device`, its count of known frames and its noise seed."""
    g = torch.Generator(device).manual_seed(subseed(seed, "story", index))
    f, size = cfg["num_frames"], cfg["image_size"]
    csize = cfg["vision"]["image_size"]
    text = cfg["text_s1"]
    tokens, vocab = text["max_positions"], text["vocab_size"]
    lo, hi = mix["caption_tokens"]
    hi = min(hi or tokens, tokens)
    lengths = torch.randint(lo, hi + 1, (f,), generator=g, device=device)
    ids = torch.stack([caption_row(g, int(n), tokens, vocab, device)
                       for n in lengths.tolist()])
    k_lo, k_hi = mix["known_frames"]
    known = int(torch.randint(k_lo, k_hi + 1, (1,), generator=g,
                              device=device))
    # smooth random images: 8 x 8 colour fields, bilinear to full size
    coarse = torch.rand(f, 3, 8, 8, generator=g, device=device)
    img = F.interpolate(coarse, size=(size, size), mode="bilinear",
                        align_corners=False)
    small = F.interpolate(img, size=(csize, csize), mode="bilinear",
                          align_corners=False, antialias=True)
    is_known = torch.arange(f, device=device) < known
    k = is_known[:, None, None, None]
    pixels = torch.where(k, img.permute(0, 2, 3, 1) * 2 - 1, -1.0)
    white, black = mask_images(cfg, device)
    clip = torch.where(k, _clip_normalize(small.permute(0, 2, 3, 1)), black)
    mask = torch.where(k, white, black)
    u = uncond_row(tokens, device).expand(f, tokens)
    return dict(
        inputs=dict(tokens_s1=ids[None], tokens_s1_u=u[None].clone(),
                    tokens_s2=ids[None].clone(), tokens_s2_u=u[None].clone(),
                    source_clip=clip[None], mask_clip=mask[None].clone(),
                    source_pixels=pixels[None], frame_known=is_known[None]),
        known=known,
        noise_seed=subseed(seed, "noise", index))


def noise(cfg: dict, noise_seed: int, device) -> dict:
    """One story's noise, drawn in the port's server's order."""
    g = torch.Generator(device).manual_seed(noise_seed)
    f, d = cfg["num_frames"], cfg["prior"]["embedding_dim"]
    down = 2 ** (len(cfg["vae"]["block_channels"]) - 1)
    h8 = cfg["image_size"] // down

    def draw(shape):
        return torch.randn(shape, generator=g, device=device)

    prior_init = draw((1, f, d))
    prior_steps = torch.stack([draw((1, f, d))
                               for _ in range(cfg["prior_steps"])])
    vae = draw((f, h8, h8, 4))
    story_init = draw((1, f, h8, h8, 4))
    return dict(prior_init=prior_init, prior_steps=prior_steps, vae=vae,
                story_init=story_init)


def cat_inputs(stories: list) -> dict:
    return {k: torch.cat([s["inputs"][k] for s in stories])
            for k in stories[0]["inputs"]}


def cat_noise(noises: list) -> dict:
    return dict(prior_init=torch.cat([n["prior_init"] for n in noises]),
                prior_steps=torch.cat([n["prior_steps"] for n in noises],
                                      dim=1),
                vae=torch.cat([n["vae"] for n in noises]),
                story_init=torch.cat([n["story_init"] for n in noises]))


def arrivals(mix: dict, lead_s: float, seconds: float) -> tuple:
    """(due times in s from the first arrival, the window's open) of an
    open loop at the mix's rate, from at least `lead_s` before the window
    opens to its close: arrival k at (k + u_k) / rate, u_k uniform in
    [0, 1) from a fixed generator, not from the run's seed: the same rate
    and the same times for every seed (only the requests' contents
    differ), with no period that the batches' service time can lock
    onto."""
    gap = 1.0 / mix["rate_per_s"]
    lead = -(-lead_s // gap) * gap
    n = int(-(-(lead + seconds) // gap))
    g = torch.Generator().manual_seed(subseed(0, "arrivals"))
    u = torch.rand(n, generator=g, dtype=torch.float64).tolist()
    return [(k + u[k]) * gap for k in range(n)], lead
