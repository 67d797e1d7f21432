"""What decides `correct`: the program's outputs of sampled stories against
the plain float32 reference (`reference/`), run after the window on the
same inputs, noise and weights, all made again from the run's seed.

Numbers compared, each the worst over the checked stories:
  frames_mean_abs  mean |program - reference| over every pixel of the
                   story's frames, in [0, 1] units;
  embeds_rel       the largest, over the story's frames, of
                   |program - reference| / |reference| of its stage-1
                   embedding (only where the entry returns embeddings).
The limits are per cell, in `limits/<workload>.json`, with the readings
they were set from.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from storybench import traffic, weights
from storybench.reference import model as ref_model
from storybench.reference import pipeline as ref_pipeline

HERE = Path(__file__).resolve().parent


def limits(workload: str) -> dict:
    """The cell's limits; none (so nothing passes) before they are set."""
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {"limits": {}}


def reference_model(cfg: dict, seed: int, device) -> ref_model.Story:
    """The reference at float32 holding the seed's weights, made again."""
    with torch.device("meta"):
        model = ref_model.Story(cfg)
    params = weights.spec(model)
    made = weights.make(params, traffic.subseed(seed, "weights"), device,
                        dtype=torch.bfloat16 if cfg["dtype"] == "bfloat16"
                        else torch.float32)
    model.load_state_dict({k: v.float() for k, v in made.items()},
                          assign=True)
    del made
    return model.eval().requires_grad_(False)


def precise():
    """Float32 products with no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def reference_story(model, cfg: dict, mix: dict, seed: int, index: int,
                    device):
    """(frames, embeds) of story `index` of the run, by the reference."""
    s = traffic.story(cfg, mix, seed, index, device)
    n = traffic.noise(cfg, s["noise_seed"], device)
    return ref_pipeline.generate(model, cfg, s["inputs"], n,
                                 cfg["prior_steps"], cfg["guidance_scale"])


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude onto e4m3's 448), back in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Fp8Products(TorchFunctionMode):
    """The control: every product of the reference (linear layers, convs,
    both products of attention) takes its two operands rounded to fp8
    e4m3, a scale a tensor, and sums in float32: the precision below the
    configuration's bf16, the step that would tempt a later change."""

    PRODUCTS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul,
                torch.Tensor.__matmul__, torch.bmm, torch.mm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(fp8(a) if i < 2 and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a
                         for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


def as_served(frames: torch.Tensor) -> torch.Tensor:
    """Frames as the server answers them: rounded to 8 bits."""
    return (frames * 255.0).round().clamp(0, 255) / 255.0


def numbers(frames, ref_frames, embeds=None, ref_embeds=None) -> dict:
    """The compared numbers of one story ((f, ...) tensors)."""
    out = {"frames_mean_abs": float((frames.float().cpu()
                                     - ref_frames.float().cpu())
                                    .abs().mean())}
    if embeds is not None:
        e, r = embeds.float().cpu(), ref_embeds.float().cpu()
        out["embeds_rel"] = float(((e - r).norm(dim=-1)
                                   / r.norm(dim=-1)).max())
    return out


def diagnostics(frames, ref_frames, known) -> dict:
    """Where the frames differ: the mean |difference| of each frame and
    of the known and unknown frames, quantiles of the pixels' |difference|
    and its maximum."""
    d = (frames.float().cpu() - ref_frames.float().cpu()).abs()
    known = known.bool().cpu()
    flat = d.flatten()
    q = torch.quantile(flat[torch.randperm(flat.numel(), generator=torch.
                       Generator().manual_seed(0))[:1 << 22]],
                       torch.tensor([0.5, 0.9, 0.99, 0.999]))
    return dict(per_frame=d.mean(dim=(1, 2, 3)).tolist(),
                known=float(d[known].mean()) if known.any() else None,
                unknown=float(d[~known].mean()) if (~known).any() else None,
                q50=float(q[0]), q90=float(q[1]), q99=float(q[2]),
                q999=float(q[3]), max=float(d.max()),
                rms=float(d.pow(2).mean().sqrt()))


def worst(readings: list) -> dict:
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(readings: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the worst readings against
    the cell's limits; a reading without a limit, or that is not a number,
    fails."""
    shown = {n: {"value": v, "limit": lim["limits"].get(n)}
             for n, v in readings.items()}
    ok = bool(shown) and all(
        c["limit"] is not None and c["value"] == c["value"]
        and c["value"] <= c["limit"] for c in shown.values())
    return ok, shown
