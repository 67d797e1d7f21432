"""One-command parity gate (SSIM >= 0.99) and the opt-in modes' quality
deltas: the port's counterpart of `tools/parity_check.py`, with the same
flags, rows and report keys, plus --device.

    # full gate against converted reference weights (needs the
    # RCDMS_WEIGHTS_ROOT layout of tests/test_weights_gate.py):
    python -m rcdms_tpu_torch.tools.parity_check \
        --weights-root $RCDMS_WEIGHTS_ROOT [--noise-npz ref_noise.npz] \
        --out parity_report.json

    # dry run on tiny seeded weights, every branch of the gate:
    python -m rcdms_tpu_torch.tools.parity_check --synthetic --device cpu

Rows of the JSON report ("skipped" rows name what was missing):

  hf_text_parity / hf_vision_parity   the full-config CLIP towers against
                                      `transformers`' CLIP models on the
                                      same weights (weights mode, where
                                      transformers is installed)
  reference_equal_noise_fp32          the fp32 two-stage run on the
                                      reference's captured noise
                                      (--noise-npz) against its latents:
                                      per-frame SSIM >= 0.99, prior
                                      cosine >= 0.999 (the parity gate)
  determinism_fp32                    two fp32 runs equal bit for bit
  bf16_vs_fp32                        the bf16 build against the fp32
                                      build, frame SSIM
  int8_vs_bf16                        the w8a8 int8 route (ops/quant.py)
                                      against bf16, and whether it engaged
  encoder_prop2_vs_bf16               encoder propagation k = 2 against
                                      bf16

Equal noise: the port's noise is explicit. One `StoryNoise` is drawn in
fp32 from a seeded `torch.Generator` and every run takes it, the fp32
build, the bf16 build, the int8 run and the k = 2 run; each casts it as
`generate` does. The int8 route quantizes each gated conv from its fp32
values when the model is cast to bf16, so the bf16 build is cast with the
int8 mode on; its bf16 run has the mode off.

The npz of --noise-npz has the schema of `tools/capture_ref_noise.py`
(`prior_{field}` for every PriorConditioning field, `story_{field}` for
every StoryConditioning field but image_proj, `prior_init_latents`,
`prior_step_noise`, `story_init_latents`, `reference_latents` and
optionally `reference_prior_embeds`); `conditioning_from_npz` reads it.
Stage 2's image_proj is the pipeline's: the known frames' own embeds
(`prior_image_embed`) where a frame is known, else the prior's output.
The fusion does not read image_proj at a known frame (its `where` takes
the seen stack there), so the JAX tool's whole prior output gives the
same latents.

The gate's verdict: PASS unless the reference check ran and failed, an HF
row failed, or the two fp32 runs differ.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from rcdms_tpu_torch.cli.common import DTYPES, device_of
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.sample.eval import ssim
from rcdms_tpu_torch.sample.pipeline import (
    StoryInputs,
    StoryNoise,
    StoryPipeline,
    build_pipeline,
    tiny_configs,
    tiny_inputs,
)
from rcdms_tpu_torch.sample.prior_sampler import PriorConditioning
from rcdms_tpu_torch.sample.story_sampler import StoryConditioning

SYNTHETIC_UNET_CHANNELS = (64, 128)  # Cin % 64 == 0: the int8 convs engage
NOISE_SEED = 0                       # the one draw every mode takes


# ---------------------------------------------------------------------------
# pipeline builders (weights vs synthetic), one per dtype
# ---------------------------------------------------------------------------


def _build(weights_root: Optional[str], dtype: str, steps: int,
           guidance: float, dataset: str, device):
    """(pipeline, inputs) on `device`. Weights mode loads the converted
    reference weights through the evaluate CLI's builder; synthetic mode
    builds the tiny pipeline with seeded weights, UNet channels (64, 128)
    so that the int8 convs engage."""
    if weights_root is None:
        configs = tiny_configs(unet_channels=SYNTHETIC_UNET_CHANNELS)
        pipeline = build_pipeline(configs, device, DTYPES[dtype], seed=0,
                                  num_steps=steps, guidance_scale=guidance)
        inputs = tiny_inputs(configs, seed=0)
        return pipeline, StoryInputs(*(t.to(device) for t in inputs))

    from rcdms_tpu_torch.cli import evaluate

    args = evaluate.parse_args([
        "--dataset", dataset,
        "--sd-pretrained", f"{weights_root}/stable-diffusion-v1-5",
        "--prior-pretrained", f"{weights_root}/kandinsky-2-2-prior/prior",
        "--text-s1-pretrained",
        f"{weights_root}/kandinsky-2-2-prior/text_encoder",
        "--vision-pretrained",
        f"{weights_root}/kandinsky-2-2-prior/image_encoder",
        "--num-inference-steps", str(steps),
        "--guidance-scale", str(guidance),
        "--dtype", dtype,
        "--device", str(device),
    ])
    pipeline, _, ds_cfg = evaluate.build_pipeline(args)
    return pipeline, _default_inputs(pipeline, ds_cfg)


def _default_inputs(pipeline: StoryPipeline, ds_cfg) -> StoryInputs:
    """Seeded StoryInputs at the real pipeline's shapes, frame 0 known (the
    mode deltas compare the pipeline with itself: the conditioning need
    only be fixed)."""
    f, size, csize = (ds_cfg.num_frames, ds_cfg.image_size,
                      ds_cfg.clip_size)
    t1 = pipeline.configs.text_s1.max_positions
    t2 = pipeline.configs.text_s2.max_positions
    rng = np.random.RandomState(0)
    dev = pipeline.device

    def ids(t):
        return torch.from_numpy(rng.randint(1, 1000, (1, f, t))).to(
            dev, torch.int64)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    known = torch.zeros(1, f, dtype=torch.bool, device=dev)
    known[:, 0] = True
    return StoryInputs(
        tokens_s1=ids(t1), tokens_s1_u=ids(t1), tokens_s2=ids(t2),
        tokens_s2_u=ids(t2), source_clip=randn(1, f, csize, csize, 3),
        mask_clip=randn(1, f, csize, csize, 3),
        source_pixels=torch.zeros(1, f, size, size, 3, device=dev),
        frame_known=known)


def _draw_noise(pipeline: StoryPipeline, inputs: StoryInputs) -> StoryNoise:
    """One request's fp32 noise from a generator seeded NOISE_SEED on the
    pipeline's device: every mode of the gate takes this one draw."""
    return StoryNoise.draw(
        pipeline, inputs.frame_known.shape[0],
        torch.Generator(pipeline.device).manual_seed(NOISE_SEED),
        tuple(inputs.source_pixels.shape[2:4]))


def _generate(pipeline: StoryPipeline, inputs: StoryInputs,
              noise: StoryNoise, prop: int = 0):
    """Full two-stage generate on `noise`; (frames in [0, 1], prior
    embeds) as fp32 numpy."""
    if prop:
        pipeline = pipeline.with_sampler(encoder_propagation=prop)
    frames, embeds = pipeline.generate(inputs, noise=noise)
    return (frames.float().cpu().numpy(), embeds.float().cpu().numpy())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _frame_ssim(a: np.ndarray, b: np.ndarray) -> list:
    return [float(ssim(a[0, i], b[0, i])) for i in range(a.shape[1])]


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    x, y = a.ravel(), b.ravel()
    return float(np.dot(x, y)
                 / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-12))


def _delta_row(frames_ref, embeds_ref, frames_alt, embeds_alt) -> dict:
    sims = _frame_ssim(frames_ref, frames_alt)
    return {
        "status": "measured",
        "ssim_per_frame": [round(s, 4) for s in sims],
        "ssim_min": round(min(sims), 4),
        "prior_cos": round(_cos(embeds_ref, embeds_alt), 5),
    }


# ---------------------------------------------------------------------------
# the reference equal-noise check (needs the captured noise npz)
# ---------------------------------------------------------------------------


def conditioning_from_npz(ns, prior_embeds=None, device="cpu",
                          dtype=torch.float32):
    """(PriorConditioning, StoryConditioning) of an npz of the schema
    above (any mapping of name -> array), on `device`, float fields in
    `dtype`. The story's image_proj is the pipeline's rule: the known
    frames' embeds (`prior_image_embed`) where `story_frame_known`, else
    `prior_embeds` (b, f, d), the prior's output; without it the story's
    conditioning is None."""
    def get(name):
        a = torch.tensor(np.asarray(ns[name]), device=device)
        return a.to(dtype) if a.is_floating_point() else a

    prior = PriorConditioning(*(get(f"prior_{k}")
                                for k in PriorConditioning._fields))
    if prior_embeds is None:
        return prior, None
    if not isinstance(prior_embeds, torch.Tensor):
        prior_embeds = torch.tensor(np.asarray(prior_embeds))
    story = {k: get(f"story_{k}") for k in StoryConditioning._fields
             if k != "image_proj"}
    story["image_proj"] = torch.where(
        story["frame_known"].bool()[..., None], prior.image_embed,
        prior_embeds.to(device, dtype))
    return prior, StoryConditioning(**story)


def run_torch_side(noise_npz: str, pipeline: StoryPipeline):
    """Drive the pipeline's two samplers on the reference's captured noise
    and conditioning; returns (prior embeds, story latents) as fp32 numpy
    for comparison against the reference's outputs."""
    ns = np.load(noise_npz)
    dev, dtype = pipeline.device, pipeline.dtype

    def noise(name):
        return torch.from_numpy(np.asarray(ns[name], np.float32)).to(dev)

    prior_cond, _ = conditioning_from_npz(ns, None, dev, dtype)
    embeds = pipeline.prior_sampler(prior_cond, noise("prior_init_latents"),
                                    noise("prior_step_noise"))
    _, story_cond = conditioning_from_npz(ns, embeds, dev, dtype)
    latents = pipeline.story_sampler(story_cond, noise("story_init_latents"))
    return (embeds.float().cpu().numpy(), latents.float().cpu().numpy())


def _reference_check(noise_npz: str, pipeline: StoryPipeline) -> dict:
    """The reference row: the fp32 `pipeline`'s samplers on the npz's
    noise against its `reference_latents` (per-frame SSIM over a data
    range of 4, at least 0.99) and `reference_prior_embeds` (cosine at
    least 0.999) where present."""
    ref = np.load(noise_npz)
    if "reference_latents" not in ref:
        return {"status": "skipped",
                "reason": "npz lacks reference_latents"}
    embeds, latents = run_torch_side(noise_npz, pipeline)
    sims = [float(ssim(latents[0, i], ref["reference_latents"][0, i],
                       data_range=4.0))
            for i in range(latents.shape[1])]
    row = {"status": "measured",
           "ssim_per_frame": [round(s, 4) for s in sims],
           "ssim_min": round(min(sims), 4),
           "passed": min(sims) >= 0.99}
    if "reference_prior_embeds" in ref:
        cos = _cos(embeds, np.asarray(ref["reference_prior_embeds"]))
        row["prior_cos"] = round(cos, 5)
        row["passed"] = bool(row["passed"] and cos >= 0.999)
    return row


# ---------------------------------------------------------------------------
# the full-config CLIP towers against transformers
# ---------------------------------------------------------------------------


def _token_batch(vocab: int, t: int):
    """Two rows of `t` random ids from RandomState(0), bos and eos at the
    ends, as the JAX weights gate draws them."""
    rng = np.random.RandomState(0)
    ids = rng.randint(1, vocab - 10, (2, t)).astype(np.int64)
    ids[:, 0] = 49406  # bos
    ids[:, -1] = 49407  # eos
    return ids


def _hf_parity_check(weights_root: str, tower: str, device) -> dict:
    """One full-config tower (tower "text": the bigG text encoder, or
    "vision") loaded by the port's builder against the `transformers`
    model on the same weights, at the JAX gate's tolerances (text: atol
    2e-4, vision: 5e-4; rtol 1e-3). Skipped, naming what is missing,
    without transformers or the weights' directory; failed, with the
    error, where the port's tower cannot take the weights (ViT-bigG/14's
    MLP of 8192 on width 1664, while the towers build 4 x the width:
    ROADMAP.md Queue 3)."""
    try:
        import transformers
    except ImportError:
        return {"status": "skipped", "reason": "transformers not installed"}
    sub = "text_encoder" if tower == "text" else "image_encoder"
    path = os.path.join(weights_root, "kandinsky-2-2-prior", sub)
    if not os.path.isdir(path):
        return {"status": "skipped",
                "reason": f"weights subdir missing: {path}"}
    from rcdms_tpu_torch.cli import common
    from rcdms_tpu_torch.configs import CLIPTextConfig, CLIPVisionConfig

    if tower == "text":
        hf = transformers.CLIPTextModelWithProjection.from_pretrained(path)
        c = hf.config
        cfg = CLIPTextConfig(
            vocab_size=c.vocab_size, width=c.hidden_size,
            num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            max_positions=c.max_position_embeddings,
            projection_dim=c.projection_dim, eos_token_id=c.eos_token_id,
            hidden_act=c.hidden_act)
        build = common.build_text_encoder
        x = torch.from_numpy(_token_batch(cfg.vocab_size,
                                          min(16, cfg.max_positions)))
        hf_in, port_in, atol = x, x.to(device), 2e-4
        keys = ("last_hidden_state", "text_embeds")
    else:
        hf = transformers.CLIPVisionModelWithProjection.from_pretrained(path)
        c = hf.config
        cfg = CLIPVisionConfig(
            image_size=c.image_size, patch_size=c.patch_size,
            width=c.hidden_size, num_layers=c.num_hidden_layers,
            num_heads=c.num_attention_heads,
            projection_dim=c.projection_dim, hidden_act=c.hidden_act)
        build = common.build_vision_encoder
        img = np.random.RandomState(1).randn(
            1, c.image_size, c.image_size, 3).astype(np.float32)
        hf_in = torch.from_numpy(img.transpose(0, 3, 1, 2))
        port_in, atol = torch.from_numpy(img).to(device), 5e-4
        keys = ("last_hidden_state", "image_embeds")
    try:
        enc = build(cfg, path, device=device)
    except (KeyError, RuntimeError, ValueError) as e:
        return {"status": "failed",
                "reason": f"the port's tower cannot take the weights: {e}"}
    with torch.no_grad():
        out = hf.eval()(hf_in)
        got = enc(port_in)
    row = {"status": "passed"}
    for key, mine in zip(keys, got):
        want = getattr(out, key).numpy()
        mine = mine.float().cpu().numpy()
        row[f"{key}_max_abs"] = float(np.abs(mine - want).max())
        if not np.allclose(mine, want, atol=atol, rtol=1e-3):
            row["status"] = "failed"
    return row


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def run_gate(weights_root: Optional[str], noise_npz: Optional[str],
             dataset: str, steps: int, guidance: float,
             device="cuda") -> dict:
    """The report: the rows above and the gate's verdict."""
    report: dict = {
        "mode": "synthetic" if weights_root is None else "weights",
        "dataset": dataset, "steps": steps, "checks": {}}
    checks = report["checks"]

    # 1. HF tower parity (weights mode only)
    if weights_root is not None:
        checks["hf_text_parity"] = _hf_parity_check(weights_root, "text",
                                                    device)
        checks["hf_vision_parity"] = _hf_parity_check(weights_root,
                                                      "vision", device)
    else:
        checks["hf_text_parity"] = checks["hf_vision_parity"] = {
            "status": "skipped", "reason": "synthetic mode"}

    quant.set_quant_mode(None)
    pl32, in32 = _build(weights_root, "float32", steps, guidance, dataset,
                        device)

    # 2. the reference equal-noise gate
    if noise_npz and os.path.exists(noise_npz):
        checks["reference_equal_noise_fp32"] = _reference_check(noise_npz,
                                                                pl32)
    else:
        checks["reference_equal_noise_fp32"] = {
            "status": "skipped",
            "reason": "--noise-npz not provided (capture per PARITY.md)"}

    # 3. mode deltas on one draw of noise (the pipeline against itself)
    noise = _draw_noise(pl32, in32)
    f32, e32 = _generate(pl32, in32, noise)
    f32_rerun, _ = _generate(pl32, in32, noise)
    checks["determinism_fp32"] = {
        "status": "measured",
        "identical": bool(np.array_equal(f32, f32_rerun))}
    del pl32

    # the int8 route quantizes from the fp32 values at the cast to bf16
    quant.set_quant_mode("int8")
    try:
        plb, inb = _build(weights_root, "bfloat16", steps, guidance,
                          dataset, device)
    finally:
        quant.set_quant_mode(None)
    fb, eb = _generate(plb, inb, noise)
    checks["bf16_vs_fp32"] = _delta_row(f32, e32, fb, eb)

    quant.set_quant_mode("int8")
    try:
        fq, eq = _generate(plb, inb, noise)
    finally:
        quant.set_quant_mode(None)
    row = _delta_row(fb, eb, fq, eq)
    row["engaged"] = bool(not np.array_equal(fb, fq))
    checks["int8_vs_bf16"] = row

    fp, ep = _generate(plb, inb, noise, prop=2)
    checks["encoder_prop2_vs_bf16"] = _delta_row(fb, eb, fp, ep)

    # verdict: hard-gate only the checks with defined thresholds
    hard = []
    ref_row = checks["reference_equal_noise_fp32"]
    if ref_row["status"] == "measured":
        hard.append(ref_row.get("passed", False))
    for name in ("hf_text_parity", "hf_vision_parity"):
        if checks[name]["status"] == "failed":
            hard.append(False)
    hard.append(checks["determinism_fp32"]["identical"])
    report["gate"] = "PASS" if all(hard) else "FAIL"
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--weights-root",
                    default=os.environ.get("RCDMS_WEIGHTS_ROOT"))
    ap.add_argument("--synthetic", action="store_true",
                    help="tiny seeded weights (the dry run); the device is "
                         "--device's")
    ap.add_argument("--noise-npz",
                    default=os.environ.get("RCDMS_PARITY_NPZ"))
    ap.add_argument("--dataset", default="pororosv")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 20 (reference eval), 2 in --synthetic")
    ap.add_argument("--guidance", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="report JSON path")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda never falls back to the CPU")
    a = ap.parse_args(argv)
    if a.synthetic:
        a.weights_root = None
    elif not a.weights_root:
        ap.error("--weights-root (or RCDMS_WEIGHTS_ROOT) required "
                 "unless --synthetic")
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    device = device_of(a)
    steps = a.steps or (2 if a.synthetic else 20)
    report = run_gate(a.weights_root, a.noise_npz, a.dataset, steps,
                      a.guidance, device)
    text = json.dumps(report, indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(text + "\n")
    return 0 if report["gate"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
