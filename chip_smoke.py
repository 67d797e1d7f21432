#!/usr/bin/env python3
"""Smoke test of the PyTorch port (rcdms_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: compiles rcdms_tpu_torch/csrc/*.cu with nvcc (sm_90a) and loads
   the library; prints the build seconds; the ptxas report goes to
   chiprun_out/chip_smoke_ptxas.log;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the main path's shapes, in fp32 and bf16 (TF32 off), tolerance
   max|kernel - plain| / max|plain| <= 1e-4 (fp32) and 2e-2 (bf16), with
   the median time of each side;
4. reference: the tiny pipeline in fp32 on the card, through the kernels,
   against the same pipeline on the CPU (plain versions) on the same
   noise: stage-1 embeds within 5e-4, frames within 1e-3;
5. story: the full-width two-stage pipeline (Flintstones configs: 91
   tokens, vocab 49412, 512 px, 5 frames) in bf16 with seeded random
   weights: the story-independent conditioning cache, two requests with
   their own generators, and request 1 again. Frames must be finite, in
   [0, 1], of shape (1, 5, 512, 512, 3), the repeat equal to the first run
   within 1e-3, and every kernel's launch count must grow.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STEPS = 20    # DDIM and UnCLIP steps of a story, the reference's
PIXELS = 512  # story frames are PIXELS x PIXELS

# kernel name -> (source, the TPU kernel it replaces)
KERNEL_INFO = {
    "attention": ("rcdms_tpu_torch/csrc/attention.cu",
                  "rcdms_tpu/ops/flash.py:142 (_nt_kernel) and :61 "
                  "(_attn_kernel)"),
    "frame_attention": ("rcdms_tpu_torch/csrc/frame_attention.cu",
                        "rcdms_tpu/ops/frame_attention.py:68 (_kernel_bfnc)"),
    "geglu_ff": ("rcdms_tpu_torch/csrc/ff.cu",
                 "rcdms_tpu/ops/geglu.py:149 (_ff_kernel)"),
    "gelu_ff": ("rcdms_tpu_torch/csrc/ff.cu",
                "rcdms_tpu/ops/geglu.py:299 (_ff_gelu_kernel)"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10) -> float:
    """Median time of fn on the card over reps runs (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(dev, dtype):
    """(kernel name, shape label, kernel call, plain call) at the main
    path's shapes (512 px, 5 frames, b = 1)."""
    from rcdms_tpu_torch.ops.flash import attention_plain, flash_attention
    from rcdms_tpu_torch.ops.frame_attention import (
        frame_attention,
        frame_attention_plain,
    )
    from rcdms_tpu_torch.ops.geglu import (
        geglu_ff,
        geglu_ff_plain,
        gelu_ff,
        gelu_ff_plain,
    )

    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    cases = []
    # kernel A: UNet self/cross attention per level, CLIP vision attention
    for s, c in ((4096, 320), (1024, 640), (256, 1280)):
        dh = c // 8
        q = r(1, 5, s, c)
        for skv, tag in ((s, "self"), (91, "cross")):
            k, v = r(1, 5, skv, c), r(1, 5, skv, c)
            cases.append((
                "attention", f"unet {tag} Sq={s} Skv={skv} dh={dh}",
                lambda q=q, k=k, v=v: flash_attention(q, k, v, 8),
                lambda q=q, k=k, v=v, dh=dh: attention_plain(
                    q, k, v, 8, dh ** -0.5)))
    q, k, v = r(5, 257, 1664), r(5, 257, 1664), r(5, 257, 1664)
    cases.append(("attention", "clip-vision S=257 dh=104",
                  lambda q=q, k=k, v=v: flash_attention(q, k, v, 16),
                  lambda q=q, k=k, v=v: attention_plain(q, k, v, 16,
                                                        104 ** -0.5)))
    # kernel B: UNet temporal modules per level, prior temporal modules
    for shape in ((1, 5, 4096, 320), (1, 5, 1024, 640), (1, 5, 256, 1280),
                  (1, 5, 64, 1280), (2, 5, 97, 2048)):
        q, k, v = r(*shape), r(*shape), r(*shape)
        dh = shape[-1] // 8
        cases.append((
            "frame_attention", "x".join(map(str, shape)),
            lambda q=q, k=k, v=v: frame_attention(q, k, v, 8),
            lambda q=q, k=k, v=v, dh=dh: frame_attention_plain(
                q, k, v, 8, dh ** -0.5)))
    # kernels C and D: UNet and prior feed-forwards (rows x c, inner 4c);
    # bf16 takes the tensor-core kernel, fp32 the CUDA-core one
    for rows, c, geglu in ((20480, 320, True), (5120, 640, True),
                           (1280, 1280, True), (320, 1280, True),
                           (970, 2048, True), (970, 2048, False)):
        inner = 4 * c
        up = 2 * inner if geglu else inner
        args = (r(rows, c), r(up, c, scale=c ** -0.5), r(up, scale=0.1),
                r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
        fn, plain = (geglu_ff, geglu_ff_plain) if geglu else (gelu_ff,
                                                               gelu_ff_plain)
        cases.append((fn.__name__, f"{rows}x{c} inner {inner}",
                      lambda a=args, fn=fn: fn(*a),
                      lambda a=args, p=plain: p(*a)))
    return cases


def check_kernels(dev, card: str) -> dict:
    """Phase 3: every kernel against its plain version; returns the
    per-kernel summary (bf16 times at each kernel's first listed shape,
    the largest error over all shapes and both dtypes)."""
    from rcdms_tpu_torch import ops

    print(f"kernels on {card}: median ms of 10 calls, kernel and plain",
          flush=True)
    summary = {name: {"max_abs_err": 0.0} for name in ops.KERNELS}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, kernel, plain in kernel_cases(dev, dtype):
            out = kernel()
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            row = dict(kernel=name, shape=label, dtype=str(dtype)[6:],
                       max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms)
            rows.append(row)
            print(f"kernel {name:16s} {row['dtype']:8s} {label:34s} "
                  f"rel_err {rel:.2e} kernel {ms:9.3f} ms "
                  f"plain {plain_ms:9.3f} ms", flush=True)
            if not rel <= TOL[dtype]:
                raise AssertionError(f"{name} {label} {dtype}: relative "
                                     f"error {rel:.3e} > {TOL[dtype]}")
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dtype == torch.bfloat16 and "ms" not in s:
                s.update(ms=ms, plain_ms=plain_ms, shape=label)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return summary


def check_tiny_reference(dev) -> dict:
    """Phase 4: the tiny pipeline (fp32, seeded weights, 2 steps) on the
    card, through the kernels, against the same pipeline on the CPU, where
    every wrapper runs its plain version, on the same explicit noise.
    Tolerances as the CPU tests hold the port against the JAX package:
    5e-4 on the stage-1 embeds, 1e-3 on the frames (fp32 on both sides,
    TF32 off; sums in another order, compounded over the steps)."""
    import copy

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.sample.pipeline import StoryNoise, build_tiny_pipeline

    pipe, inputs = build_tiny_pipeline(seed=0, num_steps=2)
    cfg = pipe.configs
    b, f = inputs.frame_known.shape
    d = cfg.prior.embedding_dim
    h8 = inputs.source_pixels.shape[2] // 2 ** (len(cfg.vae.block_channels)
                                                 - 1)
    g = torch.Generator().manual_seed(5)
    noise = StoryNoise(*(torch.randn(s, generator=g) for s in (
        (b, f, d), (2, b, f, d), (b * f, h8, h8, 4), (b, f, h8, h8, 4))))
    frames, embeds = pipe.generate(inputs, noise=noise)

    card = copy.deepcopy(pipe).to(dev)
    ops.reset_launch_counts()
    frames_c, embeds_c = card.generate(
        type(inputs)(*(t.to(dev) for t in inputs)),
        noise=StoryNoise(*(t.to(dev) for t in noise)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    embed_err = (embeds_c.cpu() - embeds).abs().max().item()
    frame_err = (frames_c.cpu() - frames).abs().max().item()
    print(f"reference: tiny story on the card vs the CPU: embeds max|diff| "
          f"{embed_err:.2e}, frames max|diff| {frame_err:.2e}; launches "
          f"{counts}", flush=True)
    if not (embed_err <= 5e-4 and frame_err <= 1e-3):
        raise AssertionError("the tiny story on the card disagrees with the "
                             "CPU's plain versions")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"tiny story launched no {missing}")
    return dict(embed_err=embed_err, frame_err=frame_err)


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_constant(value: float, size: int, dev) -> torch.Tensor:
    """A CLIP-preprocessed constant image (value in [0, 1])."""
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    return ((value - mean) / std).expand(size, size, 3).contiguous()


def token_rows(g, f: int, length: int, eos: int, dev):
    """(1, f, length) caption ids as CLIP's tokenizer lays them out: BOS
    (eos - 1), random words, EOS, EOS padding; and the "" row."""
    ids = torch.full((1, f, length), eos, dtype=torch.int64)
    ids[..., 0] = eos - 1
    uncond = ids.clone()
    for i in range(f):
        n = int(torch.randint(1, length - 1, (1,), generator=g))
        ids[0, i, 1:n + 1] = torch.randint(0, eos - 1, (n,), generator=g)
    return ids.to(dev), uncond.to(dev)


def story_request(configs, seed: int, pixels: int, dev):
    """One story: seeded captions, frame 0 known (a seeded random image),
    frames 1-4 unknown (black)."""
    from rcdms_tpu_torch.sample.pipeline import StoryInputs

    g = torch.Generator().manual_seed(seed)
    f, t = configs.prior.num_frames, configs.prior.num_text_tokens
    csize = configs.vision.image_size
    known = torch.zeros(1, f, dtype=torch.bool, device=dev)
    known[0, 0] = True
    frame0 = torch.rand(pixels, pixels, 3, generator=g).to(dev)
    px = torch.full((1, f, pixels, pixels, 3), -1.0, device=dev)
    px[0, 0] = frame0 * 2 - 1
    clip0 = torch.nn.functional.interpolate(
        frame0.permute(2, 0, 1)[None], size=(csize, csize),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    source_clip = clip_constant(0.0, csize, dev).expand(1, f, csize, csize,
                                                        3).clone()
    source_clip[0, 0] = (clip0 - mean) / std
    mask_clip = torch.where(known[..., None, None, None],
                            clip_constant(1.0, csize, dev),
                            clip_constant(0.0, csize, dev))
    tokens, uncond = token_rows(g, f, t, configs.text_s1.eos_token_id, dev)
    return StoryInputs(tokens_s1=tokens, tokens_s1_u=uncond,
                       tokens_s2=tokens, tokens_s2_u=uncond,
                       source_clip=source_clip, mask_clip=mask_clip,
                       source_pixels=px, frame_known=known)


def run_story(configs, dev, dtype, steps: int, pixels: int) -> dict:
    """Phase 5: build, cache, two requests and a repeat; returns the
    per-request seconds and the launch counts of the main path."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.sample.pipeline import build_pipeline

    t0 = time.perf_counter()
    pipe = build_pipeline(configs, dev, dtype, seed=0, num_steps=steps)
    requests = [story_request(configs, seed, pixels, dev)
                for seed in (1, 2)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    print(f"story: built the full pipeline in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in pipe.parameters()) / 1e9:.3f} B params, "
          f"{steps} steps", flush=True)

    csize = configs.vision.image_size
    ops.reset_launch_counts()
    uncond = requests[0].tokens_s1_u[0, 0]
    cache = pipe.precompute_cond_cache(uncond, uncond,
                                       clip_constant(1.0, csize, dev),
                                       clip_constant(0.0, csize, dev))
    results, seconds = [], []
    for i, (req, seed) in enumerate(((requests[0], 11), (requests[1], 12),
                                     (requests[0], 11))):
        t0 = time.perf_counter()
        frames, embeds = pipe.generate(
            req, cache, torch.Generator(dev).manual_seed(seed))
        sync()
        seconds.append(time.perf_counter() - t0)
        print(f"story: request {i + 1} {'(repeat of 1) ' if i == 2 else ''}"
              f"{seconds[-1]:.3f} s", flush=True)
        results.append(frames)
    counts = ops.launch_counts()

    f = configs.prior.num_frames
    for frames in results:
        if frames.shape != (1, f, pixels, pixels, 3):
            raise AssertionError(f"frames shape {tuple(frames.shape)}")
        if not torch.isfinite(frames).all():
            raise AssertionError("non-finite frames")
        if frames.min() < 0 or frames.max() > 1:
            raise AssertionError("frames outside [0, 1]")
    repeat_err = (results[2] - results[0]).abs().max().item()
    if repeat_err > 1e-3:
        raise AssertionError(f"repeat differs by {repeat_err}")
    if (results[1] - results[0]).abs().max().item() == 0:
        raise AssertionError("two different requests gave equal frames")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    print(f"story: repeat max|diff| {repeat_err:.2e}; launches {counts}",
          flush=True)
    return dict(seconds=seconds, counts=counts, repeat_err=repeat_err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rcdms_tpu_torch.ops import _build
    from rcdms_tpu_torch.sample.pipeline import full_configs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({built.path.name}, "
          f"nvcc {built.seconds:.1f} s)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.log"), "w") as fh:
        fh.write(built.log)

    summary = check_kernels(dev, card)
    check_tiny_reference(dev)
    story = run_story(full_configs(temporal_zero_init=False), dev,
                      torch.bfloat16, STEPS, PIXELS)
    print(f"story: {card}: per-request seconds "
          f"{[round(s, 3) for s in story['seconds']]} at {STEPS} steps",
          flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=story["counts"][name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            shape=s["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
