"""The port's benchmark entry point, the counterpart of the root `bench.py`
(the JAX package's, which stays as it is): it times the port's main path
through its own entry points and prints ONE JSON line.

    python -m rcdms_tpu_torch.bench                   # stage 2 on the card
    python -m rcdms_tpu_torch.bench --full-pipeline   # the two-stage story
    python -m rcdms_tpu_torch.bench --train-step      # a stage-2 step
    torchrun --nproc-per-node N -m rcdms_tpu_torch.bench --shard-story
    python -m rcdms_tpu_torch.bench --tiny --device cpu  # CPU smoke

Modes, each with the JAX bench's flags and keys:

  * stage 2 (the default): `StorySampler` over the SD-1.5-scale
    `StoryUNet` and fusion stacks (`--frames`, `--temporal-attn-layers`,
    `--no-temporal`), bf16, 512 px (`--image-size`: latents of a side of
    size / 8), 257 vision and 91 text tokens, frame 0 known, 20 DDIM steps
    (`--steps`), CFG `--guidance-scale`, sequential CFG unless
    `--batched-cfg`, `--encoder-propagation k`; metric
    `stage2_frames_per_sec_per_chip`. `--tiny`: the configs' `.tiny()`,
    8 x 8 latents, 9 vision and 7 text tokens, 3 steps;
  * `--full-pipeline`: `StoryPipeline.generate` as the evaluate CLI
    builds it (`cli/evaluate.py::build_pipeline`, `--dtype bfloat16`, or
    `--synthetic` with `--tiny`) on numpy-seeded inputs, with the
    story-independent conditioning precomputed once unless
    `--no-cond-cache`; metric `two_stage_frames_per_sec_per_chip`;
  * `--train-step`: `Stage2Trainer` at full width (`--remat`), AdamW at lr
    1e-5, no warmup, clip 1.0; metric `stage2_train_step_p50_s`.
    `--params-dtype bfloat16` (the default, as the JAX bench's) keeps bf16
    parameters and so bf16 moments (`TrainState.create`'s
    `params_dtype`); `float32` keeps fp32 masters under bf16 compute. The
    port's bf16 model keeps its norm and time-MLP parameters in fp32
    (`core/layers.py::_Fp32Params`), where the JAX bench's cast turns
    every fp32 leaf into bf16: under 0.1% of the bytes;
  * `--shard-story` (stage 2): the ranks of `torchrun` join a process
    group (`train/distributed.py`) and split each story over the
    ('cfg', 'frame', 'space') mesh of `train/sharding.py::inference_mesh`;
    rank 0 alone prints. frames/s/chip divides by the number of distinct
    cards the ranks use (gloo ranks sharing one card count it once), and
    `world_size` is printed beside `n_chips`.

Weights are seeded random, drawn like flax's initializers
(`core/layers.py::init_like_flax_`), never zeros as the JAX bench's are:
the tensor cores' power depends on the bits they multiply, and all-zero
operands draw less of it, so under the card's power limit they hold
higher clocks and would time a faster program than the one users run.
The conditioning is drawn from a seeded `torch.Generator` on the device.

Timing (the JAX bench's `timed_compile` and loop): the first call alone
is `first_run_s`; then one untimed warm-up call (the sampling modes) and
`--repeats` timed calls, each its own generator seeded from (seed, i),
each ended by `torch.cuda.synchronize()` and timed by
`time.perf_counter()`; the p50 is the true median. PyTorch compiles
nothing ahead of time, so `compile_s` is the kernel library's build
seconds in this process (`ops/_build.py::library().seconds`: 0.0 where a
build in `build/` was reused, and where no card runs the kernels).

Output: the JAX bench's keys for each mode, without `vs_baseline`,
`vs_baseline_denominator` and `modeled_v5e8_full_story_p50_s` (a TPU
target and a TPU model); `backend` is "cuda" or "cpu"; added are
`device_name` and `power_limit_w` (nvidia-smi's), the memory keys of the
JAX train step in every mode (`gb_in_use` and `gb_limit` from
`torch.cuda.memory_allocated` and `mem_get_info`, `peak_gb_in_use` from
`max_memory_allocated` reset before the timed calls; null on the CPU,
which is no device), `world_size` in the stage-2 mode, and `attn` (and
the train step's `params_dtype`) in the modes whose JAX line lacks it.

`--attn auto|plain|kernel` sets `ops/impl.py`'s process-wide routing
(the JAX bench's `auto|xla|pallas`); `--int8` the w8a8 mode of
`ops/quant.py`. `run(argv)` returns the line's dict and restores both
settings; `main()` prints it.
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import statistics
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rcdms_tpu_torch import ops
from rcdms_tpu_torch.cli.common import device_of, story_seed
from rcdms_tpu_torch.configs import (
    FusionConfig,
    OptimizerConfig,
    StoryUNetConfig,
    TemporalConfig,
)
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.ops.frame_attention import frame_attention
from rcdms_tpu_torch.sample.pipeline import for_inference
from rcdms_tpu_torch.sample.story_sampler import (
    StoryConditioning,
    StorySampler,
)
from rcdms_tpu_torch.train import distributed

WEIGHT_SEED = 0  # the UNet's and fusion stacks' weights
COND_SEED = 1    # the conditioning's and the training batch's draws
CALL_SEED = 42   # the sampling calls' noise (the JAX bench's PRNGKey(42))
STEP_SEED = 0    # the training steps' noise (its PRNGKey(0))
MEMORY_KEYS = ("gb_in_use", "peak_gb_in_use", "gb_limit")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--attn", default="auto", choices=list(ops.impl.IMPLS),
                    help="auto: today's routing; plain: the plain versions "
                         "of A-D, no kernel; kernel: A at every unmasked "
                         "site it takes (ops/impl.py)")
    ap.add_argument("--params-dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="(--train-step) bf16 parameters and moments, or "
                         "fp32 masters under bf16 compute; the sampling "
                         "modes hold bf16 parameters")
    ap.add_argument("--no-temporal", action="store_true",
                    help="diagnostic: drop temporal modules")
    ap.add_argument("--temporal-attn-layers", type=int, default=2,
                    help="diagnostic: temporal attention layers per block")
    ap.add_argument("--batch", type=int, default=1,
                    help="stories per batch")
    ap.add_argument("--image-size", type=int, default=512,
                    help="pixel size; latents are size/8")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per story (default 5)")
    ap.add_argument("--guidance-scale", type=float, default=2.0,
                    help="CFG scale (compute cost is scale-independent)")
    ap.add_argument("--steps", type=int, default=None,
                    help="DDIM steps (default: 20, the reference eval "
                         "config; 3 with --tiny)")
    ap.add_argument("--batched-cfg", action="store_true",
                    help="run the CFG pair as one batch-2b UNet call "
                         "instead of two sequential b calls")
    ap.add_argument("--encoder-propagation", type=int, default=0,
                    help="OPT-IN approximate fast sampling: recompute the "
                         "UNet encoder every k-th step (k>=2; changes "
                         "numerics)")
    ap.add_argument("--int8", action="store_true",
                    help="OPT-IN w8a8 int8 inference (ops/quant.py; "
                         "changes numerics)")
    ap.add_argument("--full-pipeline", action="store_true",
                    help="measure the whole two-stage pipeline (CLIP towers "
                         "+ prior + unet + VAE) instead of stage-2 only")
    ap.add_argument("--no-cond-cache", action="store_true",
                    help="(--full-pipeline) re-encode the story-independent "
                         "conditioning per story instead of using the "
                         "precomputed CondCache")
    ap.add_argument("--shard-story", action="store_true",
                    help="(stage 2) split the single story over the ranks "
                         "of torchrun's process group (('cfg','frame',"
                         "'space') inference mesh)")
    ap.add_argument("--train-step", action="store_true",
                    help="measure the full-scale stage-2 train step "
                         "(StoryUNet + fusion, AdamW, bf16 compute)")
    ap.add_argument("--remat", action="store_true",
                    help="(--train-step) gradient checkpointing on the "
                         "UNet sub-blocks")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda never falls back to the CPU")
    return ap.parse_args(argv)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on `device`; a meta build (shapes alone) draws
    nothing, so it takes a CPU one."""
    return torch.Generator("cpu" if device.type == "meta"
                           else device).manual_seed(seed)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- stage 2 -----------------------------------------------------------


class Stage2Spec(NamedTuple):
    """The stage-2 mode's configs and sizes, as the JAX bench's `build`."""

    unet: StoryUNetConfig
    fusion: FusionConfig
    hw: int      # latent side
    n_vis: int   # CLIP vision tokens a frame
    tokens: int  # caption tokens
    steps: int


def stage2_spec(args) -> Stage2Spec:
    steps = args.steps
    if args.tiny:
        ucfg = StoryUNetConfig.tiny(use_temporal=not args.no_temporal)
        fcfg = FusionConfig.tiny(hidden_dim=ucfg.cross_attention_dim,
                                 text_dim=ucfg.cross_attention_dim)
        return Stage2Spec(ucfg, fcfg, 8, 9, 7, steps or 3)
    ucfg = StoryUNetConfig(  # SD1.5-scale
        use_temporal=not args.no_temporal, num_frames=args.frames or 5,
        temporal=TemporalConfig(
            attn_layers_per_block=args.temporal_attn_layers))
    return Stage2Spec(ucfg, FusionConfig(), args.image_size // 8, 257, 91,
                      steps or 20)


class Stage2(NamedTuple):
    spec: Stage2Spec
    sampler: StorySampler
    cond: StoryConditioning
    frames: int  # frames a call: batch x frames a story


def conditioning(spec: Stage2Spec, batch: int,
                 device: torch.device) -> StoryConditioning:
    """Seeded random bf16 conditioning at the JAX bench's shapes: frame 0
    known, mask labels ones."""
    g = _generator(device, COND_SEED)
    b, f, fcfg = batch, spec.unet.num_frames, spec.fusion
    dtype = torch.bfloat16

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    known = torch.zeros(b, f, dtype=torch.bool, device=device)
    known[:, 0] = True
    return StoryConditioning(
        text_hidden=r(b, f, spec.tokens, fcfg.text_dim),
        text_hidden_u=r(b, f, spec.tokens, fcfg.text_dim),
        image_tokens=r(b, f, spec.n_vis, fcfg.seen_vis_dim),
        image_proj=r(b, f, fcfg.unseen_vis_dim),
        frame_known=known,
        masked_latents=r(b, f, spec.hw, spec.hw, 4),
        mask_label=torch.ones(b, f, spec.hw, spec.hw, 1, dtype=dtype,
                              device=device))


def build_stage2(args, device: torch.device, mesh=None) -> Stage2:
    """The stage-2 sampler over seeded random UNet and fusion stacks in
    bf16 on `device` (the int8 mode, if set, quantizes at the cast), and
    its conditioning."""
    spec = stage2_spec(args)
    g = _generator(device, WEIGHT_SEED)
    with device:
        unet, fusion = StoryUNet(spec.unet), FusionModule(spec.fusion)
    init_like_flax_(unet, g)
    init_like_flax_(fusion, g)
    sampler = StorySampler(
        for_inference(unet, torch.bfloat16),
        for_inference(fusion, torch.bfloat16),
        num_steps=spec.steps, guidance_scale=args.guidance_scale,
        sequential_cfg=not args.batched_cfg,
        encoder_propagation=args.encoder_propagation, mesh=mesh)
    return Stage2(spec, sampler, conditioning(spec, args.batch, device),
                  args.batch * spec.unet.num_frames)


# ---- the full pipeline ---------------------------------------------------


class FullPipeline(NamedTuple):
    pipeline: object  # StoryPipeline
    inputs: object    # StoryInputs
    cache: object     # CondCache, or None
    frames: int


def build_full_pipeline(args, device: torch.device, steps: int,
                        cond_cache: bool = True) -> FullPipeline:
    """The evaluate CLI's pipeline (seeded random towers at full width in
    bf16, or its tiny synthetic ones in fp32), numpy-seeded inputs as the
    JAX bench's, and the CondCache unless `cond_cache` is False."""
    from rcdms_tpu_torch.cli import evaluate
    from rcdms_tpu_torch.sample.pipeline import StoryInputs

    argv = ["--synthetic"] if args.tiny else ["--dtype", "bfloat16"]
    eargs = evaluate.parse_args(argv + [
        "--num-inference-steps", str(steps), "--guidance-scale", "2.0",
        "--encoder-propagation", str(args.encoder_propagation),
        "--device", str(device)])
    pipeline, _, ds_cfg = evaluate.build_pipeline(eargs)
    b, f = args.batch, ds_cfg.num_frames
    size, csize = ds_cfg.image_size, ds_cfg.clip_size
    t1 = pipeline.configs.text_s1.max_positions
    t2 = pipeline.configs.text_s2.max_positions
    rng = np.random.RandomState(0)

    def ids(t):
        return torch.from_numpy(rng.randint(0, 1000, (b, f, t))).to(device)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device)

    known = torch.zeros(b, f, dtype=torch.bool, device=device)
    known[:, 0] = True
    inputs = StoryInputs(
        tokens_s1=ids(t1), tokens_s1_u=ids(t1), tokens_s2=ids(t2),
        tokens_s2_u=ids(t2), source_clip=randn(b, f, csize, csize, 3),
        mask_clip=randn(b, f, csize, csize, 3),
        source_pixels=torch.zeros(b, f, size, size, 3, device=device),
        frame_known=known)
    cache = None
    if cond_cache:
        # the story-independent conditioning, once: the uncond rows and
        # stand-ins for the white / black mask images (the same compute
        # as the real constants)
        cache = pipeline.precompute_cond_cache(
            inputs.tokens_s1_u[0, 0], inputs.tokens_s2_u[0, 0],
            torch.ones(csize, csize, 3, device=device),
            torch.zeros(csize, csize, 3, device=device))
    return FullPipeline(pipeline, inputs, cache, b * f)


# ---- the train step ------------------------------------------------------


class TrainRig(NamedTuple):
    state: object  # train.train_state.TrainState
    batch: object  # train.stage2.Stage2Batch
    n_params: int


def build_train(args, device: torch.device) -> TrainRig:
    """`Stage2Trainer` with seeded random weights, AdamW (lr 1e-5, no
    warmup, clip 1.0), bf16 compute over `--params-dtype` parameters, and
    a seeded batch at the JAX bench's shapes."""
    from rcdms_tpu_torch.train.optim import make_optimizer
    from rcdms_tpu_torch.train.stage2 import Stage2Batch, Stage2Trainer
    from rcdms_tpu_torch.train.train_state import TrainState

    if args.tiny:
        ucfg = StoryUNetConfig.tiny(remat=args.remat)
        fcfg = FusionConfig.tiny(hidden_dim=ucfg.cross_attention_dim,
                                 text_dim=ucfg.cross_attention_dim)
        hw, n_vis, t = 8, 9, 7
    else:
        ucfg = StoryUNetConfig(remat=args.remat, temporal=TemporalConfig())
        fcfg = FusionConfig()
        hw, n_vis, t = args.image_size // 8, 257, 91
    dtype = torch.bfloat16
    with device:
        trainer = Stage2Trainer(StoryUNet(ucfg), FusionModule(fcfg))
    init_like_flax_(trainer, _generator(device, WEIGHT_SEED))
    n_params = sum(p.numel() for p in trainer.parameters())
    state = TrainState.create(
        trainer, make_optimizer(OptimizerConfig(
            learning_rate=1e-5, warmup_steps=0, grad_clip_norm=1.0)),
        dtype, getattr(torch, args.params_dtype))

    b, f = args.batch, args.frames or 5
    g = _generator(device, COND_SEED)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    known = torch.zeros(b, f, dtype=torch.bool, device=device)
    known[:, 0] = True
    batch = Stage2Batch(
        latents=r(b, f, hw, hw, 4), masked_latents=r(b, f, hw, hw, 4),
        mask_label=torch.ones(b, f, hw, hw, 1, device=device),
        image_tokens=r(b, f, n_vis, fcfg.seen_vis_dim, dtype=dtype),
        image_proj=r(b, f, fcfg.unseen_vis_dim, dtype=dtype),
        text_hidden=r(b, f, t, fcfg.text_dim, dtype=dtype),
        frame_known=known)
    return TrainRig(state, batch, n_params)


# ---- timing --------------------------------------------------------------


def card() -> tuple:
    """(device name, power limit in W) from nvidia-smi's line, as
    `tools.card_line` reads it."""
    from rcdms_tpu_torch.tools import card_line

    name, limit = (s.strip() for s in card_line().rsplit(",", 1))
    return name, float(limit.split()[0])


def story_counts() -> dict:
    """The story kernels' launch counts, and B's tiled ones."""
    counts = ops.launch_counts("story")
    counts["frame_attention_tiled"] = frame_attention.tiled_launches
    return counts


def _timed(call: Callable[[torch.Generator], object], device, seed: int,
           repeats: int, warm: bool, launches: Optional[list]):
    """(first_s, times): the first call alone, an untimed warm-up call if
    `warm`, then `repeats` timed calls, repeat i on a generator seeded
    from (seed, i). With a `launches` list, each timed call appends the
    story kernels' launch counts of that call. The peak memory is reset
    before the timed calls."""
    def once(g):
        t0 = time.perf_counter()
        call(g)
        sync(device)
        return time.perf_counter() - t0

    first_s = once(_generator(device, seed))
    if warm:
        once(_generator(device, seed))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(repeats):
        g = _generator(device, story_seed(seed, i))
        if launches is not None:
            ops.reset_launch_counts()
        times.append(once(g))
        if launches is not None:
            launches.append(story_counts())
    return first_s, times


def _memory(device: torch.device) -> dict:
    """The memory keys (GiB), null off a card."""
    if device.type != "cuda":
        return dict.fromkeys(MEMORY_KEYS)
    gib = 2 ** 30
    return dict(
        gb_in_use=round(torch.cuda.memory_allocated(device) / gib, 2),
        peak_gb_in_use=round(torch.cuda.max_memory_allocated(device) / gib,
                             2),
        gb_limit=round(torch.cuda.mem_get_info(device)[1] / gib, 2))


def _compile_s(device: torch.device) -> float:
    """The kernel library's build seconds in this process (0.0 where a
    build was reused, and on the CPU, where no kernel runs)."""
    if device.type != "cuda":
        return 0.0
    from rcdms_tpu_torch.ops import _build

    return _build.library().seconds


def _common(device: torch.device) -> dict:
    name, limit = card() if device.type == "cuda" else ("cpu", None)
    return dict(backend=device.type, device_name=name, power_limit_w=limit)


def _distinct_cards(device: torch.device) -> int:
    """The number of distinct cards (or hosts' CPUs) the group's ranks
    run on: 1 with no group."""
    if not distributed.active():
        return 1
    import torch.distributed as dist

    where = device.type
    if device.type == "cuda":
        where = str(torch.cuda.get_device_properties(device).uuid)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, (socket.gethostname(), where),
                           group=distributed.host_group())
    return len(set(everyone))


def run_stage2(args, device: torch.device,
               launches: Optional[list] = None) -> dict:
    if args.params_dtype != "bfloat16":
        raise ValueError("--params-dtype float32 applies to --train-step: "
                         "the port's sampling holds bf16 parameters")
    mesh, n_chips, world = None, 1, 1
    if args.shard_story:
        from rcdms_tpu_torch.train import sharding

        distributed.maybe_initialize(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = sharding.inference_mesh()
        n_chips, world = _distinct_cards(device), mesh.all.size
    compile_s = _compile_s(device)
    rig = build_stage2(args, device, mesh)
    if mesh is not None:
        from rcdms_tpu_torch.train import sharding

        sharding.check_replicated(rig.sampler.unet, mesh.all)
        sharding.check_replicated(rig.sampler.fusion, mesh.all)
    first_s, times = _timed(
        lambda g: rig.sampler(rig.cond, generator=g), device, CALL_SEED,
        args.repeats, True, launches)
    p50 = statistics.median(times)
    fps = rig.frames / p50 / n_chips
    return {
        "metric": "stage2_frames_per_sec_per_chip",
        "value": round(fps, 4),
        "unit": "frames/s/chip",
        "p50_story_latency_s": round(p50, 4),
        "ddim_steps": rig.sampler.num_steps,
        "compile_s": round(compile_s, 2),
        "first_run_s": round(first_s, 2),
        "compile_plus_first_run_s": round(compile_s + first_s, 2),
        **_common(device),
        "tiny": args.tiny,
        "attn": args.attn,
        "params_dtype": args.params_dtype,
        "n_chips": n_chips,
        "world_size": world,
        "encoder_propagation": args.encoder_propagation,
        "int8": args.int8,
        **_memory(device),
    }


def run_full_pipeline(args, device: torch.device,
                      launches: Optional[list] = None) -> dict:
    steps = 3 if args.tiny else (args.steps or 20)
    compile_s = _compile_s(device)
    rig = build_full_pipeline(args, device, steps,
                              cond_cache=not args.no_cond_cache)
    first_s, times = _timed(
        lambda g: rig.pipeline.generate(rig.inputs, rig.cache, generator=g),
        device, CALL_SEED, args.repeats, True, launches)
    p50 = statistics.median(times)
    fps = rig.frames / p50
    return {
        "metric": "two_stage_frames_per_sec_per_chip",
        "value": round(fps, 4),
        "unit": "frames/s/chip",
        "p50_story_latency_s": round(p50, 4),
        "ddim_steps": steps,
        "compile_s": round(compile_s, 2),
        "first_run_s": round(first_s, 2),
        "compile_plus_first_run_s": round(compile_s + first_s, 2),
        **_common(device),
        "tiny": args.tiny,
        "attn": args.attn,
        "int8": args.int8,
        "cond_cache": rig.cache is not None,
        "full_pipeline": True,
        **_memory(device),
    }


def run_train_step(args, device: torch.device,
                   launches: Optional[list] = None) -> dict:
    from rcdms_tpu_torch.train import loop

    compile_s = _compile_s(device)
    rig = build_train(args, device)
    losses = []

    def step(g):
        losses.append(float(loop.train_step(rig.state, rig.batch,
                                            generator=g)))

    # the JAX bench's train step has no warm-up call
    first_s, times = _timed(step, device, STEP_SEED, args.repeats, False,
                            launches)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    p50 = statistics.median(times)
    b = args.batch
    return {
        "metric": "stage2_train_step_p50_s",
        "value": round(p50, 4),
        "unit": "s/step",
        "stories_per_s_per_chip": round(b / p50, 4),
        "batch": b,
        "remat": args.remat,
        "params_m": round(rig.n_params / 1e6, 1),
        "compile_plus_first_run_s": round(compile_s + first_s, 2),
        **_common(device),
        "tiny": args.tiny,
        "attn": args.attn,
        "params_dtype": args.params_dtype,
        **_memory(device),
    }


def run(argv=None, launches: Optional[list] = None) -> dict:
    """The benchmark of the flags in `argv`; returns the JSON line's dict
    (on every rank under `--shard-story`). With a `launches` list, each
    timed call appends its story kernels' launch counts. The attention
    impl and the quant mode are restored on return."""
    args = parse_args(argv)
    if args.shard_story and (args.full_pipeline or args.train_step):
        raise ValueError("--shard-story times the stage-2 mode alone")
    device = device_of(args)
    before = (ops.attention_impl(), quant.get_quant_mode())
    ops.set_attention_impl(args.attn)
    if args.int8:
        quant.set_quant_mode("int8")
    try:
        if args.full_pipeline:
            return run_full_pipeline(args, device, launches)
        if args.train_step:
            return run_train_step(args, device, launches)
        return run_stage2(args, device, launches)
    finally:
        ops.set_attention_impl(before[0])
        quant.set_quant_mode(before[1])


def main(argv=None) -> int:
    joined = not distributed.active()
    try:
        result = run(argv)
        if distributed.rank_and_size()[0] == 0:
            print(json.dumps(result), flush=True)
    finally:
        if joined:  # a group this call joined (`--shard-story`)
            distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
