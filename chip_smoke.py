#!/usr/bin/env python3
"""Smoke test of the PyTorch port (rcdms_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --shard-faults  # phase 12's fault readings
    python3 chip_smoke.py --int8-faults   # phase 13 (a)'s fault readings

Phases, in order; any failure raises and the exit code is nonzero:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: compiles rcdms_tpu_torch/csrc/*.cu with nvcc (sm_90a) and loads
   the library; prints the build seconds; the ptxas report goes to
   chiprun_out/chip_smoke_ptxas.log;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the story's shapes (A-D) or its study's full shapes (the conv and
   GroupNorm kernels in fp32 and bf16; the small-head-dim attention
   kernels E-H, B = 80 batch-heads x 4096 x 4096 at dh 40, in bf16 only),
   TF32 off, tolerance max|kernel - plain| / max|plain| <= 1e-4 (fp32) and
   2e-2 (bf16; H, whose outputs are fp32, 1e-4), with the median time of
   each side, of one PyTorch library call that computes the same function
   where there is one (SDPA beside A,
   B and E, cuDNN beside the conv, torch.var_mean beside the moments,
   F.group_norm + F.silu beside the fused GN with SiLU, F.group_norm
   beside it without; the first port's fused
   GN kernel timed beside the cluster kernel where it takes the shape),
   and the case's bound (its work at the card's published peaks); each
   bf16 B case must take B's tiled kernel (its launch count is printed),
   each fp32 one the general kernel; A's and E's share of bf16 outputs
   off the plain version's bits is printed, and A's must be below 0.38 at
   UNet level 0 (A rounds P against the row's final maximum, as the TPU
   kernels); A's bf16 rows (beside SDPA's device time), E's seven rows
   (beside SDPA's at base128 and nt_t40; nt40's bound counts two
   exponentials a score, its online l and p), the bf16 moments (beside
   torch.var_mean's) and H's four rows (softmax over generated P,
   softmax, softmax2, reduce_only) also print their device time
   (`torch.profiler`, `tools.device_us`), which must not be under their
   bound (every exponential on MUFU.EX2, or every byte read once and
   written once): a share of the bound above 1.0 means work was left
   out; C and
   D are timed beside the unfused pair (two cuBLAS products with the
   biases and the activation between them, `others_ms`); last, every
   (mode, column tile) instance of C/D's GEMM kernel, forced through the
   plan override, at the prior's FF shape (970 x 2048, inner 8192), one
   line each (`check_ff_instances`);
4. reference: the tiny pipeline in fp32 on the card, through the kernels,
   against the same pipeline on the CPU (plain versions) on the same
   noise: stage-1 embeds within 5e-4, frames within 1e-3; the same for
   the sampling opt-ins (DDIM eta 0.5 on injected step noise, batched
   CFG, encoder propagation k = 2, the autoregressive stage 1); the int8
   route: `torch._int_mm` equal to the CPU's integer matmul on the same
   int8 operands at the tiny and full-width UNet's conv shapes, an int8
   conv module within 1e-6 of the CPU's on the same input, and a whole
   int8 tiny story with its frames' mean |diff| within 2e-2;
5. story: the full-width two-stage pipeline (Flintstones configs: 91
   tokens, vocab 49412, 512 px, 5 frames) in bf16 with seeded random
   weights: the story-independent conditioning cache, two requests with
   their own generators, and request 1 again. Frames must be finite, in
   [0, 1], of shape (1, 5, 512, 512, 3), the repeat equal to the first run
   within 1e-3, every kernel of the story (A-D) must have launched, and
   every B launch must have taken the tiled kernel.
   Then one more request under `torch.profiler`: the device time of its
   kernels summed by name into A, B, C/D, cuDNN and other, each group's
   seconds and share printed and written to
   chiprun_out/chip_smoke_story_profile.json;
6. studies: the three ResNet-block studies (`rcdms_tpu_torch/tools/`:
   channel-major 3x3 conv, GroupNorm moments, fused GroupNorm + SiLU) at
   their full shapes, in bf16 and fp32, then the three small-head-dim
   attention studies (flash_smallk, pv_overlap, pv_softmax: E-H, H reading
   or generating each row of P once a block for the warps of its cells) in
   bf16; every row within the tolerance of phase 3 of its study's
   reference (the
   pv_overlap rows also within 0.02 of its fp32 oracle), and every study
   kernel launched;
7. entry points (`rcdms_tpu_torch/cli/`): (a) `cli.generate.run` at full
   width in bf16 with seeded random init (the Flintstones DatasetConfig,
   so no h5 is opened; crc32 tokens; five fixed captions, one seeded
   128 x 128 known frame; 20 steps, CFG 2.0, seed 42): frames finite, in
   [0, 1], of shape (1, 5, 512, 512, 3), each of A-D launched and every B
   launch tiled, the grid written by `save_story_grid` to
   chiprun_out/chip_smoke_story.png with a valid PNG signature and IHDR
   size; (b) checkpoint ingest at full width: the same build's prior
   saved as a stage-1 blob and its UNet and fusion stacks as a stage-2
   DeepSpeed directory (`latest` tag), in bf16, under chiprun_out/, loaded
   by `load_rcdms_stage1` / `load_rcdms_stage2` into towers built from
   another seed; every tensor must equal its source bit for bit, and the
   loaded pipeline's request, on (a)'s inputs and generator, (a)'s frames
   within 1e-3 (phase 5's repeat tolerance); the blobs are deleted
   afterwards; (c) `python -m rcdms_tpu_torch.cli.evaluate --synthetic` in
   fp32 on the card, two stories, continue mode: every metric of the
   JSONL and the summary finite;
8. serve (`rcdms_tpu_torch/cli/serve.py`) at full width in bf16 (7a's
   model flags, --max-batch 2, --max-wait-ms 200, 20 steps) on
   127.0.0.1:0: built and warmed, then three concurrent POST /generate
   (seeds 1, 2, 3; seed 2 with a PNG reference frame): three 200s of 5
   PNGs of 512 x 512 x 3 (read back by `decode_png`), the batch sizes
   printed, every story kernel launched and every B launch tiled; then
   `_run` at batch 1 (seed 1) and batch 2 (seeds 1, 2): the same
   launches, seconds a story at each, seed 1's frames within a mean
   |diff| of 2e-2 of its lone run, finite, in [0, 1]; one request with
   encoder propagation k = 2 (the UNet encodes 20 times against 40);
   7a's request again exact (within 1e-3 of 7a) and with --quantize int8:
   finite, its int8 convs counted, its seconds and SSIM against 7a's
   frames printed.

9. train (`rcdms_tpu_torch/train/`): (1) A (both row-sum families), B and
   C at UNet level-0 shapes and D at the prior's, in bf16 and fp32, with
   operands that require grad: the op's `torch.autograd.Function` launches
   the kernel once a call, and its gradients for a seeded cotangent match
   autograd through the function the JAX backward differentiates
   (`attention_reference`, `frame_attention_reference`,
   `geglu_ff_reference`, `gelu_ff_reference`) in plain PyTorch on the
   card, at phase 3's tolerances; each case's peak memory is printed
   (A's plain backward materialises the level-0 scores); (2) the tiny
   pipeline's trainers in fp32 on the card against the same trainers on
   the CPU, same weights, batch and `TrainNoise`, 3 steps of each stage
   at lr 1e-4: every loss within 1e-4 relative, the parameters after
   step 3 within 1e-4 of each tensor's max, step 1's gradients within
   1e-3 of it (a norm's weight gradient sums over every token, and the
   two devices sum in other orders: up to 1.2e-4 at the UNet mid block's
   LayerNorm on an H100). A key projection's bias, whose gradient is
   zero but for float noise, is left out of the gradients; a tensor that
   starts at zero (the biases, the zero-initialised projections) is all
   Adam updates, which turn noise in a near-zero gradient into up to 2 lr
   a step (lr * g / (|g| + eps)), and is held at that;
   (3) full width (`full_configs(temporal_zero_init=False)`, b = 1, 5
   frames, 512 px, 91 tokens), bf16 compute over fp32 masters, seeded
   random weights, AdamW lr 1e-5, warmup 0, clip 1.0 (stage 2) and 10.0
   (stage 1): the raw batch (seeded pixels and token ids, one known
   frame) through each stage's frozen `encode_batch`, then 3
   steps of stage 2 (UNet + fusion) and, after its state is freed, 3 of
   stage 1 (prior). Every loss and gradient finite, the global gradient
   norm above 0, the tensors with an all-zero gradient printed; the
   forward launches a step (stage 2: A, B, C; stage 1: B, D; A in both
   encodes); stage 2's first step again with remat: loss within 1e-3
   relative, global gradient norm within 1e-2, more forward launches;
   per stage the median seconds of steps 2-3 and the peak memory
   (`torch.cuda.max_memory_allocated`), beside the card's line. Rows go
   to chiprun_out/chip_smoke_train.json.
10. train CLIs (`rcdms_tpu_torch/cli/train_stage{1,2}.py`): (a)
   `train_stage2.run` at full width and depth (1.285 B parameters), bf16
   over fp32 masters, seeded random init, b = 1, lr 1e-5, warmup 0, on a
   full-width synthetic Flintstones story repeated (`OneStory`), prefetch
   on, `--max-train-steps 2 --checkpointing-steps 2 --log-every 1`: the
   step-2 checkpoint equal to the trained state bit for bit; one more
   step in memory on the CLI's generators of step 2; then
   `--resume-from-checkpoint` to step 3: the restored masters, moments
   and counts equal the file's bit for bit, the resumed step-2 loss
   within 1e-3 relative of the in-memory one, and the resumed step's
   launches (its encode and forward) equal phase 9's stage-2 step and
   encode; then `evaluate.build_pipeline` with `--stage2-ckpt` loads
   the UNet and fusion stacks equal to their masters cast to bf16 bit
   for bit; (b) `train_stage1.run` at full width with the prior cut to 4
   of its 20 layers, 2 steps and a checkpoint, restored into the state
   bit for bit; each run's logged step and data seconds (`StepTimer`),
   save and restore seconds, bytes on disk and peak memory printed, the
   checkpoints (under build/chip_smoke_train/) deleted; (c) the native
   feeder built with g++ on the host, 5-frame stories of 128 px packed
   to 512 px / 224 clip equal to the numpy protocol bit for bit, ms a
   story of each. Rows go to chiprun_out/chip_smoke_train_cli.json.
11. data-parallel training (`rcdms_tpu_torch/train/distributed.py`,
   `sharding.py`, the ZeRO-2 step of `optim.py`): (a) phase 10 (a)'s
   2-step `train_stage2.run` again under a one-rank NCCL group joined
   from torchrun's variables (set here for this process): its logged
   losses and its masters equal phase 10's bit for bit, its launches
   phase 10's, its checkpoint (the moments gathered to the host) the
   trained state; step seconds, peak memory and launches a step printed;
   (b) two spawned processes on the one card in a gloo group (NCCL
   refuses two ranks on one device), phase 10 (b)'s stage 1 (prior cut
   to 4 layers) in fp32 at global batch 2 on two stories, with ZeRO-2
   and with --no-zero2, against one process (this one, no group) at
   batch 2: the logged losses and the step-2 masters and moments within
   1e-5 relative (max |diff| over the set's largest magnitude); whether
   ZeRO-2 equals --no-zero2 bit for bit is printed. Rows go to
   chiprun_out/chip_smoke_train_dp.json.
12. sharded single-story inference (`--shard-story`,
   `rcdms_tpu_torch/train/sharding.py`'s inference mesh, the block
   helpers of `rcdms_tpu_torch/core/spatial.py`): (a) phase 7a's
   `generate.run` with `--shard-story` under a one-rank NCCL group joined
   from torchrun's variables (set here for this process): its frames,
   embeds and launches equal 7a's bit for bit; (b), (c), (d) spawned
   processes on the one card in a gloo group (NCCL refuses two ranks on
   one device; SHARD_RUNS): (b) four ranks, cfg 2 x space 2; (c) three,
   space 3 (64 latent rows 24 / 24 / 16, 512 px rows 176 / 176 / 160, 5
   frames and the towers' images 2 / 2 / 1); (d) four at a 'frame' axis
   of 2, cfg 2 x frame 2 (frames 3 / 2, traded for tokens in the
   temporal modules). Each rank builds phase 5's pipeline (seed 0, bf16,
   the ranks one after another) and runs phase 5's request 1 split over
   the run's ranks, the towers' batch over every rank and the prior's
   frames over its CFG branch's: its frames within a mean |diff| of
   6.0e-3 and a max |diff| of 0.29 of phase 5's, its embeds within
   SHARD_EMBEDS_TOL, 2e-2 (max |diff| over max |embed|), every rank
   launching each of A-D and every B launch tiled; the mesh, max |diff|,
   each rank's launches, request and build seconds and peak memory
   printed. Rows go to chiprun_out/chip_smoke_shard.json. Before each
   run the card's free memory is held against what its ranks need, and
   after every phase before 12 the garbage collector's yield is printed
   (`cycles: ...`).
   `--shard-faults` runs (b) and (d) alone (their reference built
   first), sound and with each fault of SHARD_FAULTS planted in its run
   (a seam's halo of zeros in (b); frames reversed across the frame
   exchange, the prior's frames or the towers' batch gathered out of
   order in (d)), and prints each one's frames' mean and max |diff| and
   embeds' max |diff| / max: the readings the limits sit between
   (PERF.md); then the prior alone in fp32 and bf16 on 2 and 4 gloo
   ranks against one process (`shard_prior_layouts`), which tells
   rounding from a fault. Rows go to
   chiprun_out/chip_smoke_shard_faults.json.
13. the quality tools (`rcdms_tpu_torch/tools/int8_quality.py`,
   `parity_check.py`, `rcdms_tpu_torch/utils/video.py`): (a)
   `int8_quality`'s full-width report with --encprop (the SD-1.5-scale
   UNet and fusion stacks with the JAX tool's seeded random weights in
   bf16, 512 px, 5 frames, 20 steps, CFG 2.0; bf16 at seeds 42 and 43,
   int8 and k = 2 at 42; one seeded bf16 SD VAE decoder): every number
   finite, int8 and k = 2 engaged (the int8 convs ran in the int8 run
   alone), int8's frame SSIM mean to bf16 above the unrelated story's,
   its SSIM min at least 0.988 and its latent relative RMS at most 0.099,
   each of the bf16, unrelated and int8 runs launching A 1200, B 1600
   (all tiled), C 1440, D 0 (20 steps x 2 CFG calls x the UNet's 30 /
   40 / 36); (b) `ddim_inversion`: the tiny UNet in fp32 on the card
   against the CPU's plain versions within 5e-4 of the max (phase 4's),
   then (a)'s full-width UNet in bf16 over 20 steps, one UNet call a step:
   finite, A 600, B 800, C 720, its seconds printed; (c)
   `parity_check --synthetic --device cuda`: gate PASS, the two fp32 runs
   equal bit for bit, int8 engaged, every measured row finite (report in
   chiprun_out/chip_smoke_parity.json). Rows go to
   chiprun_out/chip_smoke_quality.json. `--int8-faults` runs (a)'s bf16
   and int8 runs alone, sound and with each fault of INT8_FAULTS planted
   in the int8 convs' activation quantization, and prints each one's SSIM
   min and latent relative RMS to bf16: the readings (a)'s limits sit
   between (PERF.md). Rows go to chiprun_out/chip_smoke_int8_faults.json.
14. the bench entry points (`rcdms_tpu_torch/bench.py`,
   `rcdms_tpu_torch/tools/profile_bench.py`): (a) stage 2 at full width
   in-process through `bench.run` (bf16, seeded random weights, 20 steps,
   2 timed calls): its JSON line finite with the card's keys, its value
   5 / p50, each timed call launching A 1200, B 1600 (all tiled), C 1440,
   D 0; (b) `--full-pipeline`: each call one story's launches (A 1248,
   B 2400, C 1840, D 400); (c) `--train-step` with bf16 and with fp32
   parameters: the loss finite, each step launching phase 9's forward
   launches, the peak memory printed; (d) `--attn plain --steps 2`: no
   kernel launched in the whole run; `--attn kernel` at (a)'s settings:
   (a)'s B, C and D launches and more of A, its p50 printed beside (a)'s;
   (e) `python -m rcdms_tpu_torch.bench --tiny` and `python -m
   rcdms_tpu_torch.tools.profile_bench --tiny` in processes of their own
   on the card: rc 0, their JSON lines parsed and finite. The phase
   prints its seconds; rows go to chiprun_out/chip_smoke_bench.json.
15. sharded serving (`cli.serve --shard-story`, phase 8's model flags,
   a batching window of SERVE_SHARD_WAIT_MS, each batch's requests sent
   SERVE_STAGGER_S apart so that it forms as it did): (a) in this process
   under a one-rank NCCL group joined from torchrun's variables, built as
   phase 8 built its server: phase 8's batches replayed in phase 8's
   order, every reply's frames and the launches equal phase 8's bit for
   bit; then (b)'s batches that phase 8 did not run, the one-process
   frames of (b); (b) two spawned processes on the one card in a gloo
   group (cfg 2; NCCL refuses two ranks on one device), rank 0 on port 0:
   phase 8's pair as a batch of 2, then phase 8's other request with
   phase 7a's known frame and another negative prompt (a CondCache miss,
   the towers split over the ranks); each request's frames within
   SHARD_MEAN_TOL and SHARD_MAX_TOL (phase 12's) of (a)'s, each rank
   launching each of A-D after its warmup and every B launch tiled, both
   ranks exiting 0 after SIGINT to rank 0 (the server's stop); each
   request's latency and batch size and each rank's launches, build and
   warmup seconds and peak memory printed. Before the spawn the card's
   free memory is held against what the two ranks need. Rows go to
   chiprun_out/chip_smoke_serve_shard.json.

Phases 4 and 5 count only the story's kernels (`ops.PATHS["story"]`),
phase 6 only the studies' (`ops.PATHS["studies"]`), phase 7a the story's
again, phase 8 the story's in the served requests, phase 9 the story's in
each training step and encode, phase 10 the story's in each CLI run,
phase 11 the story's in each rank's run, phase 12 the story's in (a)'s
run and in each rank's request, phase 13 the story's in each sampler run
and in the inversion, phase 14 the story's in each timed call of a bench
mode and in (d)'s whole run, phase 15 the story's in (a)'s replay and in
each rank's served requests after its warmup: each path's counts are set
to 0 just before it and read just after.
The line before the last is a JSON object with one entry per kernel (the
story kernels' `train_launches`: phase 9's forward launches a full-width
step of each stage; `train_cli_launches`: phase 10's launches in each
CLI run, encodes included; `dp_launches`: phase 11's, each rank's 2-step
run; `shard_launches`: phase 12's, (a)'s run and each rank's request in (b)
(`rank<r>`), (c) (`c_rank<r>`) and (d) (`d_rank<r>`);
`quality_launches`: phase 13's, each sampler run of (a) and (b)'s
inversion; `bench_launches`: phase 14's, the first timed call of each
bench mode, "kernel" included, and "plain": (d)'s whole run;
`serve_shard_launches`: phase 15's, (a)'s replay and each rank's served
requests in (b));
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

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
    "cm_conv3x3": ("rcdms_tpu_torch/csrc/cm_conv.cu",
                   "tools/cm_conv_study.py:137 (_cm_kernel)"),
    "gn_moments": ("rcdms_tpu_torch/csrc/group_norm.cu",
                   "tools/gn_study.py:99 (_moments_kernel)"),
    "group_norm_act": ("rcdms_tpu_torch/csrc/group_norm.cu",
                       "tools/gn_fused_study.py:115 (_gn_kernel)"),
    "smallk_attention": (
        "rcdms_tpu_torch/csrc/smallk_attention.cu",
        "tools/flash_smallk_study.py:68 (_kernel_base128), :82 "
        "(_kernel_slice40), :96 (_kernel_nt40), :116 (_kernel_nt_t40) and "
        "tools/pv_overlap_study.py:88 (_kernel_base), :92 "
        "(_make_split_kernel), :128 (_kernel_dscore)"),
    "attn_scores": ("rcdms_tpu_torch/csrc/attn_parts.cu",
                    "tools/flash_smallk_study.py:235 (k_score_base), :251 "
                    "(k_score_nt)"),
    "attn_pv": ("rcdms_tpu_torch/csrc/attn_parts.cu",
                "tools/flash_smallk_study.py:294 (k_pv_base), :304 "
                "(k_pv_narrow), :314 (k_pv_nt) and tools/pv_softmax_study.py"
                ":70 (k_pv_lanes), :76 (k_pv_std)"),
    "attn_softmax": ("rcdms_tpu_torch/csrc/attn_parts.cu",
                     "tools/flash_smallk_study.py:327 (k_softmax) and "
                     "tools/pv_softmax_study.py:82 (k_softmax), :91 "
                     "(k_softmax2), :100 (k_noop)"),
}


class Case(NamedTuple):
    """One phase-3 case: a kernel call, its plain version, the work its
    inputs need (flops, exponentials, bytes read once and written once),
    one PyTorch library call of the same function, where there is one,
    and (label, call) pairs of other versions to time beside it (both
    timed only)."""
    name: str
    label: str
    kernel: Callable
    plain: Callable
    work: tuple
    library: Optional[Callable] = None
    baselines: tuple = ()


def _collect_cycles() -> int:
    """Bytes of the card's allocated memory that a garbage collection
    frees: tensors that only reference cycles still held."""
    import gc

    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return before - torch.cuda.memory_allocated()


def _after_phase(name: str) -> None:
    """Prints what the collector frees after phase `name`: 0 unless the
    phase left tensors in reference cycles."""
    print(f"cycles: {_collect_cycles() / 2**30:.3f} GiB of the card freed "
          f"by the collector after {name}", flush=True)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., S, H * dh) -> (batch, H, S, dh), a view for SDPA."""
    return t.reshape(-1, t.shape[-2], heads, t.shape[-1] // heads
                     ).transpose(1, 2)


def kernel_cases(dev, dtype):
    """(kernel name, shape label, kernel call, plain call): A-D at the
    story's shapes (512 px, 5 frames, b = 1), then the study kernels."""
    from rcdms_tpu_torch.ops.flash import attention_plain, flash_attention
    from rcdms_tpu_torch.ops.frame_attention import (
        frame_attention,
        frame_attention_plain,
    )
    from rcdms_tpu_torch.ops.geglu import (
        geglu_ff,
        geglu_ff_plain,
        geglu_ff_reference,
        gelu_ff,
        gelu_ff_plain,
        gelu_ff_reference,
    )

    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    cases = []
    # kernel A: UNet self/cross attention per level (the plain version's
    # l from the rounded P, as `_nt_kernel`), CLIP vision attention (l
    # from the fp32 P, as `_attn_kernel`)
    attn_shapes = [(1, 5, s, skv, c, 8, "rounded", f"unet {tag} Sq={s} "
                    f"Skv={skv} dh={c // 8}")
                   for s, c in ((4096, 320), (1024, 640), (256, 1280))
                   for skv, tag in ((s, "self"), (91, "cross"))]
    attn_shapes.append((5, 1, 257, 257, 1664, 16, "fp32",
                        "clip-vision S=257 dh=104"))
    for b, f, s, skv, c, heads, row_sum, label in attn_shapes:
        lead = (b, f) if b == 1 else (b,)
        q, k, v = r(*lead, s, c), r(*lead, skv, c), r(*lead, skv, c)
        dh = c // heads
        bh = b * f * heads
        cases.append(Case(
            "attention", label,
            lambda q=q, k=k, v=v, h=heads, rs=row_sum: flash_attention(
                q, k, v, h, row_sum=rs),
            lambda q=q, k=k, v=v, h=heads, dh=dh, rs=row_sum: attention_plain(
                q, k, v, h, dh ** -0.5, row_sum=rs),
            (4 * bh * s * skv * dh, bh * s * skv, 2 * _nbytes(q, k)),
            lambda q=q, k=k, v=v, h=heads, dh=dh:
                F.scaled_dot_product_attention(
                    _heads(q, h), _heads(k, h), _heads(v, h),
                    scale=dh ** -0.5)))
    # kernel B: UNet temporal modules per level, prior temporal modules;
    # SDPA over the same q, k, v laid out as (b n, heads, f, dh) beforehand
    # (attention across the frames at each token), timed alone
    for shape in ((1, 5, 4096, 320), (1, 5, 1024, 640), (1, 5, 256, 1280),
                  (1, 5, 64, 1280), (2, 5, 97, 2048)):
        q, k, v = r(*shape), r(*shape), r(*shape)
        b, f, n, c = shape
        dh = c // 8
        per_token = [t.transpose(1, 2).reshape(b * n, f, 8, dh).transpose(
            1, 2).contiguous() for t in (q, k, v)]
        cases.append(Case(
            "frame_attention", "x".join(map(str, shape)),
            lambda q=q, k=k, v=v: frame_attention(q, k, v, 8),
            lambda q=q, k=k, v=v, dh=dh: frame_attention_plain(
                q, k, v, 8, dh ** -0.5),
            (4 * b * n * f * f * c, b * n * 8 * f * f, 4 * _nbytes(q)),
            lambda t=per_token, dh=dh: F.scaled_dot_product_attention(
                *t, scale=dh ** -0.5)))
    # kernels C and D: UNet and prior feed-forwards (rows x c, inner 4c);
    # bf16 takes the tensor-core kernel, fp32 the CUDA-core one; timed
    # beside the unfused pair (the reference function: two cuBLAS
    # products, the biases and the activation between them)
    for rows, c, geglu in ((20480, 320, True), (5120, 640, True),
                           (1280, 1280, True), (320, 1280, True),
                           (970, 2048, True), (970, 2048, False)):
        inner = 4 * c
        up = 2 * inner if geglu else inner
        args = (r(rows, c), r(up, c, scale=c ** -0.5), r(up, scale=0.1),
                r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
        fn, plain, pair = ((geglu_ff, geglu_ff_plain, geglu_ff_reference)
                           if geglu else
                           (gelu_ff, gelu_ff_plain, gelu_ff_reference))
        cases.append(Case(
            fn.__name__, f"{rows}x{c} inner {inner}",
            lambda a=args, fn=fn: fn(*a), lambda a=args, p=plain: p(*a),
            (2 * rows * c * (up + inner), 0,
             _nbytes(*args) + _nbytes(args[0])),
            baselines=(("cuBLAS pair", lambda a=args, p=pair: p(*a)),)))
    cases += study_kernel_cases(r, dev, dtype)
    if dtype == torch.bfloat16:
        cases += smallk_kernel_cases(r, dev)
    return cases


def study_kernel_cases(r, dev, dtype):
    """The study kernels at their studies' full shapes: the level-0 conv
    (5 frames of 64 x 64, 320 -> 320, padded to 4608 tokens) with and
    without the tap offsets, the moments of (50, 4096, 320), and the fused
    GroupNorm with and without SiLU at the study's four UNet shapes and
    (5, 4096, 960)."""
    from rcdms_tpu_torch.ops import group_norm as gn
    from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3, cm_conv3x3_plain
    from rcdms_tpu_torch.ops.group_norm import (
        gn_moments,
        gn_moments_plain,
        group_norm_act,
        group_norm_act_plain,
    )
    from rcdms_tpu_torch.tools import cm_conv_study as cs
    from rcdms_tpu_torch.tools import gn_fused_study as gs

    x = cs.to_cm_pad(r(cs.B, cs.H, cs.W, cs.C))
    w9, bias = r(9, cs.C, cs.COUT, scale=(9 * cs.C) ** -0.5), r(cs.COUT)
    mask = cs.interior_mask_pad().to(dev, dtype).reshape(cs.TPAD)
    # cuDNN on the same x: its padded frame as NCHW, w9 as OIHW
    x_frame = x[:, :, :cs.HP * cs.WP].unflatten(2, (cs.HP, cs.WP))
    w_oihw = w9.reshape(3, 3, cs.C, cs.COUT).permute(3, 2, 0, 1).contiguous()
    conv_work = (2 * cs.B * cs.H * cs.W * 9 * cs.C * cs.COUT, 0,
                 _nbytes(x, w9, bias, mask, x))
    cases = []
    for shifts in (True, False):
        cases.append(Case(
            "cm_conv3x3", f"{tuple(x.shape)} -> {cs.COUT}"
                          f"{'' if shifts else ' no shifts'}",
            lambda s=shifts: cm_conv3x3(x, w9, bias, mask, cs.WP, s),
            lambda s=shifts: cm_conv3x3_plain(x, w9, bias, mask, cs.WP, s),
            conv_work, lambda: F.conv2d(x_frame, w_oihw, bias)))
    xm = r(50, 4096, 320)
    # the library call: one var_mean gives the same moments (E[x^2] = var
    # + mean^2)
    cases.append(Case("gn_moments", "50x4096x320", lambda: gn_moments(xm),
                      lambda: gn_moments_plain(xm),
                      (0, 0, _nbytes(xm) + 2 * 50 * 320 * 4),
                      lambda: torch.var_mean(xm, dim=1, correction=0)))
    # the fused GroupNorm at the study's shapes and up level 0's first
    # ResNet block, with SiLU (beside F.group_norm + F.silu) and without
    # (beside F.group_norm), and the first port's kernel timed beside it
    # where its one-block group slab fits
    for shape in gs.SHAPES + [(5, 4096, 960)]:
        b, n, c = shape
        xg = r(*shape)
        x_cf = xg.transpose(1, 2)
        gscale = (r(c, scale=0.5) + 1.0).float()
        gbias = r(c, scale=0.2).float()
        slab_fits = (n * (c // gs.GROUPS) * xg.element_size()
                     <= gn.SMEM_MAX - gn._SLAB_RESERVED)
        for act in ("silu", "none"):
            args = (xg, gscale, gbias, gs.GROUPS, gs.EPS, act)
            library = (
                (lambda x_cf=x_cf, sc=gscale, bi=gbias: gs.torch_gn(x_cf, sc,
                                                                    bi))
                if act == "silu" else
                (lambda x_cf=x_cf, sc=gscale.to(dtype), bi=gbias.to(dtype):
                    F.group_norm(x_cf, gs.GROUPS, sc, bi, gs.EPS)))
            cases.append(Case(
                "group_norm_act", f"{b}x{n}x{c} {act}",
                lambda a=args: group_norm_act(*a),
                lambda a=args: group_norm_act_plain(*a),
                (0, xg.numel() if act == "silu" else 0, 2 * _nbytes(xg)),
                library,
                (("first kernel", lambda a=args: gn.group_norm_act_slab(*a)),)
                if slab_fits else ()))
    return cases


def smallk_kernel_cases(r, dev):
    """E-H at the small-head-dim studies' full shape (B = 80 batch-heads,
    Sq = Skv = 4096, dh = 40, 512-row cells), bf16: every whole-block row
    of the two attention studies (E, with SDPA beside base128 and nt_t40;
    rows, operands and work from `tools.smallk_device_times`), both score
    rows (F), the PV rows over generated and over input P (G), the softmax
    rows (H). Work counts what the inputs need: products as wide as their
    nonzero columns (base128's are zero past 40), one exponential a
    score."""
    from rcdms_tpu_torch.ops import smallk as sk
    from rcdms_tpu_torch.tools import flash_smallk_study as fs
    from rcdms_tpu_torch.tools import smallk_device_times as sdt

    b, sq, skv, dh, cells = fs.B, fs.SQ, fs.SKV, fs.DH, fs.CELLS
    exps = b * sq * skv
    qt, kt, vt = r(b, dh, sq), r(b, dh, skv), r(b, dh, skv)
    tok, sdpa = sdt.operands(qt, kt, vt)
    cases = []
    for label, kw in sdt.rows(dh):
        args = (qt, kt, vt) if kw.get("channel_major") else tok
        cases.append(Case(
            "smallk_attention", f"{label} {tuple(args[0].shape)}",
            lambda a=args, kw=kw: sk.smallk_attention(*a, fs.SCALE, **kw),
            lambda a=args, kw=kw: sk.smallk_attention_plain(*a, fs.SCALE,
                                                            **kw),
            sdt.work(qt, skv),
            (lambda t=sdpa[label]: F.scaled_dot_product_attention(
                *t, scale=fs.SCALE)) if label in sdpa else None))
    out_bytes = b * sq * 128 * 4
    q128, k128 = r(b, sq, 128), r(b, skv, 128)
    for label, q, k, cm in (("score_nt", qt, kt, True),
                            ("score_base", q128, k128, False)):
        width = dh if cm else 128
        cases.append(Case(
            "attn_scores", f"{label} {tuple(q.shape)}",
            lambda q=q, k=k, cm=cm: sk.attn_scores(q, k, channel_major=cm),
            lambda q=q, k=k, cm=cm: sk.attn_scores_plain(q, k,
                                                         channel_major=cm),
            (2 * exps * width, 0, _nbytes(q, k) + out_bytes)))
    seeds = r(b, 8, 128)
    p_in = (torch.rand(b, sk.BLK, skv, generator=torch.Generator(dev)
                       .manual_seed(3), device=dev) * 0.001).bfloat16()
    v128 = r(b, skv, 128)
    for label, v, cm, src in (
            ("pv_nt", vt, True, dict(seeds=seeds)),
            ("pv_base", v128, False, dict(seeds=seeds)),
            ("pv_narrow", v128[..., :dh].contiguous(), False,
             dict(seeds=seeds)),
            ("pv_lanes", vt, True, dict(p=p_in)),
            ("pv_std", v128, False, dict(p=p_in))):
        kw = dict(channel_major=cm, cells=cells, **src)
        width = dh if cm else v.shape[2]
        p_bytes = _nbytes(p_in) if "p" in src else 0
        cases.append(Case(
            "attn_pv", f"{label} {tuple(v.shape)}",
            lambda v=v, kw=kw: sk.attn_pv(v, **kw),
            lambda v=v, kw=kw: sk.attn_pv_plain(v, **kw),
            (2 * exps * width, 0, _nbytes(v) + p_bytes + out_bytes)))
    for label, kw in (("softmax gen", dict(seeds=seeds, skv=skv)),
                      ("softmax", dict(p=p_in, scale=1000.0)),
                      ("softmax2", dict(p=p_in, scale=1000.0, op="exp2")),
                      ("reduce_only", dict(p=p_in, op="sum"))):
        cases.append(Case(
            "attn_softmax", f"{label} {b}x{sq}x{skv}",
            lambda kw=kw: sk.attn_softmax(cells=cells, **kw),
            lambda kw=kw: sk.attn_softmax_plain(cells=cells, **kw),
            (0, 0 if kw.get("op") == "sum" else exps,
             (_nbytes(p_in) if "p" in kw else 0) + out_bytes)))
    return cases


def _max_diff(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def check_kernels(dev, card: str) -> dict:
    """Phase 3: every kernel against its plain version; returns the
    per-kernel summary (bf16 times at each kernel's first listed shape,
    the largest error over all shapes and both dtypes)."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
    from rcdms_tpu_torch.tools import bound_ms, device_us, median_ms, rel_err

    print(f"kernels on {card}: median ms of 10 calls: kernel, plain, "
          f"library call (where there is one), bound", flush=True)
    summary = {name: {"max_abs_err": 0.0} for name in ops.KERNELS}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_cases(dev, dtype):
            name, label = case.name, case.label
            frame_attention.tiled_launches = 0
            out, ref = case.kernel(), case.plain()
            torch.cuda.synchronize()
            tiled = frame_attention.tiled_launches
            if name == "frame_attention" and tiled != int(
                    dtype == torch.bfloat16):
                raise AssertionError(f"B {label} {dtype}: {tiled} tiled "
                                     f"launches")
            if isinstance(out, tuple):  # gn_moments: mean, mean of squares
                err = max(_max_diff(o, p) for o, p in zip(out, ref))
                rel = max(rel_err(o, p) for o, p in zip(out, ref))
            else:
                err, rel = _max_diff(out, ref), rel_err(out, ref)
            # A and E round P as their plain versions: the share of bf16
            # outputs off the plain version's bits
            bits_off = ((out != ref).float().mean().item()
                        if name in ("attention", "smallk_attention")
                        and dtype == torch.bfloat16 else None)
            del out, ref
            ms, plain_ms = median_ms(case.kernel), median_ms(case.plain)
            lib_ms = None if case.library is None else median_ms(
                case.library)
            others = {other: median_ms(fn) for other, fn in case.baselines}
            bound, bound_by = bound_ms(*case.work, dtype=dtype)
            # A (bf16), E, H and the moments (bf16): device time, which
            # must not be under the bound; A's, E's and the moments' beside
            # their library call's
            beside = name in ("attention", "smallk_attention",
                              "gn_moments") and dtype == torch.bfloat16
            device_ms = (sum(device_us(case.kernel).values()) / 1e3
                         if beside or name == "attn_softmax" else None)
            lib_device_ms = (sum(device_us(case.library).values()) / 1e3
                             if beside and case.library is not None
                             else None)
            row = dict(kernel=name, shape=label, dtype=str(dtype)[6:],
                       max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                       lib_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                       **({} if bits_off is None else dict(bits_off=bits_off)),
                       **({} if device_ms is None else dict(
                           device_ms=device_ms, share=bound / device_ms)),
                       **({} if lib_device_ms is None else dict(
                           lib_device_ms=lib_device_ms)),
                       **({} if not others else dict(others_ms=others)))
            if name == "frame_attention":
                row["tiled_launches"] = tiled
            rows.append(row)
            lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
            print(f"kernel {name:16s} {row['dtype']:8s} {label:34s} "
                  f"rel_err {rel:.2e} kernel {ms:9.4f} ms "
                  f"plain {plain_ms:9.4f} ms library {lib} ms "
                  f"bound {bound:.4f} ms ({bound_by})"
                  + (f" tiled {tiled}" if name == "frame_attention" else "")
                  + ("" if bits_off is None else
                     f" bits off the plain version {bits_off:.4f}")
                  + ("" if device_ms is None else
                     f" device {device_ms:.4f} ms "
                     f"({bound / device_ms:.1%} of bound)")
                  + ("" if lib_device_ms is None else
                     f" library device {lib_device_ms:.4f} ms")
                  + "".join(f" {other} {t:.4f} ms"
                            for other, t in others.items()),
                  flush=True)
            # H's outputs are fp32 sums of fp32 exponentials: fp32's
            # tolerance, whatever its P's dtype
            tol = TOL[torch.float32 if name == "attn_softmax" else dtype]
            if not rel <= tol:
                raise AssertionError(f"{name} {label} {dtype}: relative "
                                     f"error {rel:.3e} > {tol}")
            if device_ms is not None and not bound / device_ms <= 1.0:
                raise AssertionError(f"{name} {label}: device time "
                                     f"{device_ms:.4f} ms under its bound "
                                     f"{bound:.4f} ms: work left out")
            if bits_off is not None and label.startswith("unet self "
                                                         "Sq=4096") \
                    and not bits_off < 0.38:
                raise AssertionError(f"A at UNet level 0: {bits_off:.4f} of "
                                     f"its bf16 outputs off the plain "
                                     f"version's bits, not below the 0.38 "
                                     f"of a running-maximum rounding")
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dtype == torch.bfloat16 and "ms" not in s:
                s.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=bound_by, shape=label)
    for row in check_ff_instances(dev):
        rows.append(row)
        s = summary[row["kernel"]]
        s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return summary


def check_ff_instances(dev) -> list:
    """Phase 3's last step: every (mode, column tile) instance of the FF
    GEMM kernel (`geglu.LIBRARY_WIDTHS`: the default plans' tiles and the
    studies' sweep), forced through the plan override at the prior's FF
    shape (970 rows, ragged against the 128-row block; c 2048, inner
    8192): C for the geglu and bias tiles, D for the gelu tiles, in bf16
    against the plain version within TOL. One printed line an instance;
    returns the rows."""
    from rcdms_tpu_torch.ops import geglu
    from rcdms_tpu_torch.tools import rel_err

    g = torch.Generator(dev).manual_seed(5)
    rows, c = 970, 2048
    inner = 4 * c

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    args = {gg: (r(rows, c), r(up, c, scale=c ** -0.5), r(up, scale=0.1),
                 r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
            for gg, up in ((True, 2 * inner), (False, inner))}
    plain = {True: geglu.geglu_ff_plain(*args[True]),
             False: geglu.gelu_ff_plain(*args[False])}
    out = []
    try:
        for mode, widths in geglu.LIBRARY_WIDTHS.items():
            gg = mode != "gelu"
            fn = geglu.geglu_ff if gg else geglu.gelu_ff
            for bn in widths:
                geglu.set_plan_override(*((None, bn) if mode == "bias"
                                          else (bn, None)))
                got = fn(*args[gg])
                torch.cuda.synchronize()
                rel, err = rel_err(got, plain[gg]), _max_diff(got, plain[gg])
                print(f"ff instance {mode:5s} bn {bn:3d}: {fn.__name__} "
                      f"{rows}x{c} inner {inner} rel_err {rel:.2e}",
                      flush=True)
                if not rel <= TOL[torch.bfloat16]:
                    raise AssertionError(f"{fn.__name__} with the {mode} "
                                         f"tile {bn}: relative error "
                                         f"{rel:.3e}")
                out.append(dict(kernel=fn.__name__, dtype="bfloat16",
                                shape=f"{rows}x{c} inner {inner}, {mode} "
                                      f"tile {bn}", max_abs_err=err,
                                rel_err=rel))
    finally:
        geglu.set_plan_override(None)
    return out


def check_int8_products(dev, unet_cpu) -> dict:
    """Phase 4's int8 route: `torch._int_mm` on the card against the CPU's
    integer matmul on the same int8 operands (exact: its int32 sums are
    the route's result before the fp32 epilogue), at the tiny UNet's int8
    conv and at the full-width UNet's (level 0's 320 channels, level 3's
    1280, the up path's 2560 from a skip concat, conv_out's 4 output
    channels padded to 8); then the tiny UNet's
    first int8 conv module on the card against the CPU on the same fp32
    input (the same quantization, so the same sums and epilogue)."""
    import copy

    from rcdms_tpu_torch.core.layers import FrameConv
    from rcdms_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(11)
    shapes = [(5 * 8 * 8, 9 * 64, 64), (5 * 64 * 64, 9 * 320, 320),
              (5 * 64 * 64, 9 * 320, 8), (5 * 8 * 8, 9 * 1280, 1280),
              (5 * 8 * 8, 9 * 2560, 1280)]
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        want = quant.int_matmul(a, b)
        got = quant.int_matmul(a.to(dev), b.to(dev)).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"torch._int_mm ({m}, {k}) @ ({k}, {n}) "
                                 f"differs from the CPU integer matmul by "
                                 f"{(got - want).abs().max().item()}")
    conv = next(m for m in unet_cpu.modules() if isinstance(m, FrameConv)
                and m.in_channels % 64 == 0 and m.kernel_size == (3, 3)
                and m.stride == (1, 1))
    x = torch.randn((1, 5, 8, 8, conv.in_channels), generator=g)
    quant.set_quant_mode("int8")
    try:
        calls = quant.int8_conv3x3.calls
        with torch.no_grad():
            want = conv(x)
            got = copy.deepcopy(conv).to(dev)(x.to(dev)).cpu()
        if quant.int8_conv3x3.calls != calls + 2:
            raise AssertionError("the int8 conv route did not run")
    finally:
        quant.set_quant_mode(None)
    conv_err = ((got - want).abs().max() / want.abs().max()).item()
    if not conv_err <= 1e-6:
        raise AssertionError(f"the int8 conv on the card differs from the "
                             f"CPU's by {conv_err:.2e} relative")
    return dict(int_mm_shapes=shapes, conv_rel_err=conv_err)


def check_tiny_reference(dev) -> dict:
    """Phase 4: the tiny pipeline (fp32, seeded weights, 2 steps) on the
    card, through the kernels, against the same pipeline on the CPU, where
    every wrapper runs its plain version, on the same explicit noise.
    Tolerances as the CPU tests hold the port against the JAX package:
    5e-4 on the stage-1 embeds, 1e-3 on the frames (fp32 on both sides,
    TF32 off; sums in another order, compounded over the steps). Then the
    sampling opt-ins the same way: DDIM eta 0.5 on injected step noise,
    batched CFG, encoder propagation k = 2 (the card's UNet encodes only
    on step 0) and the autoregressive stage 1; and the int8 route
    (`check_int8_products`). A whole int8 story's frames are held by
    their mean |diff| (2e-2, phase 8's batch tolerance), not their
    maximum: an activation that the card and the CPU round to the two
    sides of a quantization step moves the frames of a tiny random story
    by far more than 1e-3."""
    import copy

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops import quant
    from rcdms_tpu_torch.sample.pipeline import StoryNoise, build_tiny_pipeline

    pipe, inputs = build_tiny_pipeline(seed=0, num_steps=2)
    size = inputs.source_pixels.shape[2]
    card = copy.deepcopy(pipe).to(dev)
    card_inputs = type(inputs)(*(t.to(dev) for t in inputs))
    f = pipe.configs.prior.num_frames

    def story(pipe=pipe, card=card):
        # the CPU pipeline's draws, the same on both sides
        noise = StoryNoise.draw(pipe, 1, torch.Generator().manual_seed(5),
                                size)
        frames, embeds = pipe.generate(inputs, noise=noise)
        frames_c, embeds_c = card.generate(card_inputs, noise=StoryNoise(
            *(None if t is None else t.to(dev) for t in noise)))
        torch.cuda.synchronize()
        return ((embeds_c.cpu() - embeds).abs().max().item(),
                (frames_c.cpu() - frames).abs())

    def autoreg():
        csize = pipe.configs.vision.image_size
        white = torch.full((csize, csize, 3), 1.5)
        passes = pipe.prior_sampler.draw_passes(
            1, f, torch.Generator().manual_seed(6))
        embeds = pipe.generate_stage1_autoreg(inputs, white, noise=passes)
        embeds_c = card.generate_stage1_autoreg(
            card_inputs, white.to(dev),
            noise=[(a.to(dev), b.to(dev)) for a, b in passes])
        torch.cuda.synchronize()
        return (embeds_c.cpu() - embeds).abs().max().item(), None

    results = {}

    def check(label, run, frame_stat="max"):
        embed_err, frame_diff = run()
        r = dict(embed_err=embed_err)
        if frame_diff is not None:
            r.update(frame_err=frame_diff.max().item(),
                     frame_mean_err=frame_diff.mean().item())
        results[label] = r
        print(f"reference: tiny story ({label}) on the card vs the CPU: "
              f"embeds max|diff| {embed_err:.2e}" + (
                  "" if frame_diff is None else
                  f", frames max|diff| {r['frame_err']:.2e}, mean |diff| "
                  f"{r['frame_mean_err']:.2e}"), flush=True)
        frames_ok = frame_diff is None or (
            r["frame_err"] <= 1e-3 if frame_stat == "max"
            else r["frame_mean_err"] <= 2e-2)
        if not (embed_err <= 5e-4 and frames_ok):
            raise AssertionError(f"the tiny story ({label}) on the card "
                                 f"disagrees with the CPU's plain versions")

    ops.reset_launch_counts()
    check("exact", story)
    counts = ops.launch_counts("story")
    print(f"reference: launches {counts}", flush=True)
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"tiny story launched no {missing}")
    def variant(**options):
        return lambda: story(*(p.with_sampler(**options)
                               for p in (pipe, card)))

    check("eta 0.5", variant(eta=0.5))
    check("batched cfg", variant(sequential_cfg=False))
    encodes = card.unet.encode_calls
    check("encoder propagation 2", variant(encoder_propagation=2))
    if card.unet.encode_calls - encodes != 2:
        raise AssertionError(f"k = 2 over 2 steps encoded "
                             f"{card.unet.encode_calls - encodes} times, "
                             f"not 2 (step 0, both CFG branches)")
    check("autoregressive stage 1", autoreg)
    products = results["int8 products"] = check_int8_products(dev,
                                                               pipe.unet)
    print(f"reference: int8 route: torch._int_mm equals the CPU integer "
          f"matmul at {products['int_mm_shapes']}; the int8 conv on the "
          f"card vs the CPU {products['conv_rel_err']:.2e} relative",
          flush=True)
    quant.set_quant_mode("int8")
    try:
        calls = quant.int8_conv3x3.calls
        check("int8", story, frame_stat="mean")
        if quant.int8_conv3x3.calls == calls:
            raise AssertionError("the int8 story ran no int8 conv")
    finally:
        quant.set_quant_mode(None)
    return results


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


def _check_frames(frames: torch.Tensor, f: int, pixels: int) -> None:
    if frames.shape != (1, f, pixels, pixels, 3):
        raise AssertionError(f"frames shape {tuple(frames.shape)}")
    if not torch.isfinite(frames).all():
        raise AssertionError("non-finite frames")
    if frames.min() < 0 or frames.max() > 1:
        raise AssertionError("frames outside [0, 1]")


def _check_story_launches(counts: dict, where: str) -> None:
    """Each story kernel launched, and every B launch took the tiled
    kernel."""
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched {where}: {missing}")
    _check_tiled_b(counts, where)


def _check_tiled_b(counts: dict, where: str) -> None:
    """Every B launch took the tiled kernel."""
    if counts["frame_attention_tiled"] != counts["frame_attention"]:
        raise AssertionError(f"B took the general kernel {where}: "
                             f"{counts['frame_attention_tiled']} of "
                             f"{counts['frame_attention']} launches tiled")


def run_story(configs, dev, dtype, steps: int, pixels: int) -> dict:
    """Phase 5: build, cache, two requests and a repeat; returns the
    per-request seconds and the launch counts of the main path."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
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
        if i == 0:
            request1 = dict(frames=frames.cpu(), embeds=embeds.cpu())
    counts = ops.launch_counts("story")
    counts["frame_attention_tiled"] = frame_attention.tiled_launches

    for frames in results:
        _check_frames(frames, configs.prior.num_frames, pixels)
    repeat_err = (results[2] - results[0]).abs().max().item()
    if repeat_err > 1e-3:
        raise AssertionError(f"repeat differs by {repeat_err}")
    if (results[1] - results[0]).abs().max().item() == 0:
        raise AssertionError("two different requests gave equal frames")
    _check_story_launches(counts, "on the main path")
    print(f"story: repeat max|diff| {repeat_err:.2e}; launches {counts}",
          flush=True)
    profile = profile_request(pipe, requests[1], cache, dev, 12)
    return dict(seconds=seconds, counts=counts, repeat_err=repeat_err,
                profile=profile, request1=request1)


def profile_request(pipe, req, cache, dev, seed: int) -> dict:
    """One request under torch.profiler: the device time of every kernel
    and copy, summed by name and by group (`tools.KERNEL_GROUPS`); prints
    each group's seconds and share of the request's device time and
    writes them, with the 15 longest names, to
    chip_smoke_story_profile.json."""
    from rcdms_tpu_torch.tools import group_profile, profile_call

    result = group_profile(profile_call(
        lambda: pipe.generate(req, cache,
                              torch.Generator(dev).manual_seed(seed)),
        dev), 15, dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_story_profile.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"story profile: one request {result['wall_s']:.3f} s wall "
          f"(profiled), {result['device_s']:.3f} s device: " + ", ".join(
              f"{g} {v['s']:.3f} s ({v['share']:.1%})"
              for g, v in result["groups"].items()), flush=True)
    return result


def run_studies(dev, card: str) -> dict:
    """Phase 6: each ResNet-block study's rows at its full shapes, in bf16
    and fp32, then each small-head-dim attention study's rows in bf16;
    every row within TOL of its study's reference (the dots and sdpa rows
    are only timed; pv_overlap raises itself on a row off its oracle);
    returns the studies' launch counts."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.tools import (
        cm_conv_study,
        flash_smallk_study,
        gn_fused_study,
        gn_study,
        print_rows,
        pv_overlap_study,
        pv_softmax_study,
    )

    print(f"studies on {card}: median ms of 10 calls", flush=True)
    ops.reset_launch_counts()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for study in (cm_conv_study, gn_study, gn_fused_study):
            rows += study.run(dev, dtype)
    for study in (flash_smallk_study, pv_overlap_study, pv_softmax_study):
        rows += study.run(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts("studies")
    print_rows(rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_studies.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    tol = {str(dtype)[6:]: t for dtype, t in TOL.items()}
    bad = [(r["study"], r["row"], r["dtype"], r["rel_err"]) for r in rows
           if r["rel_err"] is not None and not r["rel_err"] <= tol[r["dtype"]]]
    if bad:
        raise AssertionError(f"study rows off their reference: {bad}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"the studies launched no {missing}")
    print(f"studies: launches {counts}", flush=True)
    return counts


# phase 7's request: five Flintstones captions and one known frame
ENTRY_CAPTIONS = [
    "Fred and Barney stand in the living room talking.",
    "Wilma walks into the kitchen holding a plate.",
    "Betty and Wilma laugh together on the couch.",
    "Dino runs across the yard after Pebbles.",
    "Mr. Slate shouts at Fred in the quarry office.",
]


def _png_size(path: str) -> tuple:
    """(width, height) from a PNG's IHDR; raises unless the file starts
    with the PNG signature and an IHDR chunk."""
    import struct

    from rcdms_tpu_torch.sample.eval import PNG_SIGNATURE

    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def entry_generate(dev, args, frame0) -> tuple:
    """Phase 7a: `cli.generate.run` at full width; returns its frames,
    stage-1 embeds and launches."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import generate
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
    from rcdms_tpu_torch.sample.eval import save_story_grid

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    frames, embeds = generate.run(args, ENTRY_CAPTIONS, [frame0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts("story")
    counts["frame_attention_tiled"] = frame_attention.tiled_launches
    _check_frames(frames, len(ENTRY_CAPTIONS), PIXELS)
    if not torch.isfinite(embeds).all():
        raise AssertionError("non-finite stage-1 embeds")
    _check_story_launches(counts, "in generate.run")
    path = os.path.join(OUT_DIR, "chip_smoke_story.png")
    t0 = time.perf_counter()
    save_story_grid(path, frames[0].cpu().numpy())
    png_s = time.perf_counter() - t0
    size = _png_size(path)
    if size != (len(ENTRY_CAPTIONS) * PIXELS, PIXELS):
        raise AssertionError(f"grid PNG is {size}")
    print(f"entry 7a: generate.run {seconds:.3f} s (build, protocol and "
          f"request), frames in [{frames.min().item():.3f}, "
          f"{frames.max().item():.3f}]; launches {counts}; grid {path} "
          f"{size[0]} x {size[1]}, {os.path.getsize(path)} bytes, written "
          f"in {png_s:.3f} s", flush=True)
    return frames, embeds, counts


def entry_checkpoints(dev, args, frame0, frames_a: torch.Tensor) -> dict:
    """Phase 7b: the 7a build's prior, UNet and fusion stacks through
    reference blobs into towers built from another seed, bit for bit; the
    loaded pipeline's request against 7a's frames."""
    import shutil
    import tempfile

    from rcdms_tpu_torch.cli import common, evaluate
    from rcdms_tpu_torch.sample.pipeline import StoryPipeline

    src, dataset, ds_cfg = evaluate.build_pipeline(args)
    cfg = src.configs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=OUT_DIR)
    try:
        t0 = time.perf_counter()
        stage1 = os.path.join(tmp, "stage1.pt")
        torch.save({"module": {f"module.{k}": v for k, v in
                               src.prior.state_dict().items()}}, stage1)
        stage2 = os.path.join(tmp, "stage2")
        os.makedirs(os.path.join(stage2, "global_step1"))
        blob = {f"unet.{k}": v for k, v in src.unet.state_dict().items()}
        blob.update(src.fusion.state_dict())  # seen_module. / unseen_module.
        stage2_file = os.path.join(stage2, "global_step1",
                                   "mp_rank_00_model_states.pt")
        torch.save({"module": blob}, stage2_file)
        with open(os.path.join(stage2, "latest"), "w") as fh:
            fh.write("global_step1")
        del blob
        save_s = time.perf_counter() - t0
        nbytes = (os.path.getsize(stage1), os.path.getsize(stage2_file))

        kw = dict(dtype=src.dtype, device=dev, seed=1)
        towers = dict(prior=common.build_prior(cfg.prior, None, **kw),
                      unet=common.build_unet(cfg.unet, None, **kw),
                      fusion=common.build_fusion(cfg.fusion, **kw))
        if torch.equal(towers["unet"].conv_in.weight, src.unet.conv_in.weight):
            raise AssertionError("the other seed built the same UNet")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        common.load_rcdms_stage1(stage1, towers["prior"])
        common.load_rcdms_stage2(stage2, towers["unet"], towers["fusion"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    n_tensors = 0
    for name, tower in towers.items():
        want = getattr(src, name).state_dict()
        got = tower.state_dict()
        if set(got) != set(want):
            raise AssertionError(f"{name}: keys differ")
        for k, v in want.items():
            if got[k].dtype != v.dtype or not torch.equal(got[k], v):
                raise AssertionError(f"{name}.{k} differs from its source")
        n_tensors += len(want)

    loaded = StoryPipeline(
        cfg, num_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        towers=dict(text_s1=src.text_s1, text_s2=src.text_s2,
                    vision=src.vision, vae=src.vae, **towers)).eval()
    dtype = str(src.dtype)[6:]
    del src
    t0 = time.perf_counter()
    inputs = common.build_story_inputs(ENTRY_CAPTIONS, [frame0], "", dataset,
                                       ds_cfg, dev)
    frames, _ = loaded.generate(inputs, generator=torch.Generator(
        dev).manual_seed(common.story_seed(args.seed, 0)))
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    _check_frames(frames, len(ENTRY_CAPTIONS), PIXELS)
    err = (frames - frames_a).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"the loaded pipeline's frames differ from "
                             f"7a's by {err}")
    print(f"entry 7b: blobs stage-1 {nbytes[0]} bytes, stage-2 {nbytes[1]} "
          f"bytes ({dtype}), saved in {save_s:.2f} s, loaded in {load_s:.2f} s; "
          f"{n_tensors} tensors equal their source bit for bit; request on "
          f"the loaded pipeline {request_s:.3f} s, frames max|diff| vs 7a "
          f"{err:.2e}", flush=True)
    return dict(stage1_bytes=nbytes[0], stage2_bytes=nbytes[1],
                save_s=save_s, load_s=load_s, request_s=request_s, err=err)


def entry_evaluate(dev) -> dict:
    """Phase 7c: the evaluate CLI on synthetic stories in fp32 on the card;
    returns its summary."""
    from rcdms_tpu_torch.cli import evaluate

    out = os.path.join(OUT_DIR, "chip_smoke_eval")
    t0 = time.perf_counter()
    summary = evaluate.main(["--synthetic", "--device", str(dev), "--dtype",
                             "float32", "--mode", "continue",
                             "--num-stories", "2", "--num-inference-steps",
                             str(STEPS), "--output-dir", out])
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "metrics_0.jsonl")) as fh:
        metrics = [json.loads(line) for line in fh if line.strip()]
    with open(os.path.join(out, "summary_0.json")) as fh:
        if json.load(fh) != summary:
            raise AssertionError("summary_0.json differs from the summary")
    values = [v for m in metrics for v in m.values()] + list(summary.values())
    if len(metrics) != 2 or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"evaluate metrics {metrics} {summary}")
    print(f"entry 7c: evaluate --synthetic, 2 stories in {seconds:.2f} s "
          f"(build included): {metrics}; summary {summary}", flush=True)
    return summary


def run_entry_points(dev, card: str) -> dict:
    """Phase 7: the CLIs' entry points on the card (module docstring)."""
    import numpy as np

    from rcdms_tpu_torch.cli import evaluate

    print(f"entry points on {card}", flush=True)
    args = evaluate.parse_args([
        "--dataset", "flintstones", "--dtype", "bfloat16",
        "--num-inference-steps", str(STEPS), "--guidance-scale", "2.0",
        "--seed", "42", "--device", "cuda"])
    frame0 = np.random.RandomState(0).randint(0, 256, (128, 128, 3),
                                              np.uint8)
    frames, embeds, launches = entry_generate(dev, args, frame0)
    ckpt = entry_checkpoints(dev, args, frame0, frames)
    frames_a, embeds_a = frames.cpu(), embeds.cpu()
    del frames, embeds
    torch.cuda.empty_cache()
    return dict(checkpoints=ckpt, evaluate=entry_evaluate(dev),
                frames_a=frames_a, embeds_a=embeds_a, launches_a=launches,
                frame0=frame0)


def _serve_args(*extra):
    """The serve CLI's flags of phase 8: phase 7a's model flags."""
    from rcdms_tpu_torch.cli import serve

    return serve.parse_args([
        "--host", "127.0.0.1", "--port", "0", "--max-batch", "2",
        "--max-wait-ms", "200", "--dataset", "flintstones", "--dtype",
        "bfloat16", "--num-inference-steps", str(STEPS), "--guidance-scale",
        "2.0", "--seed", "42", "--device", "cuda", *extra])


def _story_counts() -> dict:
    from rcdms_tpu_torch.bench import story_counts

    return story_counts()


def serve_body(seed: int, frame0=None, negative: str = "") -> dict:
    """A POST /generate body of phase 7a's captions: `frame0`, if given,
    as a PNG reference frame, and a negative prompt, if not empty."""
    import base64

    from rcdms_tpu_torch.sample.eval import encode_png

    body = {"captions": ENTRY_CAPTIONS, "seed": seed}
    if frame0 is not None:
        body["reference_frames"] = [
            base64.b64encode(encode_png(frame0)).decode()]
    if negative:
        body["negative_prompt"] = negative
    return body


def serve_requests(url: str, bodies: list, stagger_s: float = 0.0) -> list:
    """Concurrent POST /generate requests of `bodies`, each started
    `stagger_s` after the one before; returns their replies, frames still
    base64 PNGs (the client may share the server's process, so decoding
    them now would hold the interpreter lock the dispatch thread needs)."""
    import threading
    import urllib.request

    replies = [None] * len(bodies)
    errors = []

    def post(i, body):
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                reply = json.loads(r.read())
                reply["status"] = r.status
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"seed {body['seed']}: {type(e).__name__}: {e}")
            return
        replies[i] = reply

    threads = []
    for i, body in enumerate(bodies):
        if i and stagger_s:
            time.sleep(stagger_s)
        threads.append(threading.Thread(target=post, args=(i, body)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(r is None for r in replies):
        raise AssertionError(f"serve requests failed: {errors}")
    return replies


def _recorded(batch: list, batches: list) -> list:
    """`batch` (a dispatch thread's), its seeds appended to `batches`."""
    if batch:
        batches.append([r.seed for r in batch])
    return batch


def run_serve(dev, card: str, entry: dict) -> dict:
    """Phase 8: `cli.serve` at full width in bf16 (phase 7a's model flags,
    --max-batch 2, --max-wait-ms 200): three concurrent HTTP requests,
    then `_run` at batch 1 and 2 (seed 1's frames alone and beside seed
    2), one request with encoder propagation k = 2, and 7a's request
    exact and with --quantize int8."""
    import base64
    import threading

    import numpy as np

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import common, serve
    from rcdms_tpu_torch.ops import quant
    from rcdms_tpu_torch.sample.eval import decode_png, ssim

    print(f"serve on {card}", flush=True)
    args = _serve_args()
    ready, box = threading.Event(), []
    t0 = time.perf_counter()
    # the server is built in the int8 mode --quantize sets, so the bf16
    # cast quantizes the UNet's gated convs from their fp32 values (the
    # warm-up runs them); its requests below run exact until the int8 one
    quant.set_quant_mode(_serve_args("--quantize", "int8").eval.quantize)
    thread = threading.Thread(target=serve.serve, args=(args,),
                              kwargs=dict(ready_event=ready, httpd_box=box),
                              daemon=True)
    thread.start()
    try:
        if not ready.wait(timeout=900):
            raise AssertionError("the server did not start")
    finally:
        quant.set_quant_mode(None)
    httpd, srv = box[0]
    print(f"serve: {card}: built, warmed and listening in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    # the seeds of each batch the dispatch thread takes, in its order
    # (phase 15 replays them)
    batches = []
    take = srv._take_batch
    srv._take_batch = lambda: _recorded(take(), batches)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bodies = [serve_body(seed, entry["frame0"] if seed == 2 else None)
              for seed in (1, 2, 3)]
    replies = serve_requests(url, bodies)
    http_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _story_counts()
    del srv._take_batch
    httpd.shutdown()
    srv.stop()
    srv.worker.join(timeout=60)
    thread.join(timeout=60)
    for r in replies:
        r["frames"] = [decode_png(base64.b64decode(x)) for x in r["frames"]]
        if r["status"] != 200 or len(r["frames"]) != len(ENTRY_CAPTIONS) \
                or any(x.shape != (PIXELS, PIXELS, 3) for x in r["frames"]):
            raise AssertionError(f"a serve reply is off: status "
                                 f"{r['status']}, {len(r['frames'])} frames")
    _check_story_launches(counts, "in the served requests")
    print(f"serve: {card}: 3 concurrent requests answered 200 in "
          f"{http_s:.3f} s; batch sizes {[r['batch_size'] for r in replies]}, "
          f"latencies {[r['latency_s'] for r in replies]} s; launches "
          f"{counts}", flush=True)

    def request(seed):
        return serve._Request(srv.story_inputs(ENTRY_CAPTIONS, [], ""), seed)

    runs = {}
    for label, seeds in (("batch 1", (1,)), ("batch 2", (1, 2))):
        ops.reset_launch_counts()
        encodes = srv.pipeline.unet.encode_calls
        t0 = time.perf_counter()
        frames = srv._run([request(s) for s in seeds])
        seconds = time.perf_counter() - t0
        runs[label] = dict(frames=frames, seconds=seconds,
                           per_story_s=seconds / len(seeds),
                           counts=_story_counts(),
                           encodes=srv.pipeline.unet.encode_calls - encodes)
        print(f"serve: {card}: _run {label}: {seconds:.3f} s, "
              f"{seconds / len(seeds):.3f} s a story; UNet encodes "
              f"{runs[label]['encodes']}; launches {runs[label]['counts']}",
              flush=True)
    one, two = runs["batch 1"], runs["batch 2"]
    if one["counts"] != two["counts"]:
        raise AssertionError(f"batch 2 launched {two['counts']}, batch 1 "
                             f"{one['counts']}")
    diff = (two["frames"][0] - one["frames"][0]).abs()
    batch_err = dict(max=diff.max().item(), mean=diff.mean().item())
    for frames in (one["frames"], two["frames"]):
        if not torch.isfinite(frames).all() or frames.min() < 0 \
                or frames.max() > 1:
            raise AssertionError("served frames non-finite or off [0, 1]")
    print(f"serve: seed 1 alone vs beside seed 2: max|diff| "
          f"{batch_err['max']:.3e}, mean |diff| {batch_err['mean']:.3e}",
          flush=True)
    if not batch_err["mean"] <= 2e-2:
        raise AssertionError(f"seed 1's frames moved by {batch_err} in a "
                             f"batch")

    exact_pipe = srv.pipeline
    srv.pipeline = exact_pipe.with_sampler(encoder_propagation=2)
    encodes = srv.pipeline.unet.encode_calls
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        frames = srv._run([request(1)])
        prop_s = time.perf_counter() - t0
        prop_counts = _story_counts()
    finally:
        srv.pipeline = exact_pipe
    prop_encodes = srv.pipeline.unet.encode_calls - encodes
    prop_err = (frames[0] - one["frames"][0]).abs().max().item()
    if not torch.isfinite(frames).all() or prop_encodes != STEPS \
            or one["encodes"] != 2 * STEPS:
        raise AssertionError(f"encoder propagation: {prop_encodes} encodes "
                             f"against {one['encodes']}, or frames "
                             f"non-finite")
    print(f"serve: {card}: encoder propagation k = 2: {prop_s:.3f} s, UNet "
          f"encodes {prop_encodes} against {one['encodes']}; frames "
          f"max|diff| vs k = 0 {prop_err:.3e}; launches {prop_counts}",
          flush=True)

    # 7a's request (its inputs, no cond cache, its generator) exact and
    # with the int8 mode --quantize sets
    inputs = common.build_story_inputs(ENTRY_CAPTIONS, [entry["frame0"]], "",
                                       srv.dataset, srv.ds_cfg, dev)
    seed = common.story_seed(args.eval.seed, 0)
    exact, _ = srv.pipeline.generate(
        inputs, generator=torch.Generator(dev).manual_seed(seed))
    exact_err = (exact.cpu() - entry["frames_a"]).abs().max().item()
    if not exact_err <= 1e-3:
        raise AssertionError(f"the server's pipeline is not 7a's: "
                             f"{exact_err}")
    quant.set_quant_mode(_serve_args("--quantize", "int8").eval.quantize)
    try:
        calls = quant.int8_conv3x3.calls
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        frames_q, _ = srv.pipeline.generate(
            inputs, generator=torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        int8_s = time.perf_counter() - t0
        int8_counts = _story_counts()
        int8_convs = quant.int8_conv3x3.calls - calls
    finally:
        quant.set_quant_mode(None)
    if not torch.isfinite(frames_q).all() or int8_convs == 0:
        raise AssertionError("the int8 request is non-finite or ran no "
                             "int8 conv")
    a = frames_q[0].cpu().numpy().astype(np.float64)
    b = entry["frames_a"][0].numpy().astype(np.float64)
    int8_ssim = float(np.mean([ssim(a[i], b[i]) for i in range(len(a))]))
    print(f"serve: {card}: --quantize int8: {int8_s:.3f} s, {int8_convs} "
          f"int8 convs a request, SSIM vs 7a's exact frames {int8_ssim:.4f} "
          f"(the exact rerun max|diff| vs 7a {exact_err:.2e}); launches "
          f"{int8_counts}", flush=True)
    del srv, exact, frames_q
    torch.cuda.empty_cache()
    return dict(batch_sizes=[r["batch_size"] for r in replies],
                batches=batches, bodies=dict(zip((1, 2, 3), bodies)),
                frames={seed: np.stack(r["frames"])
                        for seed, r in zip((1, 2, 3), replies)},
                http_s=http_s, launches=counts,
                batch1_s=one["per_story_s"], batch2_s=two["per_story_s"],
                batch_err=batch_err, propagation_s=prop_s,
                propagation_encodes=prop_encodes,
                propagation_launches=prop_counts, int8_launches=int8_counts,
                int8_s=int8_s,
                int8_convs=int8_convs, int8_ssim=int8_ssim)


# ---- phase 9: training ----------------------------------------------------

def _split_noise(name: str, t: torch.Tensor):
    """(the rest, the noise part) of a gradient: a key projection's bias
    shifts every score of a query alike, so its gradient is float noise
    around zero. It is a whole `to_k.bias`, and the middle third of the
    fusion stacks' packed `in_proj_bias`."""
    if name.endswith("to_k.bias"):
        return t[:0], t
    if name.endswith("in_proj_bias"):
        q, k, v = t.chunk(3)
        return torch.cat([q, v]), k
    return t, t[:0]


def _rel_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    if want.numel() == 0:
        return 0.0
    return _max_diff(got, want) / max(want.float().abs().max().item(), 1e-30)


def train_kernel_cases(dev, dtype):
    """(label, op, reference, operands): A at UNet level 0 (self, the
    rounded family) and in the CLIP tower (the fp32 family), B at level 0,
    C at level 0's FF, D at the prior's FF (b = 1: 485 rows)."""
    from rcdms_tpu_torch.ops.flash import attention_reference, \
        flash_attention
    from rcdms_tpu_torch.ops.frame_attention import (
        frame_attention,
        frame_attention_reference,
    )
    from rcdms_tpu_torch.ops.geglu import (
        geglu_ff,
        geglu_ff_reference,
        gelu_ff,
        gelu_ff_reference,
    )

    g = torch.Generator(dev).manual_seed(9)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def ff(rows, c, inner, geglu):
        up = 2 * inner if geglu else inner
        return [r(rows, c), r(up, c, scale=c ** -0.5), r(up, scale=0.1),
                r(c, inner, scale=inner ** -0.5), r(c, scale=0.1)]

    unet = [r(1, 5, 4096, 320) for _ in range(3)]
    clip = [r(5, 257, 1664) for _ in range(3)]
    return [
        ("attention", "unet self Sq=4096 dh=40 rounded",
         lambda *a: flash_attention(*a, 8, row_sum="rounded"),
         lambda *a: attention_reference(*a, 8, 40 ** -0.5), unet),
        ("attention", "clip-vision S=257 dh=104 fp32",
         lambda *a: flash_attention(*a, 16, row_sum="fp32"),
         lambda *a: attention_reference(*a, 16, 104 ** -0.5), clip),
        ("frame_attention", "1x5x4096x320",
         lambda *a: frame_attention(*a, 8),
         lambda *a: frame_attention_reference(*a, 8, 40 ** -0.5),
         [r(1, 5, 4096, 320) for _ in range(3)]),
        ("geglu_ff", "20480x320 inner 1280", geglu_ff, geglu_ff_reference,
         ff(20480, 320, 1280, True)),
        ("gelu_ff", "485x2048 inner 8192", gelu_ff, gelu_ff_reference,
         ff(485, 2048, 8192, False)),
    ]


def check_kernel_grads(dev) -> list:
    """Phase 9 (1): each story op under autograd on the card against
    autograd through its reference function."""
    from rcdms_tpu_torch import ops

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, op, ref, operands in train_kernel_cases(dev, dtype):
            leaves = [t.requires_grad_() for t in operands]
            cot = torch.randn(operands[0].shape, device=dev,
                              generator=torch.Generator(dev).manual_seed(
                                  10)).to(dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ops.reset_launch_counts()
            out = op(*leaves)
            launches = ops.launch_counts("story")[name]
            if launches != 1 or out.grad_fn is None:
                raise AssertionError(f"{name} {label} {dtype}: {launches} "
                                     f"launches, grad_fn {out.grad_fn}")
            got = torch.autograd.grad(out, leaves, cot)
            del out
            want = torch.autograd.grad(ref(*leaves), leaves, cot)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            rel = max(_max_diff(a, b) / b.float().abs().max().item()
                      for a, b in zip(got, want))
            rows.append(dict(kernel=name, shape=label, dtype=str(dtype)[6:],
                             launches=launches, grad_rel_err=rel,
                             peak_bytes=peak))
            print(f"train kernel {name:16s} {str(dtype)[6:]:8s} {label:34s} "
                  f"launches {launches} grad rel_err {rel:.2e} peak "
                  f"{peak / 2**30:.2f} GiB above the operands", flush=True)
            if not rel <= TOL[dtype]:
                raise AssertionError(f"{name} {label} {dtype}: gradients "
                                     f"{rel:.3e} off the reference")
            del got, want, leaves, operands
    return rows


def tiny_raw_batch(configs, dev, seed: int, pixels: int) -> dict:
    """A raw protocol batch of both stages' keys, b = 1, frame 0 known:
    seeded token ids, CLIP-preprocessed reference, source and mask images
    and [-1, 1] target and source pixels."""
    from rcdms_tpu_torch.sample.pipeline import padding_mask

    g = torch.Generator().manual_seed(seed)
    f, t = configs.prior.num_frames, configs.prior.num_text_tokens
    csize = configs.vision.image_size
    ids, _ = token_rows(g, f, t, configs.text_s1.eos_token_id, dev)
    known = torch.zeros(1, f, dtype=torch.bool, device=dev)
    known[0, 0] = True
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    ref = (torch.rand(1, f, csize, csize, 3, generator=g).to(dev)
           - mean) / std
    target = torch.rand(1, f, pixels, pixels, 3, generator=g).to(dev) * 2 - 1
    source = torch.where(known[..., None, None, None], target, -1.0)
    return dict(
        input_ids=ids, text_mask=padding_mask(
            ids, configs.text_s1.eos_token_id),
        reference_clip=ref,
        source_clip=torch.where(known[..., None, None, None], ref,
                                clip_constant(0.0, csize, dev)),
        mask_clip=torch.where(known[..., None, None, None],
                              clip_constant(1.0, csize, dev),
                              clip_constant(0.0, csize, dev)),
        target=target, source=source, frame_known=known)


def check_tiny_training(dev) -> dict:
    """Phase 9 (2): the tiny trainers in fp32 on the card against the
    CPU, 3 steps each on the same weights, batch and noise."""
    import copy

    from rcdms_tpu_torch.configs import OptimizerConfig
    from rcdms_tpu_torch.sample.pipeline import tiny_configs
    from rcdms_tpu_torch.train import loop, stage1, stage2
    from rcdms_tpu_torch.train.optim import make_optimizer
    from rcdms_tpu_torch.train.train_state import TrainState

    configs = tiny_configs()
    lr, steps = 1e-4, 3
    results = {}
    for stage, mod, clip in ((2, stage2, 1.0), (1, stage1, 10.0)):
        cfg = OptimizerConfig(learning_rate=lr, warmup_steps=0,
                              grad_clip_norm=clip)
        cpu, towers = mod.build_trainer(configs, cfg, torch.float32,
                                        seed=stage, device="cpu")
        raw = tiny_raw_batch(configs, torch.device("cpu"), 20 + stage, 32)
        encode_args = ({"generator": torch.Generator().manual_seed(3)}
                       if stage == 2 else {})
        batch = mod.encode_batch(*towers, raw, **encode_args)
        card = TrainState.create(copy.deepcopy(cpu.module).to(dev),
                                 make_optimizer(cfg))
        card_batch = type(batch)(*(x.to(dev) for x in batch))
        zero_init = {n for n, p in cpu.params.items() if not p.any()}
        g = torch.Generator().manual_seed(4)
        losses, grad_errs = [], None
        for step in range(steps):
            noise = cpu.module.draw_noise(batch, g)
            loss, grads = loop.compute_gradients(cpu, batch, noise)
            loss_c, grads_c = loop.compute_gradients(card, card_batch,
                                                     noise.to(dev))
            losses.append((loss.item(), loss_c.item()))
            if step == 0:
                grad_errs = sorted((_rel_to_max(
                    _split_noise(n, grads_c[n].cpu())[0],
                    _split_noise(n, w)[0]), n) for n, w in grads.items())
            cpu.apply_gradients(grads)
            card.apply_gradients(grads_c)
        torch.cuda.synchronize()
        loss_err = max(abs(a - b) / abs(a) for a, b in losses)
        param_err, zero_init_err = 0.0, 0.0
        for n, w in cpu.params.items():
            got, want = card.params[n].detach().cpu(), w.detach()
            if n in zero_init:
                zero_init_err = max(zero_init_err, _max_diff(got, want)
                                    / (2 * lr * steps))
            else:
                param_err = max(param_err, _rel_to_max(got, want))
        grad_err, worst = grad_errs[-1]
        results[f"stage{stage}"] = dict(
            losses=losses, loss_err=loss_err, grad_err=grad_err,
            worst_grad=worst, param_err=param_err,
            zero_init_param_err=zero_init_err)
        print(f"train tiny stage {stage}: card vs CPU, fp32, {steps} steps: "
              f"losses {[round(a, 6) for a, _ in losses]}, loss rel err "
              f"{loss_err:.2e}; step-1 gradients {grad_err:.2e} of each "
              f"tensor's max (worst {grad_errs[-3:]}); parameters "
              f"{param_err:.2e} of each tensor's max, those that start at "
              f"zero {zero_init_err:.3f} of 2 lr a step", flush=True)
        if not (loss_err <= 1e-4 and grad_err <= 1e-3 and param_err <= 1e-4
                and zero_init_err <= 1.0):
            raise AssertionError(f"tiny stage {stage} on the card disagrees "
                                 f"with the CPU: {results[f'stage{stage}']}")
    return results


def full_width_stage(stage: int, dev, card: str, steps: int = 3) -> dict:
    """Phase 9 (3) for one stage: build, encode, `steps` steps (stage 2's
    first also with remat); returns its numbers."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.configs import OptimizerConfig
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.train import loop, stage1, stage2

    configs = full_configs(temporal_zero_init=False)
    mod, clip = (stage2, 1.0) if stage == 2 else (stage1, 10.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, towers = mod.build_trainer(
        configs, OptimizerConfig(learning_rate=1e-5, warmup_steps=0,
                                 grad_clip_norm=clip),
        torch.bfloat16, seed=stage, device=dev)
    raw = tiny_raw_batch(configs, dev, 30 + stage, PIXELS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    trained = sum(p.numel() for p in state.params.values())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    encode_args = ({"generator": torch.Generator(dev).manual_seed(5)}
                   if stage == 2 else {})
    batch = mod.encode_batch(*towers, raw, **encode_args)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    encode_launches = ops.launch_counts("story")
    print(f"train stage {stage}: {card}: built in {build_s:.1f} s "
          f"({trained / 1e9:.3f} B parameters trained), encode_batch "
          f"{encode_s:.2f} s, its launches {encode_launches}", flush=True)
    if encode_launches["attention"] == 0:
        raise AssertionError(f"stage {stage}'s encode launched no A")
    g = torch.Generator(dev).manual_seed(6)
    rows, remat = [], None
    torch.cuda.reset_peak_memory_stats()
    for step in range(steps):
        noise = state.module.draw_noise(batch, g)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loop.compute_gradients(state, batch, noise)
        launches = ops.launch_counts("story")
        # per-tensor norms before the optimizer clips the gradients in
        # place; read after the step
        norms = torch.stack(torch._foreach_norm(list(grads.values())))
        norm = torch.linalg.vector_norm(norms)
        if stage == 2 and step == 0:
            remat = remat_step(state, batch, noise, loss, norm, launches)
            t0 += remat["seconds"]
        state.apply_gradients(grads)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        zero = [n for n, v in zip(grads, norms.tolist()) if v == 0]
        finite = bool(torch.isfinite(loss)) and bool(
            torch.isfinite(norms).all())
        rows.append(dict(step=step + 1, loss=loss.item(), seconds=seconds,
                         grad_norm=norm.item(), launches=launches,
                         zero_grad_tensors=zero))
        print(f"train stage {stage}: step {step + 1} loss "
              f"{loss.item():.6f}, {seconds:.3f} s, global grad norm "
              f"{norm.item():.4e}, forward launches {launches}, tensors "
              f"with an all-zero gradient {zero}", flush=True)
        if not finite or not norm.item() > 0:
            raise AssertionError(f"stage {stage} step {step + 1}: loss or "
                                 f"gradients non-finite, or zero norm")
        want = (("attention", "frame_attention", "geglu_ff") if stage == 2
                else ("frame_attention", "gelu_ff"))
        if any(launches[k] == 0 for k in want):
            raise AssertionError(f"stage {stage} step {step + 1} launched "
                                 f"{launches}")
        del grads
    peak = max(torch.cuda.max_memory_allocated(),
               remat["peak_without_bytes"] if remat else 0)
    median = statistics.median(r["seconds"] for r in rows[1:])
    print(f"train stage {stage}: {card}: median step {median:.3f} s "
          f"(steps 2-{steps}), peak memory {peak / 2**30:.2f} GiB", flush=True)
    del state, towers, batch
    torch.cuda.empty_cache()
    return dict(build_s=build_s, trained_params=trained, encode_s=encode_s,
                encode_launches=encode_launches, steps=rows,
                median_step_s=median, peak_bytes=peak,
                **({} if remat is None else dict(remat=remat)))


def remat_step(state, batch, noise, loss, norm, launches) -> dict:
    """Stage 2's first step again, the UNet's sub-blocks checkpointed:
    the same loss (1e-3) and global gradient norm (1e-2), more forward
    launches (the recomputes)."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.train import loop

    unet = state.module.unet
    levels = list(unet.down_blocks) + list(unet.up_blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for level in levels:
        level.remat = True
    try:
        ops.reset_launch_counts()
        loss_r, grads_r = loop.compute_gradients(state, batch, noise)
        launches_r = ops.launch_counts("story")
        norm_r = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(list(grads_r.values())))).item()
    finally:
        for level in levels:
            level.remat = False
    del grads_r
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    loss_err = abs(loss_r.item() - loss.item()) / abs(loss.item())
    norm_err = abs(norm_r - norm.item()) / norm.item()
    print(f"train stage 2: remat step 1 loss {loss_r.item():.6f} (rel err "
          f"{loss_err:.2e}), global grad norm rel err {norm_err:.2e}, "
          f"{seconds:.3f} s, forward launches {launches_r} against "
          f"{launches}, peak {peak / 2**30:.2f} GiB (without remat "
          f"{base / 2**30:.2f})", flush=True)
    if not (loss_err <= 1e-3 and norm_err <= 1e-2) or sum(
            launches_r.values()) <= sum(launches.values()):
        raise AssertionError("the remat step disagrees or recomputed no "
                             "kernel")
    return dict(loss=loss_r.item(), loss_err=loss_err, norm_err=norm_err,
                launches=launches_r, peak_bytes=peak,
                peak_without_bytes=base, seconds=seconds)


def run_train(dev, card: str) -> dict:
    """Phase 9: kernel gradients, tiny trainers vs the CPU, full width."""
    print(f"train on {card}", flush=True)
    kernel_rows = check_kernel_grads(dev)
    torch.cuda.empty_cache()
    tiny = check_tiny_training(dev)
    full = {f"stage{s}": full_width_stage(s, dev, card) for s in (2, 1)}
    result = dict(card=card, kernels=kernel_rows, tiny=tiny, full=full)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_train.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# ---- phase 10: the training entry points -----------------------------------

TRAIN_CLI_DIR = os.path.join(REPO, "build", "chip_smoke_train")


class OneStory:
    """A full-width synthetic Flintstones dataset that repeats one story
    batch, so that a resumed step sees the batch of the unbroken one (the
    CLIs' data iterator restarts on resume)."""

    def __init__(self, batch_size: int = 1):
        from rcdms_tpu_torch.configs import DatasetConfig
        from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset

        self.cfg = DatasetConfig(name="flintstones")
        self._batch = next(SyntheticStoryDataset(
            cfg=self.cfg, num_items=batch_size).batches(batch_size, seed=0))

    def batches(self, batch_size, **_):
        while True:
            yield self._batch


class _Timed:
    """Wraps the checkpoint module's save and restore and TrainState's
    load, recording their seconds (card synchronised), the bytes a save
    wrote, and whether each load left the state's masters and moments
    equal to the file's bit for bit."""

    def __init__(self):
        from rcdms_tpu_torch.io import checkpoint
        from rcdms_tpu_torch.train.train_state import TrainState

        self.rows = []
        self._undo = [(checkpoint, "save_checkpoint"),
                      (checkpoint, "restore_checkpoint"),
                      (TrainState, "load_state_dicts")]
        self._orig = [getattr(o, n) for o, n in self._undo]
        save, restore, load = self._orig
        rows = self.rows

        def timed_save(directory, step, state, metadata=None, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wrote = save(directory, step, state, metadata, **kw)
            path = os.path.join(directory, str(step), checkpoint.STATE_FILE)
            rows.append(dict(op="save", step=step, wrote=wrote,
                             s=time.perf_counter() - t0,
                             bytes=os.path.getsize(path) if wrote else 0))
            return wrote

        def timed_restore(directory, target=None, step=None):
            t0 = time.perf_counter()
            out = restore(directory, target, step)
            rows.append(dict(op="restore", step=out[2],
                             s=time.perf_counter() - t0))
            return out

        def timed_load(state, dicts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load(state, dicts)
            torch.cuda.synchronize()
            row = dict(op="load", s=time.perf_counter() - t0)
            row["equal"] = _state_equals_file(state.state_dicts(), dicts)
            rows.append(row)

        for (o, n), fn in zip(self._undo, (timed_save, timed_restore,
                                           timed_load)):
            setattr(o, n, fn)

    def close(self):
        for (o, n), fn in zip(self._undo, self._orig):
            setattr(o, n, fn)


def _state_equals_file(state: dict, saved: dict) -> bool:
    """The masters, moments and counts of `state` (on the card) equal those
    of `saved` (a restored tree, on the host) bit for bit."""
    for key in ("params", "mu", "nu"):
        if set(state[key]) != set(saved[key]):
            return False
        for n, t in state[key].items():
            if not torch.equal(t.view(torch.int32),
                               saved[key][n].to(t.device).view(torch.int32)):
                return False
    return all(state[k] == saved[k] for k in ("count", "mini_step",
                                               "gradient_step", "step"))


def _cli_args(mod, *extra):
    return mod.parse_args([
        "--device", "cuda", "--batch-size", "1", "--learning-rate", "1e-5",
        "--warmup-steps", "0", "--log-every", "1", "--checkpointing-steps",
        "2", "--report-to", "none", *extra])


def _logged(out: str) -> dict:
    """metrics.jsonl of a CLI's output directory, by step (the last line
    of a step wins: a resumed run logs its steps again)."""
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return {r["step"]: r for r in map(json.loads, fh) if r}


def _cli_row(stage: int, out: str, timed: "_Timed", launches: dict,
             steps: int, card: str) -> dict:
    from rcdms_tpu_torch.io.checkpoint import latest_step

    logged = _logged(out)
    mine = sorted(logged)[-steps:]  # this run's steps
    step_s = [logged[i]["step_time"] for i in mine]
    data_s = [logged[i]["data_time"] for i in mine]
    saves = [r for r in timed.rows if r["op"] == "save" and r["wrote"]]
    row = dict(
        stage=stage, steps=steps, step_s=step_s, data_s=data_s,
        median_step_s=statistics.median(step_s[1:] or step_s),
        median_data_s=statistics.median(data_s),
        save_s=[r["s"] for r in saves], ckpt_bytes=[r["bytes"] for r in saves],
        restore_s=[r["s"] for r in timed.rows if r["op"] == "load"],
        peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
        latest_step=latest_step(out),
        losses=[logged[i]["loss"] for i in mine])
    print(f"train cli stage {stage}: {card}: steps {row['step_s']} s (median "
          f"of the later {row['median_step_s']:.3f}), data "
          f"{row['data_s']} s, saves {row['save_s']} s of "
          f"{row['ckpt_bytes']} bytes, restores {row['restore_s']} s, peak "
          f"{row['peak_bytes'] / 2**30:.2f} GiB, launches {launches}, "
          f"losses {row['losses']}", flush=True)
    if not all(math.isfinite(v) for v in row["losses"]):
        raise AssertionError(f"stage {stage}: non-finite losses")
    return row


def train_cli_stage2(dev, card: str, step_launches: dict,
                     keep: dict) -> dict:
    """Phase 10 (a): `cli.train_stage2.run` at full width and depth, 2
    steps with a checkpoint at 2; one more step in memory; a resume to 3
    from the checkpoint (bit for bit restore, the step-2 loss within 1e-3
    relative, a step's forward launches equal phase 9's); `--stage2-ckpt`
    into the inference pipeline bit for bit; the checkpoints deleted.
    `keep` gets the 2-step run's masters (host copies), losses and
    launches, for phase 11 (a)."""
    import shutil

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import common, evaluate, train_stage2
    from rcdms_tpu_torch.io.checkpoint import restore_checkpoint
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.train.loop import train_step

    configs = full_configs(temporal_zero_init=False)
    dataset = OneStory()
    out = os.path.join(TRAIN_CLI_DIR, "stage2")
    shutil.rmtree(out, ignore_errors=True)
    rows = {}
    try:
        args = _cli_args(train_stage2, "--max-train-steps", "2",
                         "--output-dir", out)
        timed = _Timed()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        try:
            res = train_stage2.run(args, dataset, configs)
        finally:
            timed.close()
        launches = ops.launch_counts("story")
        rows["run"] = _cli_row(2, out, timed, launches, 2, card)
        state, towers = res.state, res.towers
        saved = restore_checkpoint(out)[0]
        if not _state_equals_file(state.state_dicts(), saved):
            raise AssertionError("the step-2 checkpoint differs from the "
                                 "trained state")
        del saved
        keep.update(masters={n: t.cpu() for n, t in state.params.items()},
                    losses=rows["run"]["losses"], launches=launches)
        # step 2 in memory, on the CLI's own generators for step 2
        raw = common.batch_to_device(next(dataset.batches(1)), dev)
        encode_gen, step_gen = common.step_generators(args.seed, 2, dev)
        with torch.no_grad():
            batch = train_stage2.encode(towers, raw, encode_gen)
        loss_mem = train_step(state, batch, generator=step_gen).item()
        names = sorted(state.params)[:: max(1, len(state.params) // 4)]
        sums = {n: state.params[n].double().sum().item() for n in names}
        del res, state, towers, batch, raw
        torch.cuda.empty_cache()

        args = _cli_args(train_stage2, "--max-train-steps", "3",
                         "--output-dir", out, "--resume-from-checkpoint", out)
        timed = _Timed()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        try:
            res = train_stage2.run(args, dataset, configs)
        finally:
            timed.close()
        resumed = ops.launch_counts("story")
        rows["resumed"] = _cli_row(2, out, timed, resumed, 1, card)
        loss_res = _logged(out)[2]["loss"]
        rel = abs(loss_res - loss_mem) / abs(loss_mem)
        equal = [r["equal"] for r in timed.rows if r["op"] == "load"]
        print(f"train cli stage 2: resumed step-2 loss {loss_res:.6f} "
              f"against {loss_mem:.6f} in memory (rel {rel:.2e}); restore "
              f"bit for bit {equal}; master sums in memory "
              f"{list(sums.values())[:2]}; a step's forward launches "
              f"{resumed}, phase 9's {step_launches}", flush=True)
        if equal != [True] or not rel <= 1e-3:
            raise AssertionError("the resumed run's restore or step-2 loss "
                                 "disagrees")
        if step_launches is not None and resumed != step_launches:
            raise AssertionError(f"a resumed step launched {resumed}, phase "
                                 f"9's step and encode {step_launches}")
        del res
        torch.cuda.empty_cache()

        # the inference pipeline from the training checkpoint
        t0 = time.perf_counter()
        pipe, _, _ = evaluate.build_pipeline(evaluate.parse_args([
            "--dataset", "flintstones", "--dtype", "bfloat16", "--device",
            "cuda", "--stage2-ckpt", out]))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        masters = restore_checkpoint(out)[0]["params"]
        n = 0
        for tower in ("unet", "fusion"):
            for name, p in getattr(pipe, tower).named_parameters():
                want = masters[f"{tower}.{name}"].to(dev, p.dtype)
                if not torch.equal(p, want):
                    raise AssertionError(f"--stage2-ckpt: {tower}.{name} "
                                         f"is not its master")
                n += 1
        print(f"train cli stage 2: --stage2-ckpt build {build_s:.2f} s; "
              f"{n} UNet and fusion tensors equal their masters cast to "
              f"bf16 bit for bit", flush=True)
        del pipe, masters
        torch.cuda.empty_cache()
        rows.update(loss_in_memory=loss_mem, loss_resumed=loss_res,
                    loss_rel=rel, stage2_ckpt_build_s=build_s,
                    stage2_ckpt_tensors=n)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return rows


def train_cli_stage1(dev, card: str) -> dict:
    """Phase 10 (b): `cli.train_stage1.run` at full width, the prior cut to
    4 of its 20 layers: 2 steps and a checkpoint; the checkpoint restored
    into the state bit for bit."""
    import dataclasses
    import shutil

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import train_stage1
    from rcdms_tpu_torch.io.checkpoint import restore_checkpoint
    from rcdms_tpu_torch.sample.pipeline import full_configs

    configs = full_configs(temporal_zero_init=False)
    configs = dataclasses.replace(configs, prior=dataclasses.replace(
        configs.prior, num_layers=4))
    out = os.path.join(TRAIN_CLI_DIR, "stage1")
    shutil.rmtree(out, ignore_errors=True)
    try:
        args = _cli_args(train_stage1, "--max-train-steps", "2",
                         "--output-dir", out)
        timed = _Timed()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        try:
            res = train_stage1.run(args, OneStory(), configs)
            res.state.load_state_dicts(restore_checkpoint(out)[0])
        finally:
            timed.close()
        launches = ops.launch_counts("story")
        row = _cli_row(1, out, timed, launches, 2, card)
        row["trained_params"] = sum(p.numel()
                                    for p in res.state.params.values())
        equal = [r["equal"] for r in timed.rows if r["op"] == "load"]
        if equal != [True]:
            raise AssertionError("stage 1's restore is not bit for bit")
        del res
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return row


def check_native_feeder(card: str, stories: int = 4) -> dict:
    """Phase 10 (c): the native feeder built with g++ on the host, 5-frame
    stories of 128 px frames packed to 512 px / 224 clip, equal to the
    numpy protocol bit for bit; ms a story of each."""
    import numpy as np

    from rcdms_tpu_torch.configs import DatasetConfig
    from rcdms_tpu_torch.data import native_feeder
    from rcdms_tpu_torch.data.protocol import (
        StoryTokenizer,
        build_story_example,
    )

    t0 = time.perf_counter()
    lib = native_feeder.build_library()
    build_s = time.perf_counter() - t0
    cfg = DatasetConfig(name="flintstones")
    tok = StoryTokenizer(cfg)
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (5, 128, 128, 3), np.uint8)
              for _ in range(stories)]
    known = [i % 5 for i in range(stories)]
    feeder = native_feeder.NativeFeeder(num_threads=4, buffer_depth=2)
    try:
        feeder.pack_batch(frames, known, cfg.image_size, cfg.clip_size)
        t0 = time.perf_counter()
        got = feeder.pack_batch(frames, known, cfg.image_size, cfg.clip_size)
        feeder_ms = (time.perf_counter() - t0) * 1e3 / stories
        t0 = time.perf_counter()
        want = [build_story_example(list(f), ["c"] * 5, k, tok, cfg=cfg)
                for f, k in zip(frames, known)]
        numpy_ms = (time.perf_counter() - t0) * 1e3 / stories
        for i, ex in enumerate(want):
            for key in ("target", "source", "reference_clip", "source_clip",
                        "mask_clip", "mask_label"):
                if not np.array_equal(got[key][i], ex[key]):
                    raise AssertionError(f"feeder {key} story {i} differs "
                                         f"from the numpy protocol")
    finally:
        feeder.close()
    print(f"native feeder: {card}: built in {build_s:.2f} s ({lib.name}); "
          f"{stories} stories of 5 x 128 px -> 512 / 224: feeder "
          f"{feeder_ms:.2f} ms a story (4 threads), numpy protocol "
          f"{numpy_ms:.2f} ms a story, equal bit for bit", flush=True)
    return dict(build_s=build_s, feeder_ms=feeder_ms, numpy_ms=numpy_ms,
                stories=stories)


def run_train_cli(dev, card: str, step_launches: Optional[dict],
                  keep: dict) -> dict:
    """Phase 10: the training entry points (module docstring);
    `step_launches` is phase 9's stage-2 step and encode launches; `keep`
    as `train_cli_stage2`'s."""
    import shutil

    print(f"train cli on {card}", flush=True)
    os.makedirs(TRAIN_CLI_DIR, exist_ok=True)
    usage = shutil.disk_usage(TRAIN_CLI_DIR)
    print(f"train cli: disk free {usage.free / 1e9:.1f} GB of "
          f"{usage.total / 1e9:.1f} GB", flush=True)
    result = dict(card=card, stage2=train_cli_stage2(dev, card,
                                                     step_launches, keep),
                  stage1=train_cli_stage1(dev, card),
                  feeder=check_native_feeder(card))
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_train_cli.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# ---- phase 11: data-parallel training --------------------------------------

DP_DIR = os.path.join(REPO, "build", "chip_smoke_dp")
DP_JOIN_S = 300  # seconds the two rank processes of phase 11 (b) may take


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def dp_one_rank(dev, card: str, phase10: dict) -> dict:
    """Phase 11 (a): phase 10 (a)'s 2-step `cli.train_stage2.run` again
    under a one-rank NCCL group joined from torchrun's variables (set here
    for this process): its logged losses and masters equal phase 10's bit
    for bit, its launches phase 10's, and its checkpoint (the moments
    gathered to the host by `save_train_state`) the trained state."""
    import shutil

    import torch.distributed as dist

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import train_stage2
    from rcdms_tpu_torch.io.checkpoint import restore_checkpoint
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.train import distributed

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = os.path.join(DP_DIR, "stage2_one_rank")
    shutil.rmtree(out, ignore_errors=True)
    try:
        distributed.maybe_initialize("cuda")
        backend = dist.get_backend()
        args = _cli_args(train_stage2, "--max-train-steps", "2",
                         "--output-dir", out)
        timed = _Timed()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        try:
            res = train_stage2.run(args, OneStory(),
                                   full_configs(temporal_zero_init=False))
        finally:
            timed.close()
        launches = ops.launch_counts("story")
        row = _cli_row(2, out, timed, launches, 2, card)
        state = res.state
        del res
        masters_equal = all(
            _bits_equal(t, phase10["masters"][n].to(t.device))
            for n, t in state.params.items())
        file_equal = _state_equals_file(state.state_dicts(),
                                        restore_checkpoint(out)[0])
        row.update(backend=backend, world=dist.get_world_size(),
                   losses_equal=row["losses"] == phase10["losses"],
                   masters_equal=masters_equal, file_equal=file_equal,
                   launches_a_step={k: v / 2 for k, v in launches.items()})
        print(f"dp one rank: {card}: stage 2 under a one-rank {backend} "
              f"group: losses {row['losses']} (phase 10 "
              f"{phase10['losses']}); losses equal bit for bit "
              f"{row['losses_equal']}, masters {masters_equal}, checkpoint "
              f"{file_equal}; launches a step {row['launches_a_step']}",
              flush=True)
        if not (row["losses_equal"] and masters_equal and file_equal):
            raise AssertionError("the one-rank group's stage-2 run differs "
                                 "from phase 10's")
        if launches != phase10["launches"]:
            raise AssertionError(f"the one-rank run launched {launches}, "
                                 f"phase 10 {phase10['launches']}")
        del state
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(out, ignore_errors=True)
    return row


class TwoStories:
    """Two full-width synthetic Flintstones stories, repeated: shard r of
    n at batch b reads rows [r b, (r + 1) b) of the two, so two ranks at
    batch 1 read together what one process reads at batch 2."""

    def __init__(self):
        from rcdms_tpu_torch.configs import DatasetConfig
        from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset

        self.cfg = DatasetConfig(name="flintstones")
        self._batch = next(SyntheticStoryDataset(
            cfg=self.cfg, num_items=2).batches(2, seed=0))

    def batches(self, batch_size, shard_id=0, num_shards=1, **_):
        if batch_size * num_shards != 2:
            raise ValueError(f"{num_shards} shards of {batch_size} rows")
        lo = shard_id * batch_size
        rows = {k: v[lo:lo + batch_size] for k, v in self._batch.items()}
        while True:
            yield rows


def _dp_stage1(out: str, batch_size: int, *extra):
    """Phase 10 (b)'s stage 1 (the prior cut to 4 layers) in fp32, 2 steps
    of --batch-size `batch_size` on `TwoStories`, one checkpoint."""
    import dataclasses

    from rcdms_tpu_torch.cli import train_stage1
    from rcdms_tpu_torch.sample.pipeline import full_configs

    configs = full_configs(temporal_zero_init=False)
    configs = dataclasses.replace(configs, prior=dataclasses.replace(
        configs.prior, num_layers=4))
    args = train_stage1.parse_args([
        "--device", "cuda", "--batch-size", str(batch_size), "--dtype",
        "float32", "--learning-rate", "1e-5", "--warmup-steps", "0",
        "--log-every", "1", "--max-train-steps", "2", "--report-to", "none",
        "--output-dir", out, *extra])
    return train_stage1.run(args, TwoStories(), configs)


def _dp_rank(rank: int, store: str, root: str) -> None:
    """Phase 11 (b)'s rank `rank` (a spawned process): joins the two-rank
    gloo group on the one card, runs `_dp_stage1` with ZeRO-2 and with
    --no-zero2, and writes its launches, seconds and peak memory."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.train import distributed

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    distributed.maybe_initialize("cuda", init_method=f"file://{store}",
                                 world_size=2, rank=rank, local_rank=0,
                                 backend="gloo")
    try:
        rows = {}
        for mode, extra in (("zero2", ()), ("replicated", ("--no-zero2",))):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _dp_stage1(os.path.join(root, mode), 2, *extra)
            torch.cuda.synchronize()
            rows[mode] = dict(launches=ops.launch_counts("story"),
                              s=time.perf_counter() - t0,
                              peak_bytes=torch.cuda.max_memory_allocated())
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(rows, fh)
    finally:
        distributed.shutdown()


def _losses(out: str) -> list:
    return [r["loss"] for _, r in sorted(_logged(out).items())]


def _set_rel(got: dict, want: dict) -> float:
    """max |got - want| / max |want| over a set of named tensors."""
    diff = max(float((got[n] - want[n]).abs().max()) for n in want)
    return diff / max(float(t.abs().max()) for t in want.values())


def dp_two_ranks(card: str) -> dict:
    """Phase 11 (b): two spawned processes on the one card, a gloo group
    (NCCL refuses two ranks on one device), `_dp_stage1` at global batch
    2 with ZeRO-2 and with --no-zero2, against one process (here, no
    group) at batch 2 on the same two stories: the logged losses and the
    step-2 masters and moments within 1e-5 relative (of the set's largest
    magnitude); ZeRO-2 against --no-zero2 reported bit for bit."""
    import shutil

    import torch.multiprocessing as mp

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.io.checkpoint import restore_checkpoint

    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank,
                         args=(r, os.path.join(DP_DIR, "store"), DP_DIR))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _dp_stage1(os.path.join(DP_DIR, "one"), 2)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_launches = ops.launch_counts("story")
        torch.cuda.empty_cache()
        for p in procs:
            p.join(DP_JOIN_S)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"phase 11 (b) rank exit codes {codes} "
                                 f"(None: still running after {DP_JOIN_S} "
                                 f"s)")
        ranks = []
        for r in range(2):
            with open(os.path.join(DP_DIR, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        want = restore_checkpoint(os.path.join(DP_DIR, "one"))[0]
        want_losses = _losses(os.path.join(DP_DIR, "one"))
        row = dict(one_s=one_s, one_launches=one_launches, ranks=ranks)
        got = {}
        for mode in ("zero2", "replicated"):
            out = os.path.join(DP_DIR, mode)
            got[mode] = restore_checkpoint(out)[0]
            losses = _losses(out)
            row[mode] = dict(
                losses=losses,
                loss_rel=max(abs(a - b) / abs(b)
                             for a, b in zip(losses, want_losses)),
                **{f"{k}_rel": _set_rel(got[mode][k], want[k])
                   for k in ("params", "mu", "nu")})
        row["zero2_bits_equal_replicated"] = all(
            _bits_equal(got["zero2"][k][n], t)
            for k in ("params", "mu", "nu")
            for n, t in got["replicated"][k].items())
        peaks = [{m: (x[m]["s"], x[m]["peak_bytes"] / 2**30) for m in x}
                 for x in ranks]
        print(f"dp two ranks: {card}: stage 1 (4 layers, fp32, global "
              f"batch 2) on two gloo ranks against one process at batch 2 "
              f"(losses {want_losses}): ZeRO-2 {row['zero2']}, --no-zero2 "
              f"{row['replicated']}; ZeRO-2 equals --no-zero2 bit for bit "
              f"{row['zero2_bits_equal_replicated']}; rank seconds and "
              f"peak GiB {peaks}; launches a rank "
              f"{[x['zero2']['launches'] for x in ranks]}, one process "
              f"{one_launches}", flush=True)
        bad = [(m, k, row[m][k]) for m in ("zero2", "replicated")
               for k in ("loss_rel", "params_rel", "mu_rel", "nu_rel")
               if not row[m][k] <= 1e-5]
        if bad:
            raise AssertionError(f"two ranks disagree with one process: "
                                 f"{bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(DP_DIR, ignore_errors=True)
    return row


def run_dp(dev, card: str, phase10: dict) -> dict:
    """Phase 11: data-parallel training (module docstring)."""
    print(f"dp on {card}", flush=True)
    result = dict(card=card, one_rank=dp_one_rank(dev, card, phase10),
                  two_ranks=dp_two_ranks(card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_train_dp.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# ---- phase 12: sharded single-story inference ------------------------------

SHARD_DIR = os.path.join(REPO, "build", "chip_smoke_shard")
# phase 12's gloo runs on the one card: name -> (ranks, 'frame' axis);
# (b) cfg 2 x space 2, (c) space 3, (d) cfg 2 x frame 2
SHARD_RUNS = {"b": (4, 1), "c": (3, 1), "d": (4, 2)}
SHARD_JOIN_S = 420  # seconds a run may take, builds included
# card memory of a phase-12 rank once built (13.27-13.45 GiB were read at
# the request's peak) and while building (25.05 GiB: fp32 weights cast)
SHARD_BUILT_BYTES = int(13.5 * 2**30)
SHARD_BUILDING_BYTES = int(25.5 * 2**30)
# frames' mean and max |diff| against one process: the geometric means of
# the sound reading and the least of `--shard-faults`' faulted ones
# (mean 4.766e-3 against 7.668e-3, max 0.1035 against 0.7910; PERF.md)
SHARD_MEAN_TOL = 6.0e-3
SHARD_MAX_TOL = 0.29
# embeds' max |diff| / max |embed| against one process: the geometric
# mean of the sound reading and the least faulted one (1.585e-2 in (b)
# and (d) against 0.1553, `frames_reversed_in_exchange`), capped at
# TOL[bf16]; the prior alone reads 4.5e-6 in fp32 on (b)'s layout
SHARD_EMBEDS_TOL = min(TOL[torch.bfloat16], math.sqrt(1.585e-2 * 0.1553))
# faults planted by `--shard-faults` (none in the phase): name -> (the
# run of SHARD_RUNS it is planted in, what it breaks)
SHARD_FAULTS = {
    "unet_level0_halo": ("b", "the UNet's level-0 convs (32 of 64 latent "
                         "rows a rank, 320 channels) take zeros for their "
                         "neighbours' rows"),
    "vae_512px_halo": ("b", "the VAE's 512-px convs (128 of 512 rows a "
                       "rank, 128 channels) take zeros for their "
                       "neighbours' rows"),
    "frames_reversed_in_exchange": ("d", "every temporal module's blocks "
                                    "see the frames in reverse order after "
                                    "the frame-for-token all_to_all"),
    "prior_frames_out_of_order": ("d", "the prior's frames gathered with "
                                  "its ranks' blocks in reverse order"),
    "tower_batch_out_of_order": ("d", "the towers' outputs gathered with "
                                 "the ranks' blocks of the b*f batch in "
                                 "reverse order"),
}
# the halo faults' feature maps: name -> (local rows, channels)
SHARD_HALO_FAULTS = {"unet_level0_halo": (32, 320),
                     "vae_512px_halo": (128, 128)}


def _torchrun_env() -> dict:
    """The variables torchrun gives a one-rank world, on a free port."""
    return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")


def shard_one_rank(card: str, entry: dict) -> dict:
    """Phase 12 (a): phase 7a's `cli.generate.run` with `--shard-story`
    under a one-rank NCCL group joined from torchrun's variables (set here
    for this process): frames, embeds and launches equal 7a's bit for
    bit."""
    import torch.distributed as dist

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import evaluate, generate
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
    from rcdms_tpu_torch.train import distributed

    env = _torchrun_env()
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        args = evaluate.parse_args([
            "--dataset", "flintstones", "--dtype", "bfloat16",
            "--num-inference-steps", str(STEPS), "--guidance-scale", "2.0",
            "--seed", "42", "--device", "cuda", "--shard-story"])
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        frames, embeds = generate.run(args, ENTRY_CAPTIONS, [entry["frame0"]])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts("story")
        counts["frame_attention_tiled"] = frame_attention.tiled_launches
        row = dict(backend=dist.get_backend(), world=dist.get_world_size(),
                   s=seconds, launches=counts,
                   frames_equal=_bits_equal(frames.cpu(), entry["frames_a"]),
                   embeds_equal=_bits_equal(embeds.cpu(), entry["embeds_a"]),
                   launches_equal=counts == entry["launches_a"])
        del frames, embeds
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"shard one rank: {card}: generate.run --shard-story under a "
          f"one-rank {row['backend']} group in {row['s']:.3f} s (build "
          f"included); frames equal 7a's bit for bit {row['frames_equal']}, "
          f"embeds {row['embeds_equal']}, launches {row['launches_equal']} "
          f"({counts})", flush=True)
    if not (row["frames_equal"] and row["embeds_equal"]
            and row["launches_equal"]):
        raise AssertionError(f"--shard-story on one rank differs from 7a: "
                             f"7a launched {entry['launches_a']}")
    return row


def _reversed_gather(module, axis: int) -> None:
    """`module.spatial` with a `gather` that joins the ranks' blocks along
    `axis` in reverse rank order (a planted fault)."""
    import types

    from rcdms_tpu_torch.core import spatial

    def gather(x, at, group, table):
        whole = spatial.gather(x, at, group, table)
        if at % x.dim() != axis or group.size == 1:
            return whole
        return torch.cat([whole.narrow(axis, o, n) for o, n in table[::-1]],
                         dim=axis)

    faulty = types.SimpleNamespace(**vars(spatial))
    faulty.gather = gather
    module.spatial = faulty


def _plant_shard_fault(name: str) -> None:
    """In this rank's process, SHARD_FAULTS[name] (every rank plants it,
    so the ranks still join the same collectives)."""
    from rcdms_tpu_torch.core import spatial
    from rcdms_tpu_torch.sample import pipeline, prior_sampler

    if name in SHARD_HALO_FAULTS:
        rows, channels = SHARD_HALO_FAULTS[name]
        real = spatial.halo

        def halo(x, axis, above, below, plan):
            if x.shape[axis] != rows or x.shape[-1] != channels:
                return real(x, axis, above, below, plan)

            def zeros(n):
                shape = list(x.shape)
                shape[axis] = n
                return x.new_zeros(shape)

            return torch.cat([zeros(above), x, zeros(below)], dim=axis)

        spatial.halo = halo
    elif name == "frames_reversed_in_exchange":
        to_tokens = spatial.frames_to_tokens
        to_frames = spatial.tokens_to_frames
        spatial.frames_to_tokens = lambda h, split: to_tokens(
            h, split).flip(1)
        spatial.tokens_to_frames = lambda h, split, n: to_frames(
            h.flip(1), split, n)
    elif name == "prior_frames_out_of_order":
        _reversed_gather(prior_sampler, 1)
    elif name == "tower_batch_out_of_order":
        _reversed_gather(pipeline, 0)
    else:
        raise ValueError(f"no shard fault {name!r}")


def _shard_rank(rank: int, world: int, frame: int, store: str, root: str,
                fault: Optional[str] = None) -> None:
    """Rank `rank` of a phase-12 gloo run (a spawned process): joins the
    gloo group of `world` ranks on the one card, builds phase 5's pipeline
    (seed 0, bf16) with the inference mesh at 'frame' axis `frame`, the
    ranks one after another (each build holds fp32 weights for a moment),
    and runs phase 5's request 1 (seed 1, generator 11); writes its mesh,
    launches, seconds and peak memory, and rank 0 the frames and embeds.
    `fault`: a planted fault of SHARD_FAULTS."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
    from rcdms_tpu_torch.sample.pipeline import build_pipeline, full_configs
    from rcdms_tpu_torch.train import distributed, sharding

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if fault is not None:
        _plant_shard_fault(fault)
    dev = torch.device("cuda")
    distributed.maybe_initialize("cuda", init_method=f"file://{store}",
                                 world_size=world, rank=rank,
                                 local_rank=0, backend="gloo")
    try:
        mesh = sharding.inference_mesh(frame)
        configs = full_configs(temporal_zero_init=False)
        t0 = time.perf_counter()
        for r in range(world):
            if r == rank:
                pipe = build_pipeline(configs, dev, torch.bfloat16, seed=0,
                                      num_steps=STEPS, mesh=mesh)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        sharding.check_replicated(pipe, mesh.all)
        req = story_request(configs, 1, PIXELS, dev)
        csize = configs.vision.image_size
        uncond = req.tokens_s1_u[0, 0]
        cache = pipe.precompute_cond_cache(uncond, uncond,
                                           clip_constant(1.0, csize, dev),
                                           clip_constant(0.0, csize, dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        frames, embeds = pipe.generate(req, cache,
                                       torch.Generator(dev).manual_seed(11))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts("story")
        counts["frame_attention_tiled"] = frame_attention.tiled_launches
        if rank == 0:
            torch.save(dict(frames=frames.cpu(), embeds=embeds.cpu()),
                       os.path.join(root, "story.pt"))
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(dict(mesh=list(mesh[:6]), launches=counts, s=seconds,
                           build_s=build_s, build_peak_bytes=build_peak,
                           peak_bytes=torch.cuda.max_memory_allocated()), fh)
    finally:
        distributed.shutdown()


def shard_ranks(card: str, request1: dict, run: str = "b",
                fault: Optional[str] = None) -> dict:
    """Phase 12 (b), (c) or (d) (`run`, SHARD_RUNS): its spawned processes
    on the one card in a gloo group (NCCL refuses two ranks on one
    device) split phase 5's request 1; against phase 5's one-process
    frames (mean and max |diff| within SHARD_MEAN_TOL and SHARD_MAX_TOL)
    and embeds (max |diff| / max |embed| within SHARD_EMBEDS_TOL); every
    rank launches each of A-D, every B launch tiled. With a planted
    `fault` (`--shard-faults`) the row is returned unchecked."""
    import shutil

    import torch.multiprocessing as mp

    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    os.makedirs(SHARD_DIR)
    world, frame = SHARD_RUNS[run]
    # the ranks are built one after another: each built rank holds
    # SHARD_BUILT_BYTES, the one building SHARD_BUILDING_BYTES
    need = (world - 1) * SHARD_BUILT_BYTES + SHARD_BUILDING_BYTES
    cycles = _collect_cycles()
    parent_bytes = torch.cuda.memory_allocated()
    free_bytes = torch.cuda.mem_get_info()[0]
    print(f"shard ({run}): the card has {free_bytes / 2**30:.2f} GiB free "
          f"for {world} ranks needing about {need / 2**30:.2f} (this "
          f"process holds {parent_bytes / 2**30:.2f} GiB; the collector "
          f"freed {cycles / 2**30:.2f} GiB left in reference cycles)",
          flush=True)
    if free_bytes < need:
        raise AssertionError(
            f"phase 12 ({run}): {free_bytes / 2**30:.2f} GiB of the card "
            f"free, under the {need / 2**30:.2f} GiB its {world} ranks need: "
            f"an earlier phase still holds {parent_bytes / 2**30:.2f} GiB")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, world, frame,
                               os.path.join(SHARD_DIR, "store"), SHARD_DIR,
                               fault))
             for r in range(world)]
    try:
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(SHARD_JOIN_S)
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"phase 12 ({run}) rank exit codes {codes} "
                                 f"(None: still running after "
                                 f"{SHARD_JOIN_S} s; the card had "
                                 f"{free_bytes / 2**30:.2f} GiB free at "
                                 f"their spawn)")
        ranks = []
        for r in range(world):
            with open(os.path.join(SHARD_DIR, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        got = torch.load(os.path.join(SHARD_DIR, "story.pt"))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    _check_frames(got["frames"], len(ENTRY_CAPTIONS), PIXELS)
    diff = (got["frames"] - request1["frames"]).abs()
    embeds_rel = ((got["embeds"] - request1["embeds"]).abs().max()
                  / request1["embeds"].abs().max()).item()
    row = dict(card=card, run=run, fault=fault, world=world,
               mesh=ranks[0]["mesh"][:3],
               wall_s=wall, frames_mean_abs=diff.mean().item(),
               frames_max_abs=diff.max().item(), embeds_rel=embeds_rel,
               parent_bytes=parent_bytes, free_bytes=free_bytes,
               ranks=ranks)
    print(f"shard ({run}): {card}: phase 5's request 1 on {world} gloo "
          f"ranks{f' with the planted fault {fault}' if fault else ''}"
          f" (mesh cfg, frame, space {row['mesh']}; each rank's c, fr, s "
          f"{[x['mesh'][3:] for x in ranks]}) in {wall:.1f} s wall (spawn "
          f"and builds "
          f"included): frames mean |diff| {row['frames_mean_abs']:.3e}, max "
          f"|diff| {row['frames_max_abs']:.3e}; embeds max |diff| / max "
          f"{embeds_rel:.3e}; per rank: request s "
          f"{[round(x['s'], 3) for x in ranks]}, build s "
          f"{[round(x['build_s'], 1) for x in ranks]}, peak GiB request "
          f"{[round(x['peak_bytes'] / 2**30, 2) for x in ranks]}, build "
          f"{[round(x['build_peak_bytes'] / 2**30, 2) for x in ranks]} "
          f"(this process holds {parent_bytes / 2**30:.2f} GiB, the card "
          f"had {free_bytes / 2**30:.2f} GiB free); launches "
          f"{[x['launches'] for x in ranks]}", flush=True)
    if fault is not None:
        return row
    for r, x in enumerate(ranks):
        _check_story_launches(x["launches"], f"on shard rank {r}")
    if not (row["frames_mean_abs"] <= SHARD_MEAN_TOL
            and row["frames_max_abs"] <= SHARD_MAX_TOL
            and embeds_rel <= SHARD_EMBEDS_TOL):
        raise AssertionError(f"the sharded story differs from phase 5's: "
                             f"{row}")
    return row


def run_shard(card: str, entry: dict, request1: dict) -> dict:
    """Phase 12: sharded single-story inference (module docstring)."""
    print(f"shard on {card}", flush=True)
    result = dict(card=card, one_rank=shard_one_rank(card, entry),
                  **{run: shard_ranks(card, request1, run)
                     for run in SHARD_RUNS})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_shard.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# the prior alone on the ranks of these (ranks, 'frame' axis) layouts in
# `--shard-faults`: world 2 splits the CFG branches alone, (b)'s also the
# frames of a branch 3 / 2
SHARD_PRIOR_LAYOUTS = ((2, 1), (4, 1))


def _prior_embeds(dtype, mesh=None) -> torch.Tensor:
    """The full-width frame prior alone (seeded random weights, seed 0) in
    `dtype`, sampling 20 steps of seeded random conditioning (one story, 5
    frames, 24 real caption tokens) with the generator seed 11, on `mesh`
    or one process: (1, 5, 1280) fp32 embeds."""
    from rcdms_tpu_torch.core.layers import init_like_flax_
    from rcdms_tpu_torch.models.prior import FramePrior
    from rcdms_tpu_torch.sample.pipeline import for_inference, full_configs
    from rcdms_tpu_torch.sample.prior_sampler import (PriorConditioning,
                                                      PriorSampler)

    dev = torch.device("cuda")
    cfg = full_configs(temporal_zero_init=False).prior
    with dev:
        prior = FramePrior(cfg)
    init_like_flax_(prior, torch.Generator(dev).manual_seed(0))
    prior = for_inference(prior, dtype)
    g = torch.Generator().manual_seed(3)
    f, d, t = cfg.num_frames, cfg.embedding_dim, cfg.num_text_tokens

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev, dtype)

    mask = (torch.arange(t) < 24).expand(1, f, t).to(dev)
    cond = PriorConditioning(randn(1, f, d), randn(1, f, t, d), mask,
                             randn(1, f, d), randn(1, f, t, d), mask,
                             randn(1, f, d), randn(1, f, d))
    sampler = PriorSampler(prior, num_steps=STEPS, mesh=mesh)
    embeds = sampler(cond, generator=torch.Generator(dev).manual_seed(11))
    torch.cuda.synchronize()
    return embeds.cpu()


def _prior_rank(rank: int, world: int, frame: int, store: str, root: str,
                dtype: str) -> None:
    """Rank `rank` of a `shard_prior_layouts` run (a spawned process): the
    prior alone (`_prior_embeds`) on the inference mesh of `world` gloo
    ranks at 'frame' axis `frame`; rank 0 writes the embeds."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rcdms_tpu_torch.train import distributed, sharding

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    distributed.maybe_initialize("cuda", init_method=f"file://{store}",
                                 world_size=world, rank=rank,
                                 local_rank=0, backend="gloo")
    try:
        embeds = _prior_embeds(getattr(torch, dtype),
                               sharding.inference_mesh(frame))
        if rank == 0:
            torch.save(embeds, os.path.join(root, "prior.pt"))
    finally:
        distributed.shutdown()


def shard_prior_layouts(card: str) -> list:
    """The prior alone (`_prior_embeds`) in fp32 and in bf16 on each of
    SHARD_PRIOR_LAYOUTS against one process (this one) in the same dtype:
    max |diff| / max |embed|. A fault of the split shows in fp32 as much
    as in bf16; rounding (products of other shapes) shrinks with the
    dtype's epsilon."""
    import shutil

    import torch.multiprocessing as mp

    rows = []
    ctx = mp.get_context("spawn")
    for dtype in ("float32", "bfloat16"):
        want = _prior_embeds(getattr(torch, dtype))
        torch.cuda.empty_cache()
        for world, frame in SHARD_PRIOR_LAYOUTS:
            shutil.rmtree(SHARD_DIR, ignore_errors=True)
            os.makedirs(SHARD_DIR)
            procs = [ctx.Process(target=_prior_rank,
                                 args=(r, world, frame,
                                       os.path.join(SHARD_DIR, "store"),
                                       SHARD_DIR, dtype))
                     for r in range(world)]
            try:
                for p in procs:
                    p.start()
                for p in procs:
                    p.join(SHARD_JOIN_S)
                codes = [p.exitcode for p in procs]
                if codes != [0] * world:
                    raise AssertionError(f"prior layout {world}, {frame} "
                                         f"in {dtype}: exit codes {codes}")
                got = torch.load(os.path.join(SHARD_DIR, "prior.pt"))
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                shutil.rmtree(SHARD_DIR, ignore_errors=True)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            rows.append(dict(card=card, dtype=dtype, world=world,
                             frame=frame, embeds_rel=rel,
                             finite=bool(got.isfinite().all())))
            print(f"shard prior: {card}: the prior alone on {world} gloo "
                  f"ranks at 'frame' {frame} in {dtype}: max |diff| / max "
                  f"{rel:.3e} against one process", flush=True)
    return rows


def shard_faults(dev, card: str) -> dict:
    """`python3 chip_smoke.py --shard-faults`: phase 12 (b) and (d) sound
    and with each fault of SHARD_FAULTS planted in its run, against phase
    5's request 1 (its pipeline built here alone): the readings phase
    12's limits are set between; then `shard_prior_layouts`. Rows go to
    chiprun_out/chip_smoke_shard_faults.json."""
    from rcdms_tpu_torch.sample.pipeline import build_pipeline, full_configs

    configs = full_configs(temporal_zero_init=False)
    pipe = build_pipeline(configs, dev, torch.bfloat16, seed=0,
                          num_steps=STEPS)
    req = story_request(configs, 1, PIXELS, dev)
    csize = configs.vision.image_size
    uncond = req.tokens_s1_u[0, 0]
    cache = pipe.precompute_cond_cache(uncond, uncond,
                                       clip_constant(1.0, csize, dev),
                                       clip_constant(0.0, csize, dev))
    frames, embeds = pipe.generate(req, cache,
                                   torch.Generator(dev).manual_seed(11))
    request1 = dict(frames=frames.cpu(), embeds=embeds.cpu())
    del pipe, cache, frames, embeds
    torch.cuda.empty_cache()
    rows = [shard_ranks(card, request1, run, fault)
            for run in ("b", "d")
            for fault in (None, *(name for name, (at, _) in
                                  SHARD_FAULTS.items() if at == run))]
    result = dict(runs=rows, prior=shard_prior_layouts(card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_shard_faults.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# launches of each story kernel in one call of the full-width UNet: A, the
# 16 spatial transformers' two attention layers but the mid block's (64
# queries a frame, under the router's 256); B, the 20 temporal modules'
# two layers; C, the GEGLU FF of the 16 transformers and the 20 temporal
# modules; no D (the prior's GELU FF)
QUALITY_UNET_CALL = {"attention": 30, "frame_attention": 40, "geglu_ff": 36,
                     "gelu_ff": 0}
QUALITY_TOL = 5e-4  # phase 4's, the tiny inversion card vs CPU
INVERSION_STEPS = STEPS
# int8's distance from bf16 in (a): the geometric means of the sound
# reading and the least faulted of `--int8-faults` (1 - SSIM min 0.0024
# against 0.0619, latent rel RMS 0.0417 against 0.234; PERF.md)
INT8_SSIM_MIN_TOL = 0.988  # int8_vs_bf16.ssim_min at least
INT8_REL_RMS_TOL = 0.099   # int8_vs_bf16.latent_rel_rms at most
# faults planted by `--int8-faults` (none in the phase): name -> (what,
# the factor on each int8 conv's activation scale, the activation's
# levels each side of 0)
INT8_FAULTS = {
    "act_scale_x2": ("the activation scale doubled (each int8 conv's "
                     "output 2x)", 2.0, 127),
    "act_scale_x1.1": ("the activation scale 1.1x", 1.1, 127),
    "act_4bit": ("the activations on 4 bits (7 levels each side)", 1.0, 7),
}


def _finite_numbers(tree, where: str) -> None:
    """Every number in a JSON-like tree finite."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _finite_numbers(v, f"{where}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _finite_numbers(v, f"{where}[{i}]")
    elif isinstance(tree, float) and not math.isfinite(tree):
        raise AssertionError(f"{where} is {tree}")


def _unet_launches(calls: int) -> dict:
    return {k: calls * n for k, n in QUALITY_UNET_CALL.items()}


def _counted(runs: dict, sync):
    """A context manager factory: `around(name)` zeroes the story kernels'
    counts (and the int8 convs'), and records the run's launches, int8
    convs and seconds in `runs[name]`."""
    import contextlib

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops import quant

    @contextlib.contextmanager
    def around(name):
        sync()
        ops.reset_launch_counts()
        int8_calls = quant.int8_conv3x3.calls
        t0 = time.perf_counter()
        yield
        sync()
        counts = _story_counts()
        runs[name] = dict(launches=counts,
                          int8_convs=quant.int8_conv3x3.calls - int8_calls,
                          seconds=time.perf_counter() - t0)
        print(f"quality: {name}: {runs[name]['seconds']:.3f} s, launches "
              f"{counts}, int8 convs {runs[name]['int8_convs']}",
              flush=True)

    return around


def _check_unet_launches(counts: dict, calls: int, where: str) -> None:
    """Exactly `calls` full-width UNet calls' launches of A-D."""
    want = _unet_launches(calls)
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{where}: launches {got}, not {calls} UNet "
                             f"calls' {want}")


def quality_int8(card: str, rig, sync) -> dict:
    """Phase 13 (a): `int8_quality`'s full-width report with --encprop."""
    from rcdms_tpu_torch.tools import int8_quality

    runs = {}
    report = int8_quality.report(rig, encprop=True, card=card,
                                 around=_counted(runs, sync))
    _finite_numbers(report, "int8_quality")
    calls = 2 * rig.sampler.num_steps
    for name in ("bf16", "bf16_unrelated", "int8"):
        where = f"in int8_quality's {name} run"
        _check_unet_launches(runs[name]["launches"], calls, where)
        _check_tiled_b(runs[name]["launches"], where)
    if runs["int8"]["launches"] != runs["bf16"]["launches"]:
        raise AssertionError("the int8 run's launches differ from bf16's")
    if runs["int8"]["int8_convs"] == 0 or runs["bf16"]["int8_convs"]:
        raise AssertionError("the int8 convs ran outside the int8 run, or "
                             "not in it")
    q, floor = report["int8_vs_bf16"], report["unrelated_bf16_noise_floor"]
    if not q["ssim_mean"] > floor["ssim_mean"]:
        raise AssertionError(f"int8's SSIM to bf16 {q['ssim_mean']} is not "
                             f"above the unrelated story's "
                             f"{floor['ssim_mean']}")
    if not (q["ssim_min"] >= INT8_SSIM_MIN_TOL
            and q["latent_rel_rms"] <= INT8_REL_RMS_TOL):
        raise AssertionError(f"int8 is too far from bf16: SSIM min "
                             f"{q['ssim_min']} (at least "
                             f"{INT8_SSIM_MIN_TOL}), latent rel RMS "
                             f"{q['latent_rel_rms']} (at most "
                             f"{INT8_REL_RMS_TOL})")
    print(f"quality: {card}: int8 vs bf16 SSIM mean {q['ssim_mean']} (min "
          f"{q['ssim_min']}), latent rel RMS {q['latent_rel_rms']}; "
          f"unrelated floor SSIM {floor['ssim_mean']}; k = 2 vs bf16 SSIM "
          f"{report['encprop2_vs_bf16']['ssim_mean']}", flush=True)
    return dict(report=report, runs=runs)


def _plant_int8_fault(name: str):
    """The int8 convs' activations quantized as INT8_FAULTS[name] says;
    returns the sound `quantize_act` to put back."""
    from rcdms_tpu_torch.ops import quant

    _, factor, levels = INT8_FAULTS[name]
    real = quant.quantize_act

    def quantize_act(x):
        xf = x.float()
        scale = xf.abs().amax().clamp_min(1e-30) / levels
        q = torch.round(xf / scale).clamp(-levels, levels).to(torch.int8)
        return q, scale * factor

    quant.quantize_act = quantize_act
    return real


def int8_faults(dev, card: str) -> list:
    """`python3 chip_smoke.py --int8-faults`: phase 13 (a)'s int8 run sound
    and with each fault of INT8_FAULTS planted, each against (a)'s bf16
    run on the same noise: the readings (a)'s limits are set between. Rows
    go to chiprun_out/chip_smoke_int8_faults.json."""
    from rcdms_tpu_torch.ops import quant
    from rcdms_tpu_torch.tools import int8_quality as iq

    rig = iq.build(tiny=False, device=dev)
    lat_bf16 = iq.sample(rig, iq.SEEDS[0])
    frames_bf16 = iq.to_frames(rig, lat_bf16)
    rows = []
    for fault in (None, *INT8_FAULTS):
        real = _plant_int8_fault(fault) if fault else quant.quantize_act
        quant.set_quant_mode("int8")
        try:
            lat = iq.sample(rig, iq.SEEDS[0])
        finally:
            quant.set_quant_mode(None)
            quant.quantize_act = real
        row = dict(fault=fault, **iq.delta(lat_bf16, frames_bf16, lat,
                                           iq.to_frames(rig, lat)))
        print(f"int8 faults: {card}: {fault or 'sound'}: SSIM min "
              f"{row['ssim_min']}, mean {row['ssim_mean']}, latent rel "
              f"RMS {row['latent_rel_rms']}", flush=True)
        rows.append(row)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_int8_faults.json"),
              "w") as fh:
        json.dump(dict(card=card, rows=rows), fh, indent=1)
    return rows


def quality_inversion(dev, card: str, rig, sync) -> dict:
    """Phase 13 (b): `ddim_inversion` on the card, the tiny UNet in fp32
    against the CPU's plain versions, then the full-width UNet of (a) in
    bf16, one UNet call a step (the cond branch's context)."""
    import copy

    from rcdms_tpu_torch.core.layers import init_like_flax_
    from rcdms_tpu_torch.core.schedulers import DDIMSchedule
    from rcdms_tpu_torch.models.unet3d import StoryUNet
    from rcdms_tpu_torch.sample.pipeline import for_inference, tiny_configs
    from rcdms_tpu_torch.utils.video import ddim_inversion

    schedule = DDIMSchedule.stage2_inference()
    g = torch.Generator().manual_seed(13)
    cfg = tiny_configs(unet_channels=(64, 128)).unet
    unet = StoryUNet(cfg)
    init_like_flax_(unet, torch.Generator().manual_seed(3))
    unet = for_inference(unet)
    unet_c = copy.deepcopy(unet).to(dev)
    lat = torch.randn((1, 5, 8, 8, 4), generator=g)
    side = torch.randn((1, 5, 8, 8, cfg.in_channels - 4), generator=g)
    ctx = torch.randn((1, 5, 7, cfg.cross_attention_dim), generator=g)

    def denoiser(net, side, ctx):
        def eps(x, t):
            tb = torch.full((1,), t, dtype=torch.int64, device=x.device)
            return net(torch.cat([x, side], -1), tb, ctx)
        return eps

    want = ddim_inversion(denoiser(unet, side, ctx), schedule, lat, 10)
    got = ddim_inversion(denoiser(unet_c, side.to(dev), ctx.to(dev)),
                         schedule, lat.to(dev), 10)
    tiny_err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    print(f"quality: tiny inversion (10 steps, fp32) on the card vs the "
          f"CPU: {tiny_err:.2e} of max", flush=True)
    if not tiny_err <= QUALITY_TOL:
        raise AssertionError(f"the tiny inversion on the card differs from "
                             f"the CPU's by {tiny_err:.2e}")

    s, cond = rig.sampler, rig.cond
    with torch.no_grad():
        context = s.fusion(cond.image_tokens, cond.image_proj,
                           cond.text_hidden, cond.frame_known)
    side = torch.cat([cond.mask_label, cond.masked_latents], -1)
    full_lat = torch.randn(cond.masked_latents.shape[:-1] + (4,),
                           generator=g).to(dev)

    def full_eps(x, t):
        tb = torch.full((1,), t, dtype=torch.int64, device=dev)
        return s.unet(torch.cat([x.to(side.dtype), side], -1), tb, context)

    runs = {}
    with _counted(runs, sync)("inversion"):
        inverted = ddim_inversion(full_eps, schedule, full_lat,
                                  INVERSION_STEPS)
    if inverted.shape != full_lat.shape or not torch.isfinite(
            inverted).all():
        raise AssertionError("the full-width inversion is not finite")
    where = "in the full-width inversion"
    _check_unet_launches(runs["inversion"]["launches"], INVERSION_STEPS,
                         where)
    _check_tiled_b(runs["inversion"]["launches"], where)
    return dict(tiny_rel_err=tiny_err, steps=INVERSION_STEPS,
                **runs["inversion"])


def quality_parity(dev, card: str) -> dict:
    """Phase 13 (c): `parity_check --synthetic --device cuda`."""
    from rcdms_tpu_torch.tools import parity_check

    out = os.path.join(OUT_DIR, "chip_smoke_parity.json")
    t0 = time.perf_counter()
    rc = parity_check.main(["--synthetic", "--device", "cuda", "--out",
                            out])
    seconds = time.perf_counter() - t0
    with open(out) as fh:
        report = json.load(fh)
    checks = report["checks"]
    if rc != 0 or report["gate"] != "PASS":
        raise AssertionError(f"the synthetic parity gate on the card: "
                             f"{report['gate']}")
    if checks["determinism_fp32"]["identical"] is not True:
        raise AssertionError("two fp32 runs on the card differ")
    if checks["int8_vs_bf16"]["engaged"] is not True:
        raise AssertionError("the int8 route did not engage")
    for name, row in checks.items():
        if row["status"] == "measured":
            _finite_numbers(row, name)
    print(f"quality: {card}: parity gate {report['gate']} in "
          f"{seconds:.1f} s: bf16 vs fp32 SSIM min "
          f"{checks['bf16_vs_fp32']['ssim_min']}, int8 vs bf16 "
          f"{checks['int8_vs_bf16']['ssim_min']}, k = 2 vs bf16 "
          f"{checks['encoder_prop2_vs_bf16']['ssim_min']}", flush=True)
    return dict(report=report, seconds=seconds)


def run_quality(dev, card: str) -> dict:
    """Phase 13: the quality tools on the card (module docstring)."""
    from rcdms_tpu_torch.tools import int8_quality

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    rig = int8_quality.build(tiny=False, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    print(f"quality: built the full-width UNet, fusion and VAE in "
          f"{build_s:.1f} s", flush=True)
    result = dict(card=card, build_s=build_s,
                  int8=quality_int8(card, rig, sync),
                  inversion=quality_inversion(dev, card, rig, sync))
    del rig
    torch.cuda.empty_cache()
    result["parity"] = quality_parity(dev, card)
    result["seconds"] = time.perf_counter() - t0
    print(f"quality: phase 13 took {result['seconds']:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_quality.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# ---- phase 14: the bench entry points ---------------------------------------

# launches of one full-width two-stage story (phase 5's request, with the
# CondCache): A, the UNet's 1200 and the bigG vision tower's 48 layers at
# 257 tokens; B, the UNet's 1600 and the prior's 800 temporal layers
# (20 steps x 2 CFG x 20); C, the UNet's 1440 and the prior's temporal
# FFs' 400; D, the prior's 10 spatial FFs (20 steps x 2 CFG x 10)
STORY_CALL = {"attention": 1248, "frame_attention": 2400, "geglu_ff": 1840,
              "gelu_ff": 400}
BENCH_REPEATS = 2  # timed calls of each in-process bench mode
BENCH_TIMEOUT_S = 300  # a subprocess of (e), its build load included


def _check_bench_line(line: dict, metric: str, where: str) -> None:
    """The bench's JSON line: its metric, every number finite, and the
    card's keys set."""
    if line["metric"] != metric:
        raise AssertionError(f"{where}: metric {line['metric']}")
    _finite_numbers(line, where)
    missing = [k for k in ("device_name", "power_limit_w", "gb_in_use",
                           "peak_gb_in_use", "gb_limit") if line[k] is None]
    if line["backend"] != "cuda" or missing:
        raise AssertionError(f"{where}: backend {line['backend']}, keys "
                             f"without a value {missing}")


def _check_calls(launches: list, want: dict, where: str) -> None:
    """Every timed call launched `want` of each story kernel, and every B
    launch took the tiled kernel."""
    if len(launches) != BENCH_REPEATS:
        raise AssertionError(f"{where}: {len(launches)} timed calls counted")
    for i, counts in enumerate(launches):
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{where}: call {i} launched {got}, not "
                                 f"{want}")
        _check_tiled_b(counts, f"{where} (call {i})")


def _bench(argv: list, where: str, per_call: bool = True):
    """`bench.run(argv)` in this process; returns its line and, with
    `per_call`, each timed call's launches (else None, and the counts
    run on over the whole run), the card's memory released after."""
    import gc

    from rcdms_tpu_torch import bench

    launches = [] if per_call else None
    t0 = time.perf_counter()
    line = bench.run(argv, launches)
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"bench: {where} ({' '.join(argv)}) in {seconds:.1f} s: "
          f"{json.dumps(line)}", flush=True)
    return line, launches


def _bench_subprocess(module: str, where: str) -> dict:
    """`python -m <module> --tiny` on the card in a process of its own: rc
    0, and its last line parsed."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", module, "--tiny"], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{where}: rc {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    _finite_numbers(line, where)
    print(f"bench: {where} in {seconds:.1f} s: "
          f"{proc.stdout.strip().splitlines()[-1][:600]}", flush=True)
    return dict(line=line, seconds=seconds)


def run_bench(card: str, step_launches: dict) -> dict:
    """Phase 14: `rcdms_tpu_torch/bench.py` and `tools/profile_bench.py`
    on the card. (a) stage 2 at full width through `bench.run`, 20 steps:
    value 5 x batch / p50, each timed call 40 UNet calls' launches (A
    1200, B 1600 all tiled, C 1440, D 0); (b) `--full-pipeline`: each call
    one story's (`STORY_CALL`); (c) `--train-step` with bf16 and with fp32
    parameters: each step phase 9's forward launches (`step_launches`),
    the peak memory printed; (d) `--attn plain --steps 2`: no launch in
    the whole run (counts set to 0 before it, read after), and `--attn
    kernel` at (a)'s settings: each timed call (a)'s B, C and D launches
    and more A launches than (a)'s (the sites under 256 queries), its p50
    printed beside (a)'s; (e) `python -m rcdms_tpu_torch.bench --tiny` and
    `python -m rcdms_tpu_torch.tools.profile_bench --tiny` in processes of
    their own, each rc 0 with its JSON line parsed. Returns the lines and
    each mode's first timed call's launches (`bench_launches`)."""
    from rcdms_tpu_torch import ops

    t0 = time.perf_counter()
    reps = ["--repeats", str(BENCH_REPEATS)]
    result, first = dict(card=card), {}

    line, calls = _bench(["--steps", str(STEPS)] + reps, "(a) stage 2")
    _check_bench_line(line, "stage2_frames_per_sec_per_chip", "(a)")
    # one story of 5 frames a call, on one card
    if not math.isclose(line["value"], 5 / line["p50_story_latency_s"],
                        rel_tol=1e-3):
        raise AssertionError(f"(a): {line['value']} frames/s, p50 "
                             f"{line['p50_story_latency_s']} s")
    _check_calls(calls, _unet_launches(2 * STEPS), "(a) stage 2")
    result["stage2"], first["stage2"] = line, calls[0]

    line, calls = _bench(["--full-pipeline"] + reps, "(b) full pipeline")
    _check_bench_line(line, "two_stage_frames_per_sec_per_chip", "(b)")
    _check_calls(calls, STORY_CALL, "(b) full pipeline")
    result["full_pipeline"], first["full_pipeline"] = line, calls[0]

    want = {k: step_launches[k] for k in STORY_CALL}
    for dtype in ("bfloat16", "float32"):
        where = f"(c) train step, {dtype} parameters"
        line, calls = _bench(["--train-step", "--params-dtype", dtype]
                             + reps, where)
        _check_bench_line(line, "stage2_train_step_p50_s", where)
        _check_calls(calls, want, where)
        print(f"bench: {where}: {line['value']} s a step, peak "
              f"{line['peak_gb_in_use']} GiB", flush=True)
        result[f"train_{dtype}"], first[f"train_{dtype}"] = line, calls[0]

    ops.reset_launch_counts()
    line, _ = _bench(["--attn", "plain", "--steps", "2"] + reps,
                     "(d) --attn plain", per_call=False)
    whole = _story_counts()
    _check_bench_line(line, "stage2_frames_per_sec_per_chip", "(d)")
    if any(whole.values()) or line["attn"] != "plain":
        raise AssertionError(f"(d) --attn plain launched {whole}")
    result["plain"], first["plain"] = line, whole

    auto = _unet_launches(2 * STEPS)
    line, calls = _bench(["--attn", "kernel", "--steps", str(STEPS)] + reps,
                         "(d) --attn kernel")
    _check_bench_line(line, "stage2_frames_per_sec_per_chip", "(d)")
    _check_calls(calls, {k: v for k, v in auto.items()
                         if k != "attention"}, "(d) --attn kernel")
    if line["attn"] != "kernel" or any(
            c["attention"] <= auto["attention"] for c in calls):
        raise AssertionError(f"(d) --attn kernel: A launched "
                             f"{[c['attention'] for c in calls]}, auto "
                             f"{auto['attention']}")
    print(f"bench: (d) stage 2 p50 --attn kernel "
          f"{line['p50_story_latency_s']} s (A {calls[0]['attention']} a "
          f"call), auto {result['stage2']['p50_story_latency_s']} s "
          f"(A {auto['attention']})", flush=True)
    result["kernel"], first["kernel"] = line, calls[0]

    result["bench_tiny"] = _bench_subprocess("rcdms_tpu_torch.bench",
                                             "(e) bench --tiny")
    if result["bench_tiny"]["line"]["backend"] != "cuda":
        raise AssertionError("(e) bench --tiny did not run on the card")
    result["profile_tiny"] = _bench_subprocess(
        "rcdms_tpu_torch.tools.profile_bench", "(e) profile_bench --tiny")
    if result["profile_tiny"]["line"]["device"] != "cuda":
        raise AssertionError("(e) profile_bench --tiny saw no card")
    result["launches"] = first
    result["seconds"] = time.perf_counter() - t0
    print(f"bench: phase 14 took {result['seconds']:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_bench.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


# ---- phase 15: one story server over the ranks ------------------------------

SERVE_SHARD_DIR = os.path.join(REPO, "build", "chip_smoke_serve_shard")
SERVE_SHARD_RANKS = 2  # (b)'s gloo ranks on the one card: cfg 2
SERVE_SHARD_JOIN_S = 420  # seconds (b)'s ranks may take, builds included
# the servers' batching window: long enough that a batch's requests, sent
# SERVE_STAGGER_S apart, join it in the order they were sent
SERVE_SHARD_WAIT_MS = "2000"
SERVE_STAGGER_S = 0.5
# (b)'s third request: its own negative prompt (a CondCache miss: the
# towers split over the ranks) and phase 7a's known frame
SERVE_SHARD_NEGATIVE = "blurry"


def _serve_batches(url: str, batches: list) -> list:
    """Each batch of bodies sent in turn, its requests SERVE_STAGGER_S
    apart (one batch, in that order, on a server of SERVE_SHARD_WAIT_MS):
    the replies of each batch, frames decoded, each batch size checked."""
    import base64

    import numpy as np

    from rcdms_tpu_torch.sample.eval import decode_png

    out = []
    for bodies in batches:
        replies = serve_requests(url, bodies, SERVE_STAGGER_S)
        for r in replies:
            r["frames"] = np.stack([decode_png(base64.b64decode(x))
                                    for x in r["frames"]])
            if r["status"] != 200 or r["frames"].shape != (
                    len(ENTRY_CAPTIONS), PIXELS, PIXELS, 3):
                raise AssertionError(f"a serve reply is off: status "
                                     f"{r['status']}, {r['frames'].shape}")
            if r["batch_size"] != len(bodies):
                raise AssertionError(f"a batch of {len(bodies)} ran as "
                                     f"{r['batch_size']}")
        out.append(replies)
    return out


def serve_shard_batches(served: dict) -> list:
    """(b)'s batches of bodies: phase 8's pair as it ran (its first two
    requests if it formed none), then its other request with phase 7a's
    known frame and SERVE_SHARD_NEGATIVE."""
    bodies = served["bodies"]
    pair = next((b for b in served["batches"] if len(b) == 2),
                sorted(bodies)[:2])
    other = next(seed for seed in sorted(bodies) if seed not in pair)
    third = dict(bodies[other], negative_prompt=SERVE_SHARD_NEGATIVE)
    if "reference_frames" not in third:
        third["reference_frames"] = bodies[2]["reference_frames"]
    return [[bodies[s] for s in pair], [third]]


def serve_one_rank(card: str, served: dict, batches_b: list) -> dict:
    """Phase 15 (a): `cli.serve --shard-story` in this process under a
    one-rank NCCL group joined from torchrun's variables, built as phase 8
    built its server: phase 8's batches replayed as they ran, each reply
    and the launches equal phase 8's bit for bit; then (b)'s batches that
    phase 8 did not run, the one-process frames (b) is held against."""
    import threading

    import numpy as np
    import torch.distributed as dist

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import serve
    from rcdms_tpu_torch.ops import quant
    from rcdms_tpu_torch.train import distributed

    env = _torchrun_env()
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    ready, box = threading.Event(), []
    thread = None
    try:
        args = _serve_args("--shard-story", "--max-wait-ms",
                           SERVE_SHARD_WAIT_MS)
        t0 = time.perf_counter()
        # as phase 8: built (and warmed) in the int8 mode, served exact
        quant.set_quant_mode(_serve_args("--quantize", "int8").eval.quantize)
        thread = threading.Thread(target=serve.serve, args=(args,),
                                  kwargs=dict(ready_event=ready,
                                              httpd_box=box), daemon=True)
        thread.start()
        try:
            while not ready.wait(timeout=1):
                if not thread.is_alive() or time.perf_counter() - t0 > 900:
                    raise AssertionError("the one-rank server did not "
                                         "start")
        finally:
            quant.set_quant_mode(None)
        httpd, srv = box.pop()
        built_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        row = dict(backend=dist.get_backend(), world=dist.get_world_size(),
                   server_world=srv.world, built_s=built_s)
        bodies = served["bodies"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        replayed = _serve_batches(url, [[bodies[s] for s in batch]
                                        for batch in served["batches"]])
        torch.cuda.synchronize()
        row["replay_s"] = time.perf_counter() - t0
        row["launches"] = _story_counts()
        seeds = [s for batch in served["batches"] for s in batch]
        replies = [r for batch in replayed for r in batch]
        row["frames_equal"] = {s: bool(np.array_equal(
            r["frames"], served["frames"][s])) for s, r in zip(seeds,
                                                             replies)}
        row["launches_equal"] = row["launches"] == served["launches"]
        # (b)'s batches: phase 8's as replayed, the others run here
        ran = [[bodies[s] for s in batch] for batch in served["batches"]]
        refs = [replayed[ran.index(batch)] if batch in ran
                else _serve_batches(url, [batch])[0] for batch in batches_b]
        row["reference_latency_s"] = [r["latency_s"] for b in refs for r in b]
        httpd.shutdown()
        srv.stop()
        srv.worker.join(timeout=60)
        thread.join(timeout=60)
        del srv, httpd
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"serve shard one rank: {card}: cli.serve --shard-story under a "
          f"one-rank {row['backend']} group (server world "
          f"{row['server_world']}): built, warmed and listening in "
          f"{row['built_s']:.2f} s; phase 8's batches {served['batches']} "
          f"replayed in {row['replay_s']:.3f} s; replies equal phase 8's "
          f"bit for bit {row['frames_equal']}, launches "
          f"{row['launches_equal']} ({row['launches']})", flush=True)
    if not (all(row["frames_equal"].values()) and row["launches_equal"]):
        raise AssertionError(f"--shard-story on one rank serves other "
                             f"frames or launches than phase 8: phase 8 "
                             f"launched {served['launches']}")
    return dict(row, refs=refs)


def _serve_shard_rank(rank: int, store: str, root: str) -> None:
    """Rank `rank` of phase 15 (b) (a spawned process): joins the gloo
    group of SERVE_SHARD_RANKS ranks on the one card and runs `cli.serve
    --shard-story`, rank 0 on port 0 (written to `root`/port once it
    listens), until rank 0's stop; writes its launches after the warmup,
    its build and warmup seconds and its peak memory."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import threading

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import serve
    from rcdms_tpu_torch.train import distributed

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    distributed.maybe_initialize("cuda", init_method=f"file://{store}",
                                 world_size=SERVE_SHARD_RANKS, rank=rank,
                                 local_rank=0, backend="gloo")
    row = {}
    warmup = serve.StoryServer.warmup

    def counted_warmup(self):
        """The warmup, timed; the counts and the peak start after it."""
        torch.cuda.synchronize()
        row["build_s"] = time.perf_counter() - t0
        row["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        warmup(self)
        torch.cuda.synchronize()
        row["warmup_s"] = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()

    serve.StoryServer.warmup = counted_warmup
    ready, box = threading.Event(), []

    def report():
        if ready.wait(SERVE_SHARD_JOIN_S):
            with open(os.path.join(root, "port.tmp"), "w") as fh:
                fh.write(str(box[0][0].server_address[1]))
            os.replace(os.path.join(root, "port.tmp"),
                       os.path.join(root, "port"))

    if rank == 0:
        threading.Thread(target=report, daemon=True).start()
    try:
        t0 = time.perf_counter()
        srv = serve.serve(_serve_args("--shard-story", "--max-wait-ms",
                                      SERVE_SHARD_WAIT_MS),
                          ready_event=ready, httpd_box=box)
        torch.cuda.synchronize()
        row.update(rank=srv.rank, world=srv.world,
                   mesh=list(srv.pipeline.mesh[:6]),
                   launches=_story_counts(),
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   lru=len(srv._cond_caches))
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(row, fh)
    finally:
        distributed.shutdown()


def serve_shard_ranks(card: str, batches_b: list, refs: list) -> dict:
    """Phase 15 (b): SERVE_SHARD_RANKS spawned processes on the one card
    in a gloo group (cfg 2; NCCL refuses two ranks on one device) serve
    (b)'s batches from rank 0; each request's frames against (a)'s one
    process (SHARD_MEAN_TOL, SHARD_MAX_TOL), every rank launching each of
    A-D, every B launch tiled, both ranks ending rc 0 after SIGINT to rank
    0 (its stop)."""
    import shutil
    import signal

    import numpy as np
    import torch.multiprocessing as mp

    shutil.rmtree(SERVE_SHARD_DIR, ignore_errors=True)
    os.makedirs(SERVE_SHARD_DIR)
    # the ranks build at once: each holds SHARD_BUILDING_BYTES at its
    # build's peak (a tower's fp32 weights beside the others' bf16 ones)
    need = SERVE_SHARD_RANKS * SHARD_BUILDING_BYTES
    cycles = _collect_cycles()
    parent_bytes = torch.cuda.memory_allocated()
    free_bytes = torch.cuda.mem_get_info()[0]
    print(f"serve shard: the card has {free_bytes / 2**30:.2f} GiB free for "
          f"{SERVE_SHARD_RANKS} ranks needing about {need / 2**30:.2f} (this "
          f"process holds {parent_bytes / 2**30:.2f} GiB; the collector "
          f"freed {cycles / 2**30:.2f} GiB left in reference cycles)",
          flush=True)
    if free_bytes < need:
        raise AssertionError(
            f"phase 15 (b): {free_bytes / 2**30:.2f} GiB of the card free, "
            f"under the {need / 2**30:.2f} GiB its ranks need: an earlier "
            f"phase still holds {parent_bytes / 2**30:.2f} GiB")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_serve_shard_rank,
                         args=(r, os.path.join(SERVE_SHARD_DIR, "store"),
                               SERVE_SHARD_DIR))
             for r in range(SERVE_SHARD_RANKS)]
    port = os.path.join(SERVE_SHARD_DIR, "port")
    try:
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        while not os.path.exists(port):
            if time.perf_counter() - t0 > SERVE_SHARD_JOIN_S or not all(
                    p.is_alive() for p in procs):
                raise AssertionError(
                    f"phase 15 (b): rank 0 did not serve (exit codes "
                    f"{[p.exitcode for p in procs]})")
            time.sleep(0.1)
        listening_s = time.perf_counter() - t0
        with open(port) as fh:
            url = f"http://127.0.0.1:{fh.read()}"
        t1 = time.perf_counter()
        replied = _serve_batches(url, batches_b)
        http_s = time.perf_counter() - t1
        os.kill(procs[0].pid, signal.SIGINT)  # the server's stop
        for p in procs:
            p.join(SERVE_SHARD_JOIN_S)
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * SERVE_SHARD_RANKS:
            raise AssertionError(f"phase 15 (b) rank exit codes {codes} "
                                 f"(None: still running after "
                                 f"{SERVE_SHARD_JOIN_S} s)")
        ranks = []
        for r in range(SERVE_SHARD_RANKS):
            with open(os.path.join(SERVE_SHARD_DIR, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(SERVE_SHARD_DIR, ignore_errors=True)
    requests = []
    for batch, ref in zip(replied, refs):
        for got, want in zip(batch, ref):
            diff = np.abs(got["frames"].astype(np.float64)
                          - want["frames"].astype(np.float64)) / 255.0
            requests.append(dict(
                batch_size=got["batch_size"], latency_s=got["latency_s"],
                one_process_latency_s=want["latency_s"],
                frames_mean_abs=float(diff.mean()),
                frames_max_abs=float(diff.max())))
    row = dict(card=card, world=SERVE_SHARD_RANKS, mesh=ranks[0]["mesh"][:3],
               wall_s=wall, listening_s=listening_s, http_s=http_s,
               requests=requests, parent_bytes=parent_bytes,
               free_bytes=free_bytes,
               ranks=[{k: x[k] for k in ("rank", "mesh", "launches",
                                         "build_s", "warmup_s",
                                         "build_peak_bytes", "peak_bytes",
                                         "lru")} for x in ranks])
    means = [f"{x['frames_mean_abs']:.3e}" for x in requests]
    maxes = [f"{x['frames_max_abs']:.3e}" for x in requests]
    print(f"serve shard (b): {card}: cli.serve --shard-story on "
          f"{SERVE_SHARD_RANKS} gloo ranks (mesh cfg, frame, space "
          f"{row['mesh']}) listening after {listening_s:.1f} s (spawn, "
          f"builds and warmup), {len(requests)} requests in "
          f"{http_s:.1f} s, both ranks rc 0 after the stop, {wall:.1f} s in "
          f"all; per request: batch size "
          f"{[x['batch_size'] for x in requests]}, latency s "
          f"{[x['latency_s'] for x in requests]} (one process "
          f"{[x['one_process_latency_s'] for x in requests]}), frames mean "
          f"|diff| {means}, max |diff| {maxes}; per rank: build s "
          f"{[round(x['build_s'], 1) for x in ranks]}, warmup s "
          f"{[round(x['warmup_s'], 1) for x in ranks]}, peak GiB serving "
          f"{[round(x['peak_bytes'] / 2**30, 2) for x in ranks]}, build "
          f"{[round(x['build_peak_bytes'] / 2**30, 2) for x in ranks]}, "
          f"CondCaches {[x['lru'] for x in ranks]}; launches "
          f"{[x['launches'] for x in ranks]}", flush=True)
    for x in ranks:
        _check_story_launches(x["launches"],
                              f"on serve shard rank {x['rank']}")
    for x in requests:
        if not (x["frames_mean_abs"] <= SHARD_MEAN_TOL
                and x["frames_max_abs"] <= SHARD_MAX_TOL):
            raise AssertionError(f"a sharded served request differs from "
                                 f"one process: {x}")
    return row


def run_serve_shard(card: str, served: dict) -> dict:
    """Phase 15: one story server over the ranks (module docstring)."""
    print(f"serve shard on {card}", flush=True)
    t0 = time.perf_counter()
    batches_b = serve_shard_batches(served)
    one = serve_one_rank(card, served, batches_b)
    refs = one.pop("refs")
    result = dict(card=card, one_rank=one,
                  ranks=serve_shard_ranks(card, batches_b, refs))
    result["seconds"] = time.perf_counter() - t0
    print(f"serve shard: phase 15 took {result['seconds']:.1f} s",
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_serve_shard.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rcdms_tpu_torch.ops import _build
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.tools import card_line

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
    if sys.argv[1:] == ["--shard-faults"]:
        result = shard_faults(dev, card)
        print(json.dumps({"shard_faults": [
            {k: r[k] for k in ("run", "fault", "frames_mean_abs",
                               "frames_max_abs", "embeds_rel")}
            for r in result["runs"]], "shard_prior": [
            {k: r[k] for k in ("dtype", "world", "frame", "embeds_rel")}
            for r in result["prior"]]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--int8-faults"]:
        rows = int8_faults(dev, card)
        print(json.dumps({"int8_faults": [
            {k: r[k] for k in ("fault", "ssim_min", "latent_rel_rms")}
            for r in rows]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    summary = check_kernels(dev, card)
    check_tiny_reference(dev)
    _after_phase("phases 3-4")
    story = run_story(full_configs(temporal_zero_init=False), dev,
                      torch.bfloat16, STEPS, PIXELS)
    print(f"story: {card}: per-request seconds "
          f"{[round(s, 3) for s in story['seconds']]} at {STEPS} steps",
          flush=True)
    _after_phase("phase 5")
    launches = {**story["counts"], **run_studies(dev, card)}
    _after_phase("phase 6")
    entry = run_entry_points(dev, card)
    _after_phase("phase 7")
    served = run_serve(dev, card, entry)
    print(f"serve: {card}: seconds a story at batch 1 "
          f"{served['batch1_s']:.3f}, at batch 2 {served['batch2_s']:.3f}",
          flush=True)
    _after_phase("phase 8")
    trained = run_train(dev, card)
    _after_phase("phase 9")
    step2 = trained["full"]["stage2"]
    step_launches = {k: v + step2["encode_launches"][k]
                     for k, v in step2["steps"][0]["launches"].items()}
    phase10 = {}
    train_cli = run_train_cli(dev, card, step_launches, phase10)
    _after_phase("phase 10")
    cli_launches = {"stage2": train_cli["stage2"]["run"]["launches"],
                    "stage2_resumed": train_cli["stage2"]["resumed"][
                        "launches"],
                    "stage1": train_cli["stage1"]["launches"]}
    for name in cli_launches["stage2"]:
        if sum(c[name] for c in cli_launches.values()) == 0:
            raise AssertionError(f"the training CLIs never launched {name}")
    dp = run_dp(dev, card, phase10)
    del phase10
    _after_phase("phase 11")
    dp_launches = {"stage2_one_rank": dp["one_rank"]["launches"],
                   **{f"stage1_rank{r}": x["zero2"]["launches"]
                      for r, x in enumerate(dp["two_ranks"]["ranks"])}}
    for name in dp_launches["stage2_one_rank"]:
        if sum(c[name] for c in dp_launches.values()) == 0:
            raise AssertionError(f"data-parallel training never launched "
                                 f"{name}")
    shard = run_shard(card, entry, story["request1"])
    shard_launches = {"one_rank": shard["one_rank"]["launches"],
                      **{f"{'' if run == 'b' else run + '_'}rank{r}":
                         x["launches"] for run in SHARD_RUNS
                         for r, x in enumerate(shard[run]["ranks"])}}
    quality = run_quality(dev, card)
    quality_launches = {**{name: run["launches"] for name, run in
                           quality["int8"]["runs"].items()},
                        "inversion": quality["inversion"]["launches"]}
    _after_phase("phase 13")
    bench_launches = run_bench(card, step2["steps"][0]["launches"])[
        "launches"]
    _after_phase("phase 14")
    serve_shard = run_serve_shard(card, served)
    serve_shard_launches = {
        "one_rank": serve_shard["one_rank"]["launches"],
        **{f"rank{x['rank']}": x["launches"]
           for x in serve_shard["ranks"]["ranks"]}}

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"], shape=s["shape"]))
        if name in served["launches"]:
            kernels[-1]["serve_launches"] = served["launches"][name]
            kernels[-1]["train_launches"] = {
                stage: r["steps"][0]["launches"][name]
                for stage, r in trained["full"].items()}
            kernels[-1]["train_cli_launches"] = {
                run: counts[name] for run, counts in cli_launches.items()}
            kernels[-1]["dp_launches"] = {
                run: counts[name] for run, counts in dp_launches.items()}
            kernels[-1]["shard_launches"] = {
                run: counts[name] for run, counts in shard_launches.items()}
            kernels[-1]["quality_launches"] = {
                run: counts[name] for run, counts in
                quality_launches.items()}
            kernels[-1]["bench_launches"] = {
                mode: counts[name] for mode, counts in
                bench_launches.items()}
            kernels[-1]["serve_shard_launches"] = {
                run: counts[name] for run, counts in
                serve_shard_launches.items()}
        if name == "frame_attention":
            kernels[-1]["tiled_launches"] = launches["frame_attention_tiled"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
