"""The collectives of the port's sharded paths, rank by rank: the port of
`tools/comm_audit.py`.

The JAX tool compiles the sharded programs over an 8-device CPU mesh and
reads GSPMD's collectives out of the HLO. The port issues its collectives
itself (`core/spatial.py`, `train/sharding.py`, `train/distributed.py`),
so it counts them: each goes through `core.spatial.collective`, and
`core.spatial.recording` keeps its site, kind, dtype, the bytes this rank
puts in, its group's size and whether a sampler's step loop issued it.

An audit is a dry run: rank r of a world of N that does not exist, on
`torch.device("meta")`, with the recorder standing in for every
collective (`recording(layout=(r, N))`, in which `train/sharding.py::
inference_mesh` reads that layout and makes no process group). The path
runs at full width on shapes alone, no weights made and no process group
joined, as the JAX tool compiles on abstract parameters. On meta the
story ops take their plain route (`ops/impl.py` "plain"): the
collectives sit in the layers around the ops, not in them, and a real
rank's record on the card (`chip_smoke.py` phase 12 (b), through the
kernels) equals the dry one.

Modes, as the JAX tool's:
  default   the stage-2 sampler (bf16 UNet and fusion stacks at full
            width, b 1, 5 frames, 512 px, 91 tokens, seeded conditioning
            as `rcdms_tpu_torch/bench.py` builds it) for each variant of
            `--variants` over 8 ranks: space4 (cfg 2, space 4), frame4
            (cfg 2, frame 4: 5 frames as blocks 2 / 2 / 1 / 0) and f2s2
            (cfg 2, frame 2, space 2)
  --full    `StoryPipeline.generate` (both text towers, the vision tower,
            the prior, the UNet and the VAE; bf16, 512 px) with a warm
            CondCache (`--no-cond-cache`: without one, as the JAX tool's
            program)
  --train   one stage-2 training step on 8 ranks (fp32 masters, AdamW,
            global batch 8) for each of `--grad-variants`: replicated
            (`--no-zero2`: the gradients all-reduced, every rank
            stepping every tensor) and zero2 (the gradients all-reduced,
            each rank stepping its cut, the masters all-gathered); and
            the logged loss's mean over the ranks

The sampler and the pipeline run `--steps` (2) steps; each collective of
a step loop counts `--model-steps` / `--steps` times, so the totals are a
`--model-steps` (20) story's. Per rank and per kind it prints the count,
the bytes and the in-loop count times the steps, and per site the count
and bytes; then `pad_waste`, the frames a rank of the frame axis computes
over its share (`core.spatial.blocks`, the JAX `frame_pad_waste`). It
models no latency: the machine has one card, and link figures of cards
it lacks would be guesses.

    python -m rcdms_tpu_torch.tools.comm_audit [--variants space4,f2s2]
    python -m rcdms_tpu_torch.tools.comm_audit --full [--no-cond-cache]
    python -m rcdms_tpu_torch.tools.comm_audit --train
    (--tiny: the tiny models, for a quick run; --out FILE: the JSON)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Dict, List, Optional

import torch

from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.spatial import Collective
from rcdms_tpu_torch.ops import impl
from rcdms_tpu_torch.train import sharding

META = torch.device("meta")
WORLD = 8
VARIANTS = {
    "space4": dict(cfg=2, frame=1),
    "frame4": dict(cfg=2, frame=4),
    "f2s2": dict(cfg=2, frame=2),
}
GRAD_VARIANTS = ("replicated", "zero2")
FRAMES = 5


def pad_waste(frame_axis: int, f: int = FRAMES) -> float:
    """The frames a rank of a frame axis of `frame_axis` computes (its
    largest block, `spatial.blocks`) over its share, f / frame_axis."""
    most = max(n for _, n in spatial.blocks(f, max(1, frame_axis)))
    return most * max(1, frame_axis) / f


def _scaled(total: int, steps: int, model_steps: int, what: str) -> int:
    if total % steps:
        raise ValueError(f"{what}: {total} over {steps} steps is no whole "
                         f"number a step: the steps issued other "
                         f"collectives")
    return total // steps * model_steps


def summarize(record: List[Collective], steps: int = 1,
              model_steps: Optional[int] = None, key: str = "kind"
              ) -> Dict[str, dict]:
    """By kind (or by `key`, "site"): `count` and `bytes` of the record,
    the in-loop ones scaled from `steps` steps to `model_steps`, and
    `in_loop`, the scaled in-loop count."""
    model_steps = steps if model_steps is None else model_steps
    raw: Dict[str, List[int]] = {}
    for c in record:
        agg = raw.setdefault(getattr(c, key), [0, 0, 0, 0])
        at = 2 if c.in_loop else 0
        agg[at] += 1
        agg[at + 1] += c.nbytes
    out = {}
    for name in sorted(raw):
        n, b, n_loop, b_loop = raw[name]
        loop = _scaled(n_loop, steps, model_steps, f"{name} count")
        out[name] = dict(
            count=n + loop,
            bytes=b + _scaled(b_loop, steps, model_steps, f"{name} bytes"),
            in_loop=loop)
    return out


@contextlib.contextmanager
def dry_run(rank: int, world: int):
    """A dry `recording` as rank `rank` of `world`, the story ops on their
    plain route (meta tensors take no kernel), no gradients; yields the
    record."""
    before = impl.attention_impl()
    impl.set_attention_impl("plain")
    try:
        with spatial.recording(layout=(rank, world)) as record:
            yield record
    finally:
        impl.set_attention_impl(before)


# ---- the stage-2 sampler ----------------------------------------------------

def build_stage2(steps: int, tiny: bool = False):
    """`rcdms_tpu_torch/bench.py`'s stage 2 on meta: (sampler, cond)."""
    from rcdms_tpu_torch import bench

    args = bench.parse_args(["--steps", str(steps)]
                            + (["--tiny"] if tiny else []))
    built = bench.build_stage2(args, META)
    return built.sampler, built.cond


@torch.no_grad()
def audit_sampler(stage2, world: int, frame: int, rank: int
                  ) -> List[Collective]:
    """Rank `rank`'s record of one stage-2 sampler call on the mesh of
    `world` ranks at 'frame' axis `frame` (a dry run)."""
    sampler, cond = stage2
    with dry_run(rank, world) as record:
        mesh = sharding.inference_mesh(frame)
        dataclasses.replace(sampler, mesh=mesh)(
            cond, generator=torch.Generator().manual_seed(0))
    return record


# ---- the full pipeline ------------------------------------------------------

def story_inputs(configs, pixels: int, device, b: int = 1):
    """A story's inputs at their shapes and dtypes (frame 0 known), and
    the CondCache's (`precompute_cond_cache`'s arguments): zeros, for a
    dry run only."""
    from rcdms_tpu_torch.sample.pipeline import StoryInputs

    f, t = configs.prior.num_frames, configs.prior.num_text_tokens
    c = configs.vision.image_size
    ids = torch.zeros(b, f, t, dtype=torch.int64, device=device)
    clip = torch.zeros(b, f, c, c, 3, device=device)
    known = torch.zeros(b, f, dtype=torch.bool, device=device)
    inputs = StoryInputs(
        tokens_s1=ids, tokens_s1_u=ids, tokens_s2=ids, tokens_s2_u=ids,
        source_clip=clip, mask_clip=clip,
        source_pixels=torch.zeros(b, f, pixels, pixels, 3, device=device),
        frame_known=known)
    white = torch.zeros(c, c, 3, device=device)
    return inputs, (ids[0, 0], ids[0, 0], white, white)


def build_pipeline(steps: int, tiny: bool = False):
    """The full-width pipeline (`full_configs(temporal_zero_init=False)`,
    bf16) or the tiny one (fp32) on meta: (pipeline, pixels)."""
    from rcdms_tpu_torch.sample.pipeline import (
        StoryPipeline,
        for_inference,
        full_configs,
        tiny_configs,
    )

    configs = tiny_configs() if tiny else full_configs(
        temporal_zero_init=False)
    with META:
        pipe = StoryPipeline(configs, num_steps=steps)
    return (for_inference(pipe, torch.float32 if tiny else torch.bfloat16),
            32 if tiny else 512)


@torch.no_grad()
def audit_full(built, world: int, frame: int, rank: int,
               cond_cache: bool = True) -> List[Collective]:
    """Rank `rank`'s record of one `generate` (with a CondCache unless
    `cond_cache` is False) on the mesh of `world` ranks (a dry run)."""
    from rcdms_tpu_torch.sample.pipeline import StoryPipeline

    pipe, pixels = built
    inputs, cache_args = story_inputs(pipe.configs, pixels, META)
    with dry_run(rank, world) as record:
        # whole on every rank: no collective
        cache = (pipe.precompute_cond_cache(*cache_args) if cond_cache
                 else None)
        # `pipe`'s towers, split over the mesh
        meshed = StoryPipeline(
            pipe.configs, num_steps=pipe.story_sampler.num_steps,
            towers=dict(pipe.named_children()),
            mesh=sharding.inference_mesh(frame))
        meshed.generate(inputs, cache,
                        generator=torch.Generator().manual_seed(0))
    return record


# ---- the training step ------------------------------------------------------

def build_train(device, zero2: bool, tiny: bool = False):
    """`rcdms_tpu_torch/bench.py`'s stage-2 train rig (fp32 masters, AdamW
    lr 1e-5, clip 1.0, bf16 compute, b 1 a rank) on `device`, its
    optimizer cut by ZeRO-2 or not (under the process group, or the dry
    run's layout)."""
    from rcdms_tpu_torch import bench

    args = bench.parse_args(["--train-step", "--params-dtype", "float32"]
                            + (["--tiny"] if tiny else []))
    rig = bench.build_train(args, torch.device(device))
    state = rig.state
    state.optimizer.zero2 = zero2
    state.opt_state = state.optimizer.init(state.params)
    return rig


def train_step(rig) -> torch.Tensor:
    """One step of the rig and the loss's mean over the ranks, as a
    logged step of `cli/common.py::train_loop`."""
    from rcdms_tpu_torch.train import distributed
    from rcdms_tpu_torch.train.loop import train_step as step

    loss = step(rig.state, rig.batch,
                generator=torch.Generator().manual_seed(0))
    return distributed.mean_over_ranks(loss)


def audit_train(world: int, rank: int, zero2: bool, tiny: bool = False
                ) -> List[Collective]:
    """Rank `rank`'s record of one training step on `world` ranks (a dry
    run)."""
    with dry_run(rank, world) as record:
        train_step(build_train(META, zero2, tiny))
    return record


# ---- output -----------------------------------------------------------------

def rank_rows(records: List[List[Collective]], steps: int,
              model_steps: int) -> List[dict]:
    return [dict(rank=r, kinds=summarize(rec, steps, model_steps),
                 sites=summarize(rec, steps, model_steps, key="site"))
            for r, rec in enumerate(records)]


def print_ranks(label: str, ranks: List[dict]) -> None:
    print(f"== {label} ==", flush=True)
    for row in ranks:
        kinds = "; ".join(
            f"{k} {v['count']} ({v['bytes'] / 2**20:.2f} MiB, in loop "
            f"{v['in_loop']})" for k, v in row["kinds"].items())
        print(f"  rank {row['rank']}: {kinds}", flush=True)
        for site, v in row["sites"].items():
            print(f"      {site:18s} {v['count']:6d}  "
                  f"{v['bytes'] / 2**20:10.2f} MiB", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="audit one stage-2 training step on 8 ranks "
                         "instead of the inference sampler")
    ap.add_argument("--full", action="store_true",
                    help="audit the whole two-stage pipeline (towers, "
                         "prior, stage 2, VAE) instead of the stage-2 "
                         "sampler alone")
    ap.add_argument("--no-cond-cache", action="store_true",
                    help="(--full) without a CondCache: the towers also "
                         "encode the uncond captions and the mask images")
    ap.add_argument("--grad-variants", default="replicated,zero2",
                    help="(--train) replicated (--no-zero2: gradients "
                         "all-reduced, every tensor stepped on every rank) "
                         "and/or zero2 (each rank steps its cut, the "
                         "masters all-gathered). The JAX tool's 'none' "
                         "(GSPMD's propagation decides) has no "
                         "counterpart: the port's collectives are "
                         "explicit")
    ap.add_argument("--variants", default="space4,frame4,f2s2")
    ap.add_argument("--steps", type=int, default=2,
                    help="steps the audited samplers run (each step "
                         "issues the same collectives)")
    ap.add_argument("--model-steps", type=int, default=20,
                    help="steps the totals count (a story's)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny models (checks the machinery; the "
                         "bytes are not a full-width story's)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)

    results = {}
    if args.train:
        for variant in args.grad_variants.split(","):
            if variant not in GRAD_VARIANTS:
                raise SystemExit(f"--grad-variants: {variant!r}, not one "
                                 f"of {GRAD_VARIANTS}")
            ranks = rank_rows([audit_train(WORLD, r, variant == "zero2",
                                           args.tiny)
                               for r in range(WORLD)], 1, 1)
            print_ranks(f"train step [{variant}]: {WORLD} ranks, global "
                        f"batch {WORLD}, fp32 masters + AdamW", ranks)
            results[variant] = dict(world=WORLD, ranks=ranks)
        out = {"train_audit": results}
    else:
        built = (build_pipeline(args.steps, args.tiny) if args.full
                 else build_stage2(args.steps, args.tiny))
        for name in args.variants.split(","):
            spec = VARIANTS[name]
            shape = sharding.mesh_shape(WORLD, spec["frame"])
            records = [audit_full(built, WORLD, spec["frame"], r,
                                  not args.no_cond_cache) if args.full
                       else audit_sampler(built, WORLD, spec["frame"], r)
                       for r in range(WORLD)]
            ranks = rank_rows(records, args.steps, args.model_steps)
            waste = pad_waste(shape[1])
            print_ranks(f"{'full pipeline' if args.full else 'stage 2'} "
                        f"[{name}]: mesh (cfg, frame, space) {shape}, "
                        f"{args.model_steps} steps; pad_waste {waste:.2f}",
                        ranks)
            results[name] = dict(mesh=dict(zip(("cfg", "frame", "space"),
                                               shape)),
                                 pad_waste=waste, ranks=ranks)
        out = {"full_audit" if args.full else "audit": results}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps({k: {name: {"pad_waste": v.get("pad_waste"),
                                 "rank0": v["ranks"][0]["kinds"]}
                          for name, v in res.items()}
                      for k, res in out.items()}), flush=True)
    return out


if __name__ == "__main__":
    main()
