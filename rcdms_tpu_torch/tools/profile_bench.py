"""Where one call of the bench's main path spends the card's time: the
port's counterpart of `tools/profile_bench.py`.

    python -m rcdms_tpu_torch.tools.profile_bench [--tiny] [--attn auto]
        [--steps 20] [--top 30] [--full-pipeline | --prior] [--device cuda]

Builds through `rcdms_tpu_torch/bench.py`'s builders (stage 2 by default;
`--full-pipeline` the two-stage story without a CondCache, as the JAX
tool; `--prior` the stage-1 `PriorSampler` alone on
`tools/prior_floor_study.py`'s build: zero weights, bf16, seeded
conditioning), makes two warm calls, then profiles one call under
`torch.profiler`. Prints the card's name and power limit, the top `--top`
kernels by device time with their kernel group (`tools.KERNEL_GROUPS`: A,
B, C/D, cuDNN, other), each group's seconds and share, the device total,
the wall seconds of the profiled call and the device's idle share
(1 - device busy / wall), and last one JSON line of the same.

On the CPU (`--device cpu`, a smoke run) there is no device: the table
holds the CPU's own operators by self time instead, and the JSON says
`"device": "cpu"`.
"""

from __future__ import annotations

import argparse
import json

import torch

from rcdms_tpu_torch import bench, ops
from rcdms_tpu_torch.cli.common import device_of
from rcdms_tpu_torch.tools import group_profile, profile_call


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--attn", default="auto", choices=list(ops.impl.IMPLS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--full-pipeline", action="store_true")
    ap.add_argument("--prior", action="store_true",
                    help="profile the stage-1 PriorSampler alone (the "
                         "build of tools/prior_floor_study.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda never falls back to the CPU")
    return ap.parse_args(argv)


def build_call(args, device: torch.device):
    """A zero-argument call of the profiled path on `device`."""
    if args.prior:
        from rcdms_tpu_torch.configs import PriorConfig
        from rcdms_tpu_torch.sample.prior_sampler import PriorSampler
        from rcdms_tpu_torch.tools.prior_floor_study import (
            conditioning,
            zero_prior,
        )

        cfg = PriorConfig.tiny() if args.tiny else PriorConfig()
        sampler = PriorSampler(zero_prior(cfg, device, torch.bfloat16),
                               num_steps=args.steps, guidance_scale=2.0)
        cond = conditioning(cfg, device, torch.bfloat16)
        return lambda: sampler(
            cond, generator=torch.Generator(device).manual_seed(0))
    flags = bench.parse_args((["--tiny"] if args.tiny else [])
                             + ["--steps", str(args.steps)])
    if args.full_pipeline:
        rig = bench.build_full_pipeline(flags, device, args.steps,
                                        cond_cache=False)
        return lambda: rig.pipeline.generate(
            rig.inputs, generator=torch.Generator(device).manual_seed(0))
    rig = bench.build_stage2(flags, device)
    return lambda: rig.sampler(
        rig.cond, generator=torch.Generator(device).manual_seed(0))


def run(argv=None) -> dict:
    """Builds, warms, profiles one call and prints the table; returns the
    summary (the attention impl is restored on return)."""
    args = parse_args(argv)
    if args.prior and args.full_pipeline:
        raise ValueError("--prior and --full-pipeline profile different "
                         "paths; pass one")
    device = device_of(args)
    before = ops.attention_impl()
    ops.set_attention_impl(args.attn)
    try:
        if device.type == "cuda":
            from rcdms_tpu_torch.ops import _build
            from rcdms_tpu_torch.tools import card_line

            print(card_line(), flush=True)
            _build.library()
        call = build_call(args, device)
        for _ in range(2):  # warm
            call()
        bench.sync(device)
        result = group_profile(profile_call(call, device), args.top, device)
    finally:
        ops.set_attention_impl(before)
    unit = "ms" if device.type == "cuda" else "ms (CPU self)"
    print(f"{'kernel':60s} {'group':6s} {unit:>14s} {'%':>6s}")
    for row in result["top"]:
        print(f"{row['name'][:60]:60s} {row['group']:6s} "
              f"{row['s'] * 1e3:14.3f} "
              f"{100 * row['s'] / result['device_s']:6.1f}")
    for g, v in result["groups"].items():
        print(f"group {g:54s} {'':6s} {v['s'] * 1e3:14.3f} "
              f"{100 * v['share']:6.1f}")
    print(f"{'TOTAL(device)':60s} {'':6s} {result['device_s'] * 1e3:14.3f}")
    print(f"wall {result['wall_s']:.4f} s, device idle "
          f"{result['idle_share']:.1%}", flush=True)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
