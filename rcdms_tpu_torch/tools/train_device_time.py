"""Where a full-width training step's time goes on the card: for each
stage, `chip_smoke.py` phase 9's build and batch (b = 1, 5 frames, 512 px,
bf16 over fp32 masters, AdamW), two warm steps, three timed steps, then
one step under `torch.profiler`: its device time summed by kernel group
(`tools.KERNEL_GROUPS`, with the optimizer's multi-tensor kernels
apart), the 12 longest kernels, and the share of the step's wall time in
which the card ran no kernel. Prints the card's name and power limit,
then one JSON line a stage.

    cd <checkout> && python3 -m rcdms_tpu_torch.tools.train_device_time
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from rcdms_tpu_torch.tools import kernel_group, profile_call


def _group(name: str) -> str:
    return ("optimizer" if "multi_tensor_apply" in name
            else kernel_group(name))


def profile_step(state, batch, noise) -> dict:
    """One step under torch.profiler: wall seconds, device seconds by
    group, the longest kernels."""
    from rcdms_tpu_torch.train import loop

    torch.cuda.synchronize()
    profiled = profile_call(lambda: loop.train_step(state, batch, noise),
                            torch.device("cuda"))
    by_name, wall = profiled["by_name"], profiled["wall_s"]
    device = sum(by_name.values())
    if device <= 0:
        raise SystemExit("train_device_time: the profiler saw no device "
                         "time")
    groups = {}
    for name, sec in by_name.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_s=wall, device_s=device, idle_share=1 - device / wall,
                groups=groups, top=[(n[:120], s) for n, s in top])


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from rcdms_tpu_torch.configs import OptimizerConfig
    from rcdms_tpu_torch.ops import _build
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.tools import card_line
    from rcdms_tpu_torch.train import loop, stage1, stage2

    if not torch.cuda.is_available():
        raise SystemExit("train_device_time: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    _build.library()
    configs = full_configs(temporal_zero_init=False)
    for stage, mod, clip in ((2, stage2, 1.0), (1, stage1, 10.0)):
        state, towers = mod.build_trainer(
            configs, OptimizerConfig(learning_rate=1e-5, warmup_steps=0,
                                     grad_clip_norm=clip),
            torch.bfloat16, seed=stage, device=dev)
        raw = chip_smoke.tiny_raw_batch(configs, dev, 30 + stage,
                                        chip_smoke.PIXELS)
        extra = ({"generator": torch.Generator(dev).manual_seed(5)}
                 if stage == 2 else {})
        batch = mod.encode_batch(*towers, raw, **extra)
        g = torch.Generator(dev).manual_seed(6)
        seconds = []
        for i in range(5):
            noise = state.module.draw_noise(batch, g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.train_step(state, batch, noise)
            torch.cuda.synchronize()
            if i >= 2:
                seconds.append(time.perf_counter() - t0)
        result = profile_step(state, batch, state.module.draw_noise(batch, g))
        print(json.dumps(dict(stage=stage, step_s=seconds,
                              median_step_s=statistics.median(seconds),
                              profiled=result)), flush=True)
        del state, towers, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
