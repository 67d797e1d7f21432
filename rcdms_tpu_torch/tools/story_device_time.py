"""The story's device time a request on the card: phase 5 of
`chip_smoke.py` alone (the kernel build, the full-width story twice plus
a repeat, one request under `torch.profiler`), for the checkout whose root
is the working directory. Prints the card's name and power limit, then one
JSON line: per-request seconds, device seconds a request and each kernel
group's.

    cd <checkout> && python3 -m rcdms_tpu_torch.tools.story_device_time

To time two commits on one card, run it in each checkout in turns; a
checkout without this file runs it by path:
`python3 -c "import runpy, sys; sys.path.insert(0, '.');
runpy.run_path('<other>/rcdms_tpu_torch/tools/story_device_time.py',
run_name='__main__')"`.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from rcdms_tpu_torch.ops import _build
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.tools import card_line

    if not torch.cuda.is_available():
        raise SystemExit("story_device_time: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    _build.library()
    story = chip_smoke.run_story(full_configs(temporal_zero_init=False),
                                 torch.device("cuda"), torch.bfloat16,
                                 chip_smoke.STEPS, chip_smoke.PIXELS)
    profile = story["profile"]
    print(json.dumps(dict(
        checkout=os.path.basename(os.getcwd()), seconds=story["seconds"],
        device_s=profile["device_s"],
        groups={g: v["s"] for g, v in profile["groups"].items()})))


if __name__ == "__main__":
    main()
