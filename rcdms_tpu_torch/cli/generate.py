"""Story generation CLI — the counterpart of `rcdms_tpu/cli/generate.py`:
captions (+ optional known reference frames) -> 5-frame story PNGs,
through the full two-stage pipeline.

    python -m rcdms_tpu_torch.cli.generate \
        --caption "pororo waves hello" --caption "pororo builds a snowman" \
        --caption "crong joins in" --caption "they laugh together" \
        --caption "the sun sets" \
        --reference frame0.png \
        --sd-pretrained ... --prior-pretrained ... --vision-pretrained ... \
        --out story.png

Known frames are given in order with --reference (0 to 4 of them; reading
the files needs Pillow). Every model and sampling flag (--synthetic,
--dtype, --device, --rcdms-stage{1,2}-ckpt, --seed, ...) is the evaluate
CLI's. The story's generator is seeded as the evaluate CLI seeds story 0.
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli.evaluate import build_pipeline
from rcdms_tpu_torch.cli.evaluate import parse_args as eval_parse_args
from rcdms_tpu_torch.sample.eval import save_story_grid


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--caption", action="append", required=True,
                   help="one per frame, in order (repeat 5x)")
    p.add_argument("--reference", action="append", default=[],
                   help="known frame image paths (prefix order)")
    p.add_argument("--negative-prompt", default="",
                   help="text for the unconditional CFG branch")
    p.add_argument("--out", default="story.png")
    args, rest = p.parse_known_args(argv)
    args.eval = eval_parse_args(rest)
    return args


def check_counts(eval_args, num_captions: int, num_references: int) -> int:
    """Raises SystemExit unless there is one caption a frame and at most one
    reference a frame; returns the number of frames."""
    f = 5 if eval_args.synthetic else \
        common.dataset_from_args(eval_args).num_frames
    if num_captions != f:
        raise SystemExit(f"need exactly {f} --caption flags, got "
                         f"{num_captions}")
    if num_references > f:
        raise SystemExit(f"at most {f} --reference frames")
    return f


def run(eval_args, captions: Sequence[str], frames: Sequence[np.ndarray],
        negative_prompt: str = ""):
    """Captions and known uint8 (h, w, 3) frames -> (frames (1, f, H, W, 3)
    fp32 in [0, 1], stage-1 embeds (1, f, d) fp32). The counts are checked
    before the pipeline is built."""
    check_counts(eval_args, len(captions), len(frames))
    pipeline, dataset, ds_cfg = build_pipeline(eval_args)
    inputs = common.build_story_inputs(captions, frames, negative_prompt,
                                       dataset, ds_cfg, pipeline.device)
    generator = torch.Generator(pipeline.device).manual_seed(
        common.story_seed(eval_args.seed, 0))
    return pipeline.generate(inputs, generator=generator)


def main(argv=None):
    args = parse_args(argv)
    ev = args.eval
    check_counts(ev, len(args.caption), len(args.reference))
    frames = []
    for path in args.reference:
        from PIL import Image

        frames.append(np.asarray(Image.open(path).convert("RGB")))
    images, _ = run(ev, list(args.caption), frames, args.negative_prompt)
    save_story_grid(args.out, images[0].cpu().numpy())
    print(f"wrote {args.out} ({len(args.caption)} frames, {len(frames)} "
          f"known, {ev.num_inference_steps} steps, cfg {ev.guidance_scale})")


if __name__ == "__main__":
    main()
