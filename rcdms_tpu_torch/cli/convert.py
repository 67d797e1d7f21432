"""One-shot conversion CLI, the counterpart of `rcdms_tpu/cli/convert.py`:
pretrained bases (diffusers / HF directories), the reference's trained
DeepSpeed blobs and this package's training checkpoints -> ONE checkpoint
(`io/checkpoint.py`, step 0) holding the whole pipeline's weights, so
later runs load one file instead of converting each source at start-up.

    python -m rcdms_tpu_torch.cli.convert \
        --sd-pretrained weights/stable-diffusion-v1-5 \
        --prior-pretrained weights/kandinsky-2-2-prior/prior \
        --text-s1-pretrained weights/kandinsky-2-2-prior/text_encoder \
        --vision-pretrained weights/kandinsky-2-2-prior/image_encoder \
        --stage1-ckpt runs/stage1 --stage2-ckpt runs/stage2 \
        --output-dir weights_torch/flintstones

    python -m rcdms_tpu_torch.cli.evaluate \
        --converted-ckpt weights_torch/flintstones ...

It takes evaluate's flags (--output-dir is the target) and builds the
pipeline as evaluate does, in --dtype; the checkpoint holds each tower's
state dict ({text_s1, text_s2, vision, vae, prior, unet, fusion}) and the
JAX CLI's metadata (kind, dataset, sources). It prints one JSON line:
saved, total_params, components."""

from __future__ import annotations

import json
import os

from rcdms_tpu_torch.cli import evaluate
from rcdms_tpu_torch.io.checkpoint import save_checkpoint


def main(argv=None) -> dict:
    args = evaluate.parse_args(argv)
    pipeline, _, _ = evaluate.build_pipeline(args)
    out = args.output_dir
    os.makedirs(out, exist_ok=True)
    meta = {
        "kind": evaluate.CONVERTED_KIND,
        "dataset": args.dataset,
        "sources": {
            "sd_pretrained": args.sd_pretrained,
            "prior_pretrained": args.prior_pretrained,
            "text_s1_pretrained": args.text_s1_pretrained,
            "vision_pretrained": args.vision_pretrained,
            "rcdms_stage1_ckpt": args.rcdms_stage1_ckpt,
            "rcdms_stage2_ckpt": args.rcdms_stage2_ckpt,
            "stage1_ckpt": args.stage1_ckpt,
            "stage2_ckpt": args.stage2_ckpt,
        },
    }
    towers = {name: getattr(pipeline, name) for name in evaluate.TOWERS}
    save_checkpoint(out, 0, {"params": {
        name: tower.state_dict() for name, tower in towers.items()}}, meta)
    line = {"saved": out,
            "total_params": sum(p.numel() for t in towers.values()
                                for p in t.parameters()),
            "components": sorted(towers)}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
