"""Evaluation CLI — the counterpart of `rcdms_tpu/cli/evaluate.py`: the
full two-stage pipeline over the test split.

Modes:
  * visualization: no known frames (known_length=0)
  * continue:      frame 0 known   (known_length=1)

Outputs in --output-dir: `metrics_{shard}.jsonl` (per story: SSIM, PSNR
and the stage-1 CLIP cosine of predicted vs ground-truth image embeds),
`summary_{shard}.json` (the JAX CLI's keys) and one 2 x F grid PNG per
story, with per-frame PNGs beside it.

Each story draws its noise from its own `torch.Generator` on the device,
seeded from (--seed, story index) (`common.story_seed`), so a story's
frames depend neither on its shard nor on its neighbours. The JAX CLI
folds the index into a jax key instead, so the two CLIs' noise differs by
design.

    python -m rcdms_tpu_torch.cli.evaluate --dataset pororosv \
        --mode continue --h5-path .../pororo.h5 --sd-pretrained ... \
        --prior-pretrained ... --output-dir eval_out --num-stories 100

`--device` defaults to cuda and never falls back to the CPU; the tests
pass `--device cpu`, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    FusionConfig,
    PriorConfig,
    StoryUNetConfig,
    TemporalConfig,
    VAEConfig,
)
from rcdms_tpu_torch.sample.eval import (
    Stage1EvalAccumulator,
    save_story_grid,
    split_indices,
    story_metrics,
)
from rcdms_tpu_torch.sample.pipeline import (
    PipelineConfigs,
    StoryInputs,
    StoryPipeline,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="pororosv",
                   choices=["flintstones", "pororosv"])
    p.add_argument("--h5-path", default="./datasets/ARLDM/pororo.h5",
                   help="ARLDM h5 file (needs h5py and OpenCV)")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--mode", default="continue",
                   choices=["visualization", "continue"])
    p.add_argument("--synthetic", action="store_true",
                   help="tiny random models on random stories (smoke)")
    p.add_argument("--sd-pretrained", default=None,
                   help="SD1.5 directory (unet/, vae/, text_encoder/)")
    p.add_argument("--prior-pretrained", default=None,
                   help="Kandinsky 2.2 prior directory")
    p.add_argument("--text-s1-pretrained", default=None,
                   help="CLIP bigG text directory")
    p.add_argument("--vision-pretrained", default=None,
                   help="CLIP ViT-bigG vision directory")
    p.add_argument("--tokenizer-path", default=None,
                   help="CLIP tokenizer directory (needs transformers); "
                        "without it, a crc32 word hash")
    p.add_argument("--rcdms-stage1-ckpt", default=None,
                   help="reference DeepSpeed stage-1 blob "
                        "(mp_rank_00_model_states.pt or its checkpoint dir)")
    p.add_argument("--rcdms-stage2-ckpt", default=None,
                   help="reference DeepSpeed stage-2 blob (seen_module./"
                        "unseen_module./unet. prefixes)")
    p.add_argument("--output-dir", default="eval_out")
    p.add_argument("--num-stories", type=int, default=16)
    p.add_argument("--num-inference-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=2.0)
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                   help="compute dtype")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--config", default=None,
                   help="reference-format OmegaConf YAML (testing.yaml "
                        "schema, needs PyYAML): unet_additional_kwargs "
                        "applied to the UNet/prior temporal modules, "
                        "noise_scheduler_kwargs to the DDIM schedule")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda never falls back to the CPU")
    return p.parse_args(argv)


def _configs(args):
    """(dataset, its config, PipelineConfigs) for the flags."""
    if args.synthetic:
        from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset

        dataset = SyntheticStoryDataset()
        ds_cfg = dataset.cfg
        t = ds_cfg.max_text_len
        prior = PriorConfig.tiny(num_text_tokens=t)
        unet = StoryUNetConfig.tiny()
        fusion = FusionConfig.tiny(hidden_dim=unet.cross_attention_dim,
                                   text_dim=unet.cross_attention_dim,
                                   unseen_vis_dim=prior.embedding_dim)
        return dataset, ds_cfg, PipelineConfigs(
            text_s1=CLIPTextConfig.tiny(
                max_positions=t, width=prior.embedding_dim,
                projection_dim=prior.embedding_dim, vocab_size=49500,
                eos_token_id=49407),
            text_s2=CLIPTextConfig.tiny(
                max_positions=t, width=unet.cross_attention_dim,
                vocab_size=49500, eos_token_id=49407),
            vision=CLIPVisionConfig.tiny(
                image_size=ds_cfg.clip_size, width=fusion.seen_vis_dim,
                projection_dim=prior.embedding_dim),
            vae=VAEConfig.tiny(), prior=prior, unet=unet, fusion=fusion)
    from rcdms_tpu_torch.data.datasets import StoryH5Dataset

    ds_cfg = common.dataset_from_args(args)
    dataset = StoryH5Dataset(ds_cfg, "test", args.tokenizer_path)
    t, vocab = ds_cfg.max_text_len, ds_cfg.vocab_size
    return dataset, ds_cfg, PipelineConfigs(
        text_s1=CLIPTextConfig.bigg(t, vocab),
        text_s2=CLIPTextConfig.sd15(t, vocab), vision=CLIPVisionConfig(),
        vae=VAEConfig(),
        prior=PriorConfig(num_text_tokens=t, temporal=TemporalConfig(
            max_frames=ds_cfg.num_frames)),
        unet=StoryUNetConfig(), fusion=FusionConfig())


def build_pipeline(args):
    """(StoryPipeline, dataset, DatasetConfig) for the flags: each tower
    from its builder (seeded random init, or converted pretrained weights),
    then the trained reference checkpoints over the prior, UNet and
    fusion stacks."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    dataset, ds_cfg, cfg = _configs(args)
    schedule = None
    if args.config:
        from rcdms_tpu_torch.reference_yaml import (
            apply_to_unet_config,
            parse_reference_yaml,
        )

        overrides, schedule = parse_reference_yaml(args.config)
        cfg = dataclasses.replace(
            cfg, unet=apply_to_unet_config(cfg.unet, overrides),
            prior=apply_to_unet_config(cfg.prior, overrides))

    kw = dict(dtype=DTYPES[args.dtype], device=device)
    sd = args.sd_pretrained

    def sub(name):
        return os.path.join(sd, name) if sd else None

    towers = dict(
        text_s1=common.build_text_encoder(cfg.text_s1,
                                          args.text_s1_pretrained, **kw),
        text_s2=common.build_text_encoder(cfg.text_s2, sub("text_encoder"),
                                          **kw),
        vision=common.build_vision_encoder(cfg.vision,
                                           args.vision_pretrained, **kw),
        vae=common.build_vae(cfg.vae, sub("vae"), **kw),
        prior=common.build_prior(cfg.prior, args.prior_pretrained, **kw),
        unet=common.build_unet(cfg.unet, sub("unet"), **kw),
        fusion=common.build_fusion(cfg.fusion, **kw))
    if args.rcdms_stage1_ckpt:
        common.load_rcdms_stage1(args.rcdms_stage1_ckpt, towers["prior"])
    if args.rcdms_stage2_ckpt:
        common.load_rcdms_stage2(args.rcdms_stage2_ckpt, towers["unet"],
                                 towers["fusion"])
    pipeline = StoryPipeline(cfg, num_steps=args.num_inference_steps,
                             guidance_scale=args.guidance_scale,
                             schedule=schedule, towers=towers).eval()
    return pipeline, dataset, ds_cfg


def _example_inputs(ex, uncond_ids, device) -> StoryInputs:
    """A dataset example as a batch-1 StoryInputs on `device`."""
    def put(key, dtype=None):
        return torch.from_numpy(np.asarray(ex[key]))[None].to(device, dtype)

    ids = put("input_ids", torch.long)
    u_ids = torch.from_numpy(uncond_ids)[None].to(device, torch.long)
    return StoryInputs(
        tokens_s1=ids, tokens_s1_u=u_ids, tokens_s2=ids, tokens_s2_u=u_ids,
        source_clip=put("source_clip"), mask_clip=put("mask_clip"),
        source_pixels=put("source"), frame_known=put("frame_known"))


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    pipeline, dataset, ds_cfg = build_pipeline(args)
    device = pipeline.device

    known_length = 1 if args.mode == "continue" else 0
    # story-independent conditioning (uncond captions, white/black mask
    # embeds), once for all stories
    cache = common.build_cond_cache(pipeline, dataset, ds_cfg)

    rng = np.random.RandomState(args.seed)
    s1_acc = Stage1EvalAccumulator()
    all_metrics = []
    t_start = time.perf_counter()

    n = min(args.num_stories, len(dataset))
    indices = split_indices(n, args.shard_id, args.num_shards)
    metrics_path = os.path.join(args.output_dir,
                                f"metrics_{args.shard_id}.jsonl")
    uncond_ids = dataset.tokenizer([""] * ds_cfg.num_frames)["input_ids"]
    with open(metrics_path, "w") as mf, torch.no_grad():
        for idx in indices:
            ex = dataset.example(idx, rng, known_length=known_length)
            inputs = _example_inputs(ex, uncond_ids, device)
            generator = torch.Generator(device).manual_seed(
                common.story_seed(args.seed, idx))
            frames, pred_embeds = pipeline.generate(inputs, cache, generator)
            # stage-1 metric: cosine of the predicted vs the real frames'
            # CLIP image embeds
            ref = torch.from_numpy(ex["reference_clip"]).to(device,
                                                            pipeline.dtype)
            _, gt_embeds = pipeline.vision(ref)
            sim = s1_acc.update(pred_embeds[0].float().cpu().numpy(),
                                gt_embeds.float().cpu().numpy())
            generated = frames[0].float().cpu().numpy()
            gt = (np.asarray(ex["target"]) + 1) / 2
            m = story_metrics(generated, gt)
            m.update({"story": idx, "clip_cosine": sim})
            all_metrics.append(m)
            mf.write(json.dumps(m) + "\n")
            save_story_grid(os.path.join(args.output_dir,
                                         f"story_{idx}.png"), generated, gt)
            print(f"story {idx}: cosine {sim:.4f} ssim {m['ssim']:.4f}",
                  flush=True)

    elapsed = time.perf_counter() - t_start
    summary = {
        "num_stories": len(indices),
        "mean_clip_cosine": s1_acc.mean,
        "elapsed_s": elapsed,
        "stories_per_s": len(indices) / elapsed,
        "mean_ssim": float(np.mean([m["ssim"] for m in all_metrics])),
        "mean_psnr": float(np.mean([m["psnr"] for m in all_metrics])),
    }
    print(json.dumps(summary))
    with open(os.path.join(args.output_dir,
                           f"summary_{args.shard_id}.json"), "w") as f:
        json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
