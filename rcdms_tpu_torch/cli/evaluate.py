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
design. `--eval-batch n` stacks n stories per `generate` call (the tail
chunk padded with its last story, whose copies are discarded), each with
its own noise (`StoryNoise.draw` / `cat`), so a story's outputs equal
`--eval-batch 1`'s up to the batch's rounding. That is stricter than the
JAX CLI, whose batch shares one key.

Opt-ins as the JAX CLI's: `--autoreg` (stage 1 only, one prior pass per
frame; cosine metrics only), `--encoder-propagation k` and
`--quantize int8`, which both change the numbers.

`--shard-story` splits each story over the ranks of the process group
that `torchrun --nproc-per-node N` starts (NCCL on `cuda:LOCAL_RANK`,
gloo with `--device cpu`; without torchrun, a one-rank mesh): the
('cfg', 'frame', 'space') mesh of `train.sharding.inference_mesh`, at
the JAX CLI's default 'frame' axis of 1, for any N (splits that do not
divide are padded as GSPMD pads them). Every rank runs its share of
every story (the towers' batch, the prior's frames, the UNet's CFG
branch and latent rows, the VAE's image rows); rank 0 alone writes the
PNGs, metrics and summary. Before the first story every rank's parameter
checksums must equal rank 0's.

    torchrun --nproc-per-node 4 -m rcdms_tpu_torch.cli.evaluate \
        --shard-story ...

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
from rcdms_tpu_torch.data.protocol import clip_preprocess, white_image
from rcdms_tpu_torch.io.checkpoint import (
    STATE_FILE,
    is_checkpoint_dir,
    restore_checkpoint,
)
from rcdms_tpu_torch.ops.quant import set_quant_mode
from rcdms_tpu_torch.sample.eval import (
    Stage1EvalAccumulator,
    save_story_grid,
    split_indices,
    story_metrics,
)
from rcdms_tpu_torch.sample.pipeline import (
    PipelineConfigs,
    StoryInputs,
    StoryNoise,
    StoryPipeline,
    for_inference,
)
from rcdms_tpu_torch.train import distributed, sharding



def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="pororosv",
                   choices=["flintstones", "pororosv"])
    p.add_argument("--h5-path", default="./datasets/ARLDM/pororo.h5",
                   help="ARLDM h5 file (needs h5py and OpenCV)")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--mode", default="continue",
                   choices=["visualization", "continue"])
    p.add_argument("--autoreg", action="store_true",
                   help="stage-1-only autoregressive eval: one sampling "
                        "pass per frame, committing each predicted embedding "
                        "as a known condition (reference "
                        "stage1_batchtest:186-242)")
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
    p.add_argument("--stage1-ckpt", default=None,
                   help="a train_stage1 checkpoint directory: its fp32 "
                        "masters into the prior")
    p.add_argument("--stage2-ckpt", default=None,
                   help="a train_stage2 checkpoint directory: its fp32 "
                        "masters into the UNet and fusion stacks")
    p.add_argument("--converted-ckpt", default=None,
                   help="a directory written by `rcdms_tpu_torch.cli."
                        "convert` holding the FULL pipeline's weights; "
                        "read after every other source")
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
    p.add_argument("--dtype", default="float32", choices=sorted(common.DTYPES),
                   help="compute dtype")
    p.add_argument("--encoder-propagation", type=int, default=0,
                   help="OPT-IN approximate fast sampling: recompute the "
                        "UNet encoder every k-th step (k>=2 changes "
                        "numerics; keep 0 for reference parity)")
    p.add_argument("--shard-story", action="store_true",
                   help="shard each single story over ALL local devices "
                        "(('cfg','frame','space') inference mesh) to cut "
                        "latency instead of sharding the story index range")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--config", default=None,
                   help="reference-format OmegaConf YAML (testing.yaml "
                        "schema, needs PyYAML): unet_additional_kwargs "
                        "applied to the UNet/prior temporal modules, "
                        "noise_scheduler_kwargs to the DDIM schedule")
    p.add_argument("--eval-batch", type=int, default=1,
                   help="stories per generate call; each story keeps its "
                        "own noise, so per-story outputs equal "
                        "--eval-batch 1's")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="OPT-IN w8a8 int8 inference (ops/quant.py) of the "
                        "UNet's 3x3 convs; CHANGES NUMERICS — never use "
                        "for parity runs")
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


CONVERTED_KIND = "rcdms_tpu-converted-pipeline"
TOWERS = ("text_s1", "text_s2", "vision", "vae", "prior", "unet", "fusion")


def restore_port_checkpoint(path: str):
    """(state, metadata, step) of the newest step of a checkpoint directory
    written by this package (`io/checkpoint.py`). An orbax directory of
    the JAX package raises: reading one needs jax and orbax, so it is
    converted first by `scripts/orbax_to_torch.py`, where jax is
    installed."""
    if os.path.isdir(path) and not is_checkpoint_dir(path) and any(
            name.isdigit() for name in os.listdir(path)):
        raise ValueError(
            f"{path} holds no checkpoint of rcdms_tpu_torch (no "
            f"<step>/{STATE_FILE}); convert an orbax checkpoint of the JAX "
            f"package first: python scripts/orbax_to_torch.py --ckpt {path} "
            f"--output-dir <dir>")
    return restore_checkpoint(path)


def build_pipeline(args):
    """(StoryPipeline, dataset, DatasetConfig) for the flags: each tower
    from its builder (seeded random init, or converted pretrained weights),
    then the training checkpoints' masters (--stage1-ckpt over the prior,
    --stage2-ckpt over the UNet and fusion stacks), the trained reference
    checkpoints, and last a converted pipeline (--converted-ckpt) over
    every tower. A tower that any checkpoint loads into is built in fp32
    and cast to --dtype after the load. `--shard-story` joins the process
    group of torchrun's environment (if any; `train/distributed.py`),
    builds the inference mesh and checks that every rank holds rank 0's
    weights."""
    device = common.device_of(args)
    mesh = None
    if args.shard_story:
        distributed.maybe_initialize(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = sharding.inference_mesh()
    if args.quantize:
        set_quant_mode(args.quantize)
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

    dtype = common.DTYPES[args.dtype]
    kw = dict(dtype=dtype, device=device)
    # a tower a checkpoint loads into stays fp32 until it is loaded, so the
    # cast (and the int8 route's quantization) sees the checkpoint's values
    fp32 = dict(kw, dtype=torch.float32)
    build = {name: fp32 if args.converted_ckpt else kw for name in TOWERS}
    if args.rcdms_stage1_ckpt or args.stage1_ckpt:
        build["prior"] = fp32
    if args.rcdms_stage2_ckpt or args.stage2_ckpt:
        build["unet"] = build["fusion"] = fp32
    sd = args.sd_pretrained

    def sub(name):
        return os.path.join(sd, name) if sd else None

    towers = dict(
        text_s1=common.build_text_encoder(cfg.text_s1,
                                          args.text_s1_pretrained,
                                          **build["text_s1"]),
        text_s2=common.build_text_encoder(cfg.text_s2, sub("text_encoder"),
                                          **build["text_s2"]),
        vision=common.build_vision_encoder(cfg.vision,
                                           args.vision_pretrained,
                                           **build["vision"]),
        vae=common.build_vae(cfg.vae, sub("vae"), **build["vae"]),
        prior=common.build_prior(cfg.prior, args.prior_pretrained,
                                 **build["prior"]),
        unet=common.build_unet(cfg.unet, sub("unet"), **build["unet"]),
        fusion=common.build_fusion(cfg.fusion, **build["fusion"]))
    if args.stage1_ckpt:
        masters = restore_port_checkpoint(args.stage1_ckpt)[0]["params"]
        common.load_masters(towers["prior"], masters, "prior.")
        del masters
    if args.stage2_ckpt:
        masters = restore_port_checkpoint(args.stage2_ckpt)[0]["params"]
        common.load_masters(towers["unet"], masters, "unet.")
        common.load_masters(towers["fusion"], masters, "fusion.")
        del masters
    if args.rcdms_stage1_ckpt:
        common.load_rcdms_stage1(args.rcdms_stage1_ckpt, towers["prior"])
    if args.rcdms_stage2_ckpt:
        common.load_rcdms_stage2(args.rcdms_stage2_ckpt, towers["unet"],
                                 towers["fusion"])
    if args.converted_ckpt:
        state, meta, _ = restore_port_checkpoint(args.converted_ckpt)
        if meta.get("kind") != CONVERTED_KIND:
            raise ValueError(
                f"{args.converted_ckpt} is not a convert-CLI checkpoint "
                f"(metadata kind={meta.get('kind')!r})")
        for name in TOWERS:
            towers[name].load_state_dict(state["params"][name], strict=True)
        del state
    for name in TOWERS:
        if build[name] is fp32:
            towers[name] = for_inference(towers[name], dtype)
    pipeline = StoryPipeline(
        cfg, num_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, schedule=schedule, towers=towers,
        encoder_propagation=args.encoder_propagation, mesh=mesh).eval()
    if mesh is not None:
        sharding.check_replicated(pipeline, mesh.all)
    return pipeline, dataset, ds_cfg


def _batch_inputs(exs, uncond_ids, device) -> StoryInputs:
    """Dataset examples stacked as one StoryInputs on `device`."""
    def stack(key, dtype=None):
        return torch.from_numpy(np.stack([np.asarray(e[key]) for e in exs])
                                ).to(device, dtype)

    ids = stack("input_ids", torch.long)
    u_ids = torch.from_numpy(np.stack([uncond_ids] * len(exs))).to(
        device, torch.long)
    return StoryInputs(
        tokens_s1=ids, tokens_s1_u=u_ids, tokens_s2=ids, tokens_s2_u=u_ids,
        source_clip=stack("source_clip"), mask_clip=stack("mask_clip"),
        source_pixels=stack("source"), frame_known=stack("frame_known"))


def main(argv=None):
    args = parse_args(argv)
    joined = not distributed.active()
    try:
        return run(args)
    finally:
        if joined:  # a group this call joined (`--shard-story`)
            distributed.shutdown()


def run(args):
    """The evaluation of parsed flags; returns the summary. Under a
    process group (`--shard-story`) rank 0 alone writes the outputs and
    prints."""
    pipeline, dataset, ds_cfg = build_pipeline(args)
    device = pipeline.device
    writer = distributed.rank_and_size()[0] == 0
    if writer:
        os.makedirs(args.output_dir, exist_ok=True)

    known_length = 1 if args.mode == "continue" else 0
    if args.autoreg:
        white_clip = torch.from_numpy(clip_preprocess(
            white_image(args.image_size), ds_cfg.clip_size)).to(device)
    else:
        # story-independent conditioning (uncond captions, white/black
        # mask embeds), once for all stories
        cache = common.build_cond_cache(pipeline, dataset, ds_cfg)

    rng = np.random.RandomState(args.seed)
    s1_acc = Stage1EvalAccumulator()
    all_metrics = []
    t_start = time.perf_counter()

    n = min(args.num_stories, len(dataset))
    indices = split_indices(n, args.shard_id, args.num_shards)
    eb = max(1, args.eval_batch)
    metrics_path = os.path.join(args.output_dir,
                                f"metrics_{args.shard_id}.jsonl")
    uncond_ids = dataset.tokenizer([""] * ds_cfg.num_frames)["input_ids"]
    with open(metrics_path if writer else os.devnull, "w") as mf, \
            torch.no_grad():
        for start in range(0, len(indices), eb):
            chunk = list(indices[start:start + eb])
            exs = [dataset.example(idx, rng, known_length=known_length)
                   for idx in chunk]
            # pad the tail chunk to the batch; the padded rows are
            # generated and discarded
            pad = eb - len(chunk)
            inputs = _batch_inputs(exs + [exs[-1]] * pad, uncond_ids, device)
            generators = [torch.Generator(device).manual_seed(
                common.story_seed(args.seed, idx))
                for idx in chunk + [chunk[-1]] * pad]
            if args.autoreg:
                passes = [pipeline.prior_sampler.draw_passes(
                    1, ds_cfg.num_frames, g) for g in generators]
                noise = [(torch.cat([p[i][0] for p in passes]),
                          torch.cat([p[i][1] for p in passes], dim=1))
                         for i in range(ds_cfg.num_frames)]
                pred_embeds = pipeline.generate_stage1_autoreg(
                    inputs, white_clip, noise=noise)
            else:
                noise = StoryNoise.cat(
                    StoryNoise.draw(pipeline, 1, g, ds_cfg.image_size)
                    for g in generators)
                frames_b, pred_embeds = pipeline.generate(inputs, cache,
                                                          noise=noise)
                frames_b = frames_b.float().cpu().numpy()
            pred_embeds = pred_embeds.float().cpu().numpy()
            for bi, idx in enumerate(chunk):
                ex = exs[bi]
                # stage-1 metric: cosine of the predicted vs the real
                # frames' CLIP image embeds
                ref = torch.from_numpy(ex["reference_clip"]).to(
                    device, pipeline.dtype)
                _, gt_embeds = pipeline.vision(ref)
                sim = s1_acc.update(pred_embeds[bi],
                                    gt_embeds.float().cpu().numpy())
                if args.autoreg:
                    m = {"story": idx, "clip_cosine": sim}
                    all_metrics.append(m)
                    mf.write(json.dumps(m) + "\n")
                    if writer:
                        print(f"story {idx}: cosine {sim:.4f} (autoreg)",
                              flush=True)
                    continue
                gt = (np.asarray(ex["target"]) + 1) / 2
                m = story_metrics(frames_b[bi], gt)
                m.update({"story": idx, "clip_cosine": sim})
                all_metrics.append(m)
                mf.write(json.dumps(m) + "\n")
                if writer:
                    save_story_grid(os.path.join(args.output_dir,
                                                 f"story_{idx}.png"),
                                    frames_b[bi], gt)
                    print(f"story {idx}: cosine {sim:.4f} ssim "
                          f"{m['ssim']:.4f}", flush=True)

    elapsed = time.perf_counter() - t_start
    summary = {
        "num_stories": len(indices),
        "mean_clip_cosine": s1_acc.mean,
        "elapsed_s": elapsed,
        "stories_per_s": len(indices) / elapsed,
    }
    if not args.autoreg:
        summary["mean_ssim"] = float(np.mean([m["ssim"]
                                              for m in all_metrics]))
        summary["mean_psnr"] = float(np.mean([m["psnr"]
                                              for m in all_metrics]))
    if writer:
        print(json.dumps(summary))
        with open(os.path.join(args.output_dir,
                               f"summary_{args.shard_id}.json"), "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
