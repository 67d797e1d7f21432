"""Stage-2 training CLI, the counterpart of `rcdms_tpu/cli/train_stage2.py`:
the story UNet and the fusion stacks trained together over fp32 masters,
the VAE and both CLIP towers frozen. One process on one card, or N
data-parallel processes under torchrun:

    torchrun --nproc-per-node 8 -m rcdms_tpu_torch.cli.train_stage2 \
        --dataset flintstones --h5-path .../flintstones.h5 \
        --sd-pretrained .../stable-diffusion-v1-5 \
        --vision-pretrained .../kandinsky-2-2-prior/image_encoder \
        --batch-size 8 --output-dir runs/stage2

Smoke run (tiny towers, synthetic stories, on the CPU):

    python -m rcdms_tpu_torch.cli.train_stage2 --synthetic --device cpu \
        --max-train-steps 2 --output-dir runs/smoke2

Checkpoints (`io/checkpoint.py`) go to --output-dir/<step>/: every
--checkpointing-steps, after the last step, and at a SIGTERM's step
boundary ({"preempted": true}); --resume-from-checkpoint continues from
the newest. The flags are the JAX CLI's with its defaults, and --device
(default cuda, no CPU fallback). --batch-size is global: each of N
processes reads its shard of the dataset, batch-size / N stories a step,
and takes cuda:{LOCAL_RANK}; the gradients are averaged over the
processes (NCCL) and each holds its ZeRO-2 cut of the optimizer state,
or all of it with --no-zero2 (`train/sharding.py`). Rank 0 writes the
metrics and the checkpoints, which any number of processes resumes."""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    FusionConfig,
    Stage2TrainConfig,
    StoryUNetConfig,
    TemporalConfig,
    VAEConfig,
)
from rcdms_tpu_torch.sample.pipeline import PipelineConfigs
from rcdms_tpu_torch.train import distributed
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.stage2 import (
    Stage2Batch,
    Stage2Trainer,
    encode_batch,
)
from rcdms_tpu_torch.train.train_state import TrainState
from rcdms_tpu_torch.utils.logging import setup_logging

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="flintstones",
                   choices=["flintstones", "pororosv"])
    p.add_argument("--h5-path", default="./datasets/ARLDM/flintstones.h5",
                   help="ARLDM h5 file (needs h5py and OpenCV)")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--sr-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic stories and tiny towers (smoke)")
    p.add_argument("--native-feeder", action="store_true",
                   help="pack pixel batches in the C++ thread pool "
                        "(native/story_feeder.cpp, bit for bit the numpy "
                        "protocol; built with g++ at first use)")
    p.add_argument("--sd-pretrained", default=None,
                   help="stable-diffusion-v1-5 directory (unet/, vae/, "
                        "text_encoder/)")
    p.add_argument("--vision-pretrained", default=None,
                   help="kandinsky image_encoder directory")
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--unet-init-ckpt", default=None,
                   help="a training checkpoint directory of this CLI: its "
                        "masters warm-start the UNet and fusion stacks")
    p.add_argument("--output-dir", default="runs/stage2")
    p.add_argument("--resume-from-checkpoint", default=None)
    p.add_argument("--rcdms-init-ckpt", default=None,
                   help="warm-start unet+fusion from a reference DeepSpeed "
                        "blob (mp_rank_00_model_states.pt)")
    d = Stage2TrainConfig()
    common.add_training_flags(p, d)
    p.add_argument("--gradient-checkpointing", action="store_true",
                   help="recompute each UNet sub-block in the backward "
                        "(StoryUNetConfig.remat)")
    p.add_argument("--config", default=None,
                   help="reference-format OmegaConf YAML (configs/"
                        "training.yaml schema, needs PyYAML) applied to "
                        "the UNet config")
    return p.parse_args(argv)


def default_configs(args, ds_cfg) -> PipelineConfigs:
    """The JAX `main`'s configs: tiny towers under --synthetic, the full
    ones otherwise (the prior and the stage-1 text tower are stage 1's and
    stay None)."""
    if args.synthetic:
        unet = StoryUNetConfig.tiny(remat=args.gradient_checkpointing)
        fusion = FusionConfig.tiny(hidden_dim=unet.cross_attention_dim,
                                   text_dim=unet.cross_attention_dim)
        return PipelineConfigs(
            text_s1=None, prior=None, unet=unet, fusion=fusion,
            vae=VAEConfig.tiny(),
            text_s2=CLIPTextConfig.tiny(
                max_positions=ds_cfg.max_text_len,
                width=unet.cross_attention_dim, vocab_size=49500,
                eos_token_id=49407),
            vision=CLIPVisionConfig.tiny(
                image_size=ds_cfg.clip_size, width=fusion.seen_vis_dim,
                projection_dim=fusion.unseen_vis_dim))
    return PipelineConfigs(
        text_s1=None, prior=None,
        unet=StoryUNetConfig(remat=args.gradient_checkpointing,
                             temporal=TemporalConfig(
                                 max_frames=ds_cfg.num_frames)),
        fusion=FusionConfig(), vae=VAEConfig(),
        text_s2=CLIPTextConfig.sd15(max_positions=ds_cfg.max_text_len,
                                    vocab_size=ds_cfg.vocab_size),
        vision=CLIPVisionConfig())


def _apply_flags(args, configs: PipelineConfigs) -> PipelineConfigs:
    unet = configs.unet
    if args.gradient_checkpointing:
        unet = dataclasses.replace(unet, remat=True)
    if args.config:
        from rcdms_tpu_torch.reference_yaml import (
            apply_to_unet_config,
            parse_reference_yaml,
        )

        overrides, _ = parse_reference_yaml(args.config)
        unet = apply_to_unet_config(unet, overrides)
    return dataclasses.replace(configs, unet=unet)


def build_state(args, configs: PipelineConfigs, device):
    """(TrainState of the UNet and fusion stacks, frozen towers (VAE, SD
    text, bigG vision)): seeded random init or the pretrained directories,
    then --rcdms-init-ckpt and --unet-init-ckpt over the trained set."""
    dtype = common.DTYPES[args.dtype]
    sd = args.sd_pretrained

    def sub(name):
        return os.path.join(sd, name) if sd else None

    kw = dict(dtype=dtype, device=device)
    towers = (common.build_vae(configs.vae, sub("vae"), **kw),
              common.build_text_encoder(configs.text_s2,
                                        sub("text_encoder"), **kw),
              common.build_vision_encoder(configs.vision,
                                          args.vision_pretrained, **kw))
    fp32 = dict(dtype=torch.float32, device=device)
    unet = common.build_unet(configs.unet, sub("unet"), **fp32)
    fusion = common.build_fusion(configs.fusion, **fp32)
    if args.rcdms_init_ckpt:
        common.load_rcdms_stage2(args.rcdms_init_ckpt, unet, fusion)
    trainer = Stage2Trainer(common.trainable(unet), common.trainable(fusion),
                            noise_offset=args.noise_offset)
    if args.unet_init_ckpt:
        from rcdms_tpu_torch.io.checkpoint import restore_checkpoint

        restored, _, _ = restore_checkpoint(args.unet_init_ckpt)
        common.load_masters(trainer, restored["params"])
        del restored
    state = TrainState.create(
        trainer, make_optimizer(common.optimizer_config(args),
                                zero2=not args.no_zero2), dtype)
    return state, towers


def encode(towers, raw: dict, generator) -> Stage2Batch:
    """The frozen towers' pass over a device batch, the posteriors sampled
    from `generator`."""
    return encode_batch(*towers, raw, generator=generator)


def run(args, dataset, configs: PipelineConfigs = None) -> common.TrainRun:
    """Train on `dataset` (its `cfg` and `batches`) as the flags say;
    `configs` defaults to `default_configs`. Under a process group (`main`
    joins torchrun's) this process trains on its rows of the global
    --batch-size."""
    device = common.device_of(args)
    batch_size = common.local_batch(args)
    configs = _apply_flags(args, configs or default_configs(args,
                                                            dataset.cfg))
    state, towers = build_state(args, configs, device)
    return common.train_loop(
        args, state, towers,
        lambda raw, g: encode(towers, raw, g), dataset, device, batch_size)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    distributed.maybe_initialize(args.device)
    try:
        run(args, common.train_dataset(args))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
