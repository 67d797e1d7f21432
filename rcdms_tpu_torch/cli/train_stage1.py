"""Stage-1 training CLI, the counterpart of `rcdms_tpu/cli/train_stage1.py`:
the frame prior trained over fp32 masters, the bigG text and vision
towers frozen. One process on one card:

    python -m rcdms_tpu_torch.cli.train_stage1 --dataset flintstones \
        --h5-path .../flintstones.h5 \
        --prior-pretrained .../kandinsky-2-2-prior/prior \
        --text-pretrained .../kandinsky-2-2-prior/text_encoder \
        --vision-pretrained .../kandinsky-2-2-prior/image_encoder \
        --output-dir runs/stage1

Smoke run (tiny towers, synthetic stories, on the CPU):

    python -m rcdms_tpu_torch.cli.train_stage1 --synthetic --device cpu \
        --max-train-steps 2 --output-dir runs/smoke1

or N data-parallel processes, `torchrun --nproc-per-node N -m
rcdms_tpu_torch.cli.train_stage1 ...`. Checkpoints, resume, SIGTERM, the
global --batch-size and --no-zero2 as `train_stage2`'s. The encode draws
no noise; the step's noise comes from the generator seeded from
(seed, 2 step + 1) (`common.step_generators`), drawn for the global
batch. The flags are the JAX CLI's with its defaults, and --device
(default cuda, no CPU fallback)."""

from __future__ import annotations

import argparse
import dataclasses

import torch

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    PriorConfig,
    Stage1TrainConfig,
    TemporalConfig,
)
from rcdms_tpu_torch.sample.pipeline import PipelineConfigs
from rcdms_tpu_torch.train import distributed
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.stage1 import (
    Stage1Batch,
    Stage1Trainer,
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
    p.add_argument("--prior-pretrained", default=None)
    p.add_argument("--text-pretrained", default=None)
    p.add_argument("--vision-pretrained", default=None)
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--output-dir", default="runs/stage1")
    p.add_argument("--resume-from-checkpoint", default=None)
    p.add_argument("--rcdms-init-ckpt", default=None,
                   help="warm-start the prior from a reference DeepSpeed "
                        "blob (mp_rank_00_model_states.pt)")
    d = Stage1TrainConfig()
    common.add_training_flags(p, d)
    p.add_argument("--config", default=None,
                   help="reference-format OmegaConf YAML (training.yaml "
                        "schema, needs PyYAML) applied to the prior's "
                        "temporal modules")
    return p.parse_args(argv)


def default_configs(args, ds_cfg) -> PipelineConfigs:
    """The JAX `main`'s configs: tiny towers under --synthetic, the full
    ones otherwise (the UNet, fusion, VAE and SD text towers are stage
    2's and stay None)."""
    none = dict(text_s2=None, vae=None, unet=None, fusion=None)
    if args.synthetic:
        prior = PriorConfig.tiny(num_text_tokens=ds_cfg.max_text_len)
        return PipelineConfigs(
            prior=prior, **none,
            text_s1=CLIPTextConfig.tiny(
                max_positions=ds_cfg.max_text_len, vocab_size=49500,
                eos_token_id=49407, width=prior.embedding_dim,
                projection_dim=prior.embedding_dim),
            vision=CLIPVisionConfig.tiny(
                image_size=ds_cfg.clip_size,
                projection_dim=prior.embedding_dim))
    return PipelineConfigs(
        prior=PriorConfig(num_text_tokens=ds_cfg.max_text_len,
                          temporal=TemporalConfig(
                              max_frames=ds_cfg.num_frames)),
        **none,
        text_s1=CLIPTextConfig.bigg(max_positions=ds_cfg.max_text_len,
                                    vocab_size=ds_cfg.vocab_size),
        vision=CLIPVisionConfig())


def _apply_flags(args, configs: PipelineConfigs) -> PipelineConfigs:
    if not args.config:
        return configs
    from rcdms_tpu_torch.reference_yaml import (
        apply_to_unet_config,
        parse_reference_yaml,
    )

    overrides, _ = parse_reference_yaml(args.config)
    return dataclasses.replace(
        configs, prior=apply_to_unet_config(configs.prior, overrides))


def build_state(args, configs: PipelineConfigs, device):
    """(TrainState of the prior, frozen towers (bigG text, bigG vision)):
    seeded random init or the pretrained directories, then
    --rcdms-init-ckpt over the prior."""
    dtype = common.DTYPES[args.dtype]
    kw = dict(dtype=dtype, device=device)
    towers = (common.build_text_encoder(configs.text_s1,
                                        args.text_pretrained, **kw),
              common.build_vision_encoder(configs.vision,
                                          args.vision_pretrained, **kw))
    prior = common.build_prior(configs.prior, args.prior_pretrained,
                               dtype=torch.float32, device=device)
    if args.rcdms_init_ckpt:
        common.load_rcdms_stage1(args.rcdms_init_ckpt, prior)
    trainer = Stage1Trainer(common.trainable(prior),
                            noise_offset=args.noise_offset)
    state = TrainState.create(
        trainer, make_optimizer(common.optimizer_config(args),
                                zero2=not args.no_zero2), dtype)
    return state, towers


def encode(towers, raw: dict, generator=None) -> Stage1Batch:
    """The frozen towers' pass over a device batch (no noise drawn)."""
    return encode_batch(*towers, raw)


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
