"""Shared CLI plumbing — the counterpart of `rcdms_tpu/cli/common.py`:
tower builders (seeded random init, or a pretrained diffusers / HF
directory converted by `io/convert.py`), the trained reference checkpoint
loaders, the inputs and conditioning cache of a story, and the training
CLIs' flags, per-step generators and loop (`train_loop`, one process or
a data-parallel process group).

Every builder draws its random init as `core/layers.py::init_like_flax_`
does, from `torch.Generator(device).manual_seed(seed)`, then overlays the
converted weights of a pretrained directory and logs how many keys stay
fresh.
"""

from __future__ import annotations

import logging
import os
import pickle
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    DatasetConfig,
    FusionConfig,
    OptimizerConfig,
    PriorConfig,
    StoryUNetConfig,
    VAEConfig,
)
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.data.protocol import (
    black_image,
    clip_preprocess,
    pixel_preprocess,
    white_image,
)
from rcdms_tpu_torch.io import convert as C
from rcdms_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from rcdms_tpu_torch.models.fusion import FusionModule
from rcdms_tpu_torch.models.prior import FramePrior
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.models.vae import VAE
from rcdms_tpu_torch.sample.pipeline import (
    CondCache,
    StoryInputs,
    StoryPipeline,
    for_inference,
)

logger = logging.getLogger("rcdms_tpu_torch.cli")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _safetensors_sibling(path: str) -> str:
    """The .safetensors file that diffusers / transformers place next to a
    .bin ('diffusion_pytorch_model.bin' -> '...safetensors',
    'pytorch_model.bin' -> 'model.safetensors'); any other path itself."""
    base = os.path.basename(path)
    if base == "pytorch_model.bin":  # transformers layout
        return os.path.join(os.path.dirname(path), "model.safetensors")
    return path[: -len(".bin")] + ".safetensors" if path.endswith(".bin") \
        else path


def _load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A diffusers / transformers weight file: its .safetensors sibling if
    there is one and `safetensors` imports, else the .bin through
    `torch.load(weights_only=True)`."""
    sibling = _safetensors_sibling(path)
    if os.path.exists(sibling):
        try:
            from safetensors.torch import load_file
        except ImportError:
            if sibling == path:
                raise
        else:
            return dict(load_file(sibling))
    return torch.load(path, map_location="cpu", weights_only=True)


def _find_weights(subdir: str) -> Optional[str]:
    for name in ("diffusion_pytorch_model.bin", "pytorch_model.bin",
                 "diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    return None


def _build(cls, cfg, pretrained: Optional[str], convert, dtype, device,
           seed: int) -> nn.Module:
    device = torch.device(device)
    with device:
        model = cls(cfg)
    init_like_flax_(model, torch.Generator(device).manual_seed(seed))
    if pretrained:
        path = _find_weights(pretrained)
        if path is None:
            raise FileNotFoundError(f"no weight file in {pretrained}")
        fresh = C.merge_into(model, convert(_load_torch_bin(path)))
        logger.info("%s: %d keys stay fresh-init", cls.__name__, len(fresh))
    return for_inference(model, dtype)


def build_text_encoder(cfg: CLIPTextConfig, pretrained: Optional[str],
                       dtype=torch.float32, device="cuda",
                       seed: int = 0) -> CLIPTextEncoder:
    """pretrained = a transformers CLIP text directory; the token table and
    positions are resized to the config's."""
    return _build(CLIPTextEncoder, cfg, pretrained,
                  lambda sd: C.convert_clip_text(sd, cfg, resize=True),
                  dtype, device, seed)


def build_vision_encoder(cfg: CLIPVisionConfig, pretrained: Optional[str],
                         dtype=torch.float32, device="cuda",
                         seed: int = 0) -> CLIPVisionEncoder:
    return _build(CLIPVisionEncoder, cfg, pretrained,
                  lambda sd: C.convert_clip_vision(sd, cfg), dtype, device,
                  seed)


def build_vae(cfg: VAEConfig, pretrained: Optional[str], dtype=torch.float32,
              device="cuda", seed: int = 0) -> VAE:
    return _build(VAE, cfg, pretrained, lambda sd: C.convert_sd_vae(sd, cfg),
                  dtype, device, seed)


def build_prior(cfg: PriorConfig, pretrained: Optional[str],
                dtype=torch.float32, device="cuda",
                seed: int = 0) -> FramePrior:
    """pretrained = a Kandinsky 2.2 prior directory: positional_embedding,
    the temporal modules and the new conditioning heads stay fresh (the
    reference's `from_pretrained_2d` surgery)."""
    def convert(sd):
        out = C.convert_kandinsky_prior(sd, cfg)
        prd = C.convert_prior_prd(sd)
        if prd is not None:
            out["prd_embedding"] = prd
        return out

    return _build(FramePrior, cfg, pretrained, convert, dtype, device, seed)


def build_unet(cfg: StoryUNetConfig, pretrained: Optional[str],
               dtype=torch.float32, device="cuda",
               seed: int = 0) -> StoryUNet:
    """pretrained = an SD1.5 unet directory; conv_in (9 channels) and the
    temporal modules stay fresh."""
    return _build(StoryUNet, cfg, pretrained,
                  lambda sd: C.convert_sd_unet(sd, cfg), dtype, device, seed)


def build_fusion(cfg: FusionConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0) -> FusionModule:
    return _build(FusionModule, cfg, None, None, dtype, device, seed)


def load_rcdms_blob(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Load the reference's DeepSpeed `mp_rank_00_model_states.pt` (or a
    bare state-dict .pt) and split it by prefix: {seen, unseen, unet,
    rest}. A checkpoint directory works too: DeepSpeed's `latest` tag is
    honoured; otherwise exactly one *model_states.pt may lie below it
    (several step directories without a tag are ambiguous and raise).

    Security note: checkpoints are pickle files. `--rcdms-*-ckpt` paths
    must be trusted — loading falls back to full (code-executing)
    unpickling when the weights-only load cannot parse the blob."""
    if os.path.isdir(path):
        tag_file = os.path.join(path, "latest")
        if os.path.isfile(tag_file):
            with open(tag_file) as fh:
                tag = fh.read().strip()
            tagged = os.path.join(path, tag)
            if os.path.isdir(tagged):
                path = tagged
        candidates = []
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                if name.endswith("model_states.pt"):
                    candidates.append(os.path.join(root, name))
        if not candidates:
            raise FileNotFoundError(f"no *model_states.pt under {path}")
        if len(candidates) > 1:
            raise ValueError(
                f"ambiguous checkpoint dir {path}: {len(candidates)} "
                f"*model_states.pt files ({candidates[:3]}...) and no "
                f"DeepSpeed 'latest' tag — pass the step directory "
                f"explicitly")
        path = candidates[0]
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        warnings.warn(
            f"weights-only load of {path} failed ({type(e).__name__}: {e});"
            " falling back to full unpickling — only do this with TRUSTED"
            " checkpoint files (arbitrary pickle code runs)")
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "module" in blob:
        blob = blob["module"]
    return C.split_deepspeed_blob(blob)


def load_rcdms_stage1(path: str, prior: FramePrior) -> FramePrior:
    """--rcdms-stage1-ckpt: a trained reference MyPriorTransformer blob into
    `prior`, in place. Raises, loading nothing, if any key would stay
    fresh: a trained checkpoint covers the whole tower."""
    converted = C.convert_rcdms_prior(load_rcdms_blob(path)["rest"],
                                      prior.cfg)
    fresh = C.fresh_keys(prior, converted)
    if fresh:
        raise ValueError(f"stage-1 checkpoint leaves {len(fresh)} params "
                         f"fresh-init ({fresh[:4]}...) — wrong config or "
                         f"truncated blob?")
    C.merge_into(prior, converted)
    return prior


def load_rcdms_stage2(path: str, unet: StoryUNet, fusion: FusionModule
                      ) -> Tuple[StoryUNet, FusionModule]:
    """--rcdms-stage2-ckpt: a trained reference SDModel blob (unet. /
    seen_module. / unseen_module. prefixes) into `unet` and `fusion`, in
    place. Raises, loading nothing, if any key would stay fresh."""
    parts = load_rcdms_blob(path)
    unet_conv = C.convert_rcdms_unet3d(parts["unet"], unet.cfg)
    fusion_conv = {f"{stack}.{k}": v
                   for stack, part in (("seen_module", "seen"),
                                       ("unseen_module", "unseen"))
                   for k, v in C.convert_fusion_stack(parts[part]).items()}
    for name, module, conv in (("unet", unet, unet_conv),
                               ("fusion", fusion, fusion_conv)):
        fresh = C.fresh_keys(module, conv)
        if fresh:
            raise ValueError(f"stage-2 checkpoint leaves {len(fresh)} {name} "
                             f"params fresh-init ({fresh[:4]}...) — wrong "
                             f"config or truncated blob?")
    C.merge_into(unet, unet_conv)
    C.merge_into(fusion, fusion_conv)
    return unet, fusion


def dataset_from_args(args) -> DatasetConfig:
    return DatasetConfig(name=args.dataset, h5_path=args.h5_path,
                         image_size=args.image_size,
                         sr_dir=getattr(args, "sr_dir", None))


def story_seed(seed: int, index: int) -> int:
    """The seed of story `index`'s generator: a hash of (seed, index), so a
    story's noise depends on neither its shard nor its neighbours."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0])


def _tokens(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows), dtype=torch.long, device=device)


def build_cond_cache(pipeline: StoryPipeline, dataset, ds_cfg: DatasetConfig,
                     negative_prompt: str = "") -> CondCache:
    """The story-independent conditioning, once per loaded model: the uncond
    caption through both text towers and the white/black mask images
    through the vision tower. Both stages share the tokenizer, so one
    tokenized row serves both."""
    row = dataset.tokenizer([negative_prompt])["input_ids"][0]
    return cond_cache_from_row(pipeline, ds_cfg, row, row)


def cond_cache_from_row(pipeline: StoryPipeline, ds_cfg: DatasetConfig,
                        uncond_row_s1, uncond_row_s2) -> CondCache:
    """build_cond_cache from already-tokenized (T,) uncond rows, one for
    each stage's text tower."""
    size, csize = ds_cfg.image_size, ds_cfg.clip_size
    dev = pipeline.device
    white = torch.from_numpy(clip_preprocess(white_image(size), csize))
    black = torch.from_numpy(clip_preprocess(black_image(size), csize))
    return pipeline.precompute_cond_cache(
        _tokens(uncond_row_s1, dev), _tokens(uncond_row_s2, dev),
        white.to(dev), black.to(dev))


def build_story_inputs(captions: Sequence[str],
                       reference_images: Sequence[np.ndarray],
                       negative_prompt: str, dataset, ds_cfg: DatasetConfig,
                       device="cuda") -> StoryInputs:
    """A batch-1 StoryInputs on `device` from raw user inputs.

    captions: num_frames strings; reference_images: 0..num_frames uint8
    (h, w, 3) arrays, the known-frame prefix (the reference's
    'visualization' / 'continue' modes, generalized to any prefix
    length)."""
    f = ds_cfg.num_frames
    if len(captions) != f:
        raise ValueError(f"need exactly {f} captions, got {len(captions)}")
    if len(reference_images) > f:
        raise ValueError(f"at most {f} reference frames, got "
                         f"{len(reference_images)}")
    size, csize = ds_cfg.image_size, ds_cfg.clip_size
    known = len(reference_images)

    black_px = pixel_preprocess(black_image(size), size)
    black_cl = clip_preprocess(black_image(size), csize)
    white_cl = clip_preprocess(white_image(size), csize)
    source_px = np.stack(
        [pixel_preprocess(reference_images[i], size) if i < known
         else black_px for i in range(f)])
    source_cl = np.stack(
        [clip_preprocess(reference_images[i], csize) if i < known
         else black_cl for i in range(f)])
    mask_cl = np.stack([white_cl if i < known else black_cl
                        for i in range(f)])

    toks = _tokens(dataset.tokenizer([c.lower() for c in captions])
                   ["input_ids"], device)[None]
    utoks = _tokens(dataset.tokenizer([negative_prompt] * f)["input_ids"],
                    device)[None]

    def put(a):
        return torch.from_numpy(a)[None].to(device)

    return StoryInputs(
        tokens_s1=toks, tokens_s1_u=utoks, tokens_s2=toks, tokens_s2_u=utoks,
        source_clip=put(source_cl), mask_clip=put(mask_cl),
        source_pixels=put(source_px),
        frame_known=put(np.arange(f) < known))


# ---------------------------------------------------------------------------
# the training CLIs' shared plumbing (train_stage1.py, train_stage2.py)
# ---------------------------------------------------------------------------

def step_generators(seed: int, step: int, device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(the encode's, the step's) generators of training step `step`,
    seeded from (seed, 2 step) and (seed, 2 step + 1) as the JAX CLIs fold
    2 step and 2 step + 1 into their key: a resumed run draws at a step
    what an unbroken run draws there."""
    return tuple(torch.Generator(device).manual_seed(
        story_seed(seed, 2 * step + k)) for k in (0, 1))


def batch_to_device(raw: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A protocol batch (numpy, possibly read-only views of the native
    feeder's ring) as tensors on `device`, copied, token ids as int64."""
    out = {}
    for k, v in raw.items():
        t = torch.from_numpy(np.array(v))
        if k.startswith("input_ids"):
            t = t.long()
        out[k] = t.to(device)
    return out


def add_training_flags(p, defaults) -> None:
    """The flags both training CLIs share, with the JAX CLIs' defaults
    (`defaults`: the stage's TrainConfig), and --device."""
    opt = defaults.optimizer
    p.add_argument("--learning-rate", type=float, default=opt.learning_rate)
    p.add_argument("--warmup-steps", type=int, default=opt.warmup_steps)
    p.add_argument("--max-train-steps", type=int, default=1_000_000)
    p.add_argument("--batch-size", type=int, default=defaults.batch_size,
                   help="global: each of N processes trains on batch-size "
                        "/ N rows")
    p.add_argument("--noise-offset", type=float,
                   default=defaults.noise_offset)
    p.add_argument("--max-grad-norm", type=float,
                   default=opt.grad_clip_norm)
    p.add_argument("--checkpointing-steps", type=int,
                   default=defaults.checkpoint_every)
    p.add_argument("--no-zero2", action="store_true",
                   help="replicate the optimizer state on every process "
                        "(by default each holds its ZeRO-2 cut)")
    p.add_argument("--accumulate-steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=defaults.seed)
    p.add_argument("--dtype", default=defaults.compute_dtype,
                   choices=["bfloat16", "float32"],
                   help="compute dtype of the trained model and the frozen "
                        "towers, over fp32 masters (the reference trains "
                        "fp16; norms and softmax statistics stay fp32)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the steps "
                        "[--profile-start, --profile-start + "
                        "--profile-steps) into this directory")
    p.add_argument("--profile-start", type=int, default=10)
    p.add_argument("--profile-steps", type=int, default=3)
    p.add_argument("--no-prefetch", action="store_true",
                   help="no background batch-prefetch thread")
    p.add_argument("--report-to", default="tensorboard",
                   help="comma list of trackers: tensorboard, wandb, "
                        "comet_ml (JSONL is always written; a tracker whose "
                        "package is missing is skipped)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda never falls back to the CPU")


def optimizer_config(args) -> OptimizerConfig:
    return OptimizerConfig(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        max_steps=args.max_train_steps, grad_clip_norm=args.max_grad_norm,
        accumulate_steps=args.accumulate_steps)


def local_batch(args) -> int:
    """This process's rows of the global --batch-size; exits unless the
    process group's size divides it."""
    from rcdms_tpu_torch.train import distributed, sharding

    _, world = distributed.rank_and_size()
    if args.batch_size % world:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by the "
            f"data-parallel device count {world}")
    return sharding.local_batch_size(args.batch_size)


def device_of(args) -> torch.device:
    """--device, refusing cuda where torch sees no card (no CPU
    fallback)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    return device


def train_dataset(args):
    """The dataset of the flags: tiny synthetic stories, or the h5 file's
    train split, with the native feeder's ring as deep as prefetching
    needs."""
    if args.synthetic:
        from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset

        return SyntheticStoryDataset()
    from rcdms_tpu_torch.data.datasets import StoryH5Dataset
    from rcdms_tpu_torch.data.prefetch import required_feeder_depth

    return StoryH5Dataset(
        dataset_from_args(args), "train", args.tokenizer_path,
        use_native_feeder=args.native_feeder,
        feeder_buffer_depth=(2 if args.no_prefetch
                             else required_feeder_depth(1)))


def trainable(module: nn.Module) -> nn.Module:
    """A builder's fp32 tower made trainable again (train mode, grads)."""
    return module.train().requires_grad_(True)


def load_masters(module: nn.Module, params: Dict[str, torch.Tensor],
                 prefix: str = "") -> nn.Module:
    """The fp32 masters of a training checkpoint whose names start with
    `prefix` into `module`'s parameters, in place (each keeps its device
    and dtype). Raises unless they name every parameter exactly."""
    own = dict(module.named_parameters())
    theirs = {n[len(prefix):]: t for n, t in params.items()
              if n.startswith(prefix)}
    if set(own) != set(theirs):
        raise KeyError(f"checkpoint masters under {prefix!r} and "
                       f"{type(module).__name__}'s parameters differ: "
                       f"{sorted(set(own) ^ set(theirs))[:5]}")
    with torch.no_grad():
        for n, p in own.items():
            if p.shape != theirs[n].shape:
                raise ValueError(f"{prefix}{n}: checkpoint "
                                 f"{tuple(theirs[n].shape)}, model "
                                 f"{tuple(p.shape)}")
            p.copy_(theirs[n])
    return module


class TrainRun(NamedTuple):
    """What a training CLI's `run` returns: the state, the frozen towers
    (in the order the stage's `encode_batch` takes them) and the global
    step reached."""

    state: object
    towers: tuple
    step: int


def train_loop(args, state, towers, encode: Callable, dataset, device,
               batch_size: int) -> TrainRun:
    """The JAX CLIs' loop, on one process or on each rank of a process
    group (`train/distributed.py`), `batch_size` rows a rank
    (`local_batch`). Each step: the profile window's tick, the rank's next
    batch (its shard of the dataset, prefetched unless --no-prefetch), the
    data timer, `encode(raw, generator)` (the frozen towers, no grad),
    then `train.loop.train_step` on the step's generator; a log line at
    --log-every and at the first step (the only points where the loss
    comes to the host, its mean over the ranks), a checkpoint every
    --checkpointing-steps, a SIGTERM check (collective: every rank stops
    at the same step). A final save after the loop; a SIGTERM saves at
    the step boundary and returns. Rank 0 alone writes the metrics and
    the checkpoints; each rank's profile goes to its own subdirectory."""
    from rcdms_tpu_torch.data.prefetch import PrefetchIterator
    from rcdms_tpu_torch.io.checkpoint import (
        restore_checkpoint,
        save_train_state,
    )
    from rcdms_tpu_torch.train import distributed
    from rcdms_tpu_torch.train.loop import train_step
    from rcdms_tpu_torch.utils.logging import (
        MetricLogger,
        ProfileWindow,
        StepTimer,
    )
    from rcdms_tpu_torch.utils.preemption import PreemptionGuard

    rank, world = distributed.rank_and_size()
    lead = rank == 0
    log = MetricLogger(args.output_dir,
                       report_to=tuple(args.report_to.split(",")),
                       run_config=vars(args)) if lead else None
    start_step = 0
    if args.resume_from_checkpoint:
        # every rank reads the file and keeps its cut of the moments
        restored, _, start_step = restore_checkpoint(
            args.resume_from_checkpoint)
        state.load_state_dicts(restored)
        del restored
        if lead:
            print(f"resumed from step {start_step}")

    def save(step: int, **meta) -> None:
        save_train_state(args.output_dir, step, state,
                         {"last_global_step": step, **meta})

    # this rank's shard of the dataset (shard 0 of 1 for one process); the
    # data iterator restarts on resume, as the JAX CLIs' does
    batches = dataset.batches(batch_size, seed=args.seed, shard_id=rank,
                              num_shards=world)
    if not args.no_prefetch:
        # overlap host decode and packing with the card's step; the native
        # feeder's ring is sized for this depth (train_dataset)
        batches = PrefetchIterator(batches, depth=1)
    guard = PreemptionGuard.install()
    profile_dir = args.profile_dir
    if profile_dir is not None and distributed.active():
        profile_dir = os.path.join(profile_dir, f"rank{rank}")
    profiler = ProfileWindow(profile_dir, args.profile_start,
                             args.profile_steps)
    timer = StepTimer()
    try:
        for step_i in range(start_step, args.max_train_steps):
            profiler.tick(step_i)
            raw = batch_to_device(next(batches), device)
            timer.data_loaded()
            encode_gen, step_gen = step_generators(args.seed, step_i, device)
            with torch.no_grad():
                batch = encode(raw, encode_gen)
            loss = train_step(state, batch, generator=step_gen)
            del raw, batch
            if step_i % args.log_every == 0 or step_i == start_step:
                # the global batch's loss; waits for the card
                loss = distributed.mean_over_ranks(loss).item()
                step_time, data_time = timer.step_done()
                if lead:
                    log.log(step_i, {"loss": loss, "step_time": step_time,
                                     "data_time": data_time})
                    print(f"step {step_i} loss {loss:.5f} ({step_time:.2f}s "
                          f"step, {data_time:.2f}s data)", flush=True)
            else:
                timer.step_done()
            if (step_i + 1) % args.checkpointing_steps == 0:
                save(step_i + 1)
            if guard.should_stop_global():
                # SIGTERM (preemption): save at the step boundary, exit
                # cleanly
                save(step_i + 1, preempted=True)
                if lead:
                    print(f"preempted: checkpoint saved at step "
                          f"{step_i + 1}", flush=True)
                return TrainRun(state, towers, step_i + 1)
        save(args.max_train_steps)
        return TrainRun(state, towers, args.max_train_steps)
    finally:
        profiler.close()
        if isinstance(batches, PrefetchIterator):
            batches.close()
        guard.uninstall()
        if log is not None:
            log.close()
