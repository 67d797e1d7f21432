"""Shared CLI plumbing — the counterpart of `rcdms_tpu/cli/common.py`:
tower builders (seeded random init, or a pretrained diffusers / HF
directory converted by `io/convert.py`), the trained reference checkpoint
loaders, and the inputs and conditioning cache of a story.

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
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    DatasetConfig,
    FusionConfig,
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
