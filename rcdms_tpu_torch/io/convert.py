"""Torch state dicts in the diffusers / HF / reference layout -> the port's
state-dict names — the counterpart of `rcdms_tpu/io/convert.py`.

The port's modules carry the reference's names (`io/bridge.py` writes the
names that the JAX converters read, and the port loads them strictly), so
most converters only select the keys their JAX counterpart reads and drop
the rest. The real work is at a few sites:

  * `convert_kandinsky_prior`: Kandinsky block i -> `transformer_blocks.{2i}`
    (the port interleaves attention blocks and temporal modules, as the
    reference does); `positional_embedding` is dropped and the temporal
    modules and `embedding_proj1/2` stay fresh;
  * `convert_clip_text`: the token table grows to the dataset's vocab and
    the positions to its caption length (`resize_text_embeddings`);
  * `convert_clip_vision`: either spelling of the pre-LayerNorm;
  * `convert_sd_vae`: both attention namings (`query`/`key`/`value`/
    `proj_attn` and `to_q`/`to_k`/`to_v`/`to_out.0`), 1x1-conv attention
    weights, `nin_shortcut`;
  * `convert_sd_unet`: the 4-channel `conv_in` and the temporal modules
    stay fresh; SD's 1x1-conv `proj_in` / `proj_out` load through the
    spatial transformer's load hook;
  * `split_deepspeed_blob`: a DeepSpeed blob split by submodule prefix.

`merge_into` loads a converted dict into a module and returns the keys
left at their fresh init, with `merge_params`'s rules: a converted key the
module lacks raises KeyError, a shape mismatch ValueError.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from rcdms_tpu_torch.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    PriorConfig,
    StoryUNetConfig,
    VAEConfig,
)

SD = Mapping[str, torch.Tensor]


def _head(key: str) -> str:
    return key.split(".", 1)[0]


def _select(sd: SD, heads) -> Dict[str, torch.Tensor]:
    """The entries whose first name component is one of `heads`."""
    return {k: v for k, v in sd.items() if _head(k) in heads}


def _layers_below(sd: SD, prefix: str, n: int) -> Dict[str, torch.Tensor]:
    """The entries `{prefix}{i}.*` with i < n (the layers a config has)."""
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    out = {}
    for k, v in sd.items():
        m = pat.match(k)
        if m and int(m.group(1)) < n:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# SD1.5 UNet / trained reference UNet3D -> StoryUNet
# ---------------------------------------------------------------------------

_UNET_HEADS = ("time_embedding", "down_blocks", "mid_block", "up_blocks",
               "conv_norm_out", "conv_out")


def convert_sd_unet(sd: SD, cfg: StoryUNetConfig) -> Dict[str, torch.Tensor]:
    """diffusers UNet2DConditionModel (SD1.5) -> a partial StoryUNet dict.
    Leaves out conv_in (9 channels, trained fresh) and every temporal
    module (fresh); `merge_into` keeps their init."""
    return {k: v for k, v in _select(sd, _UNET_HEADS).items()
            if ".motion_modules." not in k}


def convert_rcdms_unet3d(sd: SD, cfg: StoryUNetConfig
                         ) -> Dict[str, torch.Tensor]:
    """A trained reference UNet3D (9-channel conv_in, motion modules of the
    down and up levels) -> the full StoryUNet dict."""
    out = convert_sd_unet(sd, cfg)
    out.update(_select(sd, ("conv_in",)))
    if cfg.use_temporal:
        out.update({k: v for k, v in sd.items()
                    if ".motion_modules." in k
                    and _head(k) in ("down_blocks", "up_blocks")})
    return out


# ---------------------------------------------------------------------------
# Kandinsky-2.2 prior / trained reference prior -> FramePrior
# ---------------------------------------------------------------------------

_PRIOR_HEADS = ("time_embedding", "proj_in", "embedding_proj",
                "encoder_hidden_states_proj", "norm_out",
                "proj_to_clip_embeddings")


def convert_kandinsky_prior(sd: SD, cfg: PriorConfig
                            ) -> Dict[str, torch.Tensor]:
    """diffusers PriorTransformer (Kandinsky 2.2) -> a partial FramePrior
    dict: block i -> `transformer_blocks.{2 * i}` for the config's layers.
    Leaves out positional_embedding (the 97-token table is trained fresh),
    embedding_proj1/2 and the temporal modules (`transformer_blocks.{odd}`),
    which keep their init; prd_embedding comes from `convert_prior_prd`.

    All pretrained blocks land in order: the reference's strict=False load
    into its interleaved list keeps only the even Kandinsky blocks, in
    slots 0-9, and this does not copy that."""
    out = _select(sd, _PRIOR_HEADS)
    pat = re.compile(r"transformer_blocks\.(\d+)\.(.*)")
    for k, v in sd.items():
        m = pat.fullmatch(k)
        if m and int(m.group(1)) < cfg.num_layers:
            out[f"transformer_blocks.{2 * int(m.group(1))}.{m.group(2)}"] = v
    return out


def convert_prior_prd(sd: SD) -> Optional[torch.Tensor]:
    """The prd token (1, 1, inner), or None."""
    return sd.get("prd_embedding")


def convert_rcdms_prior(sd: SD, cfg: PriorConfig) -> Dict[str, torch.Tensor]:
    """A trained reference MyPriorTransformer -> the full FramePrior dict:
    `transformer_blocks.{2i}` is the i-th attention block,
    `transformer_blocks.{2i+1}` the i-th temporal module."""
    out = _select(sd, _PRIOR_HEADS + ("embedding_proj1", "embedding_proj2",
                                      "positional_embedding",
                                      "prd_embedding"))
    for k, v in _layers_below(sd, "transformer_blocks.",
                              2 * cfg.num_layers).items():
        if cfg.use_temporal or int(k.split(".")[1]) % 2 == 0:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# SD VAE -> VAE
# ---------------------------------------------------------------------------

_VAE_ATTN_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                   "proj_attn": "to_out.0"}
_VAE_ATTN = re.compile(r"((?:en|de)coder\.mid_block\.attentions\.0)\."
                       r"(query|key|value|proj_attn|to_q|to_k|to_v|to_out\.0)"
                       r"\.(weight|bias)")


def _vae_attn(key: str, v: torch.Tensor):
    """Either diffusers attention naming -> to_q/to_k/to_v/to_out.0, with a
    1x1-conv weight as the Linear weight."""
    m = _VAE_ATTN.fullmatch(key)
    if m is None:
        return key, v
    name = _VAE_ATTN_NAMES.get(m.group(2), m.group(2))
    if v.dim() == 4:
        v = v[:, :, 0, 0]
    return f"{m.group(1)}.{name}.{m.group(3)}", v


def convert_sd_vae(sd: SD, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in _select(sd, ("encoder", "decoder", "quant_conv",
                             "post_quant_conv")).items():
        k, v = _vae_attn(k, v)
        if ".nin_shortcut." in k:  # the original LDM naming
            k = k.replace(".nin_shortcut.", ".conv_shortcut.")
        if ".conv_shortcut.weight" in k and v.dim() == 2:
            v = v[:, :, None, None]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# CLIP towers (HF transformers naming)
# ---------------------------------------------------------------------------


def resize_text_embeddings(token_table: np.ndarray, pos_table: np.ndarray,
                           vocab_size: int, max_positions: int,
                           rng: Optional[np.random.RandomState] = None
                           ) -> tuple:
    """HF `resize_token_embeddings` + position resize: new rows ~
    N(mean, std) of the old rows, drawn from RandomState(0) (tokens, then
    positions); shrinking truncates. numpy float32 in and out, so the rows
    equal the JAX package's draws bit for bit."""
    rng = rng or np.random.RandomState(0)

    def grow(table, n):
        if n <= len(table):
            return table[:n].copy()
        mean = table.mean(axis=0)
        std = table.std(axis=0)
        extra = rng.normal(size=(n - len(table), table.shape[1])) * std + mean
        return np.concatenate([table, extra.astype(table.dtype)], axis=0)

    return grow(token_table, vocab_size), grow(pos_table, max_positions)


def _clip_prefix(sd: SD, tower: str) -> str:
    return f"{tower}." if any(k.startswith(f"{tower}.") for k in sd) else ""


def convert_clip_text(sd: SD, cfg: CLIPTextConfig,
                      resize: bool = True) -> Dict[str, torch.Tensor]:
    pre = _clip_prefix(sd, "text_model")
    tok = sd[f"{pre}embeddings.token_embedding.weight"]
    pos = sd[f"{pre}embeddings.position_embedding.weight"]
    if resize:
        tok, pos = (torch.from_numpy(t) for t in resize_text_embeddings(
            tok.float().numpy(), pos.float().numpy(), cfg.vocab_size,
            cfg.max_positions))
    out = {"text_model.embeddings.token_embedding.weight": tok,
           "text_model.embeddings.position_embedding.weight": pos}
    for name in ("final_layer_norm.weight", "final_layer_norm.bias"):
        out[f"text_model.{name}"] = sd[f"{pre}{name}"]
    for k, v in _layers_below(sd, f"{pre}encoder.layers.",
                              cfg.num_layers).items():
        out["text_model." + k[len(pre):]] = v
    if "text_projection.weight" in sd:
        out["text_projection.weight"] = sd["text_projection.weight"]
    return out


def convert_clip_vision(sd: SD, cfg: CLIPVisionConfig
                        ) -> Dict[str, torch.Tensor]:
    pre = _clip_prefix(sd, "vision_model")
    e = f"{pre}embeddings"
    # HF's historical "pre_layrnorm" spelling, which the port keeps
    ln = (f"{pre}pre_layrnorm" if f"{pre}pre_layrnorm.weight" in sd
          else f"{pre}pre_layernorm")
    out = {
        "vision_model.embeddings.patch_embedding.weight":
            sd[f"{e}.patch_embedding.weight"],
        "vision_model.embeddings.class_embedding":
            sd[f"{e}.class_embedding"].reshape(-1),
        "vision_model.embeddings.position_embedding.weight":
            sd[f"{e}.position_embedding.weight"],
    }
    for part in ("weight", "bias"):
        out[f"vision_model.pre_layrnorm.{part}"] = sd[f"{ln}.{part}"]
        out[f"vision_model.post_layernorm.{part}"] = \
            sd[f"{pre}post_layernorm.{part}"]
    for k, v in _layers_below(sd, f"{pre}encoder.layers.",
                              cfg.num_layers).items():
        out["vision_model." + k[len(pre):]] = v
    if "visual_projection.weight" in sd:
        out["visual_projection.weight"] = sd["visual_projection.weight"]
    return out


# ---------------------------------------------------------------------------
# Fusion stacks and trained reference blobs
# ---------------------------------------------------------------------------


def convert_fusion_stack(sd: SD, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A fine/semantic stack (text_fc, vis_fc and a torch
    nn.MultiheadAttention, packed in_proj) -> one CrossFeatureStack's
    dict; the port keeps the packing."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return _select(sub, ("text_fc", "vis_fc", "multihead_attn"))


def split_deepspeed_blob(module_sd: SD) -> Dict[str, Dict[str, torch.Tensor]]:
    """Split the reference's DeepSpeed `mp_rank_00_model_states.pt`
    `['module']` dict by prefix — seen_module. / unseen_module. / unet. —
    and strip a leading 'module.' (the stage-1 resume layout)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {
        "seen": {}, "unseen": {}, "unet": {}, "rest": {}}
    for k, v in module_sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("seen_module."):
            out["seen"][k[len("seen_module."):]] = v
        elif k.startswith("unseen_module."):
            out["unseen"][k[len("unseen_module."):]] = v
        elif k.startswith("unet."):
            out["unet"][k[len("unet."):]] = v
        else:
            out["rest"][k] = v
    return out


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def fresh_keys(module: nn.Module, converted: SD) -> List[str]:
    """The module's state-dict keys that `converted` leaves at their fresh
    init. Raises, as `merge_params` does, for a converted key the module
    lacks (KeyError) or of another shape (ValueError); a 1x1-conv weight
    (out, in, 1, 1) fits a Linear (out, in), as the load hooks take it."""
    own = module.state_dict()
    unknown = sorted(set(converted) - set(own))
    if unknown:
        raise KeyError(f"converted keys not in {type(module).__name__}: "
                       f"{unknown[:8]} (module keys: {sorted(own)[:8]}...)")
    for k, v in converted.items():
        want, got = tuple(own[k].shape), tuple(v.shape)
        if got != want and got != want + (1, 1):
            raise ValueError(f"shape mismatch at {k}: model {want} vs "
                             f"checkpoint {got}")
    return sorted(set(own) - set(converted))


def merge_into(module: nn.Module, converted: SD) -> List[str]:
    """Load `converted` into `module` in place (each parameter keeps its
    device and dtype) and return the keys left fresh."""
    fresh = fresh_keys(module, converted)
    module.load_state_dict(dict(converted), strict=False)
    return fresh
