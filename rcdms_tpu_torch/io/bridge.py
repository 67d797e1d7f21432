"""Flax parameter trees (numpy leaves) -> torch state dicts for every tower
of the port: the inverse of `rcdms_tpu/io/convert.py`. A JAX training
state crosses too (`train_state_dicts`): its parameters, the optax Adam
moments (trees shaped as the parameters, through the same functions), the
accumulated gradients of `optax.MultiSteps`, and the counts.

The state-dict names are the diffusers / HF / reference names that
`convert.py` reads, so `convert_*(to_*_state_dict(params))` gives the flax
tree back, and the port's modules load these dicts strictly.

Conventions (convert.py's, reversed): Dense kernel (in, out) -> Linear
weight (out, in); Conv kernel (kh, kw, in, out) -> Conv2d weight
(out, in, kh, kw); norm scale/bias -> weight/bias.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from rcdms_tpu_torch.configs import PriorConfig, StoryUNetConfig, VAEConfig

SD = Dict[str, np.ndarray]


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _put(sd: SD, prefix: str, leaves: SD) -> None:
    for k, v in leaves.items():
        sd[f"{prefix}.{k}"] = v


def _linear(p) -> SD:
    out = {"weight": np.ascontiguousarray(_a(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def _conv(p) -> SD:
    out = {"weight": np.ascontiguousarray(
        _a(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def hwio_to_conv_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """A JAX conv kernel (kh, kw, in, out) as a tensor -> the torch Conv2d
    weight (out, in, kh, kw), contiguous, on the same device."""
    return w_hwio.permute(3, 2, 0, 1).contiguous()


def _norm(p) -> SD:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def _layernorm(p) -> SD:
    return _norm(p["ln"])


def _attention(sd: SD, prefix: str, p) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _put(sd, f"{prefix}.{name}", _linear(p[name]))
    _put(sd, f"{prefix}.to_out.0", _linear(p["to_out"]))


def _feedforward(sd: SD, prefix: str, p) -> None:
    _put(sd, f"{prefix}.net.0.proj", _linear(p["proj_in"]))
    _put(sd, f"{prefix}.net.2", _linear(p["proj_out"]))


def _basic_block(sd: SD, prefix: str, p) -> None:
    for n in ("norm1", "norm2", "norm3"):
        if n in p:
            _put(sd, f"{prefix}.{n}", _layernorm(p[n]))
    for n in ("attn1", "attn2"):
        if n in p:
            _attention(sd, f"{prefix}.{n}", p[n])
    _feedforward(sd, f"{prefix}.ff", p["ff"])


def _spatial_transformer(sd: SD, prefix: str, p) -> None:
    _put(sd, f"{prefix}.norm", _norm(p["norm"]))
    _put(sd, f"{prefix}.proj_in", _linear(p["proj_in"]))
    _put(sd, f"{prefix}.proj_out", _linear(p["proj_out"]))
    i = 0
    while f"block_{i}" in p:
        _basic_block(sd, f"{prefix}.transformer_blocks.{i}", p[f"block_{i}"])
        i += 1


def _temporal(sd: SD, prefix: str, p) -> None:
    tt = f"{prefix}.temporal_transformer"
    if "prior_norm" in p:
        _put(sd, f"{tt}.prior_norm", _layernorm(p["prior_norm"]))
    else:
        _put(sd, f"{tt}.norm", _norm(p["norm"]))
    _put(sd, f"{tt}.proj_in", _linear(p["proj_in"]))
    _put(sd, f"{tt}.proj_out", _linear(p["proj_out"]))
    k = 0
    while f"block_{k}" in p:
        bp, blk = f"{tt}.transformer_blocks.{k}", p[f"block_{k}"]
        j = 0
        while f"attn_{j}" in blk:
            _put(sd, f"{bp}.norms.{j}", _layernorm(blk[f"norm_{j}"]))
            _attention(sd, f"{bp}.attention_blocks.{j}", blk[f"attn_{j}"])
            j += 1
        _put(sd, f"{bp}.ff_norm", _layernorm(blk["ff_norm"]))
        _feedforward(sd, f"{bp}.ff", blk["ff"])
        k += 1


def _resnet(sd: SD, prefix: str, p) -> None:
    _put(sd, f"{prefix}.norm1", _norm(p["norm1"]))
    _put(sd, f"{prefix}.conv1", _conv(p["conv1"]["conv"]))
    _put(sd, f"{prefix}.norm2", _norm(p["norm2"]))
    _put(sd, f"{prefix}.conv2", _conv(p["conv2"]["conv"]))
    if "time_emb_proj" in p:
        _put(sd, f"{prefix}.time_emb_proj", _linear(p["time_emb_proj"]))
    if "conv_shortcut" in p:
        _put(sd, f"{prefix}.conv_shortcut", _conv(p["conv_shortcut"]["conv"]))


def _sub_block(sd: SD, prefix: str, j: int, p) -> None:
    _resnet(sd, f"{prefix}.resnets.{j}", p["resnet"])
    if "attn" in p:
        _spatial_transformer(sd, f"{prefix}.attentions.{j}", p["attn"])
    if "temporal" in p:
        _temporal(sd, f"{prefix}.motion_modules.{j}", p["temporal"])


def _time_embedding(sd: SD, prefix: str, p) -> None:
    _put(sd, f"{prefix}.linear_1", _linear(p["linear_1"]))
    _put(sd, f"{prefix}.linear_2", _linear(p["linear_2"]))


def unet_state_dict(params: Mapping, cfg: StoryUNetConfig) -> SD:
    p = _unwrap(params)
    sd: SD = {}
    _time_embedding(sd, "time_embedding", p["time_embedding"])
    _put(sd, "conv_in", _conv(p["conv_in"]["conv"]))
    n = len(cfg.block_channels)
    for level in range(n):
        for j in range(cfg.layers_per_block):
            _sub_block(sd, f"down_blocks.{level}", j, p[f"down_{level}_{j}"])
        if level != n - 1:
            _put(sd, f"down_blocks.{level}.downsamplers.0.conv",
                 _conv(p[f"down_{level}_downsample"]["conv"]["conv"]))
    _resnet(sd, "mid_block.resnets.0", p["mid_resnet_0"])
    _spatial_transformer(sd, "mid_block.attentions.0", p["mid_attn"])
    if "mid_temporal" in p:
        _temporal(sd, "mid_block.motion_modules.0", p["mid_temporal"])
    _resnet(sd, "mid_block.resnets.1", p["mid_resnet_1"])
    for level in range(n):
        for j in range(cfg.layers_per_block + 1):
            _sub_block(sd, f"up_blocks.{level}", j, p[f"up_{level}_{j}"])
        if level != n - 1:
            _put(sd, f"up_blocks.{level}.upsamplers.0.conv",
                 _conv(p[f"up_{level}_upsample"]["conv"]["conv"]))
    _put(sd, "conv_norm_out", _norm(p["conv_norm_out"]))
    _put(sd, "conv_out", _conv(p["conv_out"]["conv"]))
    return sd


def prior_state_dict(params: Mapping, cfg: PriorConfig) -> SD:
    p = _unwrap(params)
    sd: SD = {}
    _time_embedding(sd, "time_embedding", p["time_embedding"])
    for name in ("encoder_hidden_states_proj", "embedding_proj",
                 "embedding_proj1", "embedding_proj2", "proj_in",
                 "proj_to_clip_embeddings"):
        _put(sd, name, _linear(p[name]))
    _put(sd, "norm_out", _layernorm(p["norm_out"]))
    sd["prd_embedding"] = _a(p["prd_embedding"])[0]
    sd["positional_embedding"] = _a(p["positional_embedding"])[0]
    for i in range(cfg.num_layers):
        _basic_block(sd, f"transformer_blocks.{2 * i}", p[f"block_{i}"])
        if cfg.use_temporal:
            _temporal(sd, f"transformer_blocks.{2 * i + 1}",
                      p[f"temporal_{i}"])
    return sd


def _vae_resnet(sd: SD, prefix: str, p) -> None:
    for n in ("norm1", "norm2"):
        _put(sd, f"{prefix}.{n}", _norm(p[n]))
    for n in ("conv1", "conv2", "conv_shortcut"):
        if n in p:
            _put(sd, f"{prefix}.{n}", _conv(p[n]))


def _vae_mid(sd: SD, prefix: str, p) -> None:
    _vae_resnet(sd, f"{prefix}.resnets.0", p["mid_block_0"])
    a = p["mid_attn"]
    _put(sd, f"{prefix}.attentions.0.group_norm", _norm(a["norm"]))
    _attention(sd, f"{prefix}.attentions.0", a)
    _vae_resnet(sd, f"{prefix}.resnets.1", p["mid_block_1"])


def vae_state_dict(params: Mapping, cfg: VAEConfig) -> SD:
    p = _unwrap(params)
    enc, dec = p["encoder"], p["decoder"]
    n = len(cfg.block_channels)
    sd: SD = {}
    _put(sd, "encoder.conv_in", _conv(enc["conv_in"]))
    for level in range(n):
        for j in range(cfg.layers_per_block):
            _vae_resnet(sd, f"encoder.down_blocks.{level}.resnets.{j}",
                        enc[f"down_{level}_{j}"])
        if level != n - 1:
            _put(sd, f"encoder.down_blocks.{level}.downsamplers.0.conv",
                 _conv(enc[f"down_{level}_downsample"]))
    _vae_mid(sd, "encoder.mid_block", enc)
    _put(sd, "encoder.conv_norm_out", _norm(enc["conv_norm_out"]))
    _put(sd, "encoder.conv_out", _conv(enc["conv_out"]))
    _put(sd, "quant_conv", _conv(enc["quant_conv"]))

    _put(sd, "post_quant_conv", _conv(dec["post_quant_conv"]))
    _put(sd, "decoder.conv_in", _conv(dec["conv_in"]))
    _vae_mid(sd, "decoder.mid_block", dec)
    for level in range(n):
        for j in range(cfg.layers_per_block + 1):
            _vae_resnet(sd, f"decoder.up_blocks.{level}.resnets.{j}",
                        dec[f"up_{level}_{j}"])
        if level != n - 1:
            _put(sd, f"decoder.up_blocks.{level}.upsamplers.0.conv",
                 _conv(dec[f"up_{level}_upsample"]))
    _put(sd, "decoder.conv_norm_out", _norm(dec["conv_norm_out"]))
    _put(sd, "decoder.conv_out", _conv(dec["conv_out"]))
    return sd


def _clip_layers(sd: SD, prefix: str, p) -> None:
    i = 0
    while f"layer_{i}" in p:
        lp, q = f"{prefix}.encoder.layers.{i}", p[f"layer_{i}"]
        _put(sd, f"{lp}.layer_norm1", _norm(q["layer_norm1"]))
        _put(sd, f"{lp}.layer_norm2", _norm(q["layer_norm2"]))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put(sd, f"{lp}.self_attn.{n}", _linear(q[n]))
        _put(sd, f"{lp}.mlp.fc1", _linear(q["fc1"]))
        _put(sd, f"{lp}.mlp.fc2", _linear(q["fc2"]))
        i += 1


def clip_text_state_dict(params: Mapping) -> SD:
    p = _unwrap(params)
    sd: SD = {
        "text_model.embeddings.token_embedding.weight":
            _a(p["token_embedding"]["embedding"]),
        "text_model.embeddings.position_embedding.weight":
            _a(p["position_embedding"]),
    }
    _clip_layers(sd, "text_model", p)
    _put(sd, "text_model.final_layer_norm", _norm(p["final_layer_norm"]))
    _put(sd, "text_projection", _linear(p["text_projection"]))
    return sd


def clip_vision_state_dict(params: Mapping) -> SD:
    p = _unwrap(params)
    e = "vision_model.embeddings"
    sd: SD = {
        f"{e}.patch_embedding.weight": _conv(p["patch_embedding"])["weight"],
        f"{e}.class_embedding": _a(p["class_embedding"]),
        f"{e}.position_embedding.weight": _a(p["position_embedding"]),
    }
    _put(sd, "vision_model.pre_layrnorm", _norm(p["pre_layernorm"]))
    _clip_layers(sd, "vision_model", p)
    _put(sd, "vision_model.post_layernorm", _norm(p["post_layernorm"]))
    _put(sd, "visual_projection", _linear(p["visual_projection"]))
    return sd


def fusion_state_dict(params: Mapping) -> SD:
    p = _unwrap(params)
    sd: SD = {}
    for stack in ("seen_module", "unseen_module"):
        s, a = p[stack], p[stack]["attn"]
        _put(sd, f"{stack}.text_fc", _linear(s["text_fc"]))
        _put(sd, f"{stack}.vis_fc", _linear(s["vis_fc"]))
        qkv = [_linear(a[n]) for n in ("to_q", "to_k", "to_v")]
        m = f"{stack}.multihead_attn"
        sd[f"{m}.in_proj_weight"] = np.concatenate([t["weight"] for t in qkv])
        sd[f"{m}.in_proj_bias"] = np.concatenate([t["bias"] for t in qkv])
        _put(sd, f"{m}.out_proj", _linear(a["to_out"]))
    return sd


def pipeline_state_dicts(params: Mapping, configs) -> Dict[str, SD]:
    """The JAX pipeline's params dict (keys text_s1, text_s2, vision, vae,
    prior, unet, fusion) -> one state dict per tower of
    `rcdms_tpu_torch.sample.pipeline.StoryPipeline`."""
    return {
        "text_s1": clip_text_state_dict(params["text_s1"]),
        "text_s2": clip_text_state_dict(params["text_s2"]),
        "vision": clip_vision_state_dict(params["vision"]),
        "vae": vae_state_dict(params["vae"], configs.vae),
        "prior": prior_state_dict(params["prior"], configs.prior),
        "unet": unet_state_dict(params["unet"], configs.unet),
        "fusion": fusion_state_dict(params["fusion"]),
    }


def load_state_dict(module: torch.nn.Module, sd: SD) -> None:
    """Strictly load a numpy state dict into `module`, keeping each
    parameter's device and dtype."""
    ref = module.state_dict()
    module.load_state_dict({
        k: torch.tensor(np.asarray(v)).to(
            ref[k].device if k in ref else "cpu",
            ref[k].dtype if k in ref else torch.float32)
        for k, v in sd.items()}, strict=True)


def load_pipeline_params(pipeline: torch.nn.Module, params: Mapping) -> None:
    """Load a JAX pipeline's params into a `StoryPipeline` in place."""
    for tower, sd in pipeline_state_dicts(params, pipeline.configs).items():
        load_state_dict(getattr(pipeline, tower), sd)


def stage1_state_dict(params: Mapping, cfg: PriorConfig) -> SD:
    """The JAX stage-1 trainable tree (the prior's) -> the state dict of
    `train.stage1.Stage1Trainer`."""
    return {f"prior.{k}": v for k, v in prior_state_dict(params, cfg).items()}


def stage2_state_dict(params: Mapping, cfg: StoryUNetConfig) -> SD:
    """The JAX stage-2 trainable tree {"params": {"unet", "fusion"}} -> the
    state dict of `train.stage2.Stage2Trainer`."""
    p = _unwrap(params)
    sd = {f"unet.{k}": v for k, v in unet_state_dict(p["unet"], cfg).items()}
    sd.update({f"fusion.{k}": v
               for k, v in fusion_state_dict(p["fusion"]).items()})
    return sd


def _states_with(tree, name: str) -> list:
    """The optax states (NamedTuples) in `tree` that have a field `name`,
    depth first; parameter trees (dicts) are not entered."""
    if isinstance(tree, tuple):
        found = [tree] if name in getattr(tree, "_fields", ()) else []
        return found + [s for v in tree for s in _states_with(v, name)]
    return []


def _one(states: list, what: str):
    if len(states) != 1:
        raise ValueError(f"expected one {what} in the optimizer state, "
                         f"found {len(states)}")
    return states[0]


def train_state_dicts(state, to_state_dict: Callable[[Mapping], SD]
                      ) -> dict:
    """A JAX `TrainState` (numpy leaves, e.g. after `jax.device_get`) of
    `rcdms_tpu.train.optim.make_optimizer`'s chain -> "params", "mu",
    "nu" and "acc" (None without accumulation) as state dicts by the
    port's names (`to_state_dict`: `stage1_state_dict` or
    `stage2_state_dict` with its config bound), and the ints "count"
    (Adam's), "mini_step", "gradient_step" and "step", as
    `train.train_state.TrainState.load_state_dicts` takes them."""
    adam = _one(_states_with(state.opt_state, "nu"), "Adam state")
    multi = _states_with(state.opt_state, "mini_step")
    multi = _one(multi, "MultiSteps state") if multi else None
    return dict(
        params=to_state_dict(state.params), mu=to_state_dict(adam.mu),
        nu=to_state_dict(adam.nu),
        acc=None if multi is None else to_state_dict(multi.acc_grads),
        count=int(adam.count), step=int(state.step),
        mini_step=0 if multi is None else int(multi.mini_step),
        gradient_step=0 if multi is None else int(multi.gradient_step))
