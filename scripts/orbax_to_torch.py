"""Convert a checkpoint of the JAX package (orbax) into the PyTorch port's
checkpoint format (`rcdms_tpu_torch/io/checkpoint.py`).

    python scripts/orbax_to_torch.py --ckpt runs/stage2 \
        --output-dir runs_torch/stage2 [--dataset pororosv | --tiny] \
        [--kind stage1|stage2|converted] [--step N]

Runs where jax and orbax are installed (the port itself never imports
them). The checkpoint is restored with `rcdms_tpu.io.checkpoint`'s
`restore_checkpoint` into an abstract target: the JAX modules' `init`
under `jax.eval_shape` at the configs the JAX CLIs build for --dataset
(or, with --tiny, for their --synthetic runs), each leaf in the dtype the
checkpoint saved it in (fp32 masters, bf16 where a converted pipeline was
saved in bf16). No model is initialised.

Three kinds, recognised from the metadata and the tree (--kind
overrides):

  stage1     `rcdms_tpu/cli/train_stage1.py`'s {params: {params: prior},
             opt_state, step}, or its params alone;
  stage2     `rcdms_tpu/cli/train_stage2.py`'s {params: {params: {unet,
             fusion}}, opt_state, step} (one level deeper than stage 1),
             or its params alone;
  converted  `rcdms_tpu/cli/convert.py`'s {params: {text_s1, text_s2,
             vision, vae, prior, unet, fusion}} (metadata kind
             rcdms_tpu-converted-pipeline).

The optimizer state's layout (gradient clipping in the chain or not,
`optax.MultiSteps` accumulation or not) is read from the checkpoint's
tree. The tensors cross through `rcdms_tpu_torch/io/bridge.py` and are
written with the port's `save_checkpoint` at the source's step, in the
layout the port's readers take:

  * a training state as `save_train_state` writes it ({params, mu, nu,
    acc, count, mini_step, gradient_step, step}, fp32), read by the
    training CLIs' --resume-from-checkpoint and by the inference CLIs'
    --stage1-ckpt / --stage2-ckpt (params alone: {params});
  * a converted pipeline as the port's `cli/convert.py` writes it
    ({params: {tower: state dict}}), read by --converted-ckpt.

The JAX metadata (last_global_step, preempted, kind, ...) is kept, with
the source directory added as `orbax_source`. The --config YAML overrides
of the JAX CLIs are not applied: a checkpoint trained under one needs its
configs built by hand. Prints one JSON line: saved, kind, step, tensors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONVERTED_KIND = "rcdms_tpu-converted-pipeline"
KINDS = ("stage1", "stage2", "converted")


def _key(entry) -> str:
    """A key-path entry (dict key, attribute, sequence index) as orbax
    names it in its tree."""
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unknown key-path entry {entry!r}")


def _leaves(tree) -> dict:
    """{path tuple of str: leaf} of a tree."""
    import jax

    return {tuple(_key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def saved_tree(directory: str, step: int) -> dict:
    """{path: ArrayMetadata (shape, dtype)} of the saved state, read from
    the checkpoint's tree metadata (no array is read)."""
    import orbax.checkpoint as ocp

    meta = ocp.StandardCheckpointer().metadata(
        os.path.join(os.path.abspath(directory), str(step), "state"))
    return _leaves(getattr(meta, "item_metadata", meta))


def saved_metadata(directory: str, step: int) -> dict:
    import orbax.checkpoint as ocp

    from rcdms_tpu.io.checkpoint import _mngr

    restored = _mngr(directory, create=False).restore(
        step, args=ocp.args.Composite(metadata=ocp.args.JsonRestore()))
    return dict(restored["metadata"] or {})


def detect_kind(meta: dict, paths) -> str:
    """The kind of a checkpoint from its metadata and its tree's paths."""
    if meta.get("kind") == CONVERTED_KIND:
        return "converted"
    inner = {p[2] for p in paths if len(p) > 2 and p[:2] == ("params",
                                                             "params")}
    return "stage2" if inner == {"unet", "fusion"} else "stage1"


# ---- the JAX CLIs' configs -------------------------------------------------


def dataset_config(dataset: str, tiny: bool):
    """The JAX CLIs' DatasetConfig: the synthetic stories' with --tiny
    (`data/datasets.py::SyntheticStoryDataset`), else --dataset's."""
    from rcdms_tpu.configs import DatasetConfig
    from rcdms_tpu.data.datasets import SyntheticStoryDataset

    if tiny:
        return SyntheticStoryDataset().cfg
    return DatasetConfig(name=dataset)


def stage1_configs(ds, tiny: bool) -> dict:
    """The prior's config as `rcdms_tpu/cli/train_stage1.py` builds it."""
    from rcdms_tpu.configs import PriorConfig, TemporalConfig

    if tiny:
        return {"prior": PriorConfig.tiny(num_text_tokens=ds.max_text_len)}
    return {"prior": PriorConfig(
        num_text_tokens=ds.max_text_len,
        temporal=TemporalConfig(max_frames=ds.num_frames))}


def stage2_configs(ds, tiny: bool) -> dict:
    """The UNet's and fusion's configs as `rcdms_tpu/cli/train_stage2.py`
    builds them (remat changes no parameter)."""
    from rcdms_tpu.configs import FusionConfig, StoryUNetConfig, TemporalConfig

    if tiny:
        unet = StoryUNetConfig.tiny()
        return {"unet": unet, "fusion": FusionConfig.tiny(
            hidden_dim=unet.cross_attention_dim,
            text_dim=unet.cross_attention_dim)}
    return {"unet": StoryUNetConfig(temporal=TemporalConfig(
        max_frames=ds.num_frames)), "fusion": FusionConfig()}


def pipeline_configs(ds, tiny: bool) -> dict:
    """The seven towers' configs as `rcdms_tpu/cli/evaluate.py` builds them
    (the convert CLI's)."""
    from rcdms_tpu.configs import (
        CLIPTextConfig,
        CLIPVisionConfig,
        FusionConfig,
        PriorConfig,
        StoryUNetConfig,
        TemporalConfig,
        VAEConfig,
    )

    t = ds.max_text_len
    if tiny:
        prior = PriorConfig.tiny(num_text_tokens=t)
        unet = StoryUNetConfig.tiny()
        fusion = FusionConfig.tiny(hidden_dim=unet.cross_attention_dim,
                                   text_dim=unet.cross_attention_dim,
                                   unseen_vis_dim=prior.embedding_dim)
        return dict(
            text_s1=CLIPTextConfig.tiny(
                max_positions=t, width=prior.embedding_dim,
                projection_dim=prior.embedding_dim, vocab_size=49500,
                eos_token_id=49407),
            text_s2=CLIPTextConfig.tiny(
                max_positions=t, width=unet.cross_attention_dim,
                vocab_size=49500, eos_token_id=49407),
            vision=CLIPVisionConfig.tiny(
                image_size=ds.clip_size, width=fusion.seen_vis_dim,
                projection_dim=prior.embedding_dim),
            vae=VAEConfig.tiny(), prior=prior, unet=unet, fusion=fusion)
    return dict(
        text_s1=CLIPTextConfig.bigg(t, ds.vocab_size),
        text_s2=CLIPTextConfig.sd15(t, ds.vocab_size),
        vision=CLIPVisionConfig(), vae=VAEConfig(),
        prior=PriorConfig(num_text_tokens=t, temporal=TemporalConfig(
            max_frames=ds.num_frames)),
        unet=StoryUNetConfig(), fusion=FusionConfig())


def abstract_towers(configs: dict) -> dict:
    """{tower: {"params": tree of ShapeDtypeStruct}}: the JAX CLIs'
    builders (`rcdms_tpu/cli/common.py`, random init) under
    `jax.eval_shape`, so nothing is initialised."""
    import jax

    from rcdms_tpu.cli import common

    builders = {
        "text_s1": common.build_text_encoder,
        "text_s2": common.build_text_encoder,
        "vision": common.build_vision_encoder, "vae": common.build_vae,
        "prior": common.build_prior, "unet": common.build_unet,
    }
    out = {}
    for name, cfg in configs.items():
        if name == "fusion":
            out[name] = jax.eval_shape(lambda: common.build_fusion(cfg)[1])
        else:
            out[name] = jax.eval_shape(
                lambda b=builders[name]: b(cfg, None)[1])
    return out


def _optimizer_states(params):
    """Abstract optimizer states of `rcdms_tpu.train.optim.make_optimizer`
    over `params`, one per layout: with and without gradient clipping,
    with and without accumulation (`optax.MultiSteps`)."""
    import jax

    from rcdms_tpu.configs import OptimizerConfig
    from rcdms_tpu.train.optim import make_optimizer

    for clip in (1.0, None):
        for accumulate in (1, 2):
            tx = make_optimizer(OptimizerConfig(
                grad_clip_norm=clip, accumulate_steps=accumulate))
            yield jax.eval_shape(tx.init, params)


def abstract_target(kind: str, configs: dict, saved: dict) -> dict:
    """The restore target of a `kind` checkpoint whose tree is `saved`
    ({path: metadata}): the abstract tree of the JAX modules and
    optimizer, each leaf in its saved dtype. Raises, naming paths, where
    no layout matches the checkpoint's tree."""
    import jax

    towers = abstract_towers(configs)
    if kind == "converted":
        target = {"params": towers}
    else:
        params = ({"params": towers["prior"]["params"]} if kind == "stage1"
                  else {"params": {"unet": towers["unet"]["params"],
                                   "fusion": towers["fusion"]["params"]}})
        target = {"params": params}
        if any(p[0] == "opt_state" for p in saved):
            for opt in _optimizer_states(params):
                candidate = {"params": params, "opt_state": opt,
                             "step": jax.ShapeDtypeStruct((), np.int32)}
                if set(_leaves(candidate)) == set(saved):
                    target = candidate
                    break
    mine = _leaves(target)
    if set(mine) != set(saved):
        diff = sorted("/".join(p) for p in set(mine) ^ set(saved))
        raise ValueError(f"the checkpoint's tree is not a {kind} checkpoint "
                         f"at these configs; paths that differ: {diff[:6]}")

    def leaf(path, s):
        m = saved[tuple(_key(k) for k in path)]
        if tuple(m.shape) != tuple(s.shape):
            raise ValueError(f"{'/'.join(_key(k) for k in path)}: saved "
                             f"{tuple(m.shape)}, config {tuple(s.shape)}")
        return jax.ShapeDtypeStruct(s.shape, m.dtype)

    return jax.tree_util.tree_map_with_path(leaf, target)


# ---- the port's layout ------------------------------------------------------


def _port_config(cfg):
    """The port's config of the JAX config `cfg` (same class name, same
    field values)."""
    from rcdms_tpu_torch import configs as pconfigs

    cls = getattr(pconfigs, type(cfg).__name__)
    return cls(**{f.name: (_port_config(v) if dataclasses.is_dataclass(v)
                           else v)
                  for f in dataclasses.fields(cfg)
                  for v in (getattr(cfg, f.name),)})


def _tensors(sd):
    import torch

    return None if sd is None else {
        k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def port_tree(kind: str, state: dict, configs: dict) -> dict:
    """The restored JAX state (numpy leaves) as the port's checkpoint
    tree."""
    from rcdms_tpu_torch.io import bridge

    pcfg = {k: _port_config(v) for k, v in configs.items()}
    if kind == "converted":
        sds = bridge.pipeline_state_dicts(state["params"],
                                          SimpleNamespace(**pcfg))
        return {"params": {k: _tensors(v) for k, v in sds.items()}}
    if kind == "stage1":
        def to_sd(p):
            return bridge.stage1_state_dict(p, pcfg["prior"])
    else:
        def to_sd(p):
            return bridge.stage2_state_dict(p, pcfg["unet"])
    if "opt_state" not in state:
        return {"params": _tensors(to_sd(state["params"]))}
    dicts = bridge.train_state_dicts(SimpleNamespace(**state), to_sd)
    return {k: _tensors(v) if k in ("params", "mu", "nu", "acc") else v
            for k, v in dicts.items()}


def convert(ckpt: str, output_dir: str, kind: str = None,
            dataset: str = "pororosv", tiny: bool = False,
            step: int = None) -> dict:
    """Convert step `step` (default the latest) of the orbax checkpoint
    directory `ckpt` into `output_dir`; returns the printed line."""
    import jax

    from rcdms_tpu.io.checkpoint import latest_step, restore_checkpoint
    from rcdms_tpu_torch.io.checkpoint import save_checkpoint

    step = latest_step(ckpt) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no orbax checkpoint under {ckpt}")
    saved = saved_tree(ckpt, step)
    meta = saved_metadata(ckpt, step)
    kind = kind or detect_kind(meta, saved)
    ds = dataset_config(dataset, tiny)
    configs = {"stage1": stage1_configs, "stage2": stage2_configs,
               "converted": pipeline_configs}[kind](ds, tiny)
    target = abstract_target(kind, configs, saved)
    state, meta, step = restore_checkpoint(ckpt, target, step)
    state = jax.device_get(state)
    tree = port_tree(kind, state, configs)
    del state
    meta = dict(meta, orbax_source=os.path.abspath(ckpt))
    if not save_checkpoint(output_dir, step, tree, meta):
        raise FileExistsError(f"{output_dir} holds step {step} or a later "
                              f"one already")
    line = {"saved": output_dir, "kind": kind, "step": step,
            "tensors": len(_leaves(tree))}
    print(json.dumps(line))
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="the JAX package's orbax checkpoint directory")
    ap.add_argument("--output-dir", required=True,
                    help="the port's checkpoint directory to write")
    ap.add_argument("--kind", choices=KINDS, default=None,
                    help="default: recognised from the checkpoint")
    ap.add_argument("--dataset", default="pororosv",
                    choices=["flintstones", "pororosv"])
    ap.add_argument("--tiny", action="store_true",
                    help="the configs of the JAX CLIs' --synthetic runs")
    ap.add_argument("--step", type=int, default=None,
                    help="default: the latest step")
    a = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    return convert(a.ckpt, a.output_dir, a.kind, a.dataset, a.tiny, a.step)


if __name__ == "__main__":
    main()
