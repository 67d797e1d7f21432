"""Loader for the reference's OmegaConf YAML config files — the counterpart
of `rcdms_tpu/configs/reference_yaml.py`.

A user of the reference carries `configs/training.yaml` / `testing.yaml`
(`unet_additional_kwargs` + `noise_scheduler_kwargs`) and passes one with
`--config`; this module maps that schema onto the port's configs and its
DDIM schedule:

    motion_module_kwargs.num_attention_heads   -> TemporalConfig.num_heads
    .num_transformer_block                     -> .num_blocks
    .attention_block_types                     -> .attn_layers_per_block
                                                  (all must be Temporal_Self)
    .temporal_position_encoding[_max_len]      -> .use_positional_encoding /
                                                  .max_frames
    .zero_initialize                           -> .zero_init_output
    use_motion_module                          -> use_temporal
    noise_scheduler_kwargs                     -> DDIMSchedule(beta_*)

Settings the port does not replicate (the disabled
`unet_use_cross_frame_attention` / `unet_use_temporal_attention`
variants, non-"Vanilla" motion types, `temporal_attention_dim_div` != 1,
partial `motion_module_resolutions`) raise instead of being dropped.
PyYAML is imported only when a file is read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from rcdms_tpu_torch.configs import TemporalConfig
from rcdms_tpu_torch.core.schedulers import DDIMSchedule


class UnsupportedReferenceConfig(ValueError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise UnsupportedReferenceConfig(msg)


def parse_reference_yaml(path: str) -> Tuple[dict, Optional[DDIMSchedule]]:
    """Returns (unet_overrides, ddim_schedule or None).

    `unet_overrides`: kwargs for dataclasses.replace on StoryUNetConfig /
    PriorConfig ({use_temporal, temporal}); the schedule is built from
    `noise_scheduler_kwargs` when present (the reference's DDIM inference
    schedule)."""
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh) or {}

    overrides: dict = {}
    uk = doc.get("unet_additional_kwargs") or {}
    if uk:
        _require(not uk.get("unet_use_cross_frame_attention", False),
                 "unet_use_cross_frame_attention=true is the disabled "
                 "SparseCausalAttention2D variant (off in every live "
                 "reference config) — not replicated")
        _require(not uk.get("unet_use_temporal_attention", False),
                 "unet_use_temporal_attention=true is a disabled reference "
                 "variant — not replicated")
        use_mm = bool(uk.get("use_motion_module", True))
        overrides["use_temporal"] = use_mm
        if use_mm:
            mtype = uk.get("motion_module_type", "Vanilla")
            _require(mtype == "Vanilla",
                     f"motion_module_type={mtype!r}: the reference factory "
                     "only supports 'Vanilla'")
            res = uk.get("motion_module_resolutions", [1, 2, 4, 8])
            _require(sorted(res) == [1, 2, 4, 8],
                     f"motion_module_resolutions={res}: partial-resolution "
                     "motion modules are not supported (every live "
                     "reference config uses all four levels)")
            mk = uk.get("motion_module_kwargs") or {}
            div = mk.get("temporal_attention_dim_div", 1)
            _require(div == 1, f"temporal_attention_dim_div={div}: only 1 "
                     "is supported (the reference default)")
            blocks = mk.get("attention_block_types",
                            ["Temporal_Self", "Temporal_Self"])
            _require(all(b == "Temporal_Self" for b in blocks),
                     f"attention_block_types={blocks}: only Temporal_Self "
                     "blocks exist in the reference's live configs")
            overrides["temporal"] = TemporalConfig(
                num_heads=int(mk.get("num_attention_heads", 8)),
                num_blocks=int(mk.get("num_transformer_block", 1)),
                attn_layers_per_block=len(blocks),
                use_positional_encoding=bool(
                    mk.get("temporal_position_encoding", True)),
                max_frames=int(
                    mk.get("temporal_position_encoding_max_len", 5)),
                zero_init_output=bool(mk.get("zero_initialize", True)),
            )

    schedule = None
    nk = doc.get("noise_scheduler_kwargs") or {}
    if nk:
        schedule = DDIMSchedule(
            beta_schedule=str(nk.get("beta_schedule", "linear")),
            beta_start=float(nk.get("beta_start", 0.00085)),
            beta_end=float(nk.get("beta_end", 0.012)),
        )
    return overrides, schedule


def apply_to_unet_config(cfg, overrides: dict):
    """dataclasses.replace with only the fields the config carries."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    usable = {k: v for k, v in overrides.items() if k in fields}
    return dataclasses.replace(cfg, **usable)
