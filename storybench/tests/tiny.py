"""A tiny configuration of the story model (the port's `tiny_configs`
widths, the real token ids) and tiny mixes, for the CPU tests."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def config(dtype: str = "float32") -> dict:
    cfg = json.loads((ROOT / "configs" / "rcdms-pororosv.json").read_text())
    t = {"num_heads": 2, "num_blocks": 1, "attn_layers_per_block": 2,
         "use_positional_encoding": True, "max_frames": 5}
    cfg.update(
        dtype=dtype, image_size=32, prior_steps=2, ddim_steps=2,
        text_s1=dict(cfg["text_s1"], width=16, num_layers=2, num_heads=2,
                     max_positions=7, projection_dim=16),
        text_s2=dict(cfg["text_s2"], width=24, num_layers=2, num_heads=2,
                     max_positions=7, projection_dim=24),
        vision=dict(cfg["vision"], image_size=28, width=16, num_layers=2,
                    num_heads=2, projection_dim=16),
        vae=dict(cfg["vae"], block_channels=[16, 32], layers_per_block=1,
                 norm_groups=4),
        prior=dict(cfg["prior"], num_heads=2, head_dim=8, num_layers=2,
                   embedding_dim=16, num_text_tokens=7, temporal=t),
        unet=dict(cfg["unet"], block_channels=[32, 64], layers_per_block=1,
                  cross_attn_levels=[True, False], norm_groups=8,
                  cross_attention_dim=24, num_attention_heads=4, temporal=t),
        fusion=dict(cfg["fusion"], text_dim=24, seen_vis_dim=16,
                    unseen_vis_dim=16, hidden_dim=24, num_heads=2))
    return copy.deepcopy(cfg)


def mix(name: str, **kw) -> dict:
    m = json.loads((ROOT / "mixes" / f"{name}.json").read_text())
    m.update(kw)
    return m
