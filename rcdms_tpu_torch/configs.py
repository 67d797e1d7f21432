"""The port's config dataclasses: the seven frozen model configs the port
builds from, with their defaults and the presets it calls (`tiny()`,
`CLIPTextConfig.sd15` / `.bigg`), the dataset protocol's config, and the
optimizer, mesh and two train configs. A copy of `rcdms_tpu/configs`,
field for field, so the port imports nothing of the JAX package. The mesh
config is carried for the train configs' sake; one-card training reads
none of it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class TemporalConfig:
    """Temporal (cross-frame) attention module config (the reference's
    `motion_module_kwargs`)."""

    num_heads: int = 8
    num_blocks: int = 1            # num_transformer_block
    attn_layers_per_block: int = 2  # len(attention_block_types) = 2x Temporal_Self
    use_positional_encoding: bool = True
    max_frames: int = 5
    zero_init_output: bool = True


@dataclass(frozen=True)
class PriorConfig:
    """Frame-prior transformer (Kandinsky-2.2-style unCLIP prior with
    interleaved temporal attention; 91 text tokens + 6 added tokens)."""

    num_heads: int = 32
    head_dim: int = 64
    num_layers: int = 20
    embedding_dim: int = 1280       # CLIP bigG projection dim
    num_text_tokens: int = 91       # 85 for PororoSV
    num_frames: int = 5
    clip_mean: float = -0.016
    clip_std: float = 0.415
    use_temporal: bool = True
    temporal: TemporalConfig = field(default_factory=TemporalConfig)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    # token layout: [text(91) | text_proj | img_proj | mask_proj | time | x_t | prd]
    @property
    def additional_tokens(self) -> int:
        return 6

    @property
    def seq_len(self) -> int:
        return self.num_text_tokens + self.additional_tokens

    @classmethod
    def tiny(cls, **kw) -> "PriorConfig":
        cfg = cls(num_heads=2, head_dim=8, num_layers=2, embedding_dim=16,
                  num_text_tokens=7,
                  temporal=TemporalConfig(num_heads=2, num_blocks=1,
                                          attn_layers_per_block=2))
        return _replace(cfg, **kw)


@dataclass(frozen=True)
class StoryUNetConfig:
    """Rich-contextual 3D UNet (SD-v1.5 inflated to 5 frames, 9-channel
    input concat)."""

    in_channels: int = 9            # noisy(4) + mask(1) + masked latents(4)
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # per-level: does the level have spatial cross-attn transformers?
    cross_attn_levels: Tuple[bool, ...] = (True, True, True, False)
    # SD1.5's `attention_head_dim=8` is (legacy diffusers naming) the number
    # of heads; head_dim = channels // num_attention_heads per level.
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_groups: int = 32
    norm_eps: float = 1e-5
    num_frames: int = 5
    use_temporal: bool = True
    temporal_mid_block: bool = False
    temporal: TemporalConfig = field(default_factory=TemporalConfig)
    remat: bool = False             # gradient checkpointing of blocks

    @classmethod
    def tiny(cls, **kw) -> "StoryUNetConfig":
        cfg = cls(block_channels=(32, 64), layers_per_block=1,
                  cross_attn_levels=(True, False), norm_groups=8,
                  cross_attention_dim=24, num_attention_heads=4,
                  temporal=TemporalConfig(num_heads=2, num_blocks=1))
        return _replace(cfg, **kw)


@dataclass(frozen=True)
class VAEConfig:
    """SD-v1.5 `AutoencoderKL` equivalent."""

    in_channels: int = 3
    latent_channels: int = 4
    block_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        return _replace(cls(block_channels=(16, 32), layers_per_block=1,
                            norm_groups=4), **kw)


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower with projection: stage 1 takes the Kandinsky prior's
    bigG tower (width 1280), stage 2 SD1.5's ViT-L tower (width 768); vocab
    and positions resized for the dataset's character tokens."""

    vocab_size: int = 49412         # flintstones; pororo=49416
    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 91         # 85 for pororo
    projection_dim: int = 768
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"  # openai CLIP; bigG uses "gelu"

    @classmethod
    def sd15(cls, max_positions: int = 91, vocab_size: int = 49412) -> "CLIPTextConfig":
        return cls(vocab_size=vocab_size, width=768, num_layers=12,
                   num_heads=12, max_positions=max_positions,
                   projection_dim=768, hidden_act="quick_gelu")

    @classmethod
    def bigg(cls, max_positions: int = 91, vocab_size: int = 49412) -> "CLIPTextConfig":
        return cls(vocab_size=vocab_size, width=1280, num_layers=32,
                   num_heads=20, max_positions=max_positions,
                   projection_dim=1280, hidden_act="gelu")

    @classmethod
    def tiny(cls, **kw) -> "CLIPTextConfig":
        return _replace(cls(vocab_size=64, width=16, num_layers=2,
                            num_heads=2, max_positions=7, projection_dim=16,
                            eos_token_id=63), **kw)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-bigG vision tower with projection: 257 tokens x 1664
    hidden, 1280-d projection."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1664
    num_layers: int = 48
    num_heads: int = 16
    projection_dim: int = 1280
    hidden_act: str = "gelu"

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        return _replace(cls(image_size=28, patch_size=14, width=16,
                            num_layers=2, num_heads=2, projection_dim=16), **kw)


@dataclass(frozen=True)
class FusionConfig:
    """The seen- and unseen-frame fusion stacks: 8-head MHA, query = the
    projected text tokens, kv = the projected image features."""

    text_dim: int = 768
    seen_vis_dim: int = 1664    # CLIP bigG last_hidden_state width
    unseen_vis_dim: int = 1280  # CLIP bigG projection dim (stage-1 output)
    hidden_dim: int = 768
    num_heads: int = 8

    @classmethod
    def tiny(cls, **kw) -> "FusionConfig":
        return _replace(cls(text_dim=24, seen_vis_dim=16, unseen_vis_dim=16,
                            hidden_dim=24, num_heads=2), **kw)


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset protocol config: the (max_len, vocab, character-token) table
    of each dataset, in one place."""

    name: str = "flintstones"
    h5_path: str = "./datasets/ARLDM/flintstones.h5"
    image_size: int = 512
    clip_size: int = 224
    num_frames: int = 5
    text_drop_rate: float = 0.1
    sr_dir: Optional[str] = None

    @property
    def max_text_len(self) -> int:
        return {"flintstones": 91, "pororosv": 85}[self.name]

    @property
    def vocab_size(self) -> int:
        return {"flintstones": 49412, "pororosv": 49416}[self.name]

    @property
    def new_tokens(self) -> Sequence[str]:
        return {
            "flintstones": ("fred", "barney", "wilma", "betty", "pebbles",
                            "dino", "slate"),
            "pororosv": ("pororo", "loopy", "eddy", "harry", "poby",
                         "tongtong", "crong", "rody", "petty"),
        }[self.name]


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + warmup schedule (reference run scripts: lr 1e-5, warmup 2000,
    weight decay 1e-2, grad clip)."""

    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 2000
    max_steps: int = 1_000_000
    grad_clip_norm: Optional[float] = 1.0
    schedule: str = "constant_with_warmup"
    accumulate_steps: int = 1  # gradient accumulation (optax.MultiSteps)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh spec: a `('data',)` axis with optimizer state sharded
    over it, and an optional tensor axis."""

    data: int = -1   # -1: all remaining devices
    tensor: int = 1  # optional tensor-parallel axis over heads/channels

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        t = max(1, self.tensor)
        d = self.data if self.data > 0 else n_devices // t
        if d * t != n_devices:
            raise ValueError(f"mesh {d}x{t} != {n_devices} devices")
        return d, t


@dataclass(frozen=True)
class Stage1TrainConfig:
    prior: PriorConfig = field(default_factory=PriorConfig)
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(grad_clip_norm=10.0))
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch_size: int = 8             # global
    noise_offset: float = 0.1
    checkpoint_every: int = 5000
    zero2: bool = True              # shard optimizer state over data axis
    compute_dtype: str = "bfloat16"
    seed: int = 42


@dataclass(frozen=True)
class Stage2TrainConfig:
    unet: StoryUNetConfig = field(default_factory=StoryUNetConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch_size: int = 8             # global
    noise_offset: float = 0.1
    checkpoint_every: int = 10000
    zero2: bool = True
    compute_dtype: str = "bfloat16"
    seed: int = 42
