"""The port's kernel ops. Each hand-written Hopper kernel has a wrapper here
that runs its plain PyTorch version on CPU tensors, launches the kernel on
CUDA tensors (or raises), and counts its launches.

The kernels belong to two paths: the story (`StoryPipeline.generate`) runs
A-D; the kernel studies (`rcdms_tpu_torch/tools/`) run the conv and
GroupNorm kernels and the small-head-dim attention kernels E-H, which no
story launches. `launch_counts(path)` reads one
path's kernels, so each path is checked for its own."""

from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3
from rcdms_tpu_torch.ops.flash import flash_attention
from rcdms_tpu_torch.ops.frame_attention import frame_attention
from rcdms_tpu_torch.ops.geglu import geglu_ff, gelu_ff
from rcdms_tpu_torch.ops.group_norm import gn_moments, group_norm_act
from rcdms_tpu_torch.ops.smallk import (
    attn_pv,
    attn_scores,
    attn_softmax,
    smallk_attention,
)

PATHS = {
    "story": {
        "attention": flash_attention,
        "frame_attention": frame_attention,
        "geglu_ff": geglu_ff,
        "gelu_ff": gelu_ff,
    },
    "studies": {
        "cm_conv3x3": cm_conv3x3,
        "gn_moments": gn_moments,
        "group_norm_act": group_norm_act,
        "smallk_attention": smallk_attention,
        "attn_scores": attn_scores,
        "attn_pv": attn_pv,
        "attn_softmax": attn_softmax,
    },
}
KERNELS = {name: fn for kernels in PATHS.values()
           for name, fn in kernels.items()}


def reset_launch_counts() -> None:
    """Zero every kernel's count, and the counts of a kernel's redesigned
    path (`frame_attention.tiled_launches`, `cm_conv3x3.tensor_launches`)."""
    for fn in KERNELS.values():
        for name in ("launches", "tiled_launches", "tensor_launches"):
            if hasattr(fn, name):
                setattr(fn, name, 0)


def launch_counts(path: str | None = None) -> dict:
    """Launches of every kernel, or of one path's kernels."""
    kernels = KERNELS if path is None else PATHS[path]
    return {name: fn.launches for name, fn in kernels.items()}
