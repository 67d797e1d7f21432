"""The port's kernel ops. Each of the four hand-written Hopper kernels has a
wrapper here that runs its plain PyTorch version on CPU tensors, launches
the kernel on CUDA tensors (or raises), and counts its launches."""

from rcdms_tpu_torch.ops.flash import flash_attention
from rcdms_tpu_torch.ops.frame_attention import frame_attention
from rcdms_tpu_torch.ops.geglu import geglu_ff, gelu_ff

KERNELS = {
    "attention": flash_attention,
    "frame_attention": frame_attention,
    "geglu_ff": geglu_ff,
    "gelu_ff": gelu_ff,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
