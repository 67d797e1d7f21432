"""The two GroupNorm kernels of the GroupNorm studies, over channels-last
(..., n, c) activations:

* `gn_moments`: per-(batch row, channel) mean and mean of squares over the
  n tokens of a (B, n, c) input, in fp32 — the port's counterpart of
  `tools/gn_study.py::pallas_moments`;
* `group_norm_act`: one-pass GroupNorm (statistics per leading index over
  each group's (n, c / groups) slab, E[x^2] - E[x]^2 in fp32) followed by
  SiLU or nothing, rounded back to x.dtype — the counterpart of
  `tools/gn_fused_study.py::_gn_pallas`. scale and bias are fp32 (c,).

Each wrapper dispatches on where x lies: on the CPU it runs its plain
version; on a CUDA device it launches `csrc/group_norm.cu` or raises.
`group_norm_act` takes any shape whose group slab, n * c / groups elements
of x, fits the shared memory one block may use, and raises otherwise (as
the study's `fits_kernel` bounds the slice by its VMEM budget).
`.launches` counts launches.
"""

from __future__ import annotations

import math

import torch

from rcdms_tpu_torch.ops import _build

ACTS = ("silu", "none")
MAX_GROUP_CHANNELS = 512  # one thread a channel of a group, at the least
_GN_RESERVED = 64  # static shared memory of the kernel (its reduction)


def gn_moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `gn_moments`: the study's `xla_mean2`."""
    xf = x.float()
    return xf.mean(dim=1), (xf * xf).mean(dim=1)


def gn_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, n, c) -> (mean, mean of squares), each (B, c) fp32."""
    if x.dim() != 3:
        raise ValueError(f"gn_moments: x {tuple(x.shape)} is not (B, n, c)")
    if x.device.type == "cpu":
        return gn_moments_plain(x)
    dtype = _build.cuda_operands("gn_moments", x)
    b, n, c = x.shape
    mean = torch.empty(b, c, device=x.device, dtype=torch.float32)
    mean2 = torch.empty_like(mean)
    code = _build.library().lib.rcdms_gn_moments(
        dtype, x.data_ptr(), mean.data_ptr(), mean2.data_ptr(), b, n, c,
        _build.stream(x))
    _build.check(code, "rcdms_gn_moments")
    gn_moments.launches += 1
    return mean, mean2


def group_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         act: str) -> torch.Tensor:
    """Plain PyTorch version of `group_norm_act`: the study's two-pass
    `_xla_reference` (per-channel moments, folded per group, then the
    normalising map and the activation), all in fp32."""
    c = x.shape[-1]
    xf = x.float()
    s1 = xf.mean(dim=-2)
    s2 = (xf * xf).mean(dim=-2)
    lead = s1.shape[:-1]
    mean_g = s1.reshape(lead + (groups, c // groups)).mean(-1)
    ex2_g = s2.reshape(lead + (groups, c // groups)).mean(-1)
    var_g = torch.clamp(ex2_g - mean_g * mean_g, min=0.0)
    mean_c = torch.repeat_interleave(mean_g, c // groups, dim=-1)
    inv_c = torch.repeat_interleave(torch.rsqrt(var_g + eps), c // groups,
                                    dim=-1)
    mul = inv_c * scale.float()
    add = bias.float() - mean_c * mul
    y = xf * mul[..., None, :] + add[..., None, :]
    if act == "silu":
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y.to(x.dtype)


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, act: str) -> torch.Tensor:
    """GroupNorm + activation over x (..., n, c) (module docstring)."""
    c = x.shape[-1]
    if x.dim() < 2 or c % groups or scale.shape != (c,) \
            or bias.shape != (c,) or act not in ACTS:
        raise ValueError(f"group_norm_act: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}, "
                         f"groups {groups}, act {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, scale, bias, groups, eps, act)
    dtype = _build.cuda_operands("group_norm_act", x)
    _build.cuda_operands("group_norm_act", scale, bias)
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise TypeError(f"group_norm_act: scale and bias must be float32 on "
                        f"{x.device}, got {scale.dtype} on {scale.device}")
    if c // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm_act: {c // groups} channels a group, "
                         f"more than {MAX_GROUP_CHANNELS}")
    n = x.shape[-2]
    slab = n * (c // groups) * x.element_size()  # one group's (n, c/g) slab
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin - _GN_RESERVED
    if slab > limit:
        raise ValueError(f"group_norm_act: a group slab of x {tuple(x.shape)} "
                         f"with {groups} groups takes {slab} bytes of shared "
                         f"memory, more than the {limit} one block may use")
    batch = math.prod(x.shape[:-2])
    out = torch.empty_like(x)
    code = _build.library().lib.rcdms_group_norm_act(
        dtype, int(act == "silu"), x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), batch, n, c, groups, float(eps),
        _build.stream(x))
    _build.check(code, "rcdms_group_norm_act")
    group_norm_act.launches += 1
    return out


gn_moments.launches = 0
group_norm_act.launches = 0
