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
`group_norm_act` spreads each (batch row, slab of whole groups) over a
thread block cluster with the launch plan of `_plan`, so one group's slab
need not fit one block: it takes fp32 and bf16 through the same kernel,
c * itemsize a multiple of 16 and a 16-byte aligned x, and raises where no
plan fits. `group_norm_act_slab` launches the first port's kernel (one
block a group slab, refused beyond a block's shared memory), kept for
`tools/gn_device_times.py`. `.launches` counts launches.
"""

from __future__ import annotations

import functools
import math

import torch

from rcdms_tpu_torch.ops import _build

ACTS = ("silu", "none")
SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448        # bytes of shared memory a block may use
MAX_THREADS = 512        # threads a CTA (the kernel's launch bound)
CLUSTERS = (1, 2, 4, 8, 16)   # 16: the non-portable cluster size
TILE_BYTES = 48 * 1024   # a CTA's tile the plan aims for
MIN_ROWS = 64            # tokens a CTA the plan prefers at the least
# the first port's kernel: one thread a channel of a group at the least,
# and its static shared memory (its reduction)
MAX_GROUP_CHANNELS = 512
_SLAB_RESERVED = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _layout(n: int, c: int, groups: int, sg: int, k: int,
            itemsize: int) -> dict:
    """The kernel's layout for a slab of `sg` groups and clusters of `k`
    CTAs (`csrc/group_norm.cu::GnLayout`): `vr` 16-byte vectors a token
    row of the slab, `rl` row lanes (a power of two, rl x vr <= 512
    threads), `rows` tokens a CTA, and the shared memory: the group
    partials and totals, the threads' per-channel sums, then the tile at
    a 128-byte boundary."""
    width = sg * (c // groups)
    row_bytes = width * itemsize
    vr = row_bytes // 16
    rl = 1
    while 0 < vr * rl * 2 <= MAX_THREADS:
        rl *= 2
    rows = _cdiv(n, k)
    stat = 8 * sg
    scratch = _cdiv(stat + 8 * sg, 16) * 16
    tile = _cdiv(scratch + 8 * rl * width, 128) * 128
    return dict(slab_groups=sg, cluster=k, rows=rows, threads=vr * rl,
                smem=tile + rows * row_bytes, width=width,
                row_bytes=row_bytes)


@functools.lru_cache(maxsize=256)
def _plan(b: int, n: int, c: int, groups: int, itemsize: int) -> dict:
    """Launch plan of the fused kernel for x (b, n, c) of `itemsize`
    bytes an element: a slab of `slab_groups` whole groups whose token
    rows are a multiple of 16 bytes (at most 512 vectors), clusters of
    `cluster` CTAs that split the n tokens into runs of `rows`, the
    CTA's `threads` and shared memory (`smem`, at most SMEM_MAX), and
    `ctas` = b x slabs x cluster. Of the plans that fit it takes the most
    CTAs up to one an SM (132), then runs of the most tokens up to
    MIN_ROWS, then the tile (rows x row bytes) nearest TILE_BYTES, then
    the widest slab, then the smallest cluster: on the H100 this came
    within 1.13x of the fastest (slab, cluster) at each of nine shapes
    and dtypes swept, and took it at (5, 4096, 320) and (5, 4096, 960)
    (PERF.md). Raises ValueError where none fits."""
    if min(b, n, c, groups) <= 0 or c % groups or (c * itemsize) % 16:
        raise ValueError(f"group_norm_act: the kernel takes c a multiple "
                         f"of groups with c * itemsize a multiple of 16, "
                         f"got b {b}, n {n}, c {c}, groups {groups}, "
                         f"itemsize {itemsize}")
    best, key = None, None
    for sg in range(1, groups + 1):
        if groups % sg:
            continue
        for k in CLUSTERS:
            p = _layout(n, c, groups, sg, k, itemsize)
            if p["row_bytes"] % 16 or p["row_bytes"] > 16 * MAX_THREADS \
                    or not p["threads"] or p["smem"] > SMEM_MAX:
                continue
            p["ctas"] = b * (groups // sg) * k
            tile = p["rows"] * p["row_bytes"]
            rank = (min(p["ctas"], SMS), min(p["rows"], MIN_ROWS),
                    -abs(math.log2(tile / TILE_BYTES)), sg, -k)
            if key is None or rank > key:
                best, key = p, rank
    if best is None:
        raise ValueError(f"group_norm_act: no plan fits x ({b}, {n}, {c}) "
                         f"with {groups} groups: a slab's token rows need "
                         f"{SMEM_MAX} bytes of shared memory or less in a "
                         f"cluster of up to {CLUSTERS[-1]} CTAs")
    return best


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


def _check_args(name, x, scale, bias, groups, act) -> None:
    c = x.shape[-1]
    if x.dim() < 2 or c % groups or scale.shape != (c,) \
            or bias.shape != (c,) or act not in ACTS:
        raise ValueError(f"{name}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}, "
                         f"groups {groups}, act {act!r}")


def _cuda_args(name, x, scale, bias) -> int:
    dtype = _build.cuda_operands(name, x)
    _build.cuda_operands(name, scale, bias)
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise TypeError(f"{name}: scale and bias must be float32 on "
                        f"{x.device}, got {scale.dtype} on {scale.device}")
    return dtype


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, act: str) -> torch.Tensor:
    """GroupNorm + activation over x (..., n, c) (module docstring)."""
    _check_args("group_norm_act", x, scale, bias, groups, act)
    if x.device.type == "cpu":
        return group_norm_act_plain(x, scale, bias, groups, eps, act)
    dtype = _cuda_args("group_norm_act", x, scale, bias)
    if x.data_ptr() % 16:
        raise ValueError("group_norm_act: the kernel takes a 16-byte "
                         "aligned x")
    n, c = x.shape[-2:]
    batch = math.prod(x.shape[:-2])
    plan = _plan(batch, n, c, groups, x.element_size())
    out = torch.empty_like(x)
    code = _build.library().lib.rcdms_group_norm_act(
        dtype, int(act == "silu"), x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), batch, n, c, groups, float(eps),
        plan["slab_groups"], plan["cluster"], plan["rows"], plan["threads"],
        plan["smem"], _build.stream(x))
    _build.check(code, "rcdms_group_norm_act")
    group_norm_act.launches += 1
    return out


def group_norm_act_slab(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int, eps: float,
                        act: str) -> torch.Tensor:
    """`group_norm_act` by the first port's kernel (card only): one block
    a (batch row, group) holds the group's (n, c / groups) slab in shared
    memory; raises for a slab larger than a block may hold."""
    _check_args("group_norm_act_slab", x, scale, bias, groups, act)
    dtype = _cuda_args("group_norm_act_slab", x, scale, bias)
    n, c = x.shape[-2:]
    if c // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm_act_slab: {c // groups} channels a "
                         f"group, more than {MAX_GROUP_CHANNELS}")
    slab = n * (c // groups) * x.element_size()  # one group's slab
    if slab > SMEM_MAX - _SLAB_RESERVED:
        raise ValueError(f"group_norm_act_slab: a group slab of x "
                         f"{tuple(x.shape)} with {groups} groups takes "
                         f"{slab} bytes of shared memory, more than the "
                         f"{SMEM_MAX - _SLAB_RESERVED} one block may use")
    out = torch.empty_like(x)
    code = _build.library().lib.rcdms_group_norm_act_slab(
        dtype, int(act == "silu"), x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), math.prod(x.shape[:-2]), n, c,
        groups, float(eps), _build.stream(x))
    _build.check(code, "rcdms_group_norm_act_slab")
    group_norm_act_slab.launches += 1
    return out


gn_moments.launches = 0
group_norm_act.launches = 0
group_norm_act_slab.launches = 0
