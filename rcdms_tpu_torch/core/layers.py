"""Core layers of the port — the counterpart of `rcdms_tpu/core/layers.py`.

Public tensors keep the JAX package's channels-last layouts: images and
feature maps (..., h, w, c), tokens (..., n, c). A per-frame conv runs on
the folded (N, h, w, c) batch viewed as NCHW, which in memory is exactly
PyTorch's channels_last format, so no copy is made around the conv.

Not ported: `PaddedDense`, `DenseNT`/`DenseTN`, `_taps9_conv`, the `cm_*`
formulations and their gates. They exist only for Mosaic's lane tiling and
GSPMD and have no job on a GPU. The int8 conv (`_taps9_conv_int8`) is
ported as `FrameConv`'s opt-in route (`ops/quant.py`).

Inside `core.spatial.spatial(rows=plan)` (sharded single-story inference)
a feature map holds this rank's block of rows, which may be empty:
`GroupNorm` sums its moments over the group and a conv that reads beyond
its rows takes its neighbours' edge rows (`spatial.halo`); outside it
they run as alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.ops import impl
from rcdms_tpu_torch.ops.geglu import geglu_ff, geglu_ff_plain, gelu_ff, \
    gelu_ff_plain
from rcdms_tpu_torch.ops.quant import (
    conv_weight_int8,
    int8_conv3x3,
    int8_enabled,
)
from rcdms_tpu_torch.utils.logging import recording, span

# flax's lecun_normal: a normal truncated at 2 sigma, rescaled to keep the
# variance 1 / fan_in (stddev of the unit normal truncated at +-2)
_TRUNC_STD = 0.87962566103423978


def sinusoidal_time_embedding(timesteps: torch.Tensor,
                              dim: int) -> torch.Tensor:
    """diffusers `get_timestep_embedding` as SD configures it (cos first,
    no frequency shift, period 10000); (batch,) -> (batch, dim) fp32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class _Fp32Params:
    """Keeps a module's parameters, its children's too, in fp32 through
    `.to(dtype)`, `.half()` and the like, as the JAX package holds them
    (`param_dtype` float32): a bf16 model rounds its activations, never
    these parameters."""

    def _apply(self, fn, recurse=True):
        # a conversion rounds: take the values from before it, on the new
        # device
        before = [p.data for p in self.parameters()]
        super()._apply(fn, recurse)
        for p, data in zip(self.parameters(), before):
            if p.dtype != torch.float32:
                p.data = data.to(p.device, torch.float32)
        return self


class TimestepEmbedding(_Fp32Params, nn.Module):
    """Two-layer SiLU MLP over the sinusoidal projection, in fp32 in any
    model dtype, as the JAX package builds it (no dtype, so flax's fp32):
    the caller rounds the sinusoid to the model dtype, this widens it, and
    the output is fp32."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample.float())))


def temporal_positional_encoding(num_frames: int, dim: int,
                                 device=None) -> torch.Tensor:
    """Sinusoidal PE over the frame axis; (num_frames, dim) fp32."""
    position = torch.arange(num_frames, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device)
                         * (-math.log(10000.0) / dim))
    args = position * div_term
    pe = torch.zeros(num_frames, dim, device=device)
    pe[:, 0::2] = torch.sin(args)
    pe[:, 1::2] = torch.cos(args[:, : dim // 2])
    return pe


class GroupNorm(_Fp32Params, nn.Module):
    """GroupNorm over channels-last (..., h, w, c) with statistics per
    leading index, so (b, f, h, w, c) gets per-frame statistics. Moments in
    fp32 as E[x^2] - E[x]^2; the affine is folded into one pass. Scale and
    bias stay fp32 in any model dtype. Rows split by a `spatial` row plan
    sum x and x^2 over their (h, w), all-reduce the sums and divide by
    the whole map's count (the blocks may differ in size, or be empty)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by "
                             f"groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not recording():  # cheaper than a span that records nothing
            return self._norm(x)
        with span("norm"):
            return self._norm(x)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        c, g = x.shape[-1], self.num_groups
        xf = x.float()
        plan = spatial.row_plan()
        if plan is None:
            s1 = xf.mean(dim=(-3, -2))
            s2 = (xf * xf).mean(dim=(-3, -2))
        else:
            sums = spatial.all_reduce_sum(torch.stack(
                [xf.sum(dim=(-3, -2)), (xf * xf).sum(dim=(-3, -2))]),
                plan.group)
            s1, s2 = sums / (plan.total(x.shape[-2]) * x.shape[-2])
        lead = s1.shape[:-1]
        mean_g = s1.reshape(lead + (g, c // g)).mean(-1)
        ex2_g = s2.reshape(lead + (g, c // g)).mean(-1)
        var_g = (ex2_g - mean_g * mean_g).clamp_min(0.0)
        mean_c = mean_g.repeat_interleave(c // g, dim=-1)
        inv_c = torch.rsqrt(var_g + self.eps).repeat_interleave(c // g,
                                                                dim=-1)
        mul = inv_c * self.weight.float()
        add = self.bias.float() - mean_c * mul
        return torch.addcmul(add[..., None, None, :], xf,
                             mul[..., None, None, :]).to(x.dtype)


class LayerNorm(_Fp32Params, nn.LayerNorm):
    """LayerNorm with fp32 statistics, cast back to the input dtype; scale
    and bias stay fp32 in any model dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not recording():  # cheaper than a span that records nothing
            return self._norm(x)
        with span("norm"):
            return self._norm(x)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class _Proj(nn.Module):
    """diffusers GEGLU/GELU holder: only its `proj` Linear is a parameter;
    the activation runs inside the fused FF kernel."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class FeedForward(nn.Module):
    """diffusers `FeedForward` (state-dict names `net.0.proj`, `net.2`),
    computed by the fused FF kernels: 'geglu' (UNet and temporal blocks,
    kernel C) or 'gelu' (the prior's blocks, kernel D); by their plain
    versions under the "plain" route (`ops/impl.py`)."""

    def __init__(self, dim: int, activation: str = "geglu", mult: int = 4):
        super().__init__()
        if activation not in ("geglu", "gelu"):
            raise ValueError(activation)
        self.activation = activation
        inner = dim * mult
        up = 2 * inner if activation == "geglu" else inner
        self.net = nn.ModuleList([_Proj(dim, up), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        geglu = self.activation == "geglu"
        fn = geglu_ff if geglu else gelu_ff
        if not impl.routes_to_wrapper(fn.__name__, x.device):
            fn = geglu_ff_plain if geglu else gelu_ff_plain
        proj_in, proj_out = self.net[0].proj, self.net[2]
        # the JAX package's FF casts its input to the model dtype
        with span("ff"):
            return fn(x.to(proj_in.weight.dtype), proj_in.weight,
                      proj_in.bias, proj_out.weight, proj_out.bias)


class Conv(nn.Conv2d):
    """Conv2d over channels-last images (..., h, w, c): the leading dims
    fold into the batch (the JAX package's `nn.Conv` over NHWC).

    Rows split by a `spatial` row plan: a conv that reads beyond its block
    of rows (k > 1 or a stride) attaches `row_halo()` rows of its
    neighbours (zeros outside the map stand for the padding), then runs
    with no row padding; a block too short for one output row (an empty
    one, or a last odd row under a stride of 2) gives none."""

    def row_halo(self) -> tuple:
        """(rows above, rows below) of a row block that the conv reads:
        its top padding above; below, what its last output reads past the
        block (k - stride - top padding)."""
        k, st, pad = self.kernel_size[0], self.stride[0], self.padding[0]
        return pad, max(0, k - st - pad)

    def run_haloed(self, haloed: torch.Tensor) -> torch.Tensor:
        """The conv over (n, h, w, c) rows that carry their halo: no row
        padding; no output rows where h is under the kernel's."""
        if haloed.shape[1] < self.kernel_size[0]:
            k, st, pad = self.kernel_size[1], self.stride[1], self.padding[1]
            cols = (haloed.shape[2] + 2 * pad - k) // st + 1
            return haloed.new_empty(
                (haloed.shape[0], 0, cols, self.out_channels))
        y = F.conv2d(haloed.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, (0, self.padding[1]), self.dilation,
                     self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x4 = x.flatten(0, -4)
        plan = spatial.row_plan()
        if plan is None:
            y = super().forward(x4.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            y = self.run_haloed(spatial.halo(x4, 1, *self.row_halo(), plan))
        return y.reshape(lead + y.shape[1:])


class FrameConv(Conv):
    """The story UNet's per-frame conv (the reference's `InflatedConv3d`),
    with the JAX `FrameConv`'s opt-in int8 route: in int8 quant mode
    (`ops/quant.py`) a 3x3, stride-1, padding-1 conv with Cin % 64 == 0
    runs `int8_conv3x3`.

    The int8 weight, its scales and the bias come from the fp32 values, as
    `_taps9_conv_int8` takes them from the fp32 `_ConvParams`: a conversion
    that rounds the weight (`.to(bfloat16)`) quantizes it first when the
    int8 mode is on, and an fp32 weight is quantized at its first int8
    call. The result is kept until the weight or bias changes (keyed on
    their `_version`, storage and dtype) and follows the module's device.
    A gated conv asked for int8 with a rounded weight and nothing quantized
    from its fp32 values raises: set the mode before the cast."""

    def _takes_int8(self) -> bool:
        return (int8_enabled() and self.kernel_size == (3, 3)
                and self.stride == (1, 1) and self.padding == (1, 1)
                and self.in_channels % 64 == 0)

    def _int8_key(self) -> tuple:
        return tuple((t._version, t.data_ptr(), t.device, t.dtype)
                     for t in (self.weight, self.bias) if t is not None)

    def _quantize(self, weight, bias) -> tuple:
        """(int8 weight, scales, fp32 bias or None) of fp32 values."""
        return conv_weight_int8(weight) + (
            None if bias is None else bias.float(),)

    def _apply(self, fn, recurse=True):
        before = (self.weight.data,
                  None if self.bias is None else self.bias.data)
        cached = getattr(self, "_int8_cache", None)
        if cached is not None and cached[0] != self._int8_key():
            cached = None  # stale: made for values the module no longer has
        super()._apply(fn, recurse)
        rounded = (before[0].dtype == torch.float32
                   and self.weight.dtype != torch.float32)
        if cached is None and rounded and self._takes_int8():
            cached = (None,) + self._quantize(*before)
        if cached is not None:  # on the new device, for the new tensors
            dev = self.weight.device
            self._int8_cache = (self._int8_key(),) + tuple(
                None if t is None else t.to(dev) for t in cached[1:])
        else:
            self._int8_cache = None
        return self

    def _int8_weight(self):
        cached = getattr(self, "_int8_cache", None)
        if cached is None or cached[0] != self._int8_key():
            if self.weight.dtype != torch.float32:
                raise RuntimeError(
                    f"FrameConv: the int8 route quantizes the fp32 weight, "
                    f"but this conv's weight is {self.weight.dtype} and "
                    f"nothing was quantized before it was rounded: set the "
                    f"int8 quant mode before casting the model")
            cached = (self._int8_key(),) + self._quantize(self.weight,
                                                          self.bias)
            self._int8_cache = cached
        return cached[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._takes_int8():
            return super().forward(x)
        lead = x.shape[:-3]
        x4 = x.flatten(0, -4)
        plan = spatial.row_plan()
        if plan is None:
            y = int8_conv3x3(x4, *self._int8_weight(), x.dtype)
        else:
            y = int8_conv3x3(spatial.halo(x4, 1, *self.row_halo(), plan),
                             *self._int8_weight(), x.dtype, haloed=True)
        return y.reshape(lead + y.shape[1:])


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal over a torch (out, in, ...) weight."""
    std = 1.0 / math.sqrt(weight[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights drawn as the JAX package's flax initializers
    draw them: lecun_normal (truncated) Linear/Conv weights, zero biases,
    unit norm scales, normal(1/sqrt(width)) embedding tables. Modules whose
    parameters flax draws otherwise (zero embeddings, zero-init output
    projections, packed projections) define `flax_init_(generator)`, which
    runs last."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=m.weight.shape[1] ** -0.5,
                            generator=generator)
    for m in module.modules():
        if hasattr(m, "flax_init_"):
            m.flax_init_(generator)
