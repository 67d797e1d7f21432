"""The channel-major 3x3 SAME conv of the level-0 conv study: the port's
counterpart of `tools/cm_conv_study.py::cm_conv_pallas`.

The study embeds each (h, w) frame in a zero ring, (h + 2) x (w + 2), and
lays it out channel-major as one row of T >= (h + 2)(w + 2) tokens, so the
conv's tap (dy, dx) is the plain token offset dy * wp + dx (wp = w + 2):

    out[b, d, t] = mask[t] * round(bias[d] + sum_s sum_c w9[s, c, d]
                                              * x[b, c, t + TAPS[s]])

x (B, C, T), w9 (9, C, Cout) with taps s = 3 (dy + 1) + (dx + 1), bias
(Cout,), mask (T,), all one dtype; out (B, Cout, T). Sums in fp32, the bias
added, rounded to x.dtype, then multiplied by the mask (1 on the frame's
interior, 0 on the ring and the tail, which become the next conv's zero
padding). Taps reading outside [0, T) read zero. `shifts=False` drops the
tap offsets: every tap reads x[b, c, t], the study's pure-product row.

`cm_conv3x3` dispatches on where x lies: on the CPU it runs
`cm_conv3x3_plain`; on a CUDA device it launches `csrc/cm_conv.cu` or
raises: the tensor-core kernel for bf16 with T and Cout multiples of 8,
16-byte aligned x and w9 and wp <= 95 (the study's shapes), the CUDA-core
one otherwise. `cm_conv3x3.launches` counts launches.
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops import _build

# the widest frame row whose window the tensor-core kernel holds
MAX_TC_WP = 95


def tap_offsets(wp: int, shifts: bool = True) -> list[int]:
    """Token offset of each of the nine taps, s = 3 (dy + 1) + (dx + 1)."""
    return [dy * wp + dx if shifts else 0
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def cm_conv3x3_plain(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor, wp: int,
                     shifts: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the study's nine shifted einsums (`cm_conv`),
    in fp32, then rounded to x.dtype and masked."""
    b, c, t = x.shape
    guard = wp + 1
    xbuf = torch.nn.functional.pad(x.float(), (guard, guard))
    acc = None
    for s, off in enumerate(tap_offsets(wp, shifts)):
        xs = xbuf[:, :, guard + off:guard + off + t]
        u = torch.einsum("cd,bct->bdt", w9[s].float(), xs)
        acc = u if acc is None else acc + u
    out = (acc + bias.float()[:, None]).to(x.dtype)
    return out * mask.to(x.dtype)


def cm_conv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
               mask: torch.Tensor, wp: int,
               shifts: bool = True) -> torch.Tensor:
    """The 3x3 conv in the padded channel-major layout (module docstring)."""
    b, c, t = x.shape
    cout = w9.shape[-1]
    if w9.shape != (9, c, cout) or bias.shape != (cout,) \
            or mask.shape != (t,) or wp <= 0:
        raise ValueError(f"cm_conv3x3: x {tuple(x.shape)}, w9 "
                         f"{tuple(w9.shape)}, bias {tuple(bias.shape)}, mask "
                         f"{tuple(mask.shape)}, wp {wp}")
    if x.device.type == "cpu":
        return cm_conv3x3_plain(x, w9, bias, mask, wp, shifts)
    dtype = _build.cuda_operands("cm_conv3x3", x, w9, bias, mask)
    tensor = (x.dtype == torch.bfloat16 and t % 8 == 0 and cout % 8 == 0
              and wp <= MAX_TC_WP
              and all(a.data_ptr() % 16 == 0 for a in (x, w9)))
    out = torch.empty(b, cout, t, device=x.device, dtype=x.dtype)
    code = _build.library().lib.rcdms_cm_conv_fwd(
        dtype, int(tensor), int(shifts), x.data_ptr(), w9.data_ptr(),
        bias.data_ptr(), mask.data_ptr(), out.data_ptr(), b, c, cout, t, wp,
        _build.stream(x))
    _build.check(code, "rcdms_cm_conv_fwd")
    cm_conv3x3.launches += 1
    return out


cm_conv3x3.launches = 0
