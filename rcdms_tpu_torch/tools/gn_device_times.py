"""Device time of the fused GroupNorm + SiLU on the card, from
`torch.profiler`, at the study's four shapes and at (5, 4096, 960), the
first ResNet block of the UNet's up level 0, in bf16, 32 groups, eps 1e-6:
the cluster kernel (`ops.group_norm_act`), the first port's kernel (one
block a group slab, `ops.group_norm.group_norm_act_slab`; it refuses
(5, 4096, 960)), F.group_norm + F.silu and F.group_norm alone (on a
channels-first copy made outside the timing, as the study times them),
beside the bound (x read once and written once at 3.35 TB/s). CUDA
events around a call, as `chip_smoke.py` times, also hold the wrapper's
host time; these are the kernels' own times.

    python -m rcdms_tpu_torch.tools.gn_device_times
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops.group_norm import (
    group_norm_act,
    group_norm_act_plain,
    group_norm_act_slab,
)
from rcdms_tpu_torch.tools import bound_ms, card_line, rel_err
from rcdms_tpu_torch.tools import gn_fused_study as gs
from rcdms_tpu_torch.tools.conv_device_times import device_us

SHAPES = gs.SHAPES + [(5, 4096, 960)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_device_times: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    print(f"{card_line()}  bf16, groups={gs.GROUPS} eps={gs.EPS}: device "
          f"us a call (kernels summed), share of the bound")
    for b, n, c in SHAPES:
        x = torch.randn(b, n, c, generator=g, device=dev).bfloat16()
        scale = torch.randn(c, generator=g, device=dev) * 0.5 + 1.0
        bias = torch.randn(c, generator=g, device=dev) * 0.2
        x_cf = x.transpose(1, 2).contiguous()
        args = (x, scale, bias, gs.GROUPS, gs.EPS, "silu")
        ref = group_norm_act_plain(*args)
        calls = {"cluster kernel": lambda: group_norm_act(*args),
                 "first kernel": lambda: group_norm_act_slab(*args),
                 "F.group_norm + F.silu": lambda: gs.torch_gn(x_cf, scale,
                                                              bias),
                 "F.group_norm": lambda: F.group_norm(
                     x_cf, gs.GROUPS, scale.bfloat16(), bias.bfloat16(),
                     gs.EPS)}
        bound, _ = bound_ms(nbytes=2 * x.numel() * x.element_size())
        print(f"  {b}x{n}x{c}: bound {bound * 1e3:.2f} us", flush=True)
        for name, fn in calls.items():
            try:
                out = fn()
            except ValueError as e:  # the first kernel's slab refusal
                print(f"    {name:22s} refused: {e}", flush=True)
                continue
            err = ("" if name.startswith("F.") else
                   f"  rel_err {rel_err(out, ref):.2e}")
            us = sum(device_us(fn).values())
            print(f"    {name:22s} {us:9.2f} us  {bound * 1e3 / us:6.1%} of "
                  f"bound{err}", flush=True)


if __name__ == "__main__":
    main()
