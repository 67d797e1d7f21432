"""Device time of kernel B on the card at the story's five temporal-attention
shapes, from `torch.profiler`: `ops.frame_attention` in bf16 on aligned
operands (the tiled kernel), on views 2 bytes off 16-byte alignment (the
general kernel, which takes what the tiled one does not), and SDPA over
the same q, k, v laid out as (b n, heads, f, dh) beforehand, as
`chip_smoke.py` times it; each beside the shape's bound (4 b f n c bytes at
3.35 TB/s). CUDA events around a synchronised call, as `chip_smoke.py`
times, also hold the wrapper's host time before its launch; these are the
kernels' own times.

    python -m rcdms_tpu_torch.tools.frame_attention_times
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops.frame_attention import frame_attention
from rcdms_tpu_torch.tools import PEAK_BYTES, card_line, device_us

# (b, f, n, c) with 8 heads: UNet levels 0-3, the prior (CFG batch 2)
SHAPES = ((1, 5, 4096, 320), (1, 5, 1024, 640), (1, 5, 256, 1280),
          (1, 5, 64, 1280), (2, 5, 97, 2048))
HEADS = 8


def rows(dev: torch.device, shapes=SHAPES) -> list[dict]:
    """One dict a shape: device microseconds a call of the tiled kernel,
    the general kernel and SDPA, and the bound."""
    g = torch.Generator(dev).manual_seed(0)
    out = []
    for shape in shapes:
        b, f, n, c = shape
        dh = c // HEADS
        size = math.prod(shape)

        def r(offset=0):
            flat = torch.randn(size + offset, generator=g, device=dev)
            return flat.bfloat16()[offset:].view(shape)

        aligned = [r() for _ in range(3)]
        unaligned = [r(1) for _ in range(3)]
        per_token = [t.transpose(1, 2).reshape(b * n, f, HEADS, dh)
                     .transpose(1, 2).contiguous() for t in aligned]
        calls = {
            "tiled": lambda: frame_attention(*aligned, HEADS),
            "general": lambda: frame_attention(*unaligned, HEADS),
            "sdpa": lambda: F.scaled_dot_product_attention(
                *per_token, scale=dh ** -0.5),
        }
        row = dict(shape=shape,
                   bound_us=4 * size * 2 / PEAK_BYTES * 1e6)
        for name, fn in calls.items():
            times = device_us(fn)
            row[name] = sum(times.values())
            row[name + "_kernels"] = {k[:80]: v for k, v in times.items()}
        out.append(row)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("frame_attention_times: needs a CUDA card")
    dev = torch.device("cuda")
    print(f"{card_line()}  kernel B, bf16, {HEADS} heads: device us a call")
    for row in rows(dev):
        print(f"{'x'.join(map(str, row['shape'])):16s} tiled "
              f"{row['tiled']:8.2f} ({row['bound_us'] / row['tiled']:6.1%} "
              f"of the {row['bound_us']:.2f} us bound)  general "
              f"{row['general']:8.2f}  sdpa {row['sdpa']:8.2f}", flush=True)
        for name in ("tiled", "general", "sdpa"):
            for kernel, us in row[name + "_kernels"].items():
                print(f"    {name:8s} {us:8.2f} us  {kernel}")


if __name__ == "__main__":
    main()
