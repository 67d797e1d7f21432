"""Kernel A at the UNet's level 0 in its two row-sum families: l from the
rounded P (`row_sum="rounded"`, as the TPU's `_nt_kernel`: the UNet's
spatial sites) and l from the fp32 P (`"fp32"`, as `_attn_kernel`: CLIP
vision), both two-pass builds of `csrc/attention.cu` (its `ROW_SUM`
template parameter): device time a call from `torch.profiler`, and each
one's error and share of bf16 outputs off the bits of the plain version
of its own family. The two alternate: rounded, fp32, fp32, rounded.

(Before the kernel rounded P against the row's final maximum, this study
built a one-pass variant that summed the rounded P from the kernel's
source; its times are in PERF.md.)

    python -m rcdms_tpu_torch.tools.attention_row_sum_study
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops.flash import (
    ROW_SUMS,
    attention_plain,
    flash_attention,
)
from rcdms_tpu_torch.tools import card_line, device_us, rel_err

SHAPE, HEADS = (1, 5, 4096, 320), 8  # UNet level 0 self-attention


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_row_sum_study: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g, device=dev).bfloat16()
               for _ in range(3))
    dh = SHAPE[-1] // HEADS
    print(f"{card_line()}  kernel A, bf16, {SHAPE} {HEADS} heads: error "
          f"against the plain version of the same family; device us a call")
    for row_sum in ROW_SUMS:
        out = flash_attention(q, k, v, HEADS, row_sum=row_sum)
        ref = attention_plain(q, k, v, HEADS, dh ** -0.5, row_sum=row_sum)
        print(f"  row_sum={row_sum:8s} rel_err {rel_err(out, ref):.3e}, "
              f"outputs off the plain version "
              f"{(out != ref).float().mean().item():.4f}")
    for row_sum in ROW_SUMS + ROW_SUMS[::-1]:
        us = sum(device_us(lambda: flash_attention(
            q, k, v, HEADS, row_sum=row_sum)).values())
        print(f"  row_sum={row_sum:8s} {us:9.2f} us", flush=True)


if __name__ == "__main__":
    main()
