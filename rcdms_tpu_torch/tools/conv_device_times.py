"""Device time by kernel of the study's bf16 3x3 conv on the card, from
`torch.profiler`: `ops.cm_conv3x3` at the study shape (its relayout and
GEMM kernels), beside cuDNN on the same tensors as `chip_smoke.py` times
it (`F.conv2d` on the padded channel-major frame: its copies and layout
transposes count) and on channels-last tensors (the study's `native`
row). CUDA events around a synchronised call, as the studies and
`chip_smoke.py` time, also hold the wrapper's host time before its first
launch; these are the kernels' own times.

    python -m rcdms_tpu_torch.tools.conv_device_times
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3
from rcdms_tpu_torch.tools import card_line
from rcdms_tpu_torch.tools import cm_conv_study as cs


def device_us(fn, reps: int = 20) -> dict[str, float]:
    """Microseconds of device time a call, per kernel name, over `reps`
    profiled calls after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = collections.Counter()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            times[e.key] += e.device_time_total / reps
    return dict(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv_device_times: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).bfloat16()

    x_nhwc = r(cs.B, cs.H, cs.W, cs.C)
    x = cs.to_cm_pad(x_nhwc)
    w9, bias = r(9, cs.C, cs.COUT, scale=(9 * cs.C) ** -0.5), r(cs.COUT)
    mask = cs.interior_mask_pad().to(dev, torch.bfloat16).reshape(cs.TPAD)
    x_frame = x[:, :, :cs.HP * cs.WP].unflatten(2, (cs.HP, cs.WP))
    w_oihw = w9.reshape(3, 3, cs.C, cs.COUT).permute(3, 2, 0, 1)
    w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
    w_oihw = w_oihw.contiguous()
    calls = {
        "cm_conv3x3": lambda: cm_conv3x3(x, w9, bias, mask, cs.WP),
        "cudnn, chip_smoke's tensors": lambda: F.conv2d(x_frame, w_oihw,
                                                        bias),
        "cudnn, channels-last (native)": lambda: cs.native(x_nhwc, w_cl,
                                                           bias),
    }
    print(f"{card_line()}  B={cs.B} {cs.H}x{cs.W} C={cs.C}->{cs.COUT} bf16")
    for name, fn in calls.items():
        times = device_us(fn)
        print(f"{name}: {sum(times.values()):.2f} us a call")
        for kernel, us in sorted(times.items(), key=lambda kv: -kv[1]):
            print(f"  {us:9.2f} us  {kernel[:100]}")


if __name__ == "__main__":
    main()
