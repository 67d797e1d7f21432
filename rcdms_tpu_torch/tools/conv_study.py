"""Bare 3x3 conv study on the card: the port of `tools/conv_study.py`.

The JAX study times the stage-2 UNet's dominant 3x3 NHWC convs against
its ceiling, to see whether a hand-written conv kernel has headroom. Here
the same six convs are cuDNN's, through `F.conv2d` in bf16 on
channels-last tensors (the port's own layout on a card), with
`torch.backends.cudnn.benchmark` off so that each call takes one fixed
algorithm, and each is read against the card's bf16 peak (989 TFLOP/s,
`tools.bound_ms`) by device time (`tools.device_row`, event time beside
it). Each row prints the cuDNN kernels its call ran.

The rows' flops are a direct conv's, 2 b h w 9 Cin Cout. A kernel whose
name shows an algorithm that does less work than that (Winograd, FFT;
`FEWER_FLOPS`) can run under the direct conv's bound, so such a row is
timed by events alone (`tools.timed_row`), says which algorithm it took,
and keeps its kernels' names and device time beside the event time.

    python -m rcdms_tpu_torch.tools.conv_study
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    device_row,
    device_us,
    require_cuda,
    timed_row,
)

# (row, b, h, w, cin, cout): the JAX study's `bench_conv` calls, in its
# order (batch = b*f = 25 at sequential CFG and b = 5 stories; 50 with the
# CFG branches batched)
ROWS = [
    ("L0 (25,64,64,320->320)", 25, 64, 64, 320, 320),
    ("L1 (25,32,32,640->640)", 25, 32, 32, 640, 640),
    ("L2 (25,16,16,1280)", 25, 16, 16, 1280, 1280),
    ("L3 (25,8,8,1280)", 25, 8, 8, 1280, 1280),
    ("up0 cat (25,64,64,640->320)", 25, 64, 64, 640, 320),
    ("L0 batched-cfg (50,...)", 50, 64, 64, 320, 320),
]
# kernel names of cuDNN algorithms that do fewer products than a direct
# conv
FEWER_FLOPS = re.compile(r"winograd|fft", re.I)


def flops(b: int, h: int, w: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * b * h * w * k * k * cin * cout


def operands(b: int, h: int, w: int, cin: int, cout: int, dev,
             dtype=torch.bfloat16) -> tuple:
    """x (b, cin, h, w) and the weight (cout, cin, 3, 3), channels-last,
    seeded standard normal (the weight scaled by 1 / sqrt(9 cin))."""
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(b, cin, h, w, generator=g, device=dev)
    wt = torch.randn(cout, cin, 3, 3, generator=g, device=dev) \
        / (9 * cin) ** 0.5
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl),
            wt.to(dtype).contiguous(memory_format=cl))


def algorithm(kernels: dict) -> str:
    """"winograd" or "fft" where a kernel name shows one, else
    "direct"."""
    for name in kernels:
        m = FEWER_FLOPS.search(name)
        if m:
            return m.group(0).lower()
    return "direct"


def run(dev: torch.device, reps: int = 10) -> list[dict]:
    """Every conv on the card; returns the rows (`kernels`: us a call by
    kernel name; `algorithm`; `share`: of the direct conv's bound)."""
    require_cuda(dev)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    out = []
    try:
        for name, b, h, w, cin, cout in ROWS:
            x, wt = operands(b, h, w, cin, cout, dev)

            def conv():
                return F.conv2d(x, wt, padding=1)

            ref = F.conv2d(x.float(), wt.float(), padding=1)
            fl = flops(b, h, w, cin, cout)
            nbytes = (x.numel() + wt.numel() + b * cout * h * w) * 2
            shape = f"({b},{h},{w},{cin})->{cout}"
            kernels = device_us(conv, reps=2 * reps)
            algo = algorithm(kernels)
            if algo == "direct":
                row = device_row("conv", name, x.dtype, shape, conv, ref, fl,
                                 nbytes, reps, kernels=kernels)
            else:
                row = timed_row("conv", name, x.dtype, shape, conv, ref, fl,
                                bound_ms(fl, 0.0, nbytes), reps)
                row["device_ms"] = sum(kernels.values()) / 1e3
                row["kernels"] = kernels
            row["algorithm"] = algo
            row["share"] = row["bound_ms"] / (
                row["device_ms"] if algo == "direct" else row["ms"])
            out.append(row)
            del x, wt, ref
    finally:
        torch.backends.cudnn.benchmark = benchmark
    return out


def print_conv_rows(rows: list[dict]) -> None:
    """One line a row (its rate and share by device time, or by event
    time where its algorithm does fewer products), then its kernels."""
    for r in rows:
        by = "device" if r["algorithm"] == "direct" else "event"
        print(f"{r['row']:28s} device {r['device_ms']:8.4f} ms event "
              f"{r['ms']:8.4f} ms {r['rate']:6.1f} TF/s by {by} time "
              f"({r['share'] * 100:4.1f}% of the bound at 989 TF/s; "
              f"{r['algorithm']}; rel_err {r['rel_err']:.2e})", flush=True)
        for name, us in sorted(r["kernels"].items(), key=lambda kv: -kv[1]):
            print(f"    {us:9.2f} us  {name[:140]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv_study: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print_conv_rows(run(torch.device("cuda")))


if __name__ == "__main__":
    main()
