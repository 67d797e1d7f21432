"""Conv formulation study on the card: the port of
`tools/conv_variants_study.py`.

The JAX study asks whether the stage-2 UNet's 3x3 convs run faster as
products whose pads are smaller than the conv's on the MXU. On the card
the question is the same against cuDNN: does a 3x3 conv written as
cuBLAS products, with its shifts or its materialised copies, beat
cuDNN's conv, and what do the bare products cost without the shifts?
NHWC activations (b, h, w, c) and HWIO weights (3, 3, cin, cout), as the
JAX study's:

  cudnn_conv     `F.conv2d` on channels-last tensors (the JAX xla_conv)
  taps9_nhwc     the sum of 9 shifted (b h w, cin) @ (cin, cout) products
  rows3_nhwc     3 row-shifted copies concatenated, then 3 column-shifted
                 (b h w, 3 cin) @ (3 cin, cout) products
  im2col_nhwc    one (b h w, 9 cin) @ (9 cin, cout) product of the 9
                 shifted copies
  taps9_cm       channel-major: the sum of 9 w_tap (cout, cin) @ x (cin,
                 h w) products of shifted views
  matmul_im2col  the bare (b h w, 9 cin) @ (9 cin, cout) product, no
                 gather (an anchor)
  matmul_taps_cm the bare 9 (cout, cin) @ (b, cin, h w) products, each
                 tap's weight `roll`ed so that no two products are one
                 (an anchor)

Each formulation's product runs in the inputs' dtype (cuBLAS accumulates
in fp32) and the taps are summed in an fp32 accumulator, cast to the
inputs' dtype at the end, as the JAX study's
`preferred_element_type=float32`. Each formulation is held against
`cudnn_conv` (max |diff| / max |cudnn_conv|, `rel_err`), then timed by
`tools.device_row` against the direct conv's flops, 2 b h w 9 cin cout.

    python -m rcdms_tpu_torch.tools.conv_variants_study [--level 0|1|2]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.tools import card_line, device_row, print_rows, \
    require_cuda

# level -> (batch = b*f*cfg-seq, H, W, C), the JAX study's
LEVELS = {0: (10, 64, 64, 320), 1: (10, 32, 32, 640), 2: (10, 16, 16, 1280)}
# a formulation's bf16 rel_err against cudnn_conv at most (phase 3's bf16
# tolerance in chip_smoke.py, whose phase 16 checks it)
TOL = 2e-2


def conv_flops(b: int, h: int, w: int, cin: int, cout: int) -> int:
    return 2 * b * h * w * 9 * cin * cout


def cudnn_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b, h, w, c), w (3, 3, cin, cout) -> (b, h, w, cout): the conv on
    channels-last views (no copy where x is contiguous NHWC)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """NHWC x with `rows` zero rows above and below, `cols` columns left
    and right."""
    return F.pad(x, (0, 0, cols, cols, rows, rows))


def taps9_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, ww, _ = x.shape
    xp = _pad(x, 1, 1)
    acc = x.new_zeros((b, h, ww, w.shape[-1]), dtype=torch.float32)
    for dy in range(3):
        for dx in range(3):
            acc += torch.matmul(xp[:, dy:dy + h, dx:dx + ww], w[dy, dx])
    return acc.to(x.dtype)


def rows3_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, ww, c = x.shape
    cout = w.shape[-1]
    xp = _pad(x, 1, 0)
    rows = _pad(torch.cat([xp[:, dy:dy + h] for dy in range(3)], dim=-1),
                0, 1)                                      # (b, h, w+2, 3c)
    # rows' channel blocks are dy-major, so the per-dx weight concatenates
    # over dy: w3[dx] = [w[0, dx]; w[1, dx]; w[2, dx]]
    w3 = w.permute(1, 0, 2, 3).reshape(3, 3 * c, cout)
    acc = x.new_zeros((b, h, ww, cout), dtype=torch.float32)
    for dx in range(3):
        acc += torch.matmul(rows[:, :, dx:dx + ww], w3[dx])
    return acc.to(x.dtype)


def im2col_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, ww, c = x.shape
    xp = _pad(x, 1, 1)
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + ww]
                      for dy in range(3) for dx in range(3)], dim=-1)
    return torch.matmul(cols, w.reshape(9 * c, w.shape[-1]))


def taps9_cm(xt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Channel-major: xt (b, c, h, w) -> (b, cout, h, w)."""
    b, c, h, ww = xt.shape
    cout = w.shape[-1]
    xp = F.pad(xt, (1, 1, 1, 1))
    acc = xt.new_zeros((b, cout, h * ww), dtype=torch.float32)
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, :, dy:dy + h, dx:dx + ww].reshape(b, c, h * ww)
            acc += torch.matmul(w[dy, dx].t(), xs)
    return acc.view(b, cout, h, ww).to(xt.dtype)


def matmul_im2col(a: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return a @ wb


def matmul_taps_cm(wm: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    """Nine (cout, cin) @ (b, cin, n) products summed in fp32; each tap's
    weight rolled along cout, so that nine equal products are not one."""
    acc = xm.new_zeros((xm.shape[0], wm.shape[0], xm.shape[2]),
                       dtype=torch.float32)
    for i in range(9):
        acc += torch.matmul(torch.roll(wm, i, dims=0), xm)
    return acc


FORMULATIONS = {"cudnn_conv": cudnn_conv, "taps9_nhwc": taps9_nhwc,
                "rows3_nhwc": rows3_nhwc, "im2col_nhwc": im2col_nhwc,
                "taps9_cm": taps9_cm}


def operands(level: int, dev, dtype=torch.bfloat16) -> tuple:
    """x (b, h, w, c) standard normal and w (3, 3, c, c) at 0.02, seeded."""
    b, h, w_, c = LEVELS[level]
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(b, h, w_, c, generator=g, device=dev).to(dtype)
    w = (torch.randn(3, 3, c, c, generator=g, device=dev) * 0.02).to(dtype)
    return x, w


def run(level: int, dev: torch.device, reps: int = 10) -> list[dict]:
    """Every formulation and anchor at `level` on the card; a
    formulation's `rel_err` is against `cudnn_conv`, an anchor's None."""
    require_cuda(dev)
    b, h, w_, c = LEVELS[level]
    dtype = torch.bfloat16
    x, w = operands(level, dev, dtype)
    xt = x.permute(0, 3, 1, 2).contiguous()
    fl = conv_flops(b, h, w_, c, c)
    shape = f"L{level} ({b},{h},{w_},{c})"
    ref = cudnn_conv(x, w)
    out = []
    for name, fn in FORMULATIONS.items():
        inp, want = (xt, ref.permute(0, 3, 1, 2)) if name == "taps9_cm" \
            else (x, ref)
        nbytes = (inp.numel() + w.numel() + ref.numel()) * x.element_size()
        out.append(device_row("conv_variants", name, dtype, shape,
                              lambda fn=fn, inp=inp: fn(inp, w), want, fl,
                              nbytes, reps))
    g = torch.Generator(dev).manual_seed(1)
    tok = b * h * w_

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    a, wb = r(tok, 9 * c), r(9 * c, c)
    out.append(device_row("conv_variants", "matmul_im2col", dtype, shape,
                          lambda: matmul_im2col(a, wb), None, fl,
                          (a.numel() + wb.numel() + tok * c) * 2, reps,
                          anchor="no gather cost"))
    del a, wb
    wm, xm = r(c, c), r(b, c, h * w_)
    out.append(device_row("conv_variants", "matmul_taps_cm", dtype, shape,
                          lambda: matmul_taps_cm(wm, xm), None, fl,
                          (wm.numel() + 2 * xm.numel()) * 2, reps,
                          anchor="no shift cost"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, default=0, choices=[0, 1, 2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, w_, c = LEVELS[args.level]
    print(card_line(), flush=True)
    print(f"level {args.level}: x ({b}, {h}, {w_}, {c}) bf16, "
          f"{conv_flops(b, h, w_, c, c) / 1e9:.2f} GFLOP/conv", flush=True)
    rows = run(args.level, torch.device("cuda"))
    print_rows(rows)
    bad = [r["row"] for r in rows
           if r["rel_err"] is not None and not r["rel_err"] <= TOL]
    if bad:
        raise SystemExit(f"formulations off cudnn_conv: {bad}")


if __name__ == "__main__":
    main()
