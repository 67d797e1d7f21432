"""Channel-major 3x3 conv study on the card: the port of
`tools/cm_conv_study.py`, at its shape (SD-1.5 UNet level 0: B = 5 frames,
64 x 64, C = Cout = 320).

The JAX study asked whether a channel-major formulation, the frame
embedded in a zero ring and laid out (C, tokens) so each tap is a token
offset, beats the native conv at level 0 on the TPU. Here the same rows ask
it of the H100, where the native conv is cuDNN's:

  native          F.conv2d on channels-last tensors (cuDNN)
  taps9_tok       token-major: nine shifted (tokens, C) x (C, Cout) products
  cm_wx, cm_xw    channel-major: nine shifted einsums, weights or
                  activations as the left operand (the study's `cm_conv`)
  cm_conv3x3      the hand-written kernel (`ops.cm_conv3x3`) on the frame
                  padded to TPAD tokens: the study's `cm_pallas` row
  cm_conv3x3_dots the kernel without the tap offsets (wrong results, the
                  pure product rate): the study's `cm_pl_dots` row

Every row but the last is held against `native` on the interior, as the
JAX study does (rel < 2e-2 in bf16). Rates count real conv work only
(interior 64 x 64 outputs), so the padded tokens count against the
channel-major rows. The plain rows take PyTorch's matmul in the operand
type, which rounds each tap's product to it before the fp32 sum (the JAX
rows kept fp32 products).

    python -m rcdms_tpu_torch.tools.cm_conv_study
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.io.bridge import hwio_to_conv_weight
from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3, tap_offsets
from rcdms_tpu_torch.tools import (
    card_line,
    median_ms,
    print_rows,
    rel_err,
    require_cuda,
)

B, H, W = 5, 64, 64
HP, WP = H + 2, W + 2           # zero-padded frame
T, TP = H * W, HP * WP
GUARD = WP + 2                  # max |tap offset| + 1: keeps slices in-buffer
TPAD = 4608                     # the study's padded token count
C = COUT = 320


def real_flops(b: int, c: int, cout: int) -> float:
    return 2.0 * b * T * 9 * c * cout


# --- layout helpers (NHWC <-> padded channel-major), as the study's -------


def to_cm(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, TP) with the frame at rows/cols [1, 65)."""
    b, h, w, c = x_nhwc.shape
    xt = F.pad(x_nhwc.permute(0, 3, 1, 2), (1, 1, 1, 1))
    return xt.reshape(b, c, TP)


def from_cm(x_cm: torch.Tensor) -> torch.Tensor:
    """(B, C, TP) -> (B, H, W, C), interior only."""
    b, c, _ = x_cm.shape
    xt = x_cm.reshape(b, c, HP, WP)[:, :, 1:-1, 1:-1]
    return xt.permute(0, 2, 3, 1)


def interior_mask() -> torch.Tensor:
    """(1, 1, TP) float32 mask: 1 on interior tokens, 0 on the pad ring."""
    m = torch.zeros(HP, WP)
    m[1:-1, 1:-1] = 1.0
    return m.reshape(1, 1, TP)


def to_cm_pad(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, TPAD): `to_cm` with a zero tail."""
    return F.pad(to_cm(x_nhwc), (0, TPAD - TP))


def interior_mask_pad() -> torch.Tensor:
    """(1, 1, TPAD) float32 mask: `interior_mask` with a zero tail."""
    return F.pad(interior_mask(), (0, TPAD - TP))


# --- the rows -------------------------------------------------------------


def native(x_nhwc: torch.Tensor, w_oihw: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """F.conv2d on channels-last memory (NHWC in, NHWC out)."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_oihw, bias, padding=1)
    return y.permute(0, 2, 3, 1)


def taps9_tok(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Token-major 3x3 SAME conv: nine shifted (tokens, C) x (C, Cout)
    products summed in fp32 (the JAX package's `_taps9_conv`)."""
    _, h, w, _ = x_nhwc.shape
    xp = F.pad(x_nhwc, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("bhwc,cd->bhwd", xp[:, dy:dy + h, dx:dx + w],
                             w_hwio[dy, dx]).float()
            acc = t if acc is None else acc + t
    return (acc + bias.float()).to(x_nhwc.dtype)


def cm_conv(x_cm: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
            mask: torch.Tensor, order: str = "wx") -> torch.Tensor:
    """Channel-major 3x3 SAME conv on (B, C, TP): nine shifted einsums over
    a buffer with GUARD zeros on both ends, ring re-zeroed by `mask`."""
    xbuf = F.pad(x_cm, (GUARD, GUARD))
    acc = None
    for i, s in enumerate(tap_offsets(WP)):
        xs = xbuf[:, :, GUARD + s:GUARD + s + TP]
        if order == "wx":
            t = torch.einsum("cd,bct->bdt", w9[i], xs)
        else:
            t = torch.einsum("bct,cd->bdt", xs, w9[i])
        acc = t.float() if acc is None else acc + t.float()
    out = acc + bias.float()[None, :, None]
    return (out * mask).to(x_cm.dtype)


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at the study's shape on the card; returns the rows."""
    require_cuda(dev)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(B, H, W, C, generator=g, device=dev).to(dtype)
    w_hwio = (torch.randn(3, 3, C, COUT, generator=g, device=dev)
              / math.sqrt(9 * C)).to(dtype)
    bias = torch.randn(COUT, generator=g, device=dev).to(dtype)
    w9 = w_hwio.reshape(9, C, COUT)
    w_oihw = hwio_to_conv_weight(w_hwio).to(
        memory_format=torch.channels_last)
    mask = interior_mask().to(dev)
    x_cm = to_cm(x)
    x_cmp = to_cm_pad(x)
    mask_p = interior_mask_pad().to(dev, dtype).reshape(TPAD)

    def interior(y_cm):  # (B, Cout, TP or TPAD) -> (B, H, W, Cout)
        return from_cm(y_cm[:, :, :TP])

    rows = [
        ("native", lambda: native(x, w_oihw, bias), None),
        ("taps9_tok", lambda: taps9_tok(x, w_hwio, bias), None),
        ("cm_wx", lambda: cm_conv(x_cm, w9, bias, mask, "wx"), interior),
        ("cm_xw", lambda: cm_conv(x_cm, w9, bias, mask, "xw"), interior),
        ("cm_conv3x3", lambda: cm_conv3x3(x_cmp, w9, bias, mask_p, WP),
         interior),
        ("cm_conv3x3_dots", lambda: cm_conv3x3(x_cmp, w9, bias, mask_p, WP,
                                               shifts=False), None),
    ]
    ref = native(x, w_oihw, bias)
    flops = real_flops(B, C, COUT)
    out = []
    for name, fn, to_nhwc in rows:
        err = None
        if name != "cm_conv3x3_dots":
            y = fn()
            err = rel_err(to_nhwc(y) if to_nhwc else y, ref)
        ms = median_ms(fn, reps)
        out.append(dict(study="cm_conv", row=name, dtype=str(dtype)[6:],
                        shape=f"{B}x{H}x{W} {C}->{COUT}", ms=ms,
                        rate=flops / ms / 1e9, unit="TFLOP/s", rel_err=err))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cm_conv_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{card_line()}  B={B} {H}x{W} C={C}->{COUT}")
    rows = run(torch.device("cuda"))
    print_rows(rows)
    bad = [r["row"] for r in rows
           if r["rel_err"] is not None and not r["rel_err"] < 2e-2]
    if bad:
        raise SystemExit(f"rows disagree with native: {bad}")


if __name__ == "__main__":
    main()
