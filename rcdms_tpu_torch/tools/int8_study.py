"""Does w8a8 int8 pay on this card? The port of `tools/int8_study.py`,
item by item, each int8 row with its quantize and dequantize, against the
bf16 product it would replace; ratios by device time (`torch.profiler`),
event time beside it.

  [1] a 4096^3 product: `ops.quant.int_matmul` (`torch._int_mm`,
      cuBLASLt) with the dynamic quantize of the activation and the fp32
      dequantize, against a bf16 `torch.matmul`
  [2] the port's int8 route, `ops.quant.int8_conv3x3` (the activation
      quantized once, an im2col, one `_int_mm` of the nine taps, the fp32
      epilogue), against the bf16 conv it replaces (cuDNN, channels-last)
      at the JAX study's four taps9 shapes
  [3] the score shape at dh 40 (40 x 4096 x 4096 x 40): a loop of
      `_int_mm` over the batch against `torch.bmm`
  [4] the P.V shape (v^T (40, 4096) times P^T, 512 rows of P a batch
      entry), P in [0, 1] at the fixed scale 127, the same way
  [5] a native int8 convolution: unavailable, PyTorch offers no int8
      convolution on CUDA

The weight side (w, k, v) is quantized once, outside the timed call, as
in the JAX study; the activation side inside it, with the study's own
quantizer (`quant_int8`: per-tensor, symmetric). `_int_mm` takes M > 16,
K a multiple of 8 and row-major operands (`ops/quant.py`), which every
shape here meets (item 4 computes P (V^T)^T, M = 512). Each row is held
against its fp32 product first (bf16 within 2e-2, int8 within 5e-2 of
max |ref|).

    python -m rcdms_tpu_torch.tools.int8_study
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops.quant import (
    conv_weight_int8,
    int8_conv3x3,
    int_matmul,
)
from rcdms_tpu_torch.tools import (
    card_line,
    device_row,
    print_rows,
    require_cuda,
)

N = 4096
# (tokens, cin, cout, label): the JAX study's taps9 shapes, as (5, h, w)
# frames of a UNet call at sequential CFG
CONV_SHAPES = [
    (5 * 32 * 32, 640, 640, "L1"),
    (5 * 16 * 16, 1280, 1280, "L2"),
    (5 * 32 * 32, 960, 640, "up-concat"),
    (5 * 64 * 64, 320, 320, "L0"),
]
BATCH, SQ, SKV, DH, BLK = 40, 4096, 4096, 40, 512
TOL = {"bfloat16": 2e-2, "int8": 5e-2}  # by the row's dtype


def quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX study's `_quant_int8`: per-tensor symmetric dynamic
    quantization, (int8 values, fp32 scale)."""
    xf = x.float()
    scale = xf.abs().max() / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dot_i8(a, w_q, w_s):
    """The activation quantized, the exact int8 product, the fp32
    dequantize, bf16 out."""
    q, s = quant_int8(a)
    return (int_matmul(q, w_q).float() * (s * w_s)).to(torch.bfloat16)


def score_i8(qm, kt8, ks):
    """q k^T a batch entry: q (B, S, dh) quantized, k^T (B, dh, S) int8."""
    q8, s = quant_int8(qm)
    out = torch.empty(qm.shape[0], qm.shape[1], kt8.shape[2],
                      dtype=torch.bfloat16, device=qm.device)
    for i in range(qm.shape[0]):
        out[i] = (int_matmul(q8[i], kt8[i]).float() * (s * ks)).to(
            torch.bfloat16)
    return out


def pv_i8(p, vq8_t, vs):
    """P (V^T)^T a batch entry, P (B, blk, S) in [0, 1] at the fixed scale
    127 (no amax pass), V^T transposed once to (B, S, dh) int8: the
    transpose of the JAX study's v^T P^T."""
    p8 = torch.round(p.float() * 127.0).to(torch.int8)
    out = torch.empty(p.shape[0], p.shape[1], vq8_t.shape[2],
                      dtype=torch.bfloat16, device=p.device)
    for i in range(p.shape[0]):
        out[i] = (int_matmul(p8[i], vq8_t[i]).float() * (vs / 127.0)).to(
            torch.bfloat16)
    return out


def _pair(item: str, shape: str, bf16_fn, i8_fn, ref, fl, reps) -> list:
    bf = device_row("int8", f"[{item}] bf16", torch.bfloat16, shape, bf16_fn,
                    ref, fl, reps=reps)
    i8 = device_row("int8", f"[{item}] int8", torch.int8, shape, i8_fn, ref,
                    fl, reps=reps)
    i8["unit"] = "TOP/s"
    i8["ratio"] = bf["device_ms"] / i8["device_ms"]
    i8["event_ratio"] = bf["ms"] / i8["ms"]
    return [bf, i8]


def run(dev: torch.device, reps: int = 10) -> list[dict]:
    """Items 1-4 on the card: a bf16 row and an int8 row each; the int8
    row carries `ratio` (bf16 device time / int8's)."""
    require_cuda(dev)
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    out = []
    # [1] the raw product
    a, w = r(N, N), r(N, N, scale=N ** -0.5)
    w_q, w_s = quant_int8(w)
    out += _pair("1", f"{N}^3", lambda: a @ w, lambda: dot_i8(a, w_q, w_s),
                 a.float() @ w.float(), 2 * N ** 3, reps)
    del a, w, w_q
    # [2] the int8 conv route against cuDNN's bf16 conv
    for tok, cin, cout, tag in CONV_SHAPES:
        side = int((tok // 5) ** 0.5)
        x = r(5, side, side, cin)
        wt = r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        bias = r(cout, scale=0.1)
        qw, ws = conv_weight_int8(wt.float())
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        w_cl = wt.contiguous(memory_format=torch.channels_last)
        ref = F.conv2d(x_cl.float(), wt.float(), bias.float(),
                       padding=1).permute(0, 2, 3, 1)
        out += _pair(
            "2", f"{tag} ({tok},{cin})->{cout}",
            lambda x_cl=x_cl, w_cl=w_cl, b=bias: F.conv2d(
                x_cl, w_cl, b, padding=1).permute(0, 2, 3, 1),
            lambda x=x, qw=qw, ws=ws, b=bias: int8_conv3x3(
                x, qw, ws, b, torch.bfloat16),
            ref, 2 * tok * cin * cout * 9, reps)
        del x, wt, qw, ref
    # [3] score shape
    qm, km = r(BATCH, SQ, DH), r(BATCH, SKV, DH)
    kq8, ks = quant_int8(km)
    kt8 = kq8.transpose(1, 2).contiguous()
    ref = torch.bmm(qm.float(), km.float().transpose(1, 2))
    out += _pair("3", f"{BATCH}x{SQ}x{SKV} dh {DH}",
                 lambda: torch.bmm(qm, km.transpose(1, 2)),
                 lambda: score_i8(qm, kt8, ks), ref,
                 2 * BATCH * SQ * SKV * DH, reps)
    del qm, km, kq8, kt8, ref
    # [4] P.V shape, (blk, S) @ (S, dh) a batch entry
    vt = r(BATCH, DH, SKV)
    p = torch.rand(BATCH, BLK, SKV, generator=g, device=dev).to(
        torch.bfloat16)
    vq8, vs = quant_int8(vt)
    vq8_t = vq8.transpose(1, 2).contiguous()
    ref = torch.bmm(p.float(), vt.float().transpose(1, 2))
    out += _pair("4", f"{BATCH}x{DH}x{SKV} blk {BLK}",
                 lambda: torch.bmm(p, vt.transpose(1, 2)),
                 lambda: pv_i8(p, vq8_t, vs), ref,
                 2 * BATCH * DH * SKV * BLK, reps)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    rows = run(torch.device("cuda"))
    print_rows(rows)
    for r in rows:
        if r["dtype"] == "int8":
            name, us = max(r["kernels"].items(), key=lambda kv: kv[1])
            print(f"  {r['row'][:3]} {r['shape']:28s} bf16 / int8: "
                  f"{r['ratio']:.2f}x by device time, {r['event_ratio']:.2f}x "
                  f"by event time; int8's longest kernel {us / 1e3:.4f} ms "
                  f"a call ({us / 1e3 / r['device_ms']:.0%}): {name[:70]}",
                  flush=True)
    print("  [5] native int8 conv: unavailable (PyTorch has no int8 "
          "convolution on CUDA; item [2] is the port's route)", flush=True)
    bad = [(r["row"], r["shape"]) for r in rows
           if not r["rel_err"] <= TOL[r["dtype"]]]
    if bad:
        raise SystemExit(f"rows off their fp32 product: {bad}")


if __name__ == "__main__":
    main()
