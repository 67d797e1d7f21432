"""The prior's feed-forwards and temporal attention on the card: the port
of `tools/prior_ff_study.py`, rows 1-6 of its docstring, at the prior's
shapes: B, F, N, C = 2, 5, 97, 2048 (rows 970 = 2 CFG x 5 frames x 97
tokens, inner 8192). The rows:

  down-proj     the bare down-projection, (970, 8192) @ (8192, 2048)
  up-proj       the bare up-projection, (970, 2048) @ (2048, 8192)
  gelu pair     the plain GELU FF in bf16 as the model's plain path
                computes it (`gelu_ff_reference`: two cuBLAS products,
                the exact-erf GELU in fp32 between them)
  geglu pair    the plain GEGLU FF in bf16 (`geglu_ff_reference`)
  D 970, C 970  kernels D (`gelu_ff`) and C (`geglu_ff`) on the 970 rows
                as they are: the rows the story runs (the kernels take
                the ragged tail)
  D/C ->1024    the same on the rows padded to 1024, as the JAX study
                padded them for `fits_kernel`'s n >= 128
  C/D a x b     the plan sweep at (2048, 8192): every (pass-1, pass-2)
                column tile pair of the library (`geglu_study.sweep`)
  B kernel      kernel B (`ops.frame_attention`) at (2, 5, 97, 2048), 8
                heads, beside its plain version (`B plain`)

Every row is held against a reference before it is timed: the products
against their fp32 product, the FF rows against C's or D's plain version,
B against its plain version. Rows are timed by device time
(`torch.profiler`) beside event time. The rate counts the JAX study's
flops (the attention core: 2 B N heads F F dh 2).

    python -m rcdms_tpu_torch.tools.prior_ff_study
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops import geglu
from rcdms_tpu_torch.ops.frame_attention import (
    frame_attention,
    frame_attention_plain,
)
from rcdms_tpu_torch.tools import (
    card_line,
    device_row,
    print_rows,
    require_cuda,
)
from rcdms_tpu_torch.tools.geglu_study import (
    gemm_ms,
    print_summary,
    summary,
    sweep,
)

B, F_, N, C = 2, 5, 97, 2048
ROWS = B * F_ * N             # 970
INNER = 4 * C                 # 8192
PADDED = 1024                 # the JAX study's rows after its pad
HEADS = 8
TOL = 2e-2

gelu_pair = geglu.gelu_ff_reference
geglu_pair = geglu.geglu_ff_reference


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def padded(fn, rows: int = PADDED):
    """fn on x's rows zero-padded to `rows`, the pad sliced off after."""
    def call(x, *weights):
        return fn(F.pad(x, (0, 0, 0, rows - x.shape[0])), *weights)[
            :x.shape[0]]
    return call


def inputs(dev, dtype=torch.bfloat16, seed: int = 0) -> dict:
    """The JAX study's operands at its scales (w1 / 45, w2 / 90) in
    torch's Linear layout; biases 0.02 (the JAX study's were zero)."""
    g = torch.Generator(dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    return dict(x=r(ROWS, C), xh=r(ROWS, INNER), w1=r(INNER, C, scale=1 / 45),
                w1g=r(2 * INNER, C, scale=1 / 45),
                w2=r(C, INNER, scale=1 / 90), b1=r(INNER, scale=0.02),
                b1g=r(2 * INNER, scale=0.02), b2=r(C, scale=0.02),
                q=r(B, F_, N, C), k=r(B, F_, N, C), v=r(B, F_, N, C))


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row on the card; returns the rows (the two sweeps' summaries
    in the `summary` of the rows `C 970 (story)` and `D 970 (story)`)."""
    require_cuda(dev)
    t = inputs(dev, dtype)
    x, xh, w1, w1g, w2 = t["x"], t["xh"], t["w1"], t["w1g"], t["w2"]
    gelu_args = (x, w1, t["b1"], w2, t["b2"])
    geglu_args = (x, w1g, t["b1g"], w2, t["b2"])
    f_down = 2 * ROWS * INNER * C
    f_up = 2 * ROWS * C * INNER
    f_pair, f_geglu = f_up + f_down, 2 * f_up + f_down
    shape = f"{ROWS}x{C} inner {INNER}"
    out = [
        device_row("prior_ff", "down-proj", dtype, f"{ROWS}x{INNER}x{C}",
                   lambda: torch.matmul(xh, w2.t()),
                   F.linear(xh.float(), w2.float()), f_down,
                   _nbytes(xh, w2) + ROWS * C * 2, reps),
        device_row("prior_ff", "up-proj", dtype, f"{ROWS}x{C}x{INNER}",
                   lambda: torch.matmul(x, w1.t()),
                   F.linear(x.float(), w1.float()), f_up,
                   _nbytes(x, w1) + ROWS * INNER * 2, reps),
    ]
    for name, fl, args, plain, kernel, pair in (
            ("D", f_pair, gelu_args, geglu.gelu_ff_plain, geglu.gelu_ff,
             gelu_pair),
            ("C", f_geglu, geglu_args, geglu.geglu_ff_plain, geglu.geglu_ff,
             geglu_pair)):
        ref = plain(*args)
        nbytes = _nbytes(*args) + _nbytes(x)
        pair_row = device_row("prior_ff", "gelu pair" if name == "D"
                              else "geglu pair", dtype, shape,
                              lambda a=args, p=pair: p(*a), ref, fl, nbytes,
                              reps)
        pair_row["gemm_ms"] = gemm_ms(pair_row["kernels"])
        out.append(pair_row)
        story = device_row("prior_ff", f"{name} 970 (story)", dtype, shape,
                           lambda a=args, k=kernel: k(*a), ref, fl, nbytes,
                           reps)
        out.append(story)
        out.append(device_row("prior_ff", f"{name} 970->1024", dtype, shape,
                              lambda a=args, k=kernel: padded(k)(*a), ref,
                              fl, nbytes, reps))
        plans = sweep("prior_ff", shape, args, name == "C", ref, reps)
        story["summary"] = summary(plans)
        out += plans
    q, k, v = t["q"], t["k"], t["v"]
    scale = (C // HEADS) ** -0.5
    f_attn = 2 * B * N * HEADS * F_ * F_ * (C // HEADS) * 2
    ref = frame_attention_plain(q, k, v, HEADS, scale)
    for name, fn in (("B kernel", lambda: frame_attention(q, k, v, HEADS)),
                     ("B plain", lambda: frame_attention_plain(
                         q, k, v, HEADS, scale))):
        out.append(device_row("prior_ff", name, dtype,
                              f"({B},{F_},{N},{C}) h{HEADS}", fn, ref,
                              f_attn, 4 * _nbytes(q), reps))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prior_ff_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{card_line()}  B={B} F={F_} N={N} C={C} rows {ROWS}", flush=True)
    rows = run(torch.device("cuda"))
    print_rows(rows)
    for r in rows:
        if "summary" in r:
            print_summary(r["row"], r["summary"], next(
                p for p in rows if p["row"] == ("gelu pair" if r["row"][0]
                                                == "D" else "geglu pair")))
    print("the story runs the 970 rows as they are (C/D take the ragged "
          "tail); the ->1024 rows pay for the pad", flush=True)
    bad = [r["row"] for r in rows if not r["rel_err"] <= TOL]
    if bad:
        raise SystemExit(f"rows off their reference: {bad}")


if __name__ == "__main__":
    main()
