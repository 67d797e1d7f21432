"""GEGLU feed-forward (kernel C) plan sweep on the card: the port of
`tools/geglu_study.py`, at every C site of the story: the JAX study's
UNet levels 0-2, level 3 and the prior's temporal FF (rows = B * n, c,
inner = 4c; `tests/test_torch_kernel_plans.py::FF_SITES`).

C runs two passes of one TMA + `wgmma` GEMM kernel (`csrc/ff.cu`): pass 1
writes the activated (rows, inner) intermediate, pass 2 the output. The
rows, per site:

  anchor      the unfused pair in bf16, `ops.geglu.geglu_ff_reference`
              (the JAX study's anchor, `_xla_reference`): two cuBLAS
              products with the biases and the GEGLU between them, the
              intermediate written and read back as C's passes do
  C a x b     `geglu_ff` with pass 1's column tile a and pass 2's b
              (`geglu.set_plan_override`), every pair the library holds
              (`geglu.LIBRARY_WIDTHS`); `default` marks `_plan`'s own

Each row is held against C's plain version (`geglu_ff_plain`) before it is
timed. Device time (`torch.profiler`) ranks the rows: event times of
small launches carry the wrapper's host time. A sweep row also splits its
device time by pass (`pass1_us`, `pass2_us`), so the best width of each
pass shows apart. The rate counts the JAX study's flops, 2 rows c 2 inner
+ 2 rows inner c; the bound is those flops at the bf16 peak or x, the
weights and y moved once.

    python -m rcdms_tpu_torch.tools.geglu_study
"""

from __future__ import annotations

import re

import torch

from rcdms_tpu_torch.ops import geglu
from rcdms_tpu_torch.tools import (
    card_line,
    device_row,
    print_rows,
    require_cuda,
)

# (label, B, n, c): B = b*f at sequential CFG, inner = 4c; the first three
# are the JAX study's SHAPES, then level 3 and the prior's temporal FF
# (rows 2 CFG x 5 frames x 97 tokens)
SHAPES = [
    ("L0", 5, 4096, 320),
    ("L1", 5, 1024, 640),
    ("L2", 5, 256, 1280),
    ("L3", 5, 64, 1280),
    ("prior", 10, 97, 2048),
]
TOL = 2e-2  # bf16, as chip_smoke.py phase 3 holds C

anchor = geglu.geglu_ff_reference


def flops(rows: int, c: int, inner: int, geglu_: bool = True) -> int:
    """The JAX study's count (`fl`): the up-projection (both halves for
    GEGLU) and the down-projection."""
    return 2 * rows * c * (2 if geglu_ else 1) * inner + 2 * rows * inner * c


def ff_inputs(rows: int, c: int, dev, dtype=torch.bfloat16,
              seed: int = 0) -> tuple:
    """x (rows, c) standard normal and C's weights in torch's Linear
    layout at the JAX study's scale (0.02), biases 0.02 too (the JAX study
    drew them zero)."""
    g = torch.Generator(dev).manual_seed(seed)
    inner = 4 * c
    up = 2 * inner

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    return (r(rows, c), r(up, c, scale=0.02), r(up, scale=0.02),
            r(c, inner, scale=0.02), r(c, scale=0.02))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pass_us(kernels: dict) -> tuple[float, float]:
    """(pass 1, pass 2) device us of the FF GEMM kernels in a profile:
    `ff_gemm_kernel<BN, MODE>`, mode 0 (bias) being pass 2."""
    p1 = p2 = 0.0
    for name, us in kernels.items():
        m = re.search(r"ff_gemm_kernel<(\d+), (\d)>", name)
        if m is None:
            continue
        if m.group(2) == "0":
            p2 += us
        else:
            p1 += us
    return p1, p2


def sweep(study: str, label: str, args: tuple, geglu_: bool,
          ref: torch.Tensor, reps: int = 10) -> list[dict]:
    """C (geglu_) or D at every (pass-1, pass-2) column tile pair of the
    library, through the plan override (reset in a `finally`)."""
    x, w2 = args[0], args[3]
    rows, c = x.shape
    inner = w2.shape[1]
    mode = "geglu" if geglu_ else "gelu"
    fn = geglu.geglu_ff if geglu_ else geglu.gelu_ff
    default = geglu._plan(rows, c, inner, geglu_)
    default = (default["pass1"]["bn"], default["pass2"]["bn"])
    fl = flops(rows, c, inner, geglu_)
    nbytes = _nbytes(*args) + _nbytes(x)
    out = []
    try:
        for bn1 in geglu.LIBRARY_WIDTHS[mode]:
            for bn2 in geglu.LIBRARY_WIDTHS["bias"]:
                geglu.set_plan_override(bn1, bn2)
                row = device_row(
                    study, f"{'C' if geglu_ else 'D'} {bn1}x{bn2}",
                    x.dtype, label, lambda: fn(*args), ref, fl, nbytes,
                    reps, plan=(bn1, bn2), default=(bn1, bn2) == default)
                row["pass1_us"], row["pass2_us"] = pass_us(row["kernels"])
                out.append(row)
    finally:
        geglu.set_plan_override(None)
    return out


def summary(rows: list[dict]) -> dict:
    """The default plan's device ms beside the best pair's, and the best
    width of each pass by its own device time."""
    plans = [r for r in rows if "plan" in r]
    best = min(plans, key=lambda r: r["device_ms"])
    dflt = next(r for r in plans if r["default"])
    p1 = min(plans, key=lambda r: r["pass1_us"])
    p2 = min(plans, key=lambda r: r["pass2_us"])
    return dict(default=dflt["plan"], default_ms=dflt["device_ms"],
                best=best["plan"], best_ms=best["device_ms"],
                best_pass1=p1["plan"][0], best_pass1_us=p1["pass1_us"],
                default_pass1_us=dflt["pass1_us"],
                best_pass2=p2["plan"][1], best_pass2_us=p2["pass2_us"],
                default_pass2_us=dflt["pass2_us"])


def print_summary(label: str, s: dict, anchor_row: dict) -> None:
    print(f"  {label}: default {s['default']} {s['default_ms']:.4f} ms, "
          f"best {s['best']} {s['best_ms']:.4f} ms "
          f"({s['default_ms'] / s['best_ms']:.3f}x); pass 1 best "
          f"{s['best_pass1']} {s['best_pass1_us']:.1f} us (default "
          f"{s['default_pass1_us']:.1f}), pass 2 best {s['best_pass2']} "
          f"{s['best_pass2_us']:.1f} us (default {s['default_pass2_us']:.1f}"
          f"); anchor {anchor_row['device_ms']:.4f} ms device "
          f"({anchor_row['gemm_ms']:.4f} in its two cuBLAS products), "
          f"{anchor_row['ms']:.4f} ms event", flush=True)


def gemm_ms(kernels: dict) -> float:
    """ms of the cuBLAS GEMM kernels in a profile, by name."""
    return sum(us for name, us in kernels.items()
               if re.search(r"gemm|xmma|cutlass|sm90_|nvjet", name, re.I)
               and "ff_gemm_kernel" not in name) / 1e3


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at every site on the card; returns the rows (a site's
    summary in its anchor row's `summary`)."""
    require_cuda(dev)
    out = []
    for label, b, n, c in SHAPES:
        rows, inner = b * n, 4 * c
        args = ff_inputs(rows, c, dev, dtype)
        ref = geglu.geglu_ff_plain(*args)
        shape = f"{label} {rows}x{c}"
        a = device_row("geglu", "anchor", dtype, shape,
                       lambda: anchor(*args), ref, flops(rows, c, inner),
                       _nbytes(*args) + _nbytes(args[0]), reps)
        a["gemm_ms"] = gemm_ms(a["kernels"])
        plans = sweep("geglu", shape, args, True, ref, reps)
        a["summary"] = summary(plans)
        out += [a, *plans]
        del args, ref
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("geglu_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    rows = run(torch.device("cuda"))
    for label, b, n, c in SHAPES:
        site = [r for r in rows if r["shape"] == f"{label} {b * n}x{c}"]
        print(f"{label}: x ({b * n}, {c}), inner {4 * c}, "
              f"{flops(b * n, c, 4 * c) / 1e9:.1f} GFLOP", flush=True)
        print_rows(site)
        print_summary(label, site[0]["summary"], site[0])
    bad = [(r["shape"], r["row"]) for r in rows if not r["rel_err"] <= TOL]
    if bad:
        raise SystemExit(f"rows off C's plain version: {bad}")


if __name__ == "__main__":
    main()
