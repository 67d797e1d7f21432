"""Fused GroupNorm + SiLU study on the card: the port of
`tools/gn_fused_study.py`, at its four shapes (every stage-2 UNet GN+SiLU
site at sequential-CFG batch 5: levels 0-2 and the 960-channel up-block
concat), 32 groups, eps 1e-6.

The JAX study asked whether one pass over x (its VMEM-resident slice)
beats XLA's two fusions (moments, then the normalise/SiLU map). Here the
question goes to the H100:

  two_pass        the plain version (`ops.group_norm_act_plain`): fp32
                  moments, group fold, then the normalising map and SiLU, as
                  the port's models compute GroupNorm today
  torch_gn        PyTorch's own F.group_norm + F.silu on a channels-first
                  copy of x (the copy is made once, outside the timing;
                  scale and bias in the operand type)
  group_norm_act  the hand-written one-pass kernel (`ops.group_norm_act`):
                  the study's `pallas 1-pass` row

Each row is held against `two_pass`. GB/s counts one read and one write
of x, the least any of them can move.

    python -m rcdms_tpu_torch.tools.gn_fused_study
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops.group_norm import (
    group_norm_act,
    group_norm_act_plain,
)
from rcdms_tpu_torch.tools import (
    card_line,
    median_ms,
    print_rows,
    rel_err,
    require_cuda,
)

GROUPS, EPS = 32, 1e-6
SHAPES = [(5, 4096, 320), (5, 1024, 640), (5, 256, 1280), (5, 1024, 960)]


def torch_gn(x_cf: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """F.group_norm + SiLU on channels-first (B, C, N)."""
    return F.silu(F.group_norm(x_cf, GROUPS, scale.to(x_cf.dtype),
                               bias.to(x_cf.dtype), EPS))


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at every study shape on the card; returns the rows."""
    require_cuda(dev)
    g = torch.Generator(dev).manual_seed(0)
    out = []
    for b, n, c in SHAPES:
        x = torch.randn(b, n, c, generator=g, device=dev).to(dtype)
        scale = torch.randn(c, generator=g, device=dev) * 0.5 + 1.0
        bias = torch.randn(c, generator=g, device=dev) * 0.2
        x_cf = x.transpose(1, 2).contiguous()
        ref = group_norm_act_plain(x, scale, bias, GROUPS, EPS, "silu")
        rows = [
            ("two_pass", lambda: group_norm_act_plain(
                x, scale, bias, GROUPS, EPS, "silu"), lambda y: y),
            ("torch_gn", lambda: torch_gn(x_cf, scale, bias),
             lambda y: y.transpose(1, 2)),
            ("group_norm_act", lambda: group_norm_act(
                x, scale, bias, GROUPS, EPS, "silu"), lambda y: y),
        ]
        gbytes = 2 * x.numel() * x.element_size() / 1e9
        for name, fn, to_bnc in rows:
            err = rel_err(to_bnc(fn()), ref)
            ms = median_ms(fn, reps)
            out.append(dict(study="gn_fused", row=name, dtype=str(dtype)[6:],
                            shape=f"{b}x{n}x{c}", ms=ms,
                            rate=gbytes / ms * 1e3, unit="GB/s", rel_err=err))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_fused_study: needs a CUDA card")
    print(f"{card_line()}  groups={GROUPS} eps={EPS}")
    rows = run(torch.device("cuda"))
    print_rows(rows)
    by = {(r["shape"], r["row"]): r["ms"] for r in rows}
    for b, n, c in SHAPES:
        s = f"{b}x{n}x{c}"
        one = by[s, "group_norm_act"]
        print(f"  {s}: one pass {by[s, 'two_pass'] / one:.2f}x the two-pass "
              f"plain version, {by[s, 'torch_gn'] / one:.2f}x "
              f"F.group_norm + F.silu")
    bad = [r["row"] for r in rows if not r["rel_err"] < 2e-2]
    if bad:
        raise SystemExit(f"rows disagree with two_pass: {bad}")


if __name__ == "__main__":
    main()
