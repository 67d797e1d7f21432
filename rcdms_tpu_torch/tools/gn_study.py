"""GroupNorm-moments study on the card: the port of `tools/gn_study.py`,
at its shape (stage-2 level 0: B = b*f = 50, N = 64*64 tokens, C = 320).

Per-(batch row, channel) mean and mean of squares over the tokens of a
channels-last (B, N, C) activation, the reduction in front of every
GroupNorm. The rows:

  xla_mean2   x.float().mean and (x*x).mean: the plain reduction (the name
              is the JAX study's; here it is PyTorch's)
  matmul_red  the moments as ones-vector products, 1^T x and 1^T (x*x), in
              the operand type (PyTorch's bmm rounds each sum to it)
  gn_moments  the hand-written kernel (`ops.gn_moments`): the study's
              `pallas` row, one read of x

Each row is held against `xla_mean2` (the larger of the two moments'
max|diff| / max|ref|). GB/s counts one read of x.

    python -m rcdms_tpu_torch.tools.gn_study
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops.group_norm import gn_moments, gn_moments_plain
from rcdms_tpu_torch.tools import (
    card_line,
    median_ms,
    print_rows,
    rel_err,
    require_cuda,
)

B, N, C = 50, 4096, 320

xla_mean2 = gn_moments_plain


def matmul_red(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Moments through ones-vector products, in fp32 at the end."""
    b, n, _ = x.shape
    ones = torch.ones(b, 1, n, dtype=x.dtype, device=x.device)
    s1 = torch.bmm(ones, x).float()
    s2 = torch.bmm(ones, x * x).float()
    return s1[:, 0] / n, s2[:, 0] / n


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at the study's shape on the card; returns the rows."""
    require_cuda(dev)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(B, N, C, generator=g, device=dev).to(dtype)
    ref = xla_mean2(x)
    gbytes = x.numel() * x.element_size() / 1e9
    out = []
    for name, fn in (("xla_mean2", xla_mean2), ("matmul_red", matmul_red),
                     ("gn_moments", gn_moments)):
        got = fn(x)
        err = max(rel_err(a, r) for a, r in zip(got, ref))
        ms = median_ms(lambda fn=fn: fn(x), reps)
        out.append(dict(study="gn", row=name, dtype=str(dtype)[6:],
                        shape=f"{B}x{N}x{C}", ms=ms, rate=gbytes / ms * 1e3,
                        unit="GB/s", rel_err=err))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{card_line()}  B={B} N={N} C={C}")
    rows = run(torch.device("cuda"))
    print_rows(rows)
    bad = [r["row"] for r in rows if not r["rel_err"] < 2e-2]
    if bad:
        raise SystemExit(f"rows disagree with xla_mean2: {bad}")


if __name__ == "__main__":
    main()
