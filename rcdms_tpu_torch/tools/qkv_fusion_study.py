"""q/k/v fusion of the prior's projections on the card: the port of
`tools/qkv_fusion_study.py`. Does one (970, 2048) @ (2048, 6144) product
beat three (2048, 2048) ones at the prior's 970 rows (2 CFG x 5 frames x
97 tokens)? The rows, bf16:

  square     tanh(x Wq): one square projection
  separate   tanh(x Wq) + tanh(x Wk) + tanh(x Wv)
  fused      tanh(x [Wq Wk Wv]) viewed as (M, 3, K) and summed over the 3

Each projection's output goes through tanh before any combine, as in the
JAX study, so that no rewrite can fold the three products into one (XLA
did, through distributivity and a reduce through the dot); separate and
fused pay the same epilogue. Each row is held against its fp32 version
first, and a rate over the card's bf16 peak (989 TFLOP/s) marks a row as
folded. Rows are timed by device time (`torch.profiler`) beside event
time.

    python -m rcdms_tpu_torch.tools.qkv_fusion_study
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.configs import PriorConfig
from rcdms_tpu_torch.tools import (
    PEAK_FLOPS,
    card_line,
    device_row,
    print_rows,
    require_cuda,
)

M, K = 970, 2048
TOL = 2e-2


def qkv_sites(cfg: PriorConfig = PriorConfig()) -> int:
    """q/k/v projections of 970 rows a prior step: each layer's spatial
    self-attention and its temporal module's attention layers (60; the
    JAX study counted 40)."""
    t = cfg.temporal
    return cfg.num_layers * (1 + t.num_blocks * t.attn_layers_per_block)


def square(x, wq):
    return torch.tanh(x @ wq)


def separate(x, wq, wk, wv):
    return torch.tanh(x @ wq) + torch.tanh(x @ wk) + torch.tanh(x @ wv)


def fused(x, w_qkv):
    return torch.tanh(x @ w_qkv).reshape(x.shape[0], 3, -1).sum(1)


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """The three rows on the card; returns them."""
    require_cuda(dev)
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    wq, wk, wv = (r(K, K, scale=K ** -0.5) for _ in range(3))
    w_qkv = torch.cat([wq, wk, wv], dim=1)
    x = r(M, K)
    f32 = [t.float() for t in (x, wq, wk, wv, w_qkv)]
    f1, f3 = 2 * M * K * K, 3 * 2 * M * K * K
    return [
        device_row("qkv", "square", dtype, f"{M}x{K}x{K}",
                   lambda: square(x, wq), square(f32[0], f32[1]), f1,
                   reps=reps),
        device_row("qkv", "separate", dtype, f"3 x {M}x{K}x{K}",
                   lambda: separate(x, wq, wk, wv),
                   separate(*f32[:4]), f3, reps=reps),
        device_row("qkv", "fused", dtype, f"{M}x{K}x{3 * K}",
                   lambda: fused(x, w_qkv), fused(f32[0], f32[4]), f3,
                   reps=reps),
    ]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qkv_fusion_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{card_line()}  M={M} K={K}", flush=True)
    rows = run(torch.device("cuda"))
    print_rows(rows)
    peak = PEAK_FLOPS[torch.bfloat16] / 1e12
    folded = [r["row"] for r in rows if r["rate"] > peak]
    sep, fus = rows[1]["device_ms"], rows[2]["device_ms"]
    print(f"fused vs separate speedup : {sep / fus:.2f}x by device time, "
          f"{rows[1]['ms'] / rows[2]['ms']:.2f}x by event time")
    sites = qkv_sites()
    print(f"naive story-level saving  : {(sep - fus) * sites * 20:+.1f} ms "
          f"({sites} qkv sites/step x 20 steps, device time)")
    if folded:
        raise SystemExit(f"rows over the bf16 peak of {peak:.0f} TFLOP/s: "
                         f"folding suspected, numbers invalid: {folded}")
    bad = [r["row"] for r in rows if not r["rel_err"] <= TOL]
    if bad:
        raise SystemExit(f"rows off their fp32 version: {bad}")


if __name__ == "__main__":
    main()
