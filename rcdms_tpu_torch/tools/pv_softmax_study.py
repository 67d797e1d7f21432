"""PV-product and softmax cost study on the card: the port of
`tools/pv_softmax_study.py`, at its shape (SD-1.5 UNet level 0: B = 80
batch-heads, 512-row q cells x 8, Skv = 4096, dh = 40, bf16).

P is one (B, 512, 4096) input block per batch row, read by all 8 cells of
the row (335 MB in all, each 4 MB block served from L2 after its first
read). The rows, each reduced to (B, 4096, 128) fp32:

  pv_lanes     P v with channel-major v (B, 40, Skv) (kernel G)
  pv_std       P v with token-major v (B, Skv, 128)
  softmax      row softmax of P * 1000 by exp, reduced (kernel H)
  softmax2     the same by exp2 of the pre-scaled argument
  reduce_only  the reduced sums of P: the read-and-reduce floor

Each row is held against its plain version (`ops/smallk.py`). The rate
counts the JAX study's 2 B Sq Skv dh flops of one product (for the softmax
rows: the rate a product would need); the bound is the least time of the
work the row's inputs need at the card's published peaks (pv_std's v is
random over all 128 columns, as the JAX study draws it). Importing the
module does no work.

    python -m rcdms_tpu_torch.tools.pv_softmax_study
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops.smallk import (
    attn_pv,
    attn_pv_plain,
    attn_softmax,
    attn_softmax_plain,
)
from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    print_rows,
    require_cuda,
    timed_row,
)

B, SKV, DH, GROUP, BLK, CELLS = 80, 4096, 40, 128, 512, 8
SQ = BLK * CELLS
FLOPS = 2 * B * SQ * SKV * DH
SOFTMAX_SCALE = 1000.0


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at the study's shape on the card; returns the rows."""
    require_cuda(dev)
    if dtype != torch.bfloat16:
        raise TypeError(f"pv_softmax_study: the study is bf16 only, got "
                        f"{dtype}")
    g = torch.Generator(dev).manual_seed(0)
    p_in = (torch.rand(B, BLK, SKV, generator=g, device=dev)
            * 0.001).to(dtype)
    vt = torch.randn(B, DH, SKV, generator=g, device=dev).to(dtype)
    v128 = torch.randn(B, SKV, GROUP, generator=g, device=dev).to(dtype)
    p_bytes = _bytes(p_in)
    out_bytes = B * SQ * GROUP * 4
    cases = [
        ("pv_lanes", attn_pv, attn_pv_plain,
         dict(v=vt, p=p_in, channel_major=True, cells=CELLS),
         bound_ms(FLOPS, 0, p_bytes + _bytes(vt) + out_bytes)),
        ("pv_std", attn_pv, attn_pv_plain,
         dict(v=v128, p=p_in, cells=CELLS),
         bound_ms(FLOPS * GROUP // DH, 0, p_bytes + _bytes(v128) + out_bytes)),
        ("softmax", attn_softmax, attn_softmax_plain,
         dict(p=p_in, op="exp", scale=SOFTMAX_SCALE, cells=CELLS),
         bound_ms(0, B * SQ * SKV, p_bytes + out_bytes)),
        ("softmax2", attn_softmax, attn_softmax_plain,
         dict(p=p_in, op="exp2", scale=SOFTMAX_SCALE, cells=CELLS),
         bound_ms(0, B * SQ * SKV, p_bytes + out_bytes)),
        ("reduce_only", attn_softmax, attn_softmax_plain,
         dict(p=p_in, op="sum", cells=CELLS),
         bound_ms(0, 0, p_bytes + out_bytes)),
    ]
    return [timed_row("pv_softmax", name, dtype, f"{tuple(p_in.shape)}",
                      lambda fn=fn, kw=kw: fn(**kw), plain(**kw), FLOPS,
                      bound, reps)
            for name, fn, plain, kw, bound in cases]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pv_softmax_study: needs a CUDA card")
    print(f"{card_line()}  B={B} blk={BLK} cells={CELLS} Skv={SKV} dh={DH}")
    rows = run(torch.device("cuda"))
    print_rows(rows)
    bad = [r["row"] for r in rows if not r["rel_err"] <= 2e-2]
    if bad:
        raise SystemExit(f"rows disagree with their plain versions: {bad}")


if __name__ == "__main__":
    main()
