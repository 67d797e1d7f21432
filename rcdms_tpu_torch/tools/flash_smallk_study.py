"""Small-head-dim attention study on the card: the port of
`tools/flash_smallk_study.py`, at its shape (SD-1.5 UNet level 0: B =
b*heads = 80, Sq = Skv = 4096, dh = 40, bf16, 512-row q cells).

At dh = 40 a score and its share of P v cost 160 tensor-core flops but one
exponential, so on the H100 the softmax, not the products, sets the floor.
The rows ask what the layout and the padding of dh cost there:

  base128     a whole block over (B, S, 128) operands zero past 40, the
              score contracting all 128 columns (kernel E)
  slice40     the same operands, the score contracting the first 40 (padded
              to 48 by the TMA box's zeros, not in device memory)
  nt40        channel-major (B, 40, S) operands and output, p normalised
              before it is rounded to bf16
  nt_t40      channel-major, l the sum of the rounded p, o scaled after the
              product
  sdpa        F.scaled_dot_product_attention on token-major (B, S, 40)
              copies, viewed as (B, 1, S, 40) so that its fused kernels
              take them: a yardstick of PyTorch's library, timed only
and each part alone (`run_isolated`'s kernels), reduced to (B, Sq, 128):
  score_base  q k^T over width 128 (kernel F); score_nt channel-major
  pv_base     generated P times v (B, Skv, 128) (kernel G); pv_narrow v
              (B, Skv, 40); pv_nt channel-major v (B, 40, Skv)
  softmax     the row softmax of generated P (kernel H)

Each kernel row is held against its plain version (`ops/smallk.py`). The
rate counts the JAX study's flops, 4 B Sq Skv dh for a whole block and 2 B
Sq Skv dh for a part (for softmax: the rate a product would need); the
bound is the least time of the work the row's inputs need at the card's
published peaks: products as wide as their nonzero columns (the whole
blocks' operands are zero past 40; score_base's and pv_base's are random
over all 128, as the JAX study draws them).

    python -m rcdms_tpu_torch.tools.flash_smallk_study
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops.smallk import (
    attn_pv,
    attn_pv_plain,
    attn_scores,
    attn_scores_plain,
    attn_softmax,
    attn_softmax_plain,
    smallk_attention,
    smallk_attention_plain,
)
from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    print_rows,
    require_cuda,
    timed_row,
)

B, SQ, SKV, DH, GROUP = 80, 4096, 4096, 40, 128
BLK_Q = 512
SCALE = DH ** -0.5
CELLS = SQ // BLK_Q
BLOCK_FLOPS = 4 * B * SQ * SKV * DH  # a whole block's useful flops
PART_FLOPS = 2 * B * SQ * SKV * DH   # one product's
EXPS = B * SQ * SKV

# (row, smallk_attention keywords) of the whole-block rows
BLOCK_ROWS = [
    ("base128", dict(dk=GROUP, norm="post")),
    ("slice40", dict(dk=DH, norm="post")),
    ("nt40", dict(channel_major=True, norm="pre")),
    ("nt_t40", dict(channel_major=True, norm="rounded")),
]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at the study's shape on the card; returns the rows."""
    require_cuda(dev)
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_smallk_study: the study is bf16 only, got "
                        f"{dtype}")
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    qt, kt, vt = r(B, DH, SQ), r(B, DH, SKV), r(B, DH, SKV)
    tok40 = [t.transpose(1, 2).contiguous() for t in (qt, kt, vt)]
    tok128 = [F.pad(t, (0, GROUP - DH)) for t in tok40]
    out = []
    for name, kw in BLOCK_ROWS:
        args = (qt, kt, vt) if kw.get("channel_major") else tok128
        out.append(timed_row(
            "flash_smallk", name, dtype,
            f"{tuple(args[0].shape)}",
            lambda a=args, kw=kw: smallk_attention(*a, SCALE, **kw),
            smallk_attention_plain(*args, SCALE, **kw), BLOCK_FLOPS,
            bound_ms(BLOCK_FLOPS, EXPS, 4 * _bytes(args[0])), reps))
    out.append(timed_row(
        "flash_smallk", "sdpa", dtype, f"{tuple(tok40[0].shape)}",
        lambda: F.scaled_dot_product_attention(
            *(t.unsqueeze(1) for t in tok40), scale=SCALE), None,
        BLOCK_FLOPS, bound_ms(BLOCK_FLOPS, EXPS, 4 * _bytes(qt)), reps))

    out_bytes = B * SQ * GROUP * 4  # the reduced (B, Sq, 128) fp32 output
    q128, k128 = r(B, SQ, GROUP), r(B, SKV, GROUP)
    for name, q, k, cm in (("score_base", q128, k128, False),
                           ("score_nt", qt, kt, True)):
        out.append(timed_row(
            "flash_smallk", name, dtype, f"{tuple(q.shape)}",
            lambda q=q, k=k, cm=cm: attn_scores(q, k, channel_major=cm),
            attn_scores_plain(q, k, channel_major=cm), PART_FLOPS,
            bound_ms(PART_FLOPS * (DH if cm else GROUP) // DH, 0,
                     2 * _bytes(q) + out_bytes), reps))
    seeds = r(B, 8, 128)
    v128 = r(B, SKV, GROUP)
    for name, v, cm in (("pv_base", v128, False),
                        ("pv_narrow", v128[..., :DH].contiguous(), False),
                        ("pv_nt", vt, True)):
        kw = dict(seeds=seeds, channel_major=cm, cells=CELLS)
        out.append(timed_row(
            "flash_smallk", name, dtype, f"{tuple(v.shape)}",
            lambda v=v, kw=kw: attn_pv(v, **kw), attn_pv_plain(v, **kw),
            PART_FLOPS, bound_ms(PART_FLOPS * v.shape[1 if cm else 2] // DH,
                                 0, _bytes(v) + out_bytes), reps))
    kw = dict(seeds=seeds, skv=SKV, cells=CELLS)
    out.append(timed_row(
        "flash_smallk", "softmax", dtype, f"{B}x{SQ}x{SKV}",
        lambda: attn_softmax(**kw), attn_softmax_plain(**kw), PART_FLOPS,
        bound_ms(0, EXPS, out_bytes), reps))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_smallk_study: needs a CUDA card")
    print(f"{card_line()}  B={B} Sq={SQ} Skv={SKV} dh={DH}")
    rows = run(torch.device("cuda"))
    print_rows(rows)
    bad = [r["row"] for r in rows
           if r["rel_err"] is not None and not r["rel_err"] <= 2e-2]
    if bad:
        raise SystemExit(f"rows disagree with their plain versions: {bad}")


if __name__ == "__main__":
    main()
