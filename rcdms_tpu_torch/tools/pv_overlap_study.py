"""PV / softmax overlap study on the card: the port of
`tools/pv_overlap_study.py`, at its shape (SD-1.5 UNet level 0: B = 80
batch-heads, 4096 x 4096 tokens, dh = 40, channel-major (B, 40, S)
operands, bf16).

The TPU study asked whether the exponentials of one part of a q block can
hide behind the P.V product of another. On the H100 the products are
asynchronous wgmma and the exponentials MUFU.EX2, so the question becomes
which products run while a warpgroup takes its exponentials. Every row is
kernel E (TMA + wgmma, two consumer warpgroups of 64 queries) with p =
bf16(exp(s - m)), l the sum of the rounded p, o = (p v) * (1 / l):

  base     no overlap: a warpgroup issues its products, waits for them,
           then takes a key tile's exponentials
  split2   the two warpgroups take turns to issue their products, so one's
           exponentials run beside the other's products (ping-pong)
  split4   the ping-pong, and each warpgroup issues its next tile's score
           product and this tile's P.V before this tile's exponentials
  dscore   the score computed twice: s for the row max, s^T = k q^T for
           p^T, staged in shared memory (wgmma's B operand), the product
           then V^T P^T

The split rows change only the schedule: their outputs equal base's bit
for bit.

Each row is held to the JAX study's own check: max|row - oracle| <= 0.02
against the fp32 oracle softmax(q^T k * scale) v (`oracle`); a row outside
it raises. The rate counts the JAX study's 4 B Sq Skv dh flops.

    python -m rcdms_tpu_torch.tools.pv_overlap_study
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops.smallk import smallk_attention
from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    median_ms,
    print_rows,
    rel_err,
    require_cuda,
)

B, SQ, SKV, DH = 80, 4096, 4096, 40
BLK_Q = 512
SCALE = DH ** -0.5
MAX_ABS_ERR = 0.02  # the JAX study's numerics check
FLOPS = 4 * B * SQ * SKV * DH
ROWS = {"base": dict(), "split2": dict(split=2), "split4": dict(split=4),
        "dscore": dict(dscore=True)}


def oracle(qt: torch.Tensor, kt: torch.Tensor,
           vt: torch.Tensor) -> torch.Tensor:
    """The JAX study's `oracle_fn` in fp32, one batch row at a time:
    softmax(q^T k * scale) v in the channel-major layout."""
    out = torch.empty(qt.shape, device=qt.device, dtype=torch.float32)
    for b in range(qt.shape[0]):
        s = (qt[b].float().T @ kt[b].float()) * SCALE
        out[b] = vt[b].float() @ torch.softmax(s, dim=-1).T
    return out


def run(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
        reps: int = 10) -> list[dict]:
    """Every row at the study's shape on the card; returns the rows. Raises
    if a row is off the oracle by more than MAX_ABS_ERR."""
    require_cuda(dev)
    if dtype != torch.bfloat16:
        raise TypeError(f"pv_overlap_study: the study is bf16 only, got "
                        f"{dtype}")
    g = torch.Generator(dev).manual_seed(0)
    qt, kt, vt = (torch.randn(B, DH, n, generator=g, device=dev).to(dtype)
                  for n in (SQ, SKV, SKV))
    ref = oracle(qt, kt, vt)
    bound = bound_ms(FLOPS, B * SQ * SKV, 4 * qt.numel() * qt.element_size())
    out = []
    for name, kw in ROWS.items():
        def fn(kw=kw):
            return smallk_attention(qt, kt, vt, SCALE, channel_major=True,
                                    norm="rounded", **kw)
        got = fn()
        err = (got.float() - ref).abs().max().item()
        if not err <= MAX_ABS_ERR:
            raise AssertionError(f"pv_overlap {name}: max|delta| {err:.4f} "
                                 f"against the oracle > {MAX_ABS_ERR}")
        ms = median_ms(fn, reps)
        out.append(dict(study="pv_overlap", row=name, dtype=str(dtype)[6:],
                        shape=f"{tuple(qt.shape)}", ms=ms,
                        rate=FLOPS / ms / 1e9, unit="TFLOP/s",
                        rel_err=rel_err(got, ref), max_abs_err=err,
                        bound_ms=bound[0], bound_by=bound[1]))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pv_overlap_study: needs a CUDA card")
    print(f"{card_line()}  B={B} Sq={SQ} Skv={SKV} dh={DH}")
    rows = run(torch.device("cuda"))
    print_rows(rows)
    base = rows[0]["ms"]
    for r in rows[1:]:
        print(f"  {r['row']}: {r['ms'] / base:.3f}x base, max|delta| "
              f"{r['max_abs_err']:.1e}")


if __name__ == "__main__":
    main()
