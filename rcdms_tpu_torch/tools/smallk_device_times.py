"""Device time of kernel E (`ops.smallk_attention`) on the card, from
`torch.profiler`, at the seven whole-block rows of the attention studies
(base128, slice40, nt40, nt_t40, split2, split4, dscore), bf16, at their
shape (80 batch-heads, 4096 x 4096, dh 40), with SDPA's device time
beside base128 (on its (80, 1, 4096, 128) tensors) and nt_t40 (on
unpadded (80, 1, 4096, 40) copies). Beside each: its error against the
plain version, the share of its bf16 outputs off the plain version's
bits, its bound (`work`: the work its inputs need at the card's
published peaks, one exponential a score, as `chip_smoke.py` phase 3
counts it) and the share of it the device time reaches, and the median
event time of 10 calls (the wrapper's host time included). The split
rows must equal nt_t40 bit for bit. `rows`, `operands` and `work` are
the row list, operands and work counts that phase 3 and the card tests
take too.

    python -m rcdms_tpu_torch.tools.smallk_device_times [--out PATH]
        [--parent CHECKOUT]

It times the kernels of the `rcdms_tpu_torch` that Python imports.
`--parent CHECKOUT` times another checkout's E (a parent commit's) in
turns with this one's on one card (`tools.turns`): this file run by path
from each checkout's root with that checkout on the path, so each builds
its own library there and a parent without this tool is timed the same
way; `--out` then holds every turn.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops.smallk import (
    smallk_attention,
    smallk_attention_plain,
)
from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    device_us,
    median_ms,
    rel_err,
    require_cuda,
)

B, SQ, SKV, DH, WIDTH = 80, 4096, 4096, 40, 128
SCALE = DH ** -0.5
SDPA_ROWS = ("base128", "nt_t40")


def rows(dh: int = DH) -> list[tuple[str, dict]]:
    """(row, smallk_attention keywords) of the studies' whole-block rows;
    dh is the channel-major width and slice40's contraction."""
    return [("base128", dict(dk=WIDTH, norm="post")),
            ("slice40", dict(dk=dh, norm="post")),
            ("nt40", dict(channel_major=True, norm="pre")),
            ("nt_t40", dict(channel_major=True, norm="rounded")),
            ("split2", dict(channel_major=True, norm="rounded", split=2)),
            ("split4", dict(channel_major=True, norm="rounded", split=4)),
            ("dscore", dict(channel_major=True, norm="rounded",
                            dscore=True))]


ROWS = rows()


def operands(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor
             ) -> tuple[list[torch.Tensor], dict[str, list[torch.Tensor]]]:
    """From channel-major (B, dh, S) q, k, v: the token-major rows' (B, S,
    128) copies, zero past dh, and SDPA's operands by row (`SDPA_ROWS`:
    base128's tensors as (B, 1, S, 128), the unpadded (B, 1, S, dh) beside
    nt_t40)."""
    tok = [F.pad(t.transpose(1, 2), (0, WIDTH - t.shape[1])).contiguous()
           for t in (qt, kt, vt)]
    sdpa = {"base128": [t.unsqueeze(1) for t in tok],
            "nt_t40": [t.transpose(1, 2).contiguous().unsqueeze(1)
                       for t in (qt, kt, vt)]}
    return tok, sdpa


def work(qt: torch.Tensor, skv: int) -> tuple[int, int, int]:
    """(flops, exponentials, bytes) that every row's inputs need, from the
    channel-major q (B, dh, Sq) and Skv: the score and P V products as
    wide as their nonzero columns (base128's are zero past dh), one
    exponential a score (the function's; nt40's pass-1 l and every row's
    second score product are the two-pass design's own), q, k, v read
    and o written once at dh."""
    b, dh, sq = qt.shape
    exps = b * sq * skv
    return 4 * exps * dh, exps, 4 * qt.numel() * qt.element_size()


def run(dev: torch.device) -> list[dict]:
    """Every row on the card (raises off a card, and where a split row is
    not nt_t40's output bit for bit)."""
    require_cuda(dev)
    g = torch.Generator(dev).manual_seed(0)
    qt, kt, vt = (torch.randn(B, DH, SQ, generator=g, device=dev).bfloat16()
                  for _ in range(3))
    tok, sdpa = operands(qt, kt, vt)
    bound, bound_by = bound_ms(*work(qt, SKV))
    out, base = [], None
    for name, kw in ROWS:
        args = (qt, kt, vt) if kw.get("channel_major") else tok

        def fn(a=args, kw=kw):
            return smallk_attention(*a, SCALE, **kw)

        got = fn()
        ref = smallk_attention_plain(*args, SCALE, **kw)
        err, bits_off = rel_err(got, ref), (got != ref).float().mean().item()
        del ref
        if name == "nt_t40":
            base = got
        elif name.startswith("split") and not torch.equal(got, base):
            raise AssertionError(f"smallk_device_times: {name} is not "
                                 f"nt_t40's output bit for bit")
        device_ms = sum(device_us(fn).values()) / 1e3
        row = dict(row=name, shape=list(args[0].shape), rel_err=err,
                   bits_off=bits_off, device_ms=device_ms,
                   event_ms=median_ms(fn), bound_ms=bound,
                   bound_by=bound_by, share=bound / device_ms)
        if name in sdpa:
            t = sdpa[name]
            row["sdpa_device_ms"] = sum(device_us(
                lambda t=t: F.scaled_dot_product_attention(
                    *t, scale=SCALE)).values()) / 1e3
        out.append(row)
        print(f"  {name:8s} {str(row['shape']):18s} device {device_ms:.4f} "
              f"ms  event {row['event_ms']:.4f} ms  bound {bound:.4f} ms "
              f"({bound_by})  {bound / device_ms:6.1%} of bound  rel_err "
              f"{err:.2e}  bits off {bits_off:.4f}"
              + (f"  SDPA device {row['sdpa_device_ms']:.4f} ms"
                 if name in sdpa else ""), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows (or turns) here as JSON")
    ap.add_argument("--parent", help="a parent checkout to time in turns "
                    "with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("smallk_device_times: needs a CUDA card")
    card = card_line()
    if args.parent:
        # imported here: a parent's turn runs this file against a package
        # that may lack it
        from rcdms_tpu_torch.tools import turns

        result = dict(card=card, turns=turns(
            args.parent, [str(Path(__file__).resolve())], ("row",)))
    else:
        print(f"{card}  B={B} Sq={SQ} Skv={SKV} dh={DH}, bf16: device ms a "
              f"call (torch.profiler), event ms (median of 10)", flush=True)
        result = dict(card=card, rows=run(torch.device("cuda")))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
