"""Device time of the attention studies' parts on the card, from
`torch.profiler`, at every study variant, bf16: F (`ops.attn_scores`:
score_base, score_nt), G (`ops.attn_pv`: pv_base, pv_narrow, pv_nt over
generated P, pv_lanes, pv_std over an input P) and, for the record, H
(`ops.attn_softmax`: softmax over generated P, softmax, softmax2,
reduce_only over an input P), at the studies' shape (80 batch-heads, 4096
x 4096, dh 40, 512-row cells). Beside each: its error against the plain
version, its bound (the work its inputs need at the card's published
peaks, as `chip_smoke.py` phase 3 counts it) and the share of the bound
the device time reaches, and the median event time of 10 calls (which
holds the wrapper's host time too).

    python -m rcdms_tpu_torch.tools.attn_parts_device_times [--out PATH]
        [--kernel attn_scores|attn_pv|attn_softmax] [--parent CHECKOUT]

It times the kernels of the `rcdms_tpu_torch` that Python imports;
`--kernel` keeps one kernel's variants. `--parent CHECKOUT` times another
checkout's kernels (a parent commit's) in turns with this one's on one
card: the parent's, this checkout's twice, the parent's again, each turn
this module of that checkout run in a process of its own from its root
(so each builds its own library there), then prints each variant's
device times side by side; `--out` then holds every turn.
"""

from __future__ import annotations

import argparse
import json

import torch

from rcdms_tpu_torch.ops.smallk import (
    attn_pv,
    attn_pv_plain,
    attn_scores,
    attn_scores_plain,
    attn_softmax,
    attn_softmax_plain,
)
from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    device_us,
    median_ms,
    rel_err,
    require_cuda,
    turns,
)

B, SQ, SKV, DH, GROUP, BLK = 80, 4096, 4096, 40, 128, 512
CELLS = SQ // BLK
MODULE = "rcdms_tpu_torch.tools.attn_parts_device_times"


def _bytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def variants(dev: torch.device) -> list[tuple]:
    """(kernel, variant, shape, call, plain call, (flops, exps, bytes)) of
    every study variant, on inputs made from seed 0 on `dev`."""
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    qt, kt, vt = r(B, DH, SQ), r(B, DH, SKV), r(B, DH, SKV)
    q128, k128, v128 = r(B, SQ, GROUP), r(B, SKV, GROUP), r(B, SKV, GROUP)
    seeds = r(B, 8, GROUP)
    p_in = (torch.rand(B, BLK, SKV, generator=g, device=dev)
            * 0.001).bfloat16()
    exps, out_bytes = B * SQ * SKV, B * SQ * GROUP * 4
    rows = []
    for name, q, k, cm in (("score_base", q128, k128, False),
                           ("score_nt", qt, kt, True)):
        kw = dict(channel_major=cm)
        rows.append((
            "attn_scores", name, tuple(q.shape),
            lambda q=q, k=k, kw=kw: attn_scores(q, k, **kw),
            lambda q=q, k=k, kw=kw: attn_scores_plain(q, k, **kw),
            (2 * exps * (DH if cm else GROUP), 0, _bytes(q, k) + out_bytes)))
    for name, v, cm, src in (
            ("pv_base", v128, False, dict(seeds=seeds)),
            ("pv_narrow", v128[..., :DH].contiguous(), False,
             dict(seeds=seeds)),
            ("pv_nt", vt, True, dict(seeds=seeds)),
            ("pv_lanes", vt, True, dict(p=p_in)),
            ("pv_std", v128, False, dict(p=p_in))):
        kw = dict(channel_major=cm, cells=CELLS, **src)
        width = v.shape[1 if cm else 2]
        rows.append((
            "attn_pv", name, tuple(v.shape),
            lambda v=v, kw=kw: attn_pv(v, **kw),
            lambda v=v, kw=kw: attn_pv_plain(v, **kw),
            (2 * exps * width, 0,
             _bytes(v) + (_bytes(p_in) if "p" in src else 0) + out_bytes)))
    for name, kw in (("softmax gen", dict(seeds=seeds, skv=SKV)),
                     ("softmax", dict(p=p_in, scale=1000.0)),
                     ("softmax2", dict(p=p_in, scale=1000.0, op="exp2")),
                     ("reduce_only", dict(p=p_in, op="sum"))):
        kw = dict(cells=CELLS, **kw)
        rows.append((
            "attn_softmax", name, (B, SQ, SKV),
            lambda kw=kw: attn_softmax(**kw),
            lambda kw=kw: attn_softmax_plain(**kw),
            (0, 0 if kw.get("op") == "sum" else exps,
             (_bytes(p_in) if "p" in kw else 0) + out_bytes)))
    return rows


def run(dev: torch.device, only: str | None = None) -> list[dict]:
    """Every variant's row on the card, or kernel `only`'s (raises off a
    card)."""
    require_cuda(dev)
    out = []
    for kernel, name, shape, fn, plain, work in variants(dev):
        if only is not None and kernel != only:
            continue
        err = rel_err(fn(), plain())
        by_name = device_us(fn)
        device_ms = sum(by_name.values()) / 1e3
        bound, bound_by = bound_ms(*work)
        out.append(dict(kernel=kernel, variant=name, shape=list(shape),
                        rel_err=err, device_ms=device_ms,
                        device_by_kernel_us=by_name,
                        event_ms=median_ms(fn), bound_ms=bound,
                        bound_by=bound_by, share=bound / device_ms))
        print(f"  {kernel:12s} {name:12s} {str(shape):18s} device "
              f"{device_ms:.4f} ms  event {out[-1]['event_ms']:.4f} ms  "
              f"bound {bound:.4f} ms ({bound_by})  {bound / device_ms:6.1%} "
              f"of bound  rel_err {err:.2e}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows (or turns) here as JSON")
    ap.add_argument("--kernel",
                    choices=("attn_scores", "attn_pv", "attn_softmax"),
                    help="time only this kernel's variants")
    ap.add_argument("--parent", help="a parent checkout to time in turns "
                    "with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_parts_device_times: needs a CUDA card")
    card = card_line()
    if args.parent:
        result = dict(card=card, turns=turns(
            args.parent, ["-m", MODULE], ("kernel", "variant"),
            None if args.kernel is None
            else lambda r: r["kernel"] == args.kernel))
    else:
        print(f"{card}  B={B} Sq={SQ} Skv={SKV} dh={DH} blk={BLK}, bf16: "
              f"device ms a call (torch.profiler), event ms (median of 10)",
              flush=True)
        result = dict(card=card, rows=run(torch.device("cuda"), args.kernel))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
