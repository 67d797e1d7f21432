"""Head-dim padding study on the card: the port of `tools/mxu_pad_study.py`.

The JAX study asks whether the level-0 attention's head dim of 40 costs a
dh-128 contraction on the TPU, whose MXU pads a contraction to 128 lanes
(so packing three heads into one 128-lane group would pay 3.2x). On the
H100 the tensor cores' `wgmma` takes k in steps of 16 for bf16: a dh-40
contraction pads to 48, not to 128. The same ten products, at the JAX
study's shapes (b*h = 80, sq = skv = 4096), tell how time scales with k
(the score family, contraction = head dim) and with n (the P.V family,
output = head dim) on the card:

  score_pad128  (80, 4096, 128) @ (80, 128, 4096)    the padded kernel's
  score_raw40   (80, 4096, 40) @ (80, 40, 4096)      no pad
  score_raw120  (27, 4096, 120) @ (27, 120, 4096)    three heads, no pad
  score_pack3   (27, 4096, 128) @ (27, 128, 12288)   3 heads block-diagonal
  score_k256    (80, 4096, 256) @ (80, 256, 4096)    k scaling
  score_k512    (40, 4096, 512) @ (40, 512, 4096)
  pv_128        (80, 4096, 4096) @ (80, 4096, 128)
  pv_40         (80, 4096, 4096) @ (80, 4096, 40)
  pv_pack3      (27, 4096, 12288) @ (27, 12288, 128)
  pv_n256       (80, 4096, 4096) @ (80, 4096, 256)

Each row is one `torch.bmm` in bf16 (cuBLAS; fp32 accumulation, a bf16
output), seeded standard-normal operands, timed by `tools.device_row`
(profiler device time, event time beside it). Its flops are 2 b m k n of
the shapes issued, its bound those flops at the bf16 peak or its inputs
read and its output written once, whichever is longer: a score product
writes a (b, 4096, 4096) output, so its bound is the bytes. The four
ratios of the JAX study follow, by device time.

    python -m rcdms_tpu_torch.tools.mxu_pad_study
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.tools import card_line, device_row, print_rows, \
    require_cuda

# (row, m, k, n, b): the JAX study's `bench_matmul` calls, in its order
ROWS = [
    ("score_pad128", 4096, 128, 4096, 80),
    ("score_raw40", 4096, 40, 4096, 80),
    ("score_raw120", 4096, 120, 4096, 27),
    ("score_pack3", 4096, 128, 3 * 4096, 27),
    ("score_k256", 4096, 256, 4096, 80),
    ("score_k512", 4096, 512, 4096, 40),
    ("pv_128", 4096, 4096, 128, 80),
    ("pv_40", 4096, 4096, 40, 80),
    ("pv_pack3", 4096, 3 * 4096, 128, 27),
    ("pv_n256", 4096, 4096, 256, 80),
]


def flops(m: int, k: int, n: int, b: int) -> int:
    return 2 * b * m * k * n


def operands(m: int, k: int, n: int, b: int, dev,
             dtype=torch.bfloat16) -> tuple:
    """x (b, m, k) and w (b, k, n), seeded standard normal."""
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(b, m, k, generator=g, device=dev).to(dtype)
    w = torch.randn(b, k, n, generator=g, device=dev).to(dtype)
    return x, w


def ratios(ms: dict) -> dict:
    """The JAX study's four ratios of the rows' times (`ms` by row)."""
    base = ms["score_pad128"]
    return {"raw40 / pad128": ms["score_raw40"] / base,
            "pack3 / pad128 per equal work":
                ms["score_pack3"] / (base * 27 / 80 * 3),
            "pv_40 / pv_128": ms["pv_40"] / ms["pv_128"],
            "k256 / k128": ms["score_k256"] / base}


def run(dev: torch.device, reps: int = 10) -> list[dict]:
    """Every row on the card, each a `device_row` (its error against an
    fp32 product of the same operands)."""
    require_cuda(dev)
    out = []
    for name, m, k, n, b in ROWS:
        x, w = operands(m, k, n, b, dev)
        ref = torch.bmm(x.float(), w.float())
        nbytes = (x.numel() + w.numel() + b * m * n) * x.element_size()
        out.append(device_row("mxu_pad", name, x.dtype,
                              f"b{b} ({m},{k})@({k},{n})",
                              lambda: torch.bmm(x, w), ref,
                              flops(m, k, n, b), nbytes, reps))
        del x, w, ref
    return out


def print_ratios(rows: list[dict]) -> dict:
    r = ratios({row["row"]: row["device_ms"] for row in rows})
    print(f"raw40 / pad128 score time ratio:  {r['raw40 / pad128']:.2f} "
          f"(1.0 => the contraction pad costs a dh-128 product, 0.31 => "
          f"3.2x to win)", flush=True)
    print(f"pack3 / pad128 score time ratio: "
          f"{r['pack3 / pad128 per equal work']:.2f} per equal work",
          flush=True)
    print(f"pv_40 / pv_128 time ratio:        {r['pv_40 / pv_128']:.2f}",
          flush=True)
    print(f"k256/k128 scaling: {r['k256 / k128']:.2f} (2.0 = linear)",
          flush=True)
    return r


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_pad_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    rows = run(torch.device("cuda"))
    print_rows(rows)
    print()
    print_ratios(rows)


if __name__ == "__main__":
    main()
