"""Row-strip efficiency on the card: the port of `tools/strip_efficiency.py`.

Under `--shard-story` each rank of a space group runs every UNet layer on
a strip of the latent rows: at a space axis of 2 the level-0 strip is 32
of 64 rows, at 4 it is 16, at 8 it is 8. Does a strip cost its share of
the rows? One full-width StoryUNet forward
(`sample/pipeline.py::full_configs(temporal_zero_init=False)`, bf16,
seeded weights, b 1, 5 frames, 64 latent columns, 91 caption tokens)
runs at each height, through the port's kernels as a story step runs it
(A, B and C; a UNet forward runs no D), and is timed by
`tools.device_row` (profiler device time, event time beside it):

    H=64 (whole)    the baseline
    H=32 (space 2)  ideal 1/2 of it
    H=16 (space 4)  ideal 1/4
    H=8  (space 8)  ideal 1/8

strip_factor(H) = t(H) / (t(64) H / 64), by device time and by event
time: 1.0 is a strip that costs exactly its share; above it, the strip
pays for launches, tiles and work that do not shrink with its rows (the
cross-attention keys, the time embedding, a kernel's fixed cost).

    python -m rcdms_tpu_torch.tools.strip_efficiency
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch import ops
from rcdms_tpu_torch.tools import (
    card_line,
    device_row,
    require_cuda,
    timed_row,
)

HEIGHTS = (64, 32, 16, 8)
WHOLE = HEIGHTS[0]
B, FRAMES, COLS, TOKENS = 1, 5, 64, 91
STRIP_KERNELS = ("attention", "frame_attention", "geglu_ff")  # A, B, C


def strip_factor(t: float, t_whole: float, h: int, whole: int = WHOLE
                 ) -> float:
    """t(H) over the whole map's time scaled to H of its rows."""
    return t / (t_whole * h / whole)


def build_unet(dev, seed: int = 0):
    """The full-width StoryUNet in bf16 on `dev` with seeded weights drawn
    as flax's initializers draw them, ready for inference."""
    from rcdms_tpu_torch.core.layers import init_like_flax_
    from rcdms_tpu_torch.models.unet3d import StoryUNet
    from rcdms_tpu_torch.sample.pipeline import for_inference, full_configs

    cfg = full_configs(temporal_zero_init=False).unet
    with torch.device(dev):
        unet = StoryUNet(cfg)
    init_like_flax_(unet, torch.Generator(dev).manual_seed(seed))
    return for_inference(unet, torch.bfloat16)


def inputs(unet, h: int, dev, seed: int = 1) -> tuple:
    """x (B, FRAMES, h, COLS, in_channels), timesteps (B,) and the context
    (B, FRAMES, TOKENS, cross_attention_dim), seeded."""
    cfg = unet.cfg
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, FRAMES, h, COLS, cfg.in_channels, generator=g,
                    device=dev).to(torch.bfloat16)
    ctx = torch.randn(B, FRAMES, TOKENS, cfg.cross_attention_dim,
                      generator=g, device=dev).to(torch.bfloat16)
    return x, torch.full((B,), 500, dtype=torch.int64, device=dev), ctx


@torch.no_grad()
def run(dev: torch.device, reps: int = 3, device_time: bool = True
        ) -> list[dict]:
    """One row a height: the forward's output shape and whether it is
    finite, the launches of A, B and C in one forward (`launches`), its
    device and event ms, and its strip factors by each. Without
    `device_time` the rows take event time alone (`timed_row`; device ms
    and factors None): the profiler has dropped some of a forward's
    ~2,500 kernel records a call on a loaded host, and `device_us` then
    raises."""
    require_cuda(dev)
    unet = build_unet(dev)
    out = []
    for h in HEIGHTS:
        x, tb, ctx = inputs(unet, h, dev)
        ops.reset_launch_counts()
        y = unet(x, tb, ctx)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts("story").items()
                    if k in STRIP_KERNELS}
        args = ("strip", f"H={h}", torch.bfloat16,
                f"({B},{FRAMES},{h},{COLS})", lambda: unet(x, tb, ctx), None,
                0.0)
        row = (device_row(*args, reps=reps) if device_time
               else dict(timed_row(*args, (0.0, "operations"), reps=reps),
                         device_ms=None))
        row.update(h=h, out_shape=tuple(y.shape),
                   finite=bool(torch.isfinite(y).all()), launches=launches)
        out.append(row)
        del x, ctx, y
    whole = out[0]
    for row in out:
        row["strip_factor_device"] = (strip_factor(
            row["device_ms"], whole["device_ms"], row["h"]) if device_time
            else None)
        row["strip_factor_event"] = strip_factor(row["ms"], whole["ms"],
                                                 row["h"])
    return out


def print_strip_rows(rows: list[dict]) -> None:
    for r in rows:
        device = ("device not read" if r["device_ms"] is None else
                  f"device {r['device_ms']:8.3f} ms  strip_factor "
                  f"{r['strip_factor_device']:5.2f}")
        print(f"H={r['h']:2d}: {device}; event {r['ms']:8.3f} ms  "
              f"strip_factor {r['strip_factor_event']:5.2f}; launches "
              f"{r['launches']}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("strip_efficiency: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    rows = run(torch.device("cuda"))
    print_strip_rows(rows)
    bad = [r["h"] for r in rows
           if not (r["finite"] and all(r["launches"].values()))]
    if bad:
        raise SystemExit(f"strip_efficiency: heights {bad} gave non-finite "
                         f"outputs or left one of A, B, C unlaunched")


if __name__ == "__main__":
    main()
