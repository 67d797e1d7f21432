"""The stage-1 prior loop against its compute floor, on the card: the port
of `tools/prior_floor_study.py`.

  1. times the full-width `PriorSampler` alone (`PriorConfig()`, bf16,
     zero weights as in the JAX study, 20 steps, CFG 2.0): the p50 of
     wall seconds over `--repeats`, and the loop's device seconds from one
     profiled run (the host sets the port's time, so the two differ);
  2. counts the loop's matmul flops from the model: every Linear weight
     at its module's token rows (`count_dense_flops`, the JAX study's
     token rules), plus the score and P.V flops of the spatial and
     temporal attention, added analytically;
  3. times the two dominant product shapes on the card, each row held
     against its fp32 version first: the square projection tanh(x W),
     970 x 2048 x 2048, and the FF pair with the exact-erf GELU between
     its products, tanh(gelu(x W1) W2) at 970 x 2048 x 8192 (a pair with
     nothing between could be folded into one product);
  4. prints the achieved rate against the flop-weighted harmonic mean of
     the two shapes' rates, the floor at that ceiling and the headroom,
     as the JAX study does, by wall time and by device time.

    python -m rcdms_tpu_torch.tools.prior_floor_study [--steps 20] [--repeats 5]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.nn as nn
import torch.nn.functional as F

from rcdms_tpu_torch.configs import PriorConfig
from rcdms_tpu_torch.tools import (
    card_line,
    device_row,
    device_us,
    print_rows,
    require_cuda,
)

# the JAX study's flop weights of the two shapes: about 45% square
# projections and 55% FF-shaped products
SQUARE_SHARE, FF_SHARE = 0.45, 0.55
TOL = 2e-2


def token_rules(cfg: PriorConfig, b: int = 1) -> list:
    """(predicate on a weight's name, token rows) in order, the first
    match wins: the JAX study's rules (`main`'s `count_dense_flops`
    call). The per-frame conditioning projections run 2 b f rows, the
    caption projection 2 b f T, everything in the blocks and temporal
    modules the CFG-doubled sequence, 2 b f seq."""
    f = cfg.num_frames
    return [
        (lambda s: any(k in s for k in (
            "embedding_proj", "proj_in", "proj_to_clip_embeddings",
            "time_embedding")) and "block" not in s and "temporal" not in s,
         2 * b * f),
        (lambda s: "encoder_hidden_states_proj" in s,
         2 * b * f * cfg.num_text_tokens),
        (lambda s: True, 2 * b * f * cfg.seq_len),
    ]


def count_dense_flops(model: nn.Module, rules: list) -> tuple[int, list]:
    """2 M K N for every Linear (K in, N out) of the model, M the token
    rows of the first rule its weight's name matches; and the rows
    (name, M, K, N)."""
    total, rows = 0, []
    for name, m in model.named_modules():
        if not isinstance(m, nn.Linear):
            continue
        joined = f"{name}.weight"
        tokens = next((tok for rule, tok in rules if rule(joined)), None)
        if tokens is None:
            raise ValueError(f"no token rule for {joined}")
        k, n = m.in_features, m.out_features
        total += 2 * tokens * k * n
        rows.append((joined, tokens, k, n))
    return total, rows


def attention_flops(cfg: PriorConfig, b: int = 1) -> int:
    """Score and P.V flops a step: spatial (seq x seq a head, every
    layer, CFG-doubled frames) and temporal (f x f at every token)."""
    f, seq, inner = cfg.num_frames, cfg.seq_len, cfg.inner_dim
    t = cfg.temporal
    return (cfg.num_layers * 2 * (2 * b * f) * cfg.num_heads * seq * seq
            * cfg.head_dim * 2
            + cfg.num_layers * t.num_blocks * t.attn_layers_per_block * 2
            * (2 * b * seq) * t.num_heads * f * f
            * (inner // t.num_heads) * 2)


def zero_prior(cfg: PriorConfig, dev, dtype):
    """The full-width frame prior with every weight zero, in `dtype`, for
    inference (the JAX study zeroes its parameter tree)."""
    from rcdms_tpu_torch.models.prior import FramePrior
    from rcdms_tpu_torch.sample.pipeline import for_inference

    with dev:
        model = FramePrior(cfg)
    for p in model.parameters():
        nn.init.zeros_(p)
    return for_inference(model, dtype)


def conditioning(cfg: PriorConfig, dev, dtype, b: int = 1):
    """Seeded random conditioning of b stories, every caption token
    real."""
    from rcdms_tpu_torch.sample.prior_sampler import PriorConditioning

    g = torch.Generator(dev).manual_seed(0)
    f, t, d = cfg.num_frames, cfg.num_text_tokens, cfg.embedding_dim

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    mask = torch.ones(b, f, t, dtype=torch.bool, device=dev)
    return PriorConditioning(r(b, f, d), r(b, f, t, d), mask, r(b, f, d),
                             r(b, f, t, d), mask, r(b, f, d), r(b, f, d))


def ceilings(m: int, inner: int, dev, dtype, reps: int = 10) -> list[dict]:
    """The square projection and the FF pair at m rows, each timed after
    its output is held against its fp32 version (weights scaled by
    1/sqrt(K), so the tanh is not saturated)."""
    g = torch.Generator(dev).manual_seed(1)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    x = r(m, inner)
    w_sq = r(inner, inner, scale=inner ** -0.5)
    w_ff = r(inner, 4 * inner, scale=inner ** -0.5)
    w_ff_t = r(4 * inner, inner, scale=(4 * inner) ** -0.5)

    def pair(a, w1, w2):
        h = F.gelu((a @ w1).float()).to(a.dtype)
        return torch.tanh(h @ w2)

    return [
        device_row("prior_floor", "square", dtype, f"{m}x{inner}x{inner}",
                   lambda: torch.tanh(x @ w_sq),
                   torch.tanh(x.float() @ w_sq.float()),
                   2 * m * inner * inner, reps=reps),
        device_row("prior_floor", "ff pair", dtype,
                   f"{m}x{inner}x{4 * inner}",
                   lambda: pair(x, w_ff, w_ff_t),
                   pair(x.float(), w_ff.float(), w_ff_t.float()),
                   2 * 2 * m * inner * 4 * inner, reps=reps),
    ]


def run(dev: torch.device, steps: int = 20, repeats: int = 5,
        dtype: torch.dtype = torch.bfloat16) -> dict:
    """The loop's wall p50 and device seconds, its flops, the two
    ceilings and what follows from them, on the card."""
    require_cuda(dev)
    from rcdms_tpu_torch.sample.prior_sampler import PriorSampler

    cfg = PriorConfig()
    b = 1
    model = zero_prior(cfg, dev, dtype)
    sampler = PriorSampler(model, num_steps=steps, guidance_scale=2.0)
    cond = conditioning(cfg, dev, dtype, b)

    def loop(seed=0):
        out = sampler(cond, generator=torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    first = loop()
    first_s = time.perf_counter() - t0
    if not torch.isfinite(first).all():
        raise AssertionError("the prior loop gave non-finite embeddings")
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        loop(i)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    device_s = sum(device_us(loop, reps=1).values()) / 1e6

    per_step, linear_rows = count_dense_flops(model, token_rules(cfg, b))
    per_step += attention_flops(cfg, b)
    story_tf = per_step * steps / 1e12
    ff_flops = sum(2 * m * k * n for _, m, k, n in linear_rows
                   if max(k, n) >= 4 * cfg.inner_dim)
    del model, sampler
    torch.cuda.empty_cache()

    rows = ceilings(2 * b * cfg.num_frames * cfg.seq_len, cfg.inner_dim, dev,
                    dtype)
    r_sq, r_ff = rows[0]["rate"], rows[1]["rate"]
    ceiling = 1.0 / (SQUARE_SHARE / r_sq + FF_SHARE / r_ff)
    floor_s = story_tf / ceiling
    return dict(card=card_line(), steps=steps, repeats=repeats,
                first_s=first_s, wall_s=times, p50_s=p50, device_s=device_s,
                idle_share=1.0 - device_s / p50, per_step_flops=per_step,
                story_tflop=story_tf,
                ff_share_of_linear=ff_flops / (per_step - attention_flops(
                    cfg, b)),
                achieved_wall=story_tf / p50,
                achieved_device=story_tf / device_s, ceiling=ceiling,
                square_rate=r_sq, ff_rate=r_ff, floor_s=floor_s,
                headroom_s=p50 - floor_s,
                device_headroom_s=device_s - floor_s, rows=rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prior_floor_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = run(torch.device("cuda"), args.steps, args.repeats)
    print(r["card"])
    print(f"prior-only p50            : {r['p50_s']:.4f} s wall (first "
          f"{r['first_s']:.2f} s; {[round(t, 4) for t in r['wall_s']]}), "
          f"device {r['device_s']:.4f} s (idle {r['idle_share']:.1%})")
    print(f"real matmul FLOPs/story   : {r['story_tflop']:.2f} TF "
          f"({r['per_step_flops'] / 1e9:.1f} GF/step x {r['steps']}; FF "
          f"shapes {r['ff_share_of_linear']:.1%} of the Linear flops)")
    print(f"achieved rate             : {r['achieved_wall']:.1f} TF/s by "
          f"wall, {r['achieved_device']:.1f} by device time")
    print(f"shape-matched ceiling     : {r['ceiling']:.1f} TF/s "
          f"(square {r['square_rate']:.1f}, FF {r['ff_rate']:.1f})")
    print(f"compute floor at ceiling  : {r['floor_s']:.3f} s -> headroom "
          f"{r['headroom_s']:+.3f} s ({r['headroom_s'] / r['p50_s']:.0%} of "
          f"p50), {r['device_headroom_s']:+.3f} s of device time")
    print_rows(r["rows"])
    bad = [x["row"] for x in r["rows"] if not x["rel_err"] <= TOL]
    if bad:
        raise SystemExit(f"ceiling rows off their fp32 version: {bad}")


if __name__ == "__main__":
    main()
