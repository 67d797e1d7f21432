#!/usr/bin/env python3
"""Smoke test of the PyTorch port (rcdms_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: compiles rcdms_tpu_torch/csrc/*.cu with nvcc (sm_90a) and loads
   the library; prints the build seconds; the ptxas report goes to
   chiprun_out/chip_smoke_ptxas.log;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the story's shapes (A-D) or its study's full shapes (the conv and
   GroupNorm kernels in fp32 and bf16; the small-head-dim attention
   kernels E-H, B = 80 batch-heads x 4096 x 4096 at dh 40, in bf16 only),
   TF32 off, tolerance max|kernel - plain| / max|plain| <= 1e-4 (fp32) and
   2e-2 (bf16), with the median time of each side, of one PyTorch library
   call that computes the same function where there is one (SDPA beside A,
   B and E, cuDNN beside the conv, F.group_norm + F.silu beside the fused
   GN), and the case's bound (its work at the card's published peaks);
4. reference: the tiny pipeline in fp32 on the card, through the kernels,
   against the same pipeline on the CPU (plain versions) on the same
   noise: stage-1 embeds within 5e-4, frames within 1e-3;
5. story: the full-width two-stage pipeline (Flintstones configs: 91
   tokens, vocab 49412, 512 px, 5 frames) in bf16 with seeded random
   weights: the story-independent conditioning cache, two requests with
   their own generators, and request 1 again. Frames must be finite, in
   [0, 1], of shape (1, 5, 512, 512, 3), the repeat equal to the first run
   within 1e-3, and every kernel of the story (A-D) must have launched.
   Then one more request under `torch.profiler`: the device time of its
   kernels summed by name into A, B, C/D, cuDNN and other, each group's
   seconds and share printed and written to
   chiprun_out/chip_smoke_story_profile.json;
6. studies: the three ResNet-block studies (`rcdms_tpu_torch/tools/`:
   channel-major 3x3 conv, GroupNorm moments, fused GroupNorm + SiLU) at
   their full shapes, in bf16 and fp32, then the three small-head-dim
   attention studies (flash_smallk, pv_overlap, pv_softmax) in bf16; every
   row within the tolerance of phase 3 of its study's reference (the
   pv_overlap rows also within 0.02 of its fp32 oracle), and every study
   kernel launched.

Phases 4 and 5 count only the story's kernels (`ops.PATHS["story"]`),
phase 6 only the studies' (`ops.PATHS["studies"]`): each path's counts are
set to 0 just before it and read just after. The line before the last is
a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STEPS = 20    # DDIM and UnCLIP steps of a story, the reference's
PIXELS = 512  # story frames are PIXELS x PIXELS

# kernel name -> (source, the TPU kernel it replaces)
KERNEL_INFO = {
    "attention": ("rcdms_tpu_torch/csrc/attention.cu",
                  "rcdms_tpu/ops/flash.py:142 (_nt_kernel) and :61 "
                  "(_attn_kernel)"),
    "frame_attention": ("rcdms_tpu_torch/csrc/frame_attention.cu",
                        "rcdms_tpu/ops/frame_attention.py:68 (_kernel_bfnc)"),
    "geglu_ff": ("rcdms_tpu_torch/csrc/ff.cu",
                 "rcdms_tpu/ops/geglu.py:149 (_ff_kernel)"),
    "gelu_ff": ("rcdms_tpu_torch/csrc/ff.cu",
                "rcdms_tpu/ops/geglu.py:299 (_ff_gelu_kernel)"),
    "cm_conv3x3": ("rcdms_tpu_torch/csrc/cm_conv.cu",
                   "tools/cm_conv_study.py:137 (_cm_kernel)"),
    "gn_moments": ("rcdms_tpu_torch/csrc/group_norm.cu",
                   "tools/gn_study.py:99 (_moments_kernel)"),
    "group_norm_act": ("rcdms_tpu_torch/csrc/group_norm.cu",
                       "tools/gn_fused_study.py:115 (_gn_kernel)"),
    "smallk_attention": (
        "rcdms_tpu_torch/csrc/smallk_attention.cu",
        "tools/flash_smallk_study.py:68 (_kernel_base128), :82 "
        "(_kernel_slice40), :96 (_kernel_nt40), :116 (_kernel_nt_t40) and "
        "tools/pv_overlap_study.py:88 (_kernel_base), :92 "
        "(_make_split_kernel), :128 (_kernel_dscore)"),
    "attn_scores": ("rcdms_tpu_torch/csrc/attn_parts.cu",
                    "tools/flash_smallk_study.py:235 (k_score_base), :251 "
                    "(k_score_nt)"),
    "attn_pv": ("rcdms_tpu_torch/csrc/attn_parts.cu",
                "tools/flash_smallk_study.py:294 (k_pv_base), :304 "
                "(k_pv_narrow), :314 (k_pv_nt) and tools/pv_softmax_study.py"
                ":70 (k_pv_lanes), :76 (k_pv_std)"),
    "attn_softmax": ("rcdms_tpu_torch/csrc/attn_parts.cu",
                     "tools/flash_smallk_study.py:327 (k_softmax) and "
                     "tools/pv_softmax_study.py:82 (k_softmax), :91 "
                     "(k_softmax2), :100 (k_noop)"),
}


class Case(NamedTuple):
    """One phase-3 case: a kernel call, its plain version, the work its
    inputs need (flops, exponentials, bytes read once and written once),
    and one PyTorch library call of the same function, where there is
    one (timed only)."""
    name: str
    label: str
    kernel: Callable
    plain: Callable
    work: tuple
    library: Optional[Callable] = None


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., S, H * dh) -> (batch, H, S, dh), a view for SDPA."""
    return t.reshape(-1, t.shape[-2], heads, t.shape[-1] // heads
                     ).transpose(1, 2)


def kernel_cases(dev, dtype):
    """(kernel name, shape label, kernel call, plain call): A-D at the
    story's shapes (512 px, 5 frames, b = 1), then the study kernels."""
    from rcdms_tpu_torch.ops.flash import attention_plain, flash_attention
    from rcdms_tpu_torch.ops.frame_attention import (
        frame_attention,
        frame_attention_plain,
    )
    from rcdms_tpu_torch.ops.geglu import (
        geglu_ff,
        geglu_ff_plain,
        gelu_ff,
        gelu_ff_plain,
    )

    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    cases = []
    # kernel A: UNet self/cross attention per level, CLIP vision attention
    attn_shapes = [(1, 5, s, skv, c, 8, f"unet {tag} Sq={s} Skv={skv} "
                    f"dh={c // 8}")
                   for s, c in ((4096, 320), (1024, 640), (256, 1280))
                   for skv, tag in ((s, "self"), (91, "cross"))]
    attn_shapes.append((5, 1, 257, 257, 1664, 16, "clip-vision S=257 dh=104"))
    for b, f, s, skv, c, heads, label in attn_shapes:
        lead = (b, f) if b == 1 else (b,)
        q, k, v = r(*lead, s, c), r(*lead, skv, c), r(*lead, skv, c)
        dh = c // heads
        bh = b * f * heads
        cases.append(Case(
            "attention", label,
            lambda q=q, k=k, v=v, h=heads: flash_attention(q, k, v, h),
            lambda q=q, k=k, v=v, h=heads, dh=dh: attention_plain(
                q, k, v, h, dh ** -0.5),
            (4 * bh * s * skv * dh, bh * s * skv, 2 * _nbytes(q, k)),
            lambda q=q, k=k, v=v, h=heads, dh=dh:
                F.scaled_dot_product_attention(
                    _heads(q, h), _heads(k, h), _heads(v, h),
                    scale=dh ** -0.5)))
    # kernel B: UNet temporal modules per level, prior temporal modules;
    # SDPA over the same q, k, v laid out as (b n, heads, f, dh) beforehand
    # (attention across the frames at each token), timed alone
    for shape in ((1, 5, 4096, 320), (1, 5, 1024, 640), (1, 5, 256, 1280),
                  (1, 5, 64, 1280), (2, 5, 97, 2048)):
        q, k, v = r(*shape), r(*shape), r(*shape)
        b, f, n, c = shape
        dh = c // 8
        per_token = [t.transpose(1, 2).reshape(b * n, f, 8, dh).transpose(
            1, 2).contiguous() for t in (q, k, v)]
        cases.append(Case(
            "frame_attention", "x".join(map(str, shape)),
            lambda q=q, k=k, v=v: frame_attention(q, k, v, 8),
            lambda q=q, k=k, v=v, dh=dh: frame_attention_plain(
                q, k, v, 8, dh ** -0.5),
            (4 * b * n * f * f * c, b * n * 8 * f * f, 4 * _nbytes(q)),
            lambda t=per_token, dh=dh: F.scaled_dot_product_attention(
                *t, scale=dh ** -0.5)))
    # kernels C and D: UNet and prior feed-forwards (rows x c, inner 4c);
    # bf16 takes the tensor-core kernel, fp32 the CUDA-core one
    for rows, c, geglu in ((20480, 320, True), (5120, 640, True),
                           (1280, 1280, True), (320, 1280, True),
                           (970, 2048, True), (970, 2048, False)):
        inner = 4 * c
        up = 2 * inner if geglu else inner
        args = (r(rows, c), r(up, c, scale=c ** -0.5), r(up, scale=0.1),
                r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
        fn, plain = (geglu_ff, geglu_ff_plain) if geglu else (gelu_ff,
                                                               gelu_ff_plain)
        cases.append(Case(
            fn.__name__, f"{rows}x{c} inner {inner}",
            lambda a=args, fn=fn: fn(*a), lambda a=args, p=plain: p(*a),
            (2 * rows * c * (up + inner), 0,
             _nbytes(*args) + _nbytes(args[0]))))
    cases += study_kernel_cases(r, dev, dtype)
    if dtype == torch.bfloat16:
        cases += smallk_kernel_cases(r, dev)
    return cases


def study_kernel_cases(r, dev, dtype):
    """The study kernels at their studies' full shapes: the level-0 conv
    (5 frames of 64 x 64, 320 -> 320, padded to 4608 tokens) with and
    without the tap offsets, the moments of (50, 4096, 320), and the fused
    GroupNorm + SiLU at the four UNet shapes."""
    from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3, cm_conv3x3_plain
    from rcdms_tpu_torch.ops.group_norm import (
        gn_moments,
        gn_moments_plain,
        group_norm_act,
        group_norm_act_plain,
    )
    from rcdms_tpu_torch.tools import cm_conv_study as cs
    from rcdms_tpu_torch.tools import gn_fused_study as gs

    x = cs.to_cm_pad(r(cs.B, cs.H, cs.W, cs.C))
    w9, bias = r(9, cs.C, cs.COUT, scale=(9 * cs.C) ** -0.5), r(cs.COUT)
    mask = cs.interior_mask_pad().to(dev, dtype).reshape(cs.TPAD)
    # cuDNN on the same x: its padded frame as NCHW, w9 as OIHW
    x_frame = x[:, :, :cs.HP * cs.WP].unflatten(2, (cs.HP, cs.WP))
    w_oihw = w9.reshape(3, 3, cs.C, cs.COUT).permute(3, 2, 0, 1).contiguous()
    conv_work = (2 * cs.B * cs.H * cs.W * 9 * cs.C * cs.COUT, 0,
                 _nbytes(x, w9, bias, mask, x))
    cases = []
    for shifts in (True, False):
        cases.append(Case(
            "cm_conv3x3", f"{tuple(x.shape)} -> {cs.COUT}"
                          f"{'' if shifts else ' no shifts'}",
            lambda s=shifts: cm_conv3x3(x, w9, bias, mask, cs.WP, s),
            lambda s=shifts: cm_conv3x3_plain(x, w9, bias, mask, cs.WP, s),
            conv_work, lambda: F.conv2d(x_frame, w_oihw, bias)))
    xm = r(50, 4096, 320)
    cases.append(Case("gn_moments", "50x4096x320", lambda: gn_moments(xm),
                      lambda: gn_moments_plain(xm),
                      (0, 0, _nbytes(xm) + 2 * 50 * 320 * 4)))
    for shape in gs.SHAPES:
        c = shape[-1]
        args = (r(*shape), (r(c, scale=0.5) + 1.0).float(),
                r(c, scale=0.2).float(), gs.GROUPS, gs.EPS, "silu")
        x_cf = args[0].transpose(1, 2)
        cases.append(Case(
            "group_norm_act", "x".join(map(str, shape)),
            lambda a=args: group_norm_act(*a),
            lambda a=args: group_norm_act_plain(*a),
            (0, args[0].numel(), 2 * _nbytes(args[0])),
            lambda x_cf=x_cf, a=args: gs.torch_gn(x_cf, a[1], a[2])))
    return cases


def smallk_kernel_cases(r, dev):
    """E-H at the small-head-dim studies' full shape (B = 80 batch-heads,
    Sq = Skv = 4096, dh = 40, 512-row cells), bf16: every whole-block row
    of the two attention studies (E, SDPA beside base128), both score rows
    (F), the PV rows over generated and over input P (G), the softmax rows
    (H). Work counts what the inputs need: products as wide as their
    nonzero columns (base128's are zero past 40), one exponential a
    score."""
    from rcdms_tpu_torch.ops import smallk as sk
    from rcdms_tpu_torch.tools import flash_smallk_study as fs

    b, sq, skv, dh, cells = fs.B, fs.SQ, fs.SKV, fs.DH, fs.CELLS
    qt, kt, vt = r(b, dh, sq), r(b, dh, skv), r(b, dh, skv)
    tok = [F.pad(t.transpose(1, 2), (0, 128 - dh)).contiguous()
           for t in (qt, kt, vt)]
    exps = b * sq * skv
    block = (4 * exps * dh, exps, 4 * _nbytes(qt))
    # SDPA beside base128 on its (80, 1, 4096, 128) tensors and beside
    # nt_t40 on the unpadded (80, 1, 4096, 40) ones
    sdpa = {"base128": [t.unsqueeze(1) for t in tok],
            "nt_t40": [t.transpose(1, 2).contiguous().unsqueeze(1)
                       for t in (qt, kt, vt)]}
    cases = []
    for label, kw in (("base128", dict(dk=128)), ("slice40", dict(dk=dh)),
                      ("nt40", dict(norm="pre")), ("nt_t40", {}),
                      ("split2", dict(split=2)), ("split4", dict(split=4)),
                      ("dscore", dict(dscore=True))):
        cm = "dk" not in kw
        kw = ({"channel_major": True, "norm": "rounded", **kw} if cm
              else {"norm": "post", **kw})
        args = (qt, kt, vt) if cm else tok
        cases.append(Case(
            "smallk_attention", f"{label} {tuple(args[0].shape)}",
            lambda a=args, kw=kw: sk.smallk_attention(*a, fs.SCALE, **kw),
            lambda a=args, kw=kw: sk.smallk_attention_plain(*a, fs.SCALE,
                                                            **kw),
            block,
            (lambda t=sdpa[label]: F.scaled_dot_product_attention(
                *t, scale=fs.SCALE)) if label in sdpa else None))
    out_bytes = b * sq * 128 * 4
    q128, k128 = r(b, sq, 128), r(b, skv, 128)
    for label, q, k, cm in (("score_nt", qt, kt, True),
                            ("score_base", q128, k128, False)):
        width = dh if cm else 128
        cases.append(Case(
            "attn_scores", f"{label} {tuple(q.shape)}",
            lambda q=q, k=k, cm=cm: sk.attn_scores(q, k, channel_major=cm),
            lambda q=q, k=k, cm=cm: sk.attn_scores_plain(q, k,
                                                         channel_major=cm),
            (2 * exps * width, 0, _nbytes(q, k) + out_bytes)))
    seeds = r(b, 8, 128)
    p_in = (torch.rand(b, sk.BLK, skv, generator=torch.Generator(dev)
                       .manual_seed(3), device=dev) * 0.001).bfloat16()
    v128 = r(b, skv, 128)
    for label, v, cm, src in (
            ("pv_nt", vt, True, dict(seeds=seeds)),
            ("pv_base", v128, False, dict(seeds=seeds)),
            ("pv_narrow", v128[..., :dh].contiguous(), False,
             dict(seeds=seeds)),
            ("pv_lanes", vt, True, dict(p=p_in)),
            ("pv_std", v128, False, dict(p=p_in))):
        kw = dict(channel_major=cm, cells=cells, **src)
        width = dh if cm else v.shape[2]
        p_bytes = _nbytes(p_in) if "p" in src else 0
        cases.append(Case(
            "attn_pv", f"{label} {tuple(v.shape)}",
            lambda v=v, kw=kw: sk.attn_pv(v, **kw),
            lambda v=v, kw=kw: sk.attn_pv_plain(v, **kw),
            (2 * exps * width, 0, _nbytes(v) + p_bytes + out_bytes)))
    for label, kw in (("softmax gen", dict(seeds=seeds, skv=skv)),
                      ("softmax", dict(p=p_in, scale=1000.0)),
                      ("softmax2", dict(p=p_in, scale=1000.0, op="exp2")),
                      ("reduce_only", dict(p=p_in, op="sum"))):
        cases.append(Case(
            "attn_softmax", f"{label} {b}x{sq}x{skv}",
            lambda kw=kw: sk.attn_softmax(cells=cells, **kw),
            lambda kw=kw: sk.attn_softmax_plain(cells=cells, **kw),
            (0, 0 if kw.get("op") == "sum" else exps,
             (_nbytes(p_in) if "p" in kw else 0) + out_bytes)))
    return cases


def _max_diff(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def check_kernels(dev, card: str) -> dict:
    """Phase 3: every kernel against its plain version; returns the
    per-kernel summary (bf16 times at each kernel's first listed shape,
    the largest error over all shapes and both dtypes)."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.tools import bound_ms, median_ms, rel_err

    print(f"kernels on {card}: median ms of 10 calls: kernel, plain, "
          f"library call (where there is one), bound", flush=True)
    summary = {name: {"max_abs_err": 0.0} for name in ops.KERNELS}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_cases(dev, dtype):
            name, label = case.name, case.label
            out, ref = case.kernel(), case.plain()
            torch.cuda.synchronize()
            if isinstance(out, tuple):  # gn_moments: mean, mean of squares
                err = max(_max_diff(o, p) for o, p in zip(out, ref))
                rel = max(rel_err(o, p) for o, p in zip(out, ref))
            else:
                err, rel = _max_diff(out, ref), rel_err(out, ref)
            del out, ref
            ms, plain_ms = median_ms(case.kernel), median_ms(case.plain)
            lib_ms = None if case.library is None else median_ms(
                case.library)
            bound, bound_by = bound_ms(*case.work, dtype=dtype)
            row = dict(kernel=name, shape=label, dtype=str(dtype)[6:],
                       max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                       lib_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
            rows.append(row)
            lib = "-" if lib_ms is None else f"{lib_ms:.3f}"
            print(f"kernel {name:16s} {row['dtype']:8s} {label:34s} "
                  f"rel_err {rel:.2e} kernel {ms:9.3f} ms "
                  f"plain {plain_ms:9.3f} ms library {lib} ms "
                  f"bound {bound:.4f} ms ({bound_by})", flush=True)
            if not rel <= TOL[dtype]:
                raise AssertionError(f"{name} {label} {dtype}: relative "
                                     f"error {rel:.3e} > {TOL[dtype]}")
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dtype == torch.bfloat16 and "ms" not in s:
                s.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=bound_by, shape=label)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return summary


def check_tiny_reference(dev) -> dict:
    """Phase 4: the tiny pipeline (fp32, seeded weights, 2 steps) on the
    card, through the kernels, against the same pipeline on the CPU, where
    every wrapper runs its plain version, on the same explicit noise.
    Tolerances as the CPU tests hold the port against the JAX package:
    5e-4 on the stage-1 embeds, 1e-3 on the frames (fp32 on both sides,
    TF32 off; sums in another order, compounded over the steps)."""
    import copy

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.sample.pipeline import StoryNoise, build_tiny_pipeline

    pipe, inputs = build_tiny_pipeline(seed=0, num_steps=2)
    cfg = pipe.configs
    b, f = inputs.frame_known.shape
    d = cfg.prior.embedding_dim
    h8 = inputs.source_pixels.shape[2] // 2 ** (len(cfg.vae.block_channels)
                                                 - 1)
    g = torch.Generator().manual_seed(5)
    noise = StoryNoise(*(torch.randn(s, generator=g) for s in (
        (b, f, d), (2, b, f, d), (b * f, h8, h8, 4), (b, f, h8, h8, 4))))
    frames, embeds = pipe.generate(inputs, noise=noise)

    card = copy.deepcopy(pipe).to(dev)
    ops.reset_launch_counts()
    frames_c, embeds_c = card.generate(
        type(inputs)(*(t.to(dev) for t in inputs)),
        noise=StoryNoise(*(t.to(dev) for t in noise)))
    torch.cuda.synchronize()
    counts = ops.launch_counts("story")
    embed_err = (embeds_c.cpu() - embeds).abs().max().item()
    frame_err = (frames_c.cpu() - frames).abs().max().item()
    print(f"reference: tiny story on the card vs the CPU: embeds max|diff| "
          f"{embed_err:.2e}, frames max|diff| {frame_err:.2e}; launches "
          f"{counts}", flush=True)
    if not (embed_err <= 5e-4 and frame_err <= 1e-3):
        raise AssertionError("the tiny story on the card disagrees with the "
                             "CPU's plain versions")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"tiny story launched no {missing}")
    return dict(embed_err=embed_err, frame_err=frame_err)


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_constant(value: float, size: int, dev) -> torch.Tensor:
    """A CLIP-preprocessed constant image (value in [0, 1])."""
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    return ((value - mean) / std).expand(size, size, 3).contiguous()


def token_rows(g, f: int, length: int, eos: int, dev):
    """(1, f, length) caption ids as CLIP's tokenizer lays them out: BOS
    (eos - 1), random words, EOS, EOS padding; and the "" row."""
    ids = torch.full((1, f, length), eos, dtype=torch.int64)
    ids[..., 0] = eos - 1
    uncond = ids.clone()
    for i in range(f):
        n = int(torch.randint(1, length - 1, (1,), generator=g))
        ids[0, i, 1:n + 1] = torch.randint(0, eos - 1, (n,), generator=g)
    return ids.to(dev), uncond.to(dev)


def story_request(configs, seed: int, pixels: int, dev):
    """One story: seeded captions, frame 0 known (a seeded random image),
    frames 1-4 unknown (black)."""
    from rcdms_tpu_torch.sample.pipeline import StoryInputs

    g = torch.Generator().manual_seed(seed)
    f, t = configs.prior.num_frames, configs.prior.num_text_tokens
    csize = configs.vision.image_size
    known = torch.zeros(1, f, dtype=torch.bool, device=dev)
    known[0, 0] = True
    frame0 = torch.rand(pixels, pixels, 3, generator=g).to(dev)
    px = torch.full((1, f, pixels, pixels, 3), -1.0, device=dev)
    px[0, 0] = frame0 * 2 - 1
    clip0 = torch.nn.functional.interpolate(
        frame0.permute(2, 0, 1)[None], size=(csize, csize),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    source_clip = clip_constant(0.0, csize, dev).expand(1, f, csize, csize,
                                                        3).clone()
    source_clip[0, 0] = (clip0 - mean) / std
    mask_clip = torch.where(known[..., None, None, None],
                            clip_constant(1.0, csize, dev),
                            clip_constant(0.0, csize, dev))
    tokens, uncond = token_rows(g, f, t, configs.text_s1.eos_token_id, dev)
    return StoryInputs(tokens_s1=tokens, tokens_s1_u=uncond,
                       tokens_s2=tokens, tokens_s2_u=uncond,
                       source_clip=source_clip, mask_clip=mask_clip,
                       source_pixels=px, frame_known=known)


def run_story(configs, dev, dtype, steps: int, pixels: int) -> dict:
    """Phase 5: build, cache, two requests and a repeat; returns the
    per-request seconds and the launch counts of the main path."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.sample.pipeline import build_pipeline

    t0 = time.perf_counter()
    pipe = build_pipeline(configs, dev, dtype, seed=0, num_steps=steps)
    requests = [story_request(configs, seed, pixels, dev)
                for seed in (1, 2)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    print(f"story: built the full pipeline in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in pipe.parameters()) / 1e9:.3f} B params, "
          f"{steps} steps", flush=True)

    csize = configs.vision.image_size
    ops.reset_launch_counts()
    uncond = requests[0].tokens_s1_u[0, 0]
    cache = pipe.precompute_cond_cache(uncond, uncond,
                                       clip_constant(1.0, csize, dev),
                                       clip_constant(0.0, csize, dev))
    results, seconds = [], []
    for i, (req, seed) in enumerate(((requests[0], 11), (requests[1], 12),
                                     (requests[0], 11))):
        t0 = time.perf_counter()
        frames, embeds = pipe.generate(
            req, cache, torch.Generator(dev).manual_seed(seed))
        sync()
        seconds.append(time.perf_counter() - t0)
        print(f"story: request {i + 1} {'(repeat of 1) ' if i == 2 else ''}"
              f"{seconds[-1]:.3f} s", flush=True)
        results.append(frames)
    counts = ops.launch_counts("story")

    f = configs.prior.num_frames
    for frames in results:
        if frames.shape != (1, f, pixels, pixels, 3):
            raise AssertionError(f"frames shape {tuple(frames.shape)}")
        if not torch.isfinite(frames).all():
            raise AssertionError("non-finite frames")
        if frames.min() < 0 or frames.max() > 1:
            raise AssertionError("frames outside [0, 1]")
    repeat_err = (results[2] - results[0]).abs().max().item()
    if repeat_err > 1e-3:
        raise AssertionError(f"repeat differs by {repeat_err}")
    if (results[1] - results[0]).abs().max().item() == 0:
        raise AssertionError("two different requests gave equal frames")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    print(f"story: repeat max|diff| {repeat_err:.2e}; launches {counts}",
          flush=True)
    profile = profile_request(pipe, requests[1], cache, dev, 12)
    return dict(seconds=seconds, counts=counts, repeat_err=repeat_err,
                profile=profile)


# profiler groups of a story's kernels: (group, substrings of the kernel
# name), the first match wins; "other" takes the rest (cuBLAS products,
# norms, elementwise PyTorch kernels, copies)
KERNEL_GROUPS = (
    ("C/D", ("ff_gemm_kernel", "rcdms::(anonymous namespace)::ff_kernel")),
    ("B", ("frame_attention_kernel",)),
    ("A", ("attention_mma_kernel",
           "rcdms::(anonymous namespace)::attention_kernel")),
    ("cuDNN", ("cudnn", "fprop", "implicit_gemm", "winograd")),
)


def kernel_group(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def profile_request(pipe, req, cache, dev, seed: int) -> dict:
    """One request under torch.profiler: the device time of every kernel
    and copy, summed by name and by group (KERNEL_GROUPS); prints each
    group's seconds and share of the request's device time and writes
    them, with the 15 longest names, to chip_smoke_story_profile.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(req, cache, torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() * 1e-6)
    device = sum(by_name.values())
    if device <= 0:
        raise AssertionError("the profiler saw no device time")
    groups = dict.fromkeys(("A", "B", "C/D", "cuDNN", "other"), 0.0)
    for name, sec in by_name.items():
        groups[kernel_group(name)] += sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    result = dict(wall_s=wall, device_s=device,
                  groups={g: dict(s=sec, share=sec / device)
                          for g, sec in groups.items()},
                  top=[dict(name=n[:160], s=sec) for n, sec in top])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_story_profile.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"story profile: one request {wall:.3f} s wall (profiled), "
          f"{device:.3f} s device: " + ", ".join(
              f"{g} {v['s']:.3f} s ({v['share']:.1%})"
              for g, v in result["groups"].items()), flush=True)
    return result


def run_studies(dev, card: str) -> dict:
    """Phase 6: each ResNet-block study's rows at its full shapes, in bf16
    and fp32, then each small-head-dim attention study's rows in bf16;
    every row within TOL of its study's reference (the dots and sdpa rows
    are only timed; pv_overlap raises itself on a row off its oracle);
    returns the studies' launch counts."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.tools import (
        cm_conv_study,
        flash_smallk_study,
        gn_fused_study,
        gn_study,
        print_rows,
        pv_overlap_study,
        pv_softmax_study,
    )

    print(f"studies on {card}: median ms of 10 calls", flush=True)
    ops.reset_launch_counts()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for study in (cm_conv_study, gn_study, gn_fused_study):
            rows += study.run(dev, dtype)
    for study in (flash_smallk_study, pv_overlap_study, pv_softmax_study):
        rows += study.run(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts("studies")
    print_rows(rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_studies.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    tol = {str(dtype)[6:]: t for dtype, t in TOL.items()}
    bad = [(r["study"], r["row"], r["dtype"], r["rel_err"]) for r in rows
           if r["rel_err"] is not None and not r["rel_err"] <= tol[r["dtype"]]]
    if bad:
        raise AssertionError(f"study rows off their reference: {bad}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"the studies launched no {missing}")
    print(f"studies: launches {counts}", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rcdms_tpu_torch.ops import _build
    from rcdms_tpu_torch.sample.pipeline import full_configs
    from rcdms_tpu_torch.tools import card_line

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({built.path.name}, "
          f"nvcc {built.seconds:.1f} s)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.log"), "w") as fh:
        fh.write(built.log)

    summary = check_kernels(dev, card)
    check_tiny_reference(dev)
    story = run_story(full_configs(temporal_zero_init=False), dev,
                      torch.bfloat16, STEPS, PIXELS)
    print(f"story: {card}: per-request seconds "
          f"{[round(s, 3) for s in story['seconds']]} at {STEPS} steps",
          flush=True)
    launches = {**story["counts"], **run_studies(dev, card)}

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"], shape=s["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
