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
   2e-2 (bf16; H, whose outputs are fp32, 1e-4), with the median time of
   each side, of one PyTorch library call that computes the same function
   where there is one (SDPA beside A,
   B and E, cuDNN beside the conv, F.group_norm + F.silu beside the fused
   GN with SiLU, F.group_norm beside it without; the first port's fused
   GN kernel timed beside the cluster kernel where it takes the shape),
   and the case's bound (its work at the card's published peaks); each
   bf16 B case must take B's tiled kernel (its launch count is printed),
   each fp32 one the general kernel; A's share of bf16 outputs off the
   plain version's bits is printed, and must be below 0.38 at UNet level
   0 (A rounds P against the row's final maximum, as the TPU kernels);
   H's four rows (softmax over generated P, softmax, softmax2,
   reduce_only) also print their device time (`torch.profiler`), which
   must not be under their bound (every cell's exponentials on MUFU.EX2,
   or P read once and the output written once): a share of the bound
   above 1.0 means work was left out;
4. reference: the tiny pipeline in fp32 on the card, through the kernels,
   against the same pipeline on the CPU (plain versions) on the same
   noise: stage-1 embeds within 5e-4, frames within 1e-3; the same for
   the sampling opt-ins (DDIM eta 0.5 on injected step noise, batched
   CFG, encoder propagation k = 2, the autoregressive stage 1); the int8
   route: `torch._int_mm` equal to the CPU's integer matmul on the same
   int8 operands at the tiny and full-width UNet's conv shapes, an int8
   conv module within 1e-6 of the CPU's on the same input, and a whole
   int8 tiny story with its frames' mean |diff| within 2e-2;
5. story: the full-width two-stage pipeline (Flintstones configs: 91
   tokens, vocab 49412, 512 px, 5 frames) in bf16 with seeded random
   weights: the story-independent conditioning cache, two requests with
   their own generators, and request 1 again. Frames must be finite, in
   [0, 1], of shape (1, 5, 512, 512, 3), the repeat equal to the first run
   within 1e-3, every kernel of the story (A-D) must have launched, and
   every B launch must have taken the tiled kernel.
   Then one more request under `torch.profiler`: the device time of its
   kernels summed by name into A, B, C/D, cuDNN and other, each group's
   seconds and share printed and written to
   chiprun_out/chip_smoke_story_profile.json;
6. studies: the three ResNet-block studies (`rcdms_tpu_torch/tools/`:
   channel-major 3x3 conv, GroupNorm moments, fused GroupNorm + SiLU) at
   their full shapes, in bf16 and fp32, then the three small-head-dim
   attention studies (flash_smallk, pv_overlap, pv_softmax: E-H, H reading
   or generating each row of P once a block for the warps of its cells) in
   bf16; every row within the tolerance of phase 3 of its study's
   reference (the
   pv_overlap rows also within 0.02 of its fp32 oracle), and every study
   kernel launched;
7. entry points (`rcdms_tpu_torch/cli/`): (a) `cli.generate.run` at full
   width in bf16 with seeded random init (the Flintstones DatasetConfig,
   so no h5 is opened; crc32 tokens; five fixed captions, one seeded
   128 x 128 known frame; 20 steps, CFG 2.0, seed 42): frames finite, in
   [0, 1], of shape (1, 5, 512, 512, 3), each of A-D launched and every B
   launch tiled, the grid written by `save_story_grid` to
   chiprun_out/chip_smoke_story.png with a valid PNG signature and IHDR
   size; (b) checkpoint ingest at full width: the same build's prior
   saved as a stage-1 blob and its UNet and fusion stacks as a stage-2
   DeepSpeed directory (`latest` tag), in bf16, under chiprun_out/, loaded
   by `load_rcdms_stage1` / `load_rcdms_stage2` into towers built from
   another seed; every tensor must equal its source bit for bit, and the
   loaded pipeline's request, on (a)'s inputs and generator, (a)'s frames
   within 1e-3 (phase 5's repeat tolerance); the blobs are deleted
   afterwards; (c) `python -m rcdms_tpu_torch.cli.evaluate --synthetic` in
   fp32 on the card, two stories, continue mode: every metric of the
   JSONL and the summary finite;
8. serve (`rcdms_tpu_torch/cli/serve.py`) at full width in bf16 (7a's
   model flags, --max-batch 2, --max-wait-ms 200, 20 steps) on
   127.0.0.1:0: built and warmed, then three concurrent POST /generate
   (seeds 1, 2, 3; seed 2 with a PNG reference frame): three 200s of 5
   PNGs of 512 x 512 x 3 (read back by `decode_png`), the batch sizes
   printed, every story kernel launched and every B launch tiled; then
   `_run` at batch 1 (seed 1) and batch 2 (seeds 1, 2): the same
   launches, seconds a story at each, seed 1's frames within a mean
   |diff| of 2e-2 of its lone run, finite, in [0, 1]; one request with
   encoder propagation k = 2 (the UNet encodes 20 times against 40);
   7a's request again exact (within 1e-3 of 7a) and with --quantize int8:
   finite, its int8 convs counted, its seconds and SSIM against 7a's
   frames printed.

Phases 4 and 5 count only the story's kernels (`ops.PATHS["story"]`),
phase 6 only the studies' (`ops.PATHS["studies"]`), phase 7a the story's
again, phase 8 the story's in the served requests: each path's counts are
set to 0 just before it and read just after.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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
    one PyTorch library call of the same function, where there is one,
    and (label, call) pairs of other versions to time beside it (both
    timed only)."""
    name: str
    label: str
    kernel: Callable
    plain: Callable
    work: tuple
    library: Optional[Callable] = None
    baselines: tuple = ()


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
    # kernel A: UNet self/cross attention per level (the plain version's
    # l from the rounded P, as `_nt_kernel`), CLIP vision attention (l
    # from the fp32 P, as `_attn_kernel`)
    attn_shapes = [(1, 5, s, skv, c, 8, "rounded", f"unet {tag} Sq={s} "
                    f"Skv={skv} dh={c // 8}")
                   for s, c in ((4096, 320), (1024, 640), (256, 1280))
                   for skv, tag in ((s, "self"), (91, "cross"))]
    attn_shapes.append((5, 1, 257, 257, 1664, 16, "fp32",
                        "clip-vision S=257 dh=104"))
    for b, f, s, skv, c, heads, row_sum, label in attn_shapes:
        lead = (b, f) if b == 1 else (b,)
        q, k, v = r(*lead, s, c), r(*lead, skv, c), r(*lead, skv, c)
        dh = c // heads
        bh = b * f * heads
        cases.append(Case(
            "attention", label,
            lambda q=q, k=k, v=v, h=heads, rs=row_sum: flash_attention(
                q, k, v, h, row_sum=rs),
            lambda q=q, k=k, v=v, h=heads, dh=dh, rs=row_sum: attention_plain(
                q, k, v, h, dh ** -0.5, row_sum=rs),
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
    GroupNorm with and without SiLU at the study's four UNet shapes and
    (5, 4096, 960)."""
    from rcdms_tpu_torch.ops import group_norm as gn
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
    # the fused GroupNorm at the study's shapes and up level 0's first
    # ResNet block, with SiLU (beside F.group_norm + F.silu) and without
    # (beside F.group_norm), and the first port's kernel timed beside it
    # where its one-block group slab fits
    for shape in gs.SHAPES + [(5, 4096, 960)]:
        b, n, c = shape
        xg = r(*shape)
        x_cf = xg.transpose(1, 2)
        gscale = (r(c, scale=0.5) + 1.0).float()
        gbias = r(c, scale=0.2).float()
        slab_fits = (n * (c // gs.GROUPS) * xg.element_size()
                     <= gn.SMEM_MAX - gn._SLAB_RESERVED)
        for act in ("silu", "none"):
            args = (xg, gscale, gbias, gs.GROUPS, gs.EPS, act)
            library = (
                (lambda x_cf=x_cf, sc=gscale, bi=gbias: gs.torch_gn(x_cf, sc,
                                                                    bi))
                if act == "silu" else
                (lambda x_cf=x_cf, sc=gscale.to(dtype), bi=gbias.to(dtype):
                    F.group_norm(x_cf, gs.GROUPS, sc, bi, gs.EPS)))
            cases.append(Case(
                "group_norm_act", f"{b}x{n}x{c} {act}",
                lambda a=args: group_norm_act(*a),
                lambda a=args: group_norm_act_plain(*a),
                (0, xg.numel() if act == "silu" else 0, 2 * _nbytes(xg)),
                library,
                (("first kernel", lambda a=args: gn.group_norm_act_slab(*a)),)
                if slab_fits else ()))
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
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
    from rcdms_tpu_torch.tools import bound_ms, device_us, median_ms, rel_err

    print(f"kernels on {card}: median ms of 10 calls: kernel, plain, "
          f"library call (where there is one), bound", flush=True)
    summary = {name: {"max_abs_err": 0.0} for name in ops.KERNELS}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_cases(dev, dtype):
            name, label = case.name, case.label
            frame_attention.tiled_launches = 0
            out, ref = case.kernel(), case.plain()
            torch.cuda.synchronize()
            tiled = frame_attention.tiled_launches
            if name == "frame_attention" and tiled != int(
                    dtype == torch.bfloat16):
                raise AssertionError(f"B {label} {dtype}: {tiled} tiled "
                                     f"launches")
            if isinstance(out, tuple):  # gn_moments: mean, mean of squares
                err = max(_max_diff(o, p) for o, p in zip(out, ref))
                rel = max(rel_err(o, p) for o, p in zip(out, ref))
            else:
                err, rel = _max_diff(out, ref), rel_err(out, ref)
            # A rounds P as its plain version: the share of bf16 outputs
            # off the plain version's bits
            bits_off = ((out != ref).float().mean().item()
                        if name == "attention" and dtype == torch.bfloat16
                        else None)
            del out, ref
            ms, plain_ms = median_ms(case.kernel), median_ms(case.plain)
            lib_ms = None if case.library is None else median_ms(
                case.library)
            others = {other: median_ms(fn) for other, fn in case.baselines}
            bound, bound_by = bound_ms(*case.work, dtype=dtype)
            # H: device time, which must not be under the bound
            device_ms = (sum(device_us(case.kernel).values()) / 1e3
                         if name == "attn_softmax" else None)
            row = dict(kernel=name, shape=label, dtype=str(dtype)[6:],
                       max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                       lib_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                       **({} if bits_off is None else dict(bits_off=bits_off)),
                       **({} if device_ms is None else dict(
                           device_ms=device_ms, share=bound / device_ms)),
                       **({} if not others else dict(others_ms=others)))
            if name == "frame_attention":
                row["tiled_launches"] = tiled
            rows.append(row)
            lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
            print(f"kernel {name:16s} {row['dtype']:8s} {label:34s} "
                  f"rel_err {rel:.2e} kernel {ms:9.4f} ms "
                  f"plain {plain_ms:9.4f} ms library {lib} ms "
                  f"bound {bound:.4f} ms ({bound_by})"
                  + (f" tiled {tiled}" if name == "frame_attention" else "")
                  + ("" if bits_off is None else
                     f" bits off the plain version {bits_off:.4f}")
                  + ("" if device_ms is None else
                     f" device {device_ms:.4f} ms "
                     f"({bound / device_ms:.1%} of bound)")
                  + "".join(f" {other} {t:.4f} ms"
                            for other, t in others.items()),
                  flush=True)
            # H's outputs are fp32 sums of fp32 exponentials: fp32's
            # tolerance, whatever its P's dtype
            tol = TOL[torch.float32 if name == "attn_softmax" else dtype]
            if not rel <= tol:
                raise AssertionError(f"{name} {label} {dtype}: relative "
                                     f"error {rel:.3e} > {tol}")
            if device_ms is not None and not bound / device_ms <= 1.0:
                raise AssertionError(f"{name} {label}: device time "
                                     f"{device_ms:.4f} ms under its bound "
                                     f"{bound:.4f} ms: work left out")
            if bits_off is not None and label.startswith("unet self "
                                                         "Sq=4096") \
                    and not bits_off < 0.38:
                raise AssertionError(f"A at UNet level 0: {bits_off:.4f} of "
                                     f"its bf16 outputs off the plain "
                                     f"version's bits, not below the 0.38 "
                                     f"of a running-maximum rounding")
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dtype == torch.bfloat16 and "ms" not in s:
                s.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=bound_by, shape=label)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return summary


def _with_sampler(pipe, **options):
    """A pipeline over `pipe`'s towers, steps, guidance and schedule, with
    the story sampler's `options` (`StoryPipeline`'s constructor)."""
    from rcdms_tpu_torch.sample.pipeline import StoryPipeline

    s = pipe.story_sampler
    return StoryPipeline(pipe.configs, num_steps=s.num_steps,
                         guidance_scale=s.guidance_scale, schedule=s.schedule,
                         towers=dict(pipe.named_children()), **options)


def check_int8_products(dev, unet_cpu) -> dict:
    """Phase 4's int8 route: `torch._int_mm` on the card against the CPU's
    integer matmul on the same int8 operands (exact: its int32 sums are
    the route's result before the fp32 epilogue), at the tiny UNet's int8
    conv and at the full-width UNet's (level 0's 320 channels, level 3's
    1280, the up path's 2560 from a skip concat, conv_out's 4 output
    channels padded to 8); then the tiny UNet's
    first int8 conv module on the card against the CPU on the same fp32
    input (the same quantization, so the same sums and epilogue)."""
    import copy

    from rcdms_tpu_torch.core.layers import FrameConv
    from rcdms_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(11)
    shapes = [(5 * 8 * 8, 9 * 64, 64), (5 * 64 * 64, 9 * 320, 320),
              (5 * 64 * 64, 9 * 320, 8), (5 * 8 * 8, 9 * 1280, 1280),
              (5 * 8 * 8, 9 * 2560, 1280)]
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        want = quant.int_matmul(a, b)
        got = quant.int_matmul(a.to(dev), b.to(dev)).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"torch._int_mm ({m}, {k}) @ ({k}, {n}) "
                                 f"differs from the CPU integer matmul by "
                                 f"{(got - want).abs().max().item()}")
    conv = next(m for m in unet_cpu.modules() if isinstance(m, FrameConv)
                and m.in_channels % 64 == 0 and m.kernel_size == (3, 3)
                and m.stride == (1, 1))
    x = torch.randn((1, 5, 8, 8, conv.in_channels), generator=g)
    quant.set_quant_mode("int8")
    try:
        calls = quant.int8_conv3x3.calls
        with torch.no_grad():
            want = conv(x)
            got = copy.deepcopy(conv).to(dev)(x.to(dev)).cpu()
        if quant.int8_conv3x3.calls != calls + 2:
            raise AssertionError("the int8 conv route did not run")
    finally:
        quant.set_quant_mode(None)
    conv_err = ((got - want).abs().max() / want.abs().max()).item()
    if not conv_err <= 1e-6:
        raise AssertionError(f"the int8 conv on the card differs from the "
                             f"CPU's by {conv_err:.2e} relative")
    return dict(int_mm_shapes=shapes, conv_rel_err=conv_err)


def check_tiny_reference(dev) -> dict:
    """Phase 4: the tiny pipeline (fp32, seeded weights, 2 steps) on the
    card, through the kernels, against the same pipeline on the CPU, where
    every wrapper runs its plain version, on the same explicit noise.
    Tolerances as the CPU tests hold the port against the JAX package:
    5e-4 on the stage-1 embeds, 1e-3 on the frames (fp32 on both sides,
    TF32 off; sums in another order, compounded over the steps). Then the
    sampling opt-ins the same way: DDIM eta 0.5 on injected step noise,
    batched CFG, encoder propagation k = 2 (the card's UNet encodes only
    on step 0) and the autoregressive stage 1; and the int8 route
    (`check_int8_products`). A whole int8 story's frames are held by
    their mean |diff| (2e-2, phase 8's batch tolerance), not their
    maximum: an activation that the card and the CPU round to the two
    sides of a quantization step moves the frames of a tiny random story
    by far more than 1e-3."""
    import copy

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops import quant
    from rcdms_tpu_torch.sample.pipeline import StoryNoise, build_tiny_pipeline

    pipe, inputs = build_tiny_pipeline(seed=0, num_steps=2)
    size = inputs.source_pixels.shape[2]
    card = copy.deepcopy(pipe).to(dev)
    card_inputs = type(inputs)(*(t.to(dev) for t in inputs))
    f = pipe.configs.prior.num_frames

    def story(pipe=pipe, card=card):
        # the CPU pipeline's draws, the same on both sides
        noise = StoryNoise.draw(pipe, 1, torch.Generator().manual_seed(5),
                                size)
        frames, embeds = pipe.generate(inputs, noise=noise)
        frames_c, embeds_c = card.generate(card_inputs, noise=StoryNoise(
            *(None if t is None else t.to(dev) for t in noise)))
        torch.cuda.synchronize()
        return ((embeds_c.cpu() - embeds).abs().max().item(),
                (frames_c.cpu() - frames).abs())

    def autoreg():
        csize = pipe.configs.vision.image_size
        white = torch.full((csize, csize, 3), 1.5)
        passes = pipe.prior_sampler.draw_passes(
            1, f, torch.Generator().manual_seed(6))
        embeds = pipe.generate_stage1_autoreg(inputs, white, noise=passes)
        embeds_c = card.generate_stage1_autoreg(
            card_inputs, white.to(dev),
            noise=[(a.to(dev), b.to(dev)) for a, b in passes])
        torch.cuda.synchronize()
        return (embeds_c.cpu() - embeds).abs().max().item(), None

    results = {}

    def check(label, run, frame_stat="max"):
        embed_err, frame_diff = run()
        r = dict(embed_err=embed_err)
        if frame_diff is not None:
            r.update(frame_err=frame_diff.max().item(),
                     frame_mean_err=frame_diff.mean().item())
        results[label] = r
        print(f"reference: tiny story ({label}) on the card vs the CPU: "
              f"embeds max|diff| {embed_err:.2e}" + (
                  "" if frame_diff is None else
                  f", frames max|diff| {r['frame_err']:.2e}, mean |diff| "
                  f"{r['frame_mean_err']:.2e}"), flush=True)
        frames_ok = frame_diff is None or (
            r["frame_err"] <= 1e-3 if frame_stat == "max"
            else r["frame_mean_err"] <= 2e-2)
        if not (embed_err <= 5e-4 and frames_ok):
            raise AssertionError(f"the tiny story ({label}) on the card "
                                 f"disagrees with the CPU's plain versions")

    ops.reset_launch_counts()
    check("exact", story)
    counts = ops.launch_counts("story")
    print(f"reference: launches {counts}", flush=True)
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"tiny story launched no {missing}")
    def variant(**options):
        return lambda: story(*(_with_sampler(p, **options)
                               for p in (pipe, card)))

    check("eta 0.5", variant(eta=0.5))
    check("batched cfg", variant(sequential_cfg=False))
    encodes = card.unet.encode_calls
    check("encoder propagation 2", variant(encoder_propagation=2))
    if card.unet.encode_calls - encodes != 2:
        raise AssertionError(f"k = 2 over 2 steps encoded "
                             f"{card.unet.encode_calls - encodes} times, "
                             f"not 2 (step 0, both CFG branches)")
    check("autoregressive stage 1", autoreg)
    products = results["int8 products"] = check_int8_products(dev,
                                                               pipe.unet)
    print(f"reference: int8 route: torch._int_mm equals the CPU integer "
          f"matmul at {products['int_mm_shapes']}; the int8 conv on the "
          f"card vs the CPU {products['conv_rel_err']:.2e} relative",
          flush=True)
    quant.set_quant_mode("int8")
    try:
        calls = quant.int8_conv3x3.calls
        check("int8", story, frame_stat="mean")
        if quant.int8_conv3x3.calls == calls:
            raise AssertionError("the int8 story ran no int8 conv")
    finally:
        quant.set_quant_mode(None)
    return results


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


def _check_frames(frames: torch.Tensor, f: int, pixels: int) -> None:
    if frames.shape != (1, f, pixels, pixels, 3):
        raise AssertionError(f"frames shape {tuple(frames.shape)}")
    if not torch.isfinite(frames).all():
        raise AssertionError("non-finite frames")
    if frames.min() < 0 or frames.max() > 1:
        raise AssertionError("frames outside [0, 1]")


def _check_story_launches(counts: dict, where: str) -> None:
    """Each story kernel launched, and every B launch took the tiled
    kernel."""
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched {where}: {missing}")
    if counts["frame_attention_tiled"] != counts["frame_attention"]:
        raise AssertionError(f"B took the general kernel {where}: "
                             f"{counts['frame_attention_tiled']} of "
                             f"{counts['frame_attention']} launches tiled")


def run_story(configs, dev, dtype, steps: int, pixels: int) -> dict:
    """Phase 5: build, cache, two requests and a repeat; returns the
    per-request seconds and the launch counts of the main path."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
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
    counts["frame_attention_tiled"] = frame_attention.tiled_launches

    for frames in results:
        _check_frames(frames, configs.prior.num_frames, pixels)
    repeat_err = (results[2] - results[0]).abs().max().item()
    if repeat_err > 1e-3:
        raise AssertionError(f"repeat differs by {repeat_err}")
    if (results[1] - results[0]).abs().max().item() == 0:
        raise AssertionError("two different requests gave equal frames")
    _check_story_launches(counts, "on the main path")
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
    ("B", ("frame_attention_kernel", "frame_attention_tiled_kernel")),
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


# phase 7's request: five Flintstones captions and one known frame
ENTRY_CAPTIONS = [
    "Fred and Barney stand in the living room talking.",
    "Wilma walks into the kitchen holding a plate.",
    "Betty and Wilma laugh together on the couch.",
    "Dino runs across the yard after Pebbles.",
    "Mr. Slate shouts at Fred in the quarry office.",
]


def _png_size(path: str) -> tuple:
    """(width, height) from a PNG's IHDR; raises unless the file starts
    with the PNG signature and an IHDR chunk."""
    import struct

    from rcdms_tpu_torch.sample.eval import PNG_SIGNATURE

    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def entry_generate(dev, args, frame0) -> torch.Tensor:
    """Phase 7a: `cli.generate.run` at full width; returns its frames."""
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import generate
    from rcdms_tpu_torch.ops.frame_attention import frame_attention
    from rcdms_tpu_torch.sample.eval import save_story_grid

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    frames, embeds = generate.run(args, ENTRY_CAPTIONS, [frame0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts("story")
    counts["frame_attention_tiled"] = frame_attention.tiled_launches
    _check_frames(frames, len(ENTRY_CAPTIONS), PIXELS)
    if not torch.isfinite(embeds).all():
        raise AssertionError("non-finite stage-1 embeds")
    _check_story_launches(counts, "in generate.run")
    path = os.path.join(OUT_DIR, "chip_smoke_story.png")
    t0 = time.perf_counter()
    save_story_grid(path, frames[0].cpu().numpy())
    png_s = time.perf_counter() - t0
    size = _png_size(path)
    if size != (len(ENTRY_CAPTIONS) * PIXELS, PIXELS):
        raise AssertionError(f"grid PNG is {size}")
    print(f"entry 7a: generate.run {seconds:.3f} s (build, protocol and "
          f"request), frames in [{frames.min().item():.3f}, "
          f"{frames.max().item():.3f}]; launches {counts}; grid {path} "
          f"{size[0]} x {size[1]}, {os.path.getsize(path)} bytes, written "
          f"in {png_s:.3f} s", flush=True)
    return frames


def entry_checkpoints(dev, args, frame0, frames_a: torch.Tensor) -> dict:
    """Phase 7b: the 7a build's prior, UNet and fusion stacks through
    reference blobs into towers built from another seed, bit for bit; the
    loaded pipeline's request against 7a's frames."""
    import shutil
    import tempfile

    from rcdms_tpu_torch.cli import common, evaluate
    from rcdms_tpu_torch.sample.pipeline import StoryPipeline

    src, dataset, ds_cfg = evaluate.build_pipeline(args)
    cfg = src.configs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=OUT_DIR)
    try:
        t0 = time.perf_counter()
        stage1 = os.path.join(tmp, "stage1.pt")
        torch.save({"module": {f"module.{k}": v for k, v in
                               src.prior.state_dict().items()}}, stage1)
        stage2 = os.path.join(tmp, "stage2")
        os.makedirs(os.path.join(stage2, "global_step1"))
        blob = {f"unet.{k}": v for k, v in src.unet.state_dict().items()}
        blob.update(src.fusion.state_dict())  # seen_module. / unseen_module.
        stage2_file = os.path.join(stage2, "global_step1",
                                   "mp_rank_00_model_states.pt")
        torch.save({"module": blob}, stage2_file)
        with open(os.path.join(stage2, "latest"), "w") as fh:
            fh.write("global_step1")
        del blob
        save_s = time.perf_counter() - t0
        nbytes = (os.path.getsize(stage1), os.path.getsize(stage2_file))

        kw = dict(dtype=src.dtype, device=dev, seed=1)
        towers = dict(prior=common.build_prior(cfg.prior, None, **kw),
                      unet=common.build_unet(cfg.unet, None, **kw),
                      fusion=common.build_fusion(cfg.fusion, **kw))
        if torch.equal(towers["unet"].conv_in.weight, src.unet.conv_in.weight):
            raise AssertionError("the other seed built the same UNet")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        common.load_rcdms_stage1(stage1, towers["prior"])
        common.load_rcdms_stage2(stage2, towers["unet"], towers["fusion"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    n_tensors = 0
    for name, tower in towers.items():
        want = getattr(src, name).state_dict()
        got = tower.state_dict()
        if set(got) != set(want):
            raise AssertionError(f"{name}: keys differ")
        for k, v in want.items():
            if got[k].dtype != v.dtype or not torch.equal(got[k], v):
                raise AssertionError(f"{name}.{k} differs from its source")
        n_tensors += len(want)

    loaded = StoryPipeline(
        cfg, num_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        towers=dict(text_s1=src.text_s1, text_s2=src.text_s2,
                    vision=src.vision, vae=src.vae, **towers)).eval()
    dtype = str(src.dtype)[6:]
    del src
    t0 = time.perf_counter()
    inputs = common.build_story_inputs(ENTRY_CAPTIONS, [frame0], "", dataset,
                                       ds_cfg, dev)
    frames, _ = loaded.generate(inputs, generator=torch.Generator(
        dev).manual_seed(common.story_seed(args.seed, 0)))
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    _check_frames(frames, len(ENTRY_CAPTIONS), PIXELS)
    err = (frames - frames_a).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"the loaded pipeline's frames differ from "
                             f"7a's by {err}")
    print(f"entry 7b: blobs stage-1 {nbytes[0]} bytes, stage-2 {nbytes[1]} "
          f"bytes ({dtype}), saved in {save_s:.2f} s, loaded in {load_s:.2f} s; "
          f"{n_tensors} tensors equal their source bit for bit; request on "
          f"the loaded pipeline {request_s:.3f} s, frames max|diff| vs 7a "
          f"{err:.2e}", flush=True)
    return dict(stage1_bytes=nbytes[0], stage2_bytes=nbytes[1],
                save_s=save_s, load_s=load_s, request_s=request_s, err=err)


def entry_evaluate(dev) -> dict:
    """Phase 7c: the evaluate CLI on synthetic stories in fp32 on the card;
    returns its summary."""
    from rcdms_tpu_torch.cli import evaluate

    out = os.path.join(OUT_DIR, "chip_smoke_eval")
    t0 = time.perf_counter()
    summary = evaluate.main(["--synthetic", "--device", str(dev), "--dtype",
                             "float32", "--mode", "continue",
                             "--num-stories", "2", "--num-inference-steps",
                             str(STEPS), "--output-dir", out])
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "metrics_0.jsonl")) as fh:
        metrics = [json.loads(line) for line in fh if line.strip()]
    with open(os.path.join(out, "summary_0.json")) as fh:
        if json.load(fh) != summary:
            raise AssertionError("summary_0.json differs from the summary")
    values = [v for m in metrics for v in m.values()] + list(summary.values())
    if len(metrics) != 2 or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"evaluate metrics {metrics} {summary}")
    print(f"entry 7c: evaluate --synthetic, 2 stories in {seconds:.2f} s "
          f"(build included): {metrics}; summary {summary}", flush=True)
    return summary


def run_entry_points(dev, card: str) -> dict:
    """Phase 7: the CLIs' entry points on the card (module docstring)."""
    import numpy as np

    from rcdms_tpu_torch.cli import evaluate

    print(f"entry points on {card}", flush=True)
    args = evaluate.parse_args([
        "--dataset", "flintstones", "--dtype", "bfloat16",
        "--num-inference-steps", str(STEPS), "--guidance-scale", "2.0",
        "--seed", "42", "--device", "cuda"])
    frame0 = np.random.RandomState(0).randint(0, 256, (128, 128, 3),
                                              np.uint8)
    frames = entry_generate(dev, args, frame0)
    ckpt = entry_checkpoints(dev, args, frame0, frames)
    frames_a = frames.cpu()
    del frames
    torch.cuda.empty_cache()
    return dict(checkpoints=ckpt, evaluate=entry_evaluate(dev),
                frames_a=frames_a, frame0=frame0)


def _serve_args(*extra):
    """The serve CLI's flags of phase 8: phase 7a's model flags."""
    from rcdms_tpu_torch.cli import serve

    return serve.parse_args([
        "--host", "127.0.0.1", "--port", "0", "--max-batch", "2",
        "--max-wait-ms", "200", "--dataset", "flintstones", "--dtype",
        "bfloat16", "--num-inference-steps", str(STEPS), "--guidance-scale",
        "2.0", "--seed", "42", "--device", "cuda", *extra])


def _story_counts() -> dict:
    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.ops.frame_attention import frame_attention

    counts = ops.launch_counts("story")
    counts["frame_attention_tiled"] = frame_attention.tiled_launches
    return counts


def serve_requests(url: str, frame0) -> list:
    """Three concurrent POST /generate requests (seeds 1, 2, 3; seed 2
    with `frame0` as a PNG reference frame); returns their replies, frames
    still base64 PNGs (the client shares the server's process, so decoding
    them now would hold the interpreter lock the dispatch thread needs)."""
    import base64
    import threading
    import urllib.request

    from rcdms_tpu_torch.sample.eval import encode_png

    replies = [None] * 3
    errors = []

    def post(i, seed):
        body = {"captions": ENTRY_CAPTIONS, "seed": seed}
        if seed == 2:
            body["reference_frames"] = [
                base64.b64encode(encode_png(frame0)).decode()]
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                reply = json.loads(r.read())
                reply["status"] = r.status
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"seed {seed}: {type(e).__name__}: {e}")
            return
        replies[i] = reply

    threads = [threading.Thread(target=post, args=(i, seed))
               for i, seed in enumerate((1, 2, 3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(r is None for r in replies):
        raise AssertionError(f"serve requests failed: {errors}")
    return replies


def run_serve(dev, card: str, entry: dict) -> dict:
    """Phase 8: `cli.serve` at full width in bf16 (phase 7a's model flags,
    --max-batch 2, --max-wait-ms 200): three concurrent HTTP requests,
    then `_run` at batch 1 and 2 (seed 1's frames alone and beside seed
    2), one request with encoder propagation k = 2, and 7a's request
    exact and with --quantize int8."""
    import base64
    import threading

    import numpy as np

    from rcdms_tpu_torch import ops
    from rcdms_tpu_torch.cli import common, serve
    from rcdms_tpu_torch.ops import quant
    from rcdms_tpu_torch.sample.eval import decode_png, ssim

    print(f"serve on {card}", flush=True)
    args = _serve_args()
    ready, box = threading.Event(), []
    t0 = time.perf_counter()
    # the server is built in the int8 mode --quantize sets, so the bf16
    # cast quantizes the UNet's gated convs from their fp32 values (the
    # warm-up runs them); its requests below run exact until the int8 one
    quant.set_quant_mode(_serve_args("--quantize", "int8").eval.quantize)
    thread = threading.Thread(target=serve.serve, args=(args,),
                              kwargs=dict(ready_event=ready, httpd_box=box),
                              daemon=True)
    thread.start()
    try:
        if not ready.wait(timeout=900):
            raise AssertionError("the server did not start")
    finally:
        quant.set_quant_mode(None)
    httpd, srv = box[0]
    print(f"serve: {card}: built, warmed and listening in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    replies = serve_requests(url, entry["frame0"])
    http_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _story_counts()
    httpd.shutdown()
    srv.stop()
    srv.worker.join(timeout=60)
    thread.join(timeout=60)
    for r in replies:
        r["frames"] = [decode_png(base64.b64decode(x)) for x in r["frames"]]
        if r["status"] != 200 or len(r["frames"]) != len(ENTRY_CAPTIONS) \
                or any(x.shape != (PIXELS, PIXELS, 3) for x in r["frames"]):
            raise AssertionError(f"a serve reply is off: status "
                                 f"{r['status']}, {len(r['frames'])} frames")
    _check_story_launches(counts, "in the served requests")
    print(f"serve: {card}: 3 concurrent requests answered 200 in "
          f"{http_s:.3f} s; batch sizes {[r['batch_size'] for r in replies]}, "
          f"latencies {[r['latency_s'] for r in replies]} s; launches "
          f"{counts}", flush=True)

    def request(seed):
        return serve._Request(srv.story_inputs(ENTRY_CAPTIONS, [], ""), seed)

    runs = {}
    for label, seeds in (("batch 1", (1,)), ("batch 2", (1, 2))):
        ops.reset_launch_counts()
        encodes = srv.pipeline.unet.encode_calls
        t0 = time.perf_counter()
        frames = srv._run([request(s) for s in seeds])
        seconds = time.perf_counter() - t0
        runs[label] = dict(frames=frames, seconds=seconds,
                           per_story_s=seconds / len(seeds),
                           counts=_story_counts(),
                           encodes=srv.pipeline.unet.encode_calls - encodes)
        print(f"serve: {card}: _run {label}: {seconds:.3f} s, "
              f"{seconds / len(seeds):.3f} s a story; UNet encodes "
              f"{runs[label]['encodes']}; launches {runs[label]['counts']}",
              flush=True)
    one, two = runs["batch 1"], runs["batch 2"]
    if one["counts"] != two["counts"]:
        raise AssertionError(f"batch 2 launched {two['counts']}, batch 1 "
                             f"{one['counts']}")
    diff = (two["frames"][0] - one["frames"][0]).abs()
    batch_err = dict(max=diff.max().item(), mean=diff.mean().item())
    for frames in (one["frames"], two["frames"]):
        if not torch.isfinite(frames).all() or frames.min() < 0 \
                or frames.max() > 1:
            raise AssertionError("served frames non-finite or off [0, 1]")
    print(f"serve: seed 1 alone vs beside seed 2: max|diff| "
          f"{batch_err['max']:.3e}, mean |diff| {batch_err['mean']:.3e}",
          flush=True)
    if not batch_err["mean"] <= 2e-2:
        raise AssertionError(f"seed 1's frames moved by {batch_err} in a "
                             f"batch")

    exact_pipe = srv.pipeline
    srv.pipeline = _with_sampler(exact_pipe, encoder_propagation=2)
    encodes = srv.pipeline.unet.encode_calls
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        frames = srv._run([request(1)])
        prop_s = time.perf_counter() - t0
        prop_counts = _story_counts()
    finally:
        srv.pipeline = exact_pipe
    prop_encodes = srv.pipeline.unet.encode_calls - encodes
    prop_err = (frames[0] - one["frames"][0]).abs().max().item()
    if not torch.isfinite(frames).all() or prop_encodes != STEPS \
            or one["encodes"] != 2 * STEPS:
        raise AssertionError(f"encoder propagation: {prop_encodes} encodes "
                             f"against {one['encodes']}, or frames "
                             f"non-finite")
    print(f"serve: {card}: encoder propagation k = 2: {prop_s:.3f} s, UNet "
          f"encodes {prop_encodes} against {one['encodes']}; frames "
          f"max|diff| vs k = 0 {prop_err:.3e}; launches {prop_counts}",
          flush=True)

    # 7a's request (its inputs, no cond cache, its generator) exact and
    # with the int8 mode --quantize sets
    inputs = common.build_story_inputs(ENTRY_CAPTIONS, [entry["frame0"]], "",
                                       srv.dataset, srv.ds_cfg, dev)
    seed = common.story_seed(args.eval.seed, 0)
    exact, _ = srv.pipeline.generate(
        inputs, generator=torch.Generator(dev).manual_seed(seed))
    exact_err = (exact.cpu() - entry["frames_a"]).abs().max().item()
    if not exact_err <= 1e-3:
        raise AssertionError(f"the server's pipeline is not 7a's: "
                             f"{exact_err}")
    quant.set_quant_mode(_serve_args("--quantize", "int8").eval.quantize)
    try:
        calls = quant.int8_conv3x3.calls
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        frames_q, _ = srv.pipeline.generate(
            inputs, generator=torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        int8_s = time.perf_counter() - t0
        int8_counts = _story_counts()
        int8_convs = quant.int8_conv3x3.calls - calls
    finally:
        quant.set_quant_mode(None)
    if not torch.isfinite(frames_q).all() or int8_convs == 0:
        raise AssertionError("the int8 request is non-finite or ran no "
                             "int8 conv")
    a = frames_q[0].cpu().numpy().astype(np.float64)
    b = entry["frames_a"][0].numpy().astype(np.float64)
    int8_ssim = float(np.mean([ssim(a[i], b[i]) for i in range(len(a))]))
    print(f"serve: {card}: --quantize int8: {int8_s:.3f} s, {int8_convs} "
          f"int8 convs a request, SSIM vs 7a's exact frames {int8_ssim:.4f} "
          f"(the exact rerun max|diff| vs 7a {exact_err:.2e}); launches "
          f"{int8_counts}", flush=True)
    del srv, exact, frames_q
    torch.cuda.empty_cache()
    return dict(batch_sizes=[r["batch_size"] for r in replies],
                http_s=http_s, launches=counts,
                batch1_s=one["per_story_s"], batch2_s=two["per_story_s"],
                batch_err=batch_err, propagation_s=prop_s,
                propagation_encodes=prop_encodes,
                propagation_launches=prop_counts, int8_launches=int8_counts,
                int8_s=int8_s,
                int8_convs=int8_convs, int8_ssim=int8_ssim)


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
    entry = run_entry_points(dev, card)
    served = run_serve(dev, card, entry)
    print(f"serve: {card}: seconds a story at batch 1 "
          f"{served['batch1_s']:.3f}, at batch 2 {served['batch2_s']:.3f}",
          flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"], shape=s["shape"]))
        if name in served["launches"]:
            kernels[-1]["serve_launches"] = served["launches"][name]
        if name == "frame_attention":
            kernels[-1]["tiled_launches"] = launches["frame_attention_tiled"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
