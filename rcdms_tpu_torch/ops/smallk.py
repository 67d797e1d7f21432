"""The four kernels of the small-head-dim attention studies (SD-1.5 UNet
level 0: B = 80 batch-heads, 4096 x 4096 tokens, dh = 40, bf16):

* `smallk_attention` (E): a whole block, softmax(q k^T * scale) v, in the
  token-major (B, S, 128) layout (the score contracting `dk` = 40 or 128
  columns) or channel-major (B, dh, S); three normalisations, the rounding
  families of the TPU kernels: "post" (fp32 p, o = (bf16 p) v / l), "pre"
  (p = bf16(p / l) before the product), "rounded" (p = bf16(exp(s - m)),
  l = the sum of the rounded p, o = (p v) * (1 / l)); and the schedules
  `split` (2 or 4 sub-blocks, exp of one beside the product of the other)
  and `dscore` (the score computed twice, the second time transposed).
  The counterpart of `tools/flash_smallk_study.py::run_variant` and
  `tools/pv_overlap_study.py::run_variant`;
* `attn_scores` (F): q k^T, unscaled, each row reduced to 128 lane-group
  sums (`redsum`): `run_isolated`'s score kernels;
* `attn_pv` (G): P v with P generated as the study's `gen_p` or read from a
  (B, 512, Skv) input that every 512-row cell of a batch row shares; out
  (B, Sq, 128) fp32, zero past the width of v: `run_isolated`'s PV kernels
  and `tools/pv_softmax_study.py`'s;
* `attn_softmax` (H): the row softmax of generated P or of an input P *
  scale, by exp or by exp2 of the pre-scaled argument, reduced like F;
  or the reduced sums of P alone (op "sum").

Each wrapper dispatches on where its tensors lie: on the CPU it runs its
plain version; on a CUDA device it launches `csrc/smallk_attention.cu` (E,
`mma.sync`, with the launch plan of `_plan`) or `csrc/attn_parts.cu`
(bf16 only, as the TPU studies), or raises. The
variants are the studies' own; anything else raises on either device.
The plain versions work one batch row at a time: a whole (80, 4096, 4096)
fp32 score tensor would take 5.4 GB. `.launches` counts launches.
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops import _build

BLK = 512     # rows of a cell, as the TPU studies cut Sq
GROUP = 128   # width of the lane-group reductions and of F-H's outputs
LOG2E = 1.4426950408889634
NORMS = {"post": 0, "pre": 1, "rounded": 2}
SOFTMAX_OPS = {"exp": 0, "exp2": 1, "sum": 2}
# (channel_major, norm, split, dscore) of the studies' whole-block rows
SMALLK_VARIANTS = {(False, "post", 1, False), (True, "pre", 1, False),
                   (True, "rounded", 1, False), (True, "rounded", 2, False),
                   (True, "rounded", 4, False), (True, "rounded", 1, True)}


def _card_bf16(name: str, *tensors: torch.Tensor) -> None:
    _build.cuda_operands(name, *tensors)
    if tensors[0].dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 operands, got "
                        f"{tensors[0].dtype}")


def gen_p(seeds: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The study's generated probabilities, (B, rows, cols) bf16:
    bf16((7 r + c) mod 117) times seeds[b, 0, 0], rounded to bf16."""
    r = torch.arange(rows, device=seeds.device)[:, None] * 7
    c = torch.arange(cols, device=seeds.device)[None]
    base = ((r + c) % 117).float()
    return (base[None] * seeds[:, 0, 0, None, None].float()).to(torch.bfloat16)


def _redsum(s: torch.Tensor) -> torch.Tensor:
    """(rows, n * GROUP) -> (rows, GROUP): the sum over the n groups."""
    return s.reshape(s.shape[0], -1, GROUP).sum(1)


# ---- E --------------------------------------------------------------------


def _check_smallk(q, k, v, channel_major, dk, norm, split, dscore) -> int:
    """Validate E's operands and variant; return the contraction width."""
    if (channel_major, norm, split, dscore) not in SMALLK_VARIANTS:
        raise ValueError(f"smallk_attention: no study variant is channel_"
                         f"major={channel_major}, norm={norm!r}, "
                         f"split={split}, dscore={dscore}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0]:
        raise ValueError(f"smallk_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if channel_major:
        if q.shape[1] != k.shape[1] or dk not in (None, q.shape[1]):
            raise ValueError(f"smallk_attention: channel-major q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, dk {dk}")
        return q.shape[1]
    width = q.shape[2]
    dk = width if dk is None else dk
    if k.shape[2] != width or not 0 < dk <= width:
        raise ValueError(f"smallk_attention: token-major q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, dk {dk}")
    return dk


def _plan(channel_major: bool, dk: int, split: int, dscore: bool) -> dict:
    """Launch plan of E's `mma.sync` kernel: a block of `bq` = 128 queries
    in `threads` / 32 warps of `split` m16 row tiles each
    (`rows_per_warp`); the score contracting `dp` columns (dk padded to
    48, or 128 token-major); `n_tiles` n8 output tiles a row tile (the 128
    token-major columns, or dk / 8 rounded up to 5 or 6 channel-major); and
    the block's shared memory (`smem`): the Q tile and two stages of K and
    V tiles of `kv_tile` keys, token-major rows (or channel-major rows of
    128 / 64 tokens) 8 bf16 longer than their data, plus dscore's 128
    fp32 row maxima. Raises ValueError for operands the kernel does not
    take."""
    if dk <= 0 or dk % 8 or dk > (48 if channel_major else 128):
        raise ValueError(f"smallk_attention: the kernel takes dk a multiple "
                         f"of 8 up to {48 if channel_major else 128}, got "
                         f"{dk}")
    bq, kv, width = 128, 64, 128
    dp = 48 if dk <= 48 else 128
    if channel_major:
        n_tiles = 5 if dk <= 40 else 6
        smem = 2 * (dp * (bq + 8) + 4 * dp * (kv + 8)) + (4 * bq if dscore
                                                           else 0)
    else:
        n_tiles = width // 8
        smem = 2 * ((bq + 2 * kv) * (dp + 8) + 2 * kv * (width + 8))
    return dict(bq=bq, kv_tile=kv, dp=dp, n_tiles=n_tiles,
                rows_per_warp=16 * split, threads=32 * 8 // split, smem=smem)


def smallk_attention_plain(q, k, v, scale: float, *, channel_major=False,
                           dk=None, norm="post", split=1,
                           dscore=False) -> torch.Tensor:
    """Plain PyTorch version of `smallk_attention`, one batch row at a
    time, in fp32 with the kernel's roundings (split changes no number)."""
    dk = _check_smallk(q, k, v, channel_major, dk, norm, split, dscore)
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        if channel_major:
            qb, kb, vb = (t[b].float().T for t in (q, k, v))
        else:
            qb, kb, vb = q[b, :, :dk].float(), k[b, :, :dk].float(), \
                v[b].float()
        s = (qb @ kb.T) * scale
        m = s.amax(-1, keepdim=True)
        if dscore:  # p from the transposed score, as the kernel forms it
            p = torch.exp((kb @ qb.T) * scale - m.T).T
        else:
            p = torch.exp(s - m)
        if norm == "post":
            o = (p.bfloat16().float() @ vb) / p.sum(-1, keepdim=True)
        elif norm == "pre":
            o = (p / p.sum(-1, keepdim=True)).bfloat16().float() @ vb
        else:
            pb = p.bfloat16().float()
            o = (pb @ vb) * (1.0 / pb.sum(-1, keepdim=True))
        out[b] = (o.T if channel_major else o).to(q.dtype)
    return out


def smallk_attention(q, k, v, scale: float, *, channel_major=False, dk=None,
                     norm="post", split=1, dscore=False) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, Sq, W) / (B, Skv, W) operands, the
    score contracting the first dk columns, or over channel-major (B, dh,
    S) ones; out like q, in q's dtype (module docstring)."""
    dk = _check_smallk(q, k, v, channel_major, dk, norm, split, dscore)
    kw = dict(channel_major=channel_major, dk=dk, norm=norm, split=split,
              dscore=dscore)
    if q.device.type == "cpu":
        return smallk_attention_plain(q, k, v, scale, **kw)
    _card_bf16("smallk_attention", q, k, v)
    bsz, sq, skv = q.shape[0], q.shape[-1 if channel_major else 1], \
        k.shape[-1 if channel_major else 1]
    width = dk if channel_major else q.shape[2]
    if sq % 128 or skv % 64 or dk % 8 or (
            dk > 48 if channel_major else (width != 128 or 48 < dk < 128)):
        raise ValueError(f"smallk_attention: the kernel takes Sq a multiple "
                         f"of 128, Skv of 64, and channel-major dh <= 48 or "
                         f"token-major width 128 with dk <= 48 or 128 (a "
                         f"multiple of 8); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, dk {dk}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("smallk_attention: the kernel takes 16-byte "
                         "aligned q, k, v")
    plan = _plan(channel_major, dk, split, dscore)
    out = torch.empty_like(q)
    code = _build.library().lib.rcdms_smallk_attention(
        int(channel_major), NORMS[norm], split, int(dscore), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, sq, skv, width, dk,
        float(scale), plan["smem"], _build.stream(q))
    _build.check(code, "rcdms_smallk_attention")
    smallk_attention.launches += 1
    return out


# ---- F --------------------------------------------------------------------


def _check_scores(q, k, channel_major) -> None:
    d = 1 if channel_major else 2
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] \
            or q.shape[d] != k.shape[d] or k.shape[3 - d] % GROUP:
        raise ValueError(f"attn_scores: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, channel_major={channel_major}")


def attn_scores_plain(q, k, *, channel_major=False) -> torch.Tensor:
    """Plain PyTorch version of `attn_scores`, one batch row at a time."""
    _check_scores(q, k, channel_major)
    sq = q.shape[2 if channel_major else 1]
    out = torch.empty(q.shape[0], sq, GROUP, device=q.device,
                      dtype=torch.float32)
    for b in range(q.shape[0]):
        qb, kb = (q[b].float().T, k[b].float().T) if channel_major else (
            q[b].float(), k[b].float())
        out[b] = _redsum(qb @ kb.T)
    return out


def attn_scores(q, k, *, channel_major=False) -> torch.Tensor:
    """q k^T reduced to (B, Sq, 128) fp32 lane-group sums; q (B, Sq, 128),
    k (B, Skv, 128), or channel-major q (B, dh, Sq), k (B, dh, Skv)."""
    _check_scores(q, k, channel_major)
    if q.device.type == "cpu":
        return attn_scores_plain(q, k, channel_major=channel_major)
    _card_bf16("attn_scores", q, k)
    d = q.shape[1] if channel_major else q.shape[2]
    sq = q.shape[2 if channel_major else 1]
    if sq % 128 or (d > 48 or d % 8 if channel_major else d != 128):
        raise ValueError(f"attn_scores: the kernel takes Sq a multiple of "
                         f"128 and channel-major dh <= 48 (a multiple of 8) "
                         f"or token-major width 128; got q {tuple(q.shape)}")
    out = torch.empty(q.shape[0], sq, GROUP, device=q.device,
                      dtype=torch.float32)
    code = _build.library().lib.rcdms_attn_scores(
        int(channel_major), q.data_ptr(), k.data_ptr(), out.data_ptr(),
        q.shape[0], sq, k.shape[2 if channel_major else 1], d,
        _build.stream(q))
    _build.check(code, "rcdms_attn_scores")
    attn_scores.launches += 1
    return out


# ---- G and H: P from seeds or from an input --------------------------------


def _p_source(name, seeds, p, batch, skv=None) -> tuple[int, int]:
    """Check that exactly one P source is given; return (blk, Skv)."""
    if (seeds is None) == (p is None):
        raise ValueError(f"{name}: give seeds (to generate P) or p, not both")
    if seeds is not None:
        if seeds.shape != (batch, 8, 128):
            raise ValueError(f"{name}: seeds {tuple(seeds.shape)} is not "
                             f"({batch}, 8, 128)")
        return BLK, skv
    if p.dim() != 3 or p.shape[0] != batch or (skv not in (None, p.shape[2])):
        raise ValueError(f"{name}: p {tuple(p.shape)} for batch {batch}, "
                         f"Skv {skv}")
    return p.shape[1], p.shape[2]


def _check_pv(v, seeds, p, channel_major, cells):
    if v.dim() != 3 or cells < 1:
        raise ValueError(f"attn_pv: v {tuple(v.shape)}, cells {cells}")
    skv, width = (v.shape[2], v.shape[1]) if channel_major else (
        v.shape[1], v.shape[2])
    if width > GROUP:
        raise ValueError(f"attn_pv: v {tuple(v.shape)} is wider than {GROUP}")
    blk, _ = _p_source("attn_pv", seeds, p, v.shape[0], skv)
    return blk, skv, width


def attn_pv_plain(v, *, seeds=None, p=None, channel_major=False,
                  cells=8) -> torch.Tensor:
    """Plain PyTorch version of `attn_pv`, one batch row at a time: every
    cell of a batch row has the same P, so its product is computed once."""
    blk, skv, width = _check_pv(v, seeds, p, channel_major, cells)
    out = torch.zeros(v.shape[0], cells * blk, GROUP, device=v.device,
                      dtype=torch.float32)
    for b in range(v.shape[0]):
        pb = gen_p(seeds[b:b + 1], blk, skv)[0] if p is None else p[b]
        vb = v[b].float().T if channel_major else v[b].float()
        out[b, :, :width] = (pb.float() @ vb).repeat(cells, 1)
    return out


def attn_pv(v, *, seeds=None, p=None, channel_major=False,
            cells=8) -> torch.Tensor:
    """P v for `cells` cells of BLK rows, out (B, cells * blk, 128) fp32,
    zero past the width of v. P: generated from seeds (B, 8, 128), or p
    (B, blk, Skv). v: (B, Skv, width), or channel-major (B, dh, Skv)."""
    blk, skv, width = _check_pv(v, seeds, p, channel_major, cells)
    kw = dict(seeds=seeds, p=p, channel_major=channel_major, cells=cells)
    if v.device.type == "cpu":
        return attn_pv_plain(v, **kw)
    _card_bf16("attn_pv", v, seeds if p is None else p)
    layout = 2 if channel_major else (0 if width == GROUP else 1)
    if blk % 128 or skv % 64 or (layout and (width > 48 or width % 8)):
        raise ValueError(f"attn_pv: the kernel takes blk a multiple of 128, "
                         f"Skv of 64 and v of width 128 or <= 48 (a multiple "
                         f"of 8); got v {tuple(v.shape)}, blk {blk}")
    out = torch.empty(v.shape[0], cells * blk, GROUP, device=v.device,
                      dtype=torch.float32)
    code = _build.library().lib.rcdms_attn_pv(
        layout, None if seeds is None else seeds.data_ptr(),
        None if p is None else p.data_ptr(), v.data_ptr(), out.data_ptr(),
        v.shape[0], cells * blk, skv, blk, width, _build.stream(v))
    _build.check(code, "rcdms_attn_pv")
    attn_pv.launches += 1
    return out


def _check_softmax(seeds, p, op, cells, skv):
    if op not in SOFTMAX_OPS or cells < 1:
        raise ValueError(f"attn_softmax: op {op!r}, cells {cells}")
    batch = (seeds if p is None else p).shape[0]
    blk, skv = _p_source("attn_softmax", seeds, p, batch, skv)
    if skv is None or skv % GROUP:
        raise ValueError(f"attn_softmax: Skv {skv} is not a multiple of "
                         f"{GROUP}")
    return batch, blk, skv


def attn_softmax_plain(*, seeds=None, p=None, op="exp", scale=1.0, cells=8,
                       skv=None) -> torch.Tensor:
    """Plain PyTorch version of `attn_softmax`, one batch row at a time."""
    batch, blk, skv = _check_softmax(seeds, p, op, cells, skv)
    out = torch.empty(batch, cells * blk, GROUP,
                      device=(seeds if p is None else p).device,
                      dtype=torch.float32)
    for b in range(batch):
        pb = (gen_p(seeds[b:b + 1], blk, skv)[0] if p is None else p[b])
        if op == "sum":
            red = _redsum(pb.float())
        else:
            s = pb.float() * scale
            m = s.amax(-1, keepdim=True)
            e = torch.exp(s - m) if op == "exp" else torch.exp2(
                (s - m) * LOG2E)
            red = _redsum(e * (1.0 / e.sum(-1, keepdim=True)))
        out[b] = red.repeat(cells, 1)
    return out


def attn_softmax(*, seeds=None, p=None, op="exp", scale=1.0, cells=8,
                 skv=None) -> torch.Tensor:
    """The row softmax of P * scale (op "exp", or "exp2" of the pre-scaled
    argument), or P itself (op "sum"), reduced to (B, cells * blk, 128)
    fp32 lane-group sums. P: generated from seeds (B, 8, 128) with skv
    columns, or p (B, blk, Skv)."""
    batch, blk, skv = _check_softmax(seeds, p, op, cells, skv)
    kw = dict(seeds=seeds, p=p, op=op, scale=scale, cells=cells, skv=skv)
    src = seeds if p is None else p
    if src.device.type == "cpu":
        return attn_softmax_plain(**kw)
    _card_bf16("attn_softmax", src)
    out = torch.empty(batch, cells * blk, GROUP, device=src.device,
                      dtype=torch.float32)
    code = _build.library().lib.rcdms_attn_softmax(
        SOFTMAX_OPS[op], None if seeds is None else seeds.data_ptr(),
        None if p is None else p.data_ptr(), out.data_ptr(), batch,
        cells * blk, skv, blk, float(scale), _build.stream(src))
    _build.check(code, "rcdms_attn_softmax")
    attn_softmax.launches += 1
    return out


smallk_attention.launches = 0
attn_scores.launches = 0
attn_pv.launches = 0
attn_softmax.launches = 0
