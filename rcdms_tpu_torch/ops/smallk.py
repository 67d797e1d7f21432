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
  or the reduced sums of P alone (op "sum"). Its exp rows are bound by
  the MUFU's exponentials (every cell's), its sums by bytes.

Each wrapper dispatches on where its tensors lie: on the CPU it runs its
plain version; on a CUDA device it launches `csrc/smallk_attention.cu` (E,
TMA + `wgmma`, with the launch plan of `_plan`) or `csrc/attn_parts.cu` (F
and G on TMA + `wgmma`, with the plans of `_scores_plan` and `_pv_plan`;
H, a row of P read by one TMA bulk copy or generated once a block and
shared by the warps of its cells, one FFMA and one MUFU.EX2 an element,
with the plan of `_softmax_plan`), bf16 only, as the TPU studies, or
raises. The variants are the studies' own; anything else raises on
either device.
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


E_QUERIES = 128       # queries a block: two consumer warpgroups of 64
E_MAX_STAGES = 4
E_CM_ROWS = 48        # channel-major box rows: dh padded to k48 by TMA
E_SPLITS = (1, 2, 4)  # the kernel's schedules: base, ping-pong, + overlap


def _plan(channel_major: bool, dk: int, split: int, dscore: bool) -> dict:
    """Launch plan of E's TMA + `wgmma` kernel (blocks of E_QUERIES
    queries in two consumer warpgroups, and a producer warpgroup): the
    score contracting `dp` columns (dk padded to 48, or 128 token-major;
    channel-major boxes of 48 rows of 64 tokens, rows past dh TMA's
    zeros); `nv` the width of P V (channel-major n40 for dk <= 40, else
    n48; dscore 64, V^T's rows padded to wgmma's M; token-major 128); `bn`
    keys a tile (128 channel-major, 64 token-major); the ring of `stages`
    K and V tiles (`stage_bytes` each), the most of at most four that fit;
    and the block's shared memory (`smem`): 1024 bytes to align, the Q
    tiles, a 1024-byte tile of ones, dscore's four P^T buffers (bn keys x
    64 queries), the ring, dscore's 128 fp32 a query, the full and empty
    mbarriers of each stage and Q's. The C entry takes dp, nv, bn, stages
    and smem and refuses any that differ from the instance's. Raises
    ValueError for operands the kernel does not take."""
    if split not in E_SPLITS or (dscore and (split != 1
                                             or not channel_major)):
        raise ValueError(f"smallk_attention: no kernel schedule for split "
                         f"{split}, dscore {dscore}, channel_major "
                         f"{channel_major}")
    if channel_major:
        if dk <= 0 or dk % 8 or dk > E_CM_ROWS:
            raise ValueError(f"smallk_attention: the kernel takes channel-"
                             f"major dh a multiple of 8 up to {E_CM_ROWS}, "
                             f"got {dk}")
        dp, bn = E_CM_ROWS, 128
        nv = 64 if dscore else (40 if dk <= 40 else 48)
        q_tile = k_box = E_CM_ROWS * 128   # a warpgroup's Q; 64 keys of K
        k_tile, v_box = 2 * k_box, (64 if dscore else E_CM_ROWS) * 128
    else:
        if dk <= 0 or dk % 8 or (48 < dk != GROUP):
            raise ValueError(f"smallk_attention: the kernel takes token-"
                             f"major dk a multiple of 8 up to 48, or "
                             f"{GROUP}, got {dk}")
        dp, bn, nv = (48 if dk <= 48 else GROUP), 64, GROUP
        boxes = -(-dp // 64)
        q_tile, k_tile, v_box = boxes * 64 * 128, boxes * bn * 128, bn * 128
    stage = k_tile + 2 * v_box
    fixed = 1024 + 2 * q_tile + 1024 + (4 * bn * 128 if dscore else 0)

    def smem(stages):
        return (fixed + stages * stage + (4 * E_QUERIES if dscore else 0)
                + 8 * (2 * stages + 1))

    stages = max(n for n in range(2, E_MAX_STAGES + 1)
                 if smem(n) <= SMEM_MAX)
    return dict(dp=dp, nv=nv, bn=bn, stages=stages, stage_bytes=stage,
                smem=smem(stages))


# ---- F and G: the TMA + wgmma tile kernels' plans --------------------------

TILE_ROWS = 128       # rows a block: two consumer warpgroups of 64
TILE_THREADS = 288    # the two warpgroups and one producer warp
PV_KEYS = 64          # keys a ring stage of G: four k16 steps
MAX_STAGES = 8
RING_BYTES = 96 * 1024  # the ring's budget: two blocks an SM fit beside it
BOX = 64 * 128        # a TMA box of 64 rows of 128 bytes (128-byte swizzle)
P_TABLE = 1024        # G's table of generated P pairs, ahead of the ring
PV_LAYOUTS = {"tm128": 0, "tm40": 1, "cm40": 2}


def _staging_bytes(n: int) -> int:
    """The epilogue's staging of 8 consumer warps' 16 rows x n fp32, at a
    row stride of n floats, or n + 8 where n mod 32 is not 8 or 24 (then
    a half warp's float2 stores would share banks)."""
    return 8 * 16 * (n if n % 32 in (8, 24) else n + 8) * 4


def _tile_smem(fixed: int, stage: int, stages: int, n: int) -> int:
    """A tile kernel's shared memory (`tile_bytes` in attn_parts.cu): F's
    Q tiles or G's P table, and the ring, under the staging; the full and
    empty mbarriers of each stage and Q's; 1024 bytes to align the
    swizzled tiles."""
    return 1024 + max(fixed + stages * stage, _staging_bytes(n)) \
        + 8 * (2 * stages + 1)


def _tile_plan(fixed: int, stage: int, n: int, **extra) -> dict:
    stages = min(MAX_STAGES, RING_BYTES // stage)
    return dict(rows=TILE_ROWS, warpgroups=2, threads=TILE_THREADS,
                stages=stages, stage_bytes=stage, n=n,
                smem=_tile_smem(fixed, stage, stages, n), **extra)


def _scores_plan(channel_major: bool, dk: int) -> dict:
    """Launch plan of F's kernel: blocks of `rows` = 128 queries in two
    consumer warpgroups and a producer warp; the contraction `kp`, dk
    padded with zeros to a multiple of 16 (wgmma's k16), channel-major dk
    <= 48 or token-major 128; n = 128 output columns; a ring of `stages`
    key groups (`stage_bytes`: two TMA boxes, [kp d][64 keys] or [128
    keys][64 d]) as deep as RING_BYTES allows, up to 8; the block's shared
    memory (`smem`). Raises ValueError for operands the kernel does not
    take."""
    if channel_major:
        if dk <= 0 or dk % 8 or dk > 48:
            raise ValueError(f"attn_scores: the kernel takes channel-major "
                             f"dh a multiple of 8 up to 48, got {dk}")
        kp = -(-dk // 16) * 16
        q_wg = k_box = kp * 128
    else:
        if dk != GROUP:
            raise ValueError(f"attn_scores: the kernel takes token-major "
                             f"width {GROUP}, got {dk}")
        kp, q_wg, k_box = GROUP, 2 * BOX, 2 * BOX
    return _tile_plan(2 * q_wg, 2 * k_box, GROUP, kp=kp)


def _pv_plan(layout: str, width: int, gen: bool) -> dict:
    """Launch plan of G's kernel for v in `layout` ("tm128" (B, Skv, 128),
    "tm40" (B, Skv, width), "cm40" (B, width, Skv)) and P generated
    (`gen`) or an input: blocks of 128 rows as F's; the product's width
    `n`, 128, or width padded to wgmma's n40 (width <= 40) or n48; the
    generated P's table of products (P_TABLE bytes); a ring of `stages`
    stages of 64 keys (`stage_bytes`: input P's two [64 rows][64 keys]
    boxes, then V's tm128 two [64 keys][64 n] boxes, tm40 one, cm40 one [n
    d][64 keys]) as deep as RING_BYTES allows, up to 8; the block's shared
    memory (`smem`). Raises ValueError for operands the kernel does not
    take."""
    if layout not in PV_LAYOUTS:
        raise ValueError(f"attn_pv: no layout {layout!r}")
    if layout == "tm128":
        if width != GROUP:
            raise ValueError(f"attn_pv: tm128 takes width {GROUP}, got "
                             f"{width}")
        n = GROUP
    else:
        if width <= 0 or width % 8 or width > 48:
            raise ValueError(f"attn_pv: the kernel takes v of width 128 or "
                             f"<= 48 (a multiple of 8), got {width}")
        n = 40 if width <= 40 else 48
    v_box = -(-n * 128 // 1024) * 1024 if layout == "cm40" else BOX
    stage = (0 if gen else 2 * BOX) + (2 if layout == "tm128" else 1) * v_box
    return _tile_plan(P_TABLE if gen else 0, stage, n, keys=PV_KEYS)


# ---- H: the row kernel's plan ----------------------------------------------

ROW_WARPS = 8        # warps an H block at most
ROW_RUN = 8          # consecutive rows an H block takes at most
SMEM_MAX = 232448    # shared memory one block may take on the H100
GEN_TABLE = 512      # H's table of generated P pairs (123 of 4 bytes)


def _softmax_smem(gen: bool, stages: int, skv: int) -> int:
    """H's shared memory (`softmax_bytes` in attn_parts.cu): `stages` rows
    of Skv bf16, then generated P's pair table or input P's full and empty
    mbarriers of each row buffer."""
    return 2 * stages * skv + (GEN_TABLE if gen else 16 * stages)


def _softmax_plan(cells: int, blk: int, skv: int, gen: bool) -> dict:
    """Launch plan of H's kernel for `cells` cells of `blk` rows of Skv
    columns, P generated (`gen`) or an input: the cells split into
    `groups` (grid y) of `cells_per_block` <= 8, as even as they go, a warp
    each; a block takes `rows` consecutive rows through `stages` row
    buffers (2, or 1 where two rows do not fit); `grid` (x, y) for each
    batch row; the block's `threads` and shared memory (`smem`). `max_skv`
    is the longest row the kernel takes: one row buffer in SMEM_MAX.
    Raises ValueError beyond it."""
    if cells < 1 or blk < 1 or skv < GROUP or skv % GROUP:
        raise ValueError(f"attn_softmax: cells {cells}, blk {blk}, Skv {skv}")
    max_skv = (SMEM_MAX - _softmax_smem(gen, 1, 0)) // 2 // GROUP * GROUP
    if skv > max_skv:
        raise ValueError(f"attn_softmax: a row of Skv {skv} does not fit "
                         f"the kernel's shared memory (Skv <= {max_skv})")
    groups = -(-cells // ROW_WARPS)
    cpb = -(-cells // groups)
    stages = 2 if _softmax_smem(gen, 2, skv) <= SMEM_MAX else 1
    rows = min(ROW_RUN, blk)
    return dict(groups=groups, cells_per_block=cpb, rows=rows, stages=stages,
                grid=(-(-blk // rows), groups), threads=32 * cpb,
                smem=_softmax_smem(gen, stages, skv), max_skv=max_skv)


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
                         "aligned q, k, v (TMA)")
    if bsz > 65535:
        raise ValueError(f"smallk_attention: batch {bsz} past the grid's "
                         f"65535")
    plan = _plan(channel_major, dk, split, dscore)
    out = torch.empty_like(q)
    code = _build.library().lib.rcdms_smallk_attention(
        int(channel_major), NORMS[norm], split, int(dscore), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, sq, skv, width, dk,
        float(scale), plan["dp"], plan["nv"], plan["bn"], plan["stages"],
        plan["smem"], _build.stream(q))
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
    if any(t.data_ptr() % 16 for t in (q, k)):
        raise ValueError("attn_scores: the kernel takes 16-byte aligned q, "
                         "k (TMA)")
    plan = _scores_plan(channel_major, d)
    out = torch.empty(q.shape[0], sq, GROUP, device=q.device,
                      dtype=torch.float32)
    code = _build.library().lib.rcdms_attn_scores(
        int(channel_major), plan["kp"], plan["stages"], plan["smem"],
        q.data_ptr(), k.data_ptr(), out.data_ptr(), q.shape[0], sq,
        k.shape[2 if channel_major else 1], d, _build.stream(q))
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
    layout = "cm40" if channel_major else ("tm128" if width == GROUP
                                           else "tm40")
    if blk % 128 or skv % 64 or (layout != "tm128" and (width > 48
                                                        or width % 8)):
        raise ValueError(f"attn_pv: the kernel takes blk a multiple of 128, "
                         f"Skv of 64 and v of width 128 or <= 48 (a multiple "
                         f"of 8); got v {tuple(v.shape)}, blk {blk}")
    if any(t.data_ptr() % 16 for t in (v, p) if t is not None):
        raise ValueError("attn_pv: the kernel takes 16-byte aligned v, p "
                         "(TMA)")
    plan = _pv_plan(layout, width, p is None)
    out = torch.empty(v.shape[0], cells * blk, GROUP, device=v.device,
                      dtype=torch.float32)
    code = _build.library().lib.rcdms_attn_pv(
        PV_LAYOUTS[layout], plan["n"], plan["stages"], plan["smem"],
        None if seeds is None else seeds.data_ptr(),
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
    if p is not None and p.data_ptr() % 16:
        raise ValueError("attn_softmax: the kernel takes a 16-byte aligned p "
                         "(TMA bulk copies)")
    if batch > 65535:
        raise ValueError(f"attn_softmax: batch {batch} past the grid's 65535")
    plan = _softmax_plan(cells, blk, skv, p is None)
    out = torch.empty(batch, cells * blk, GROUP, device=src.device,
                      dtype=torch.float32)
    code = _build.library().lib.rcdms_attn_softmax(
        SOFTMAX_OPS[op], plan["cells_per_block"], plan["rows"],
        plan["stages"], plan["smem"],
        None if seeds is None else seeds.data_ptr(),
        None if p is None else p.data_ptr(), out.data_ptr(), batch, cells,
        skv, blk, float(scale), _build.stream(src))
    _build.check(code, "rcdms_attn_softmax")
    attn_softmax.launches += 1
    return out


smallk_attention.launches = 0
attn_scores.launches = 0
attn_pv.launches = 0
attn_softmax.launches = 0
