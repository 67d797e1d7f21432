"""The launch plans of the port's redesigned bf16 kernels, on the CPU.

`rcdms_tpu_torch/ops/flash.py::_plan` (kernel A, TMA + `wgmma` attention),
`rcdms_tpu_torch/ops/geglu.py::_plan` (kernels C and D, two TMA + `wgmma`
GEMM passes), `rcdms_tpu_torch/ops/smallk.py::_plan` (kernel E, the
studies' whole attention block on `mma.sync`) and
`rcdms_tpu_torch/ops/cm_conv.py::_plan` (the bf16 3x3 conv, an implicit
GEMM on TMA + `wgmma`) and `rcdms_tpu_torch/ops/frame_attention.py::_plan`
(kernel B's tiled bf16 kernel: TMA bulk copies, one thread a (token, head,
frame) and channel slice) and `rcdms_tpu_torch/ops/group_norm.py::_plan`
(the fused GroupNorm + SiLU over a thread block cluster, bf16 and fp32)
and `smallk._scores_plan` / `smallk._pv_plan` (the studies' kernels F and
G: TMA + `wgmma` tile kernels, with a numpy model of G's generated P)
and `smallk._softmax_plan` (kernel H: rows of P shared by the warps of a
block's cells, with numpy models of its generated row and of its pair
max and FFMA argument) are pure Python: they choose the tile shapes and
compute the shared memory that the CUDA kernels lay out (the kernels refuse
a plan whose bytes differ from their own). Here every shape of the story's
main path and the study shapes (those `chip_smoke.py` and the card tests
hold the kernels to) must fit one block's 232,448 bytes of shared memory on
the H100, the padded widths must be the designs', and shapes the kernels do
not take must raise."""

import collections
import importlib

import numpy as np
import pytest
import torch

from rcdms_tpu_torch.ops import cm_conv, flash, geglu, smallk
from rcdms_tpu_torch.tools import cm_conv_study, gn_fused_study

# the module, which `rcdms_tpu_torch.ops` shadows with its wrapper
frame_attention_ops = importlib.import_module(
    "rcdms_tpu_torch.ops.frame_attention")
group_norm_ops = importlib.import_module("rcdms_tpu_torch.ops.group_norm")

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100

# kernel A: (label, dh) of every attention site of a story: UNet self and
# cross attention at levels 0-2 (the cross sites share their level's dh),
# CLIP vision attention
ATTENTION_SITES = [("unet level 0", 40), ("unet level 1", 80),
                   ("unet level 2", 160), ("clip vision", 104)]
# kernels C and D: (rows, c, geglu) of every feed-forward of a story,
# inner = 4c: UNet levels 0-3 and the prior's temporal and spatial FFs
FF_SITES = [(20480, 320, True), (5120, 640, True), (1280, 1280, True),
            (320, 1280, True), (970, 2048, True), (970, 2048, False)]


# registers a consumer thread keeps for addresses, loop state and the row
# statistics, beside the accumulators and P's fragments
ATTENTION_SPARE_REGS = 32


def _attention_layout_bytes(plan):
    """The kernel's shared memory from the plan's tiles: 1024 bytes to
    align, Q (128 rows), the tile of ones, the ring (K and V tiles of bn
    rows a stage), the full and empty mbarriers of each stage and Q's; rows
    of `boxes` 128-byte swizzled boxes."""
    row = plan["boxes"] * 2 * flash.BOX_COLUMNS
    stages = plan["stages"]
    return (1024 + plan["bq"] * row + flash.ONES_BYTES
            + stages * 2 * plan["bn"] * row + 8 * (2 * stages + 1))


@pytest.mark.parametrize("label,dh", ATTENTION_SITES)
def test_attention_plan_fits_and_pads(label, dh):
    row_sum = "fp32" if label == "clip vision" else "rounded"
    plan = flash._plan(dh, row_sum)
    assert plan["row_sum"] == int(row_sum == "rounded")
    assert plan["smem"] <= SMEM_LIMIT, label
    assert plan["dp"] % 16 == 0 and dh <= plan["dp"] < dh + 16
    assert dh <= plan["nv"] <= plan["dp"] and plan["nv"] % 8 == 0
    assert plan["bn"] == flash.KEY_TILES[plan["dp"]]
    assert plan["boxes"] * flash.BOX_COLUMNS >= plan["dp"] \
        > (plan["boxes"] - 1) * flash.BOX_COLUMNS
    # two consumer warpgroups of 64 rows and a producer warpgroup, in
    # clusters of two blocks that each load half of a K/V tile
    assert plan["bq"] == 128 and plan["threads"] == 3 * 128
    assert plan["cluster"] == 2 and plan["bn"] % (8 * plan["cluster"]) == 0
    assert 2 <= plan["stages"] <= flash.MAX_STAGES
    assert plan["smem"] == _attention_layout_bytes(plan)
    # the deepest ring that fits
    deeper = dict(plan, stages=plan["stages"] + 1)
    assert plan["stages"] == flash.MAX_STAGES \
        or _attention_layout_bytes(deeper) > SMEM_LIMIT


@pytest.mark.parametrize("dh,dp,nv", [(40, 48, 40), (104, 112, 112),
                                      (80, 80, 80), (160, 160, 160),
                                      (8, 48, 40), (256, 256, 256)])
def test_attention_plan_padded_widths(dh, dp, nv):
    plan = flash._plan(dh, "rounded")
    assert (plan["dp"], plan["nv"]) == (dp, nv)


@pytest.mark.parametrize("dh", [0, 20, 44, 260, 264])
def test_attention_plan_refuses(dh):
    with pytest.raises(ValueError):
        flash._plan(dh, "rounded")


def test_attention_plan_carries_the_row_sum_family():
    """The kernel's template parameter: 1 sums l from the rounded P
    (`_nt_kernel`), 0 from the fp32 P (`_attn_kernel`); the tiles and
    shared memory do not depend on it."""
    rounded, fp32 = flash._plan(40, "rounded"), flash._plan(40, "fp32")
    assert (rounded.pop("row_sum"), fp32.pop("row_sum")) == (1, 0)
    assert rounded == fp32
    with pytest.raises(ValueError):
        flash._plan(40, "bf16")


def test_attention_plan_every_supported_width_fits():
    """Every dh the kernel takes: shared memory, wgmma's shapes (m64 a
    consumer warpgroup; the score product n = bn, P V n = nv, each a
    multiple of 8 up to 256; k16 steps over dp and over bn), TMA's boxes
    (64 columns x 1 head x rows x 1 batch, a K/V box half a tile's rows:
    128 bytes inner, every dimension at most 256, global strides
    multiples of 16 bytes at the story's head counts) and a consumer
    thread's registers (two banks of score accumulators, P's fragments,
    the output accumulators)."""
    for dh in range(8, flash.MAX_HEAD_DIM + 1, 8):
        plan = flash._plan(dh, "rounded")
        dp, nv, bn = plan["dp"], plan["nv"], plan["bn"]
        assert plan["smem"] <= SMEM_LIMIT, dh
        assert plan["smem"] == _attention_layout_bytes(plan), dh
        assert plan["bq"] == 2 * 64
        for n in (bn, nv):
            assert n % 8 == 0 and 8 <= n <= 256, (dh, n)
        assert dp % 16 == 0 and bn % 16 == 0 and dh <= nv <= dp
        inner = 2 * flash.BOX_COLUMNS
        assert inner % 16 == 0 and inner <= 128  # the swizzle's span
        for box in ((flash.BOX_COLUMNS, 1, 64, 1),
                    (flash.BOX_COLUMNS, 1, bn // plan["cluster"], 1)):
            assert all(1 <= d <= 256 for d in box), (dh, box)
        for heads in (1, 8, 16):
            for s in (1, 91, 257, 4096):
                strides = (2 * dh, 2 * heads * dh, 2 * s * heads * dh)
                assert all(x % 16 == 0 for x in strides), (dh, heads, s)
        regs = 2 * (bn // 2) + bn // 4 + nv // 2
        assert regs + ATTENTION_SPARE_REGS <= flash.CONSUMER_REGS, (dh, regs)


@pytest.mark.parametrize("rows,c,geglu_", FF_SITES)
def test_ff_plan_fits(rows, c, geglu_):
    inner = 4 * c
    plan = geglu._plan(rows, c, inner, geglu_)
    assert plan["intermediate"] == (rows, inner)
    for name, n in (("pass1", inner), ("pass2", c)):
        p = plan[name]
        assert p["smem"] <= SMEM_LIMIT, (name, p)
        assert p["bm"] == 128 and p["bn"] % 8 == 0 and p["bn"] <= 256
        assert p["bn"] in geglu.TILE_WIDTHS[p["mode"]]
        assert p["grid"] == (-(-n // p["bn"]), -(-rows // 128))
        nw = 2 if p["mode"] == "geglu" else 1
        stage = 128 * 64 * 2 + nw * p["bn"] * 64 * 2
        assert p["smem"] == p["stages"] * stage + 2 * p["stages"] * 8 + 1024
    assert plan["pass1"]["mode"] == ("geglu" if geglu_ else "gelu")
    assert plan["pass2"]["mode"] == "bias"


def test_ff_plan_tiles_of_the_story():
    """The column tiles chosen at the story's heaviest shapes: level 0's
    pass 2 splits c = 320 into two 160-wide tiles, not 256 + a mostly
    empty one."""
    plan = geglu._plan(20480, 320, 1280, True)
    assert plan["pass1"]["bn"] == 128 and plan["pass2"]["bn"] == 160
    plan = geglu._plan(970, 2048, 8192, False)
    assert plan["pass1"]["bn"] == 256 and plan["pass2"]["bn"] == 128


@pytest.mark.parametrize("rows,c,inner", [(70, 100, 400), (70, 320, 1284),
                                          (0, 320, 1280), (70, 0, 1280)])
def test_ff_plan_refuses(rows, c, inner):
    with pytest.raises(ValueError):
        geglu._plan(rows, c, inner, True)


# kernel E: (channel_major, dk, split, dscore, smem bytes) of every row of
# the attention studies at dh 40, and the widest dk of each layout. Bytes:
# token-major Q (128 rows) and two stages of K (64 rows) of dp + 8 bf16,
# two stages of V (64 rows of 136); channel-major Q (dp rows of 136 bf16)
# and two stages of K and V (dp rows of 72), dscore 512 more for its 128
# fp32 row maxima.
SMALLK_PLANS = [
    (False, 128, 1, False, 104448), (False, 40, 1, False, 63488),
    (False, 48, 1, False, 63488), (True, 40, 1, False, 40704),
    (True, 40, 2, False, 40704), (True, 40, 4, False, 40704),
    (True, 40, 1, True, 41216), (True, 48, 1, True, 41216)]


@pytest.mark.parametrize("cm,dk,split,dscore,smem", SMALLK_PLANS)
def test_smallk_plan(cm, dk, split, dscore, smem):
    plan = smallk._plan(cm, dk, split, dscore)
    assert plan["smem"] == smem <= SMEM_LIMIT
    assert plan["bq"] == 128 and plan["kv_tile"] == 64
    assert plan["dp"] == (48 if dk <= 48 else 128)
    assert plan["rows_per_warp"] == 16 * split
    assert plan["threads"] * plan["rows_per_warp"] == 32 * plan["bq"]
    if cm:  # the output's n8 tiles cover dk inside the padded width
        assert dk <= 8 * plan["n_tiles"] <= plan["dp"]
        assert plan["n_tiles"] == (5 if dk <= 40 else 6)
    else:   # V and o are 128 wide
        assert plan["n_tiles"] == 16


@pytest.mark.parametrize("cm,dk", [(True, 0), (True, 44), (True, 56),
                                   (False, 44), (False, 136)])
def test_smallk_plan_refuses(cm, dk):
    with pytest.raises(ValueError):
        smallk._plan(cm, dk, 1, False)


# the bf16 conv: (B, C, Cout, T, wp) of the study (5 frames of 64 x 64
# padded to 4608 tokens, 320 -> 320) and of the card tests' tensor-core
# cases (a partial channel chunk, a Cout tile cut short, a token tile past
# the frame)
CONV_SHAPES = [(5, 320, 320, 4608, 66), (2, 24, 40, 200, 15),
               (1, 100, 360, 512, 20)]


@pytest.mark.parametrize("b,c,cout,t,wp", CONV_SHAPES)
def test_conv_plan_fits_and_covers(b, c, cout, t, wp):
    plan = cm_conv._plan(b, c, cout, t, wp)
    assert plan["smem"] <= SMEM_LIMIT
    assert 1 <= plan["mt"] <= cm_conv.MAX_MT and plan["bm"] == 64 * plan["mt"]
    stage = (plan["mt"] * 64 + 2 * 48) * 64 * 2  # mt w9 boxes, two xt boxes
    assert plan["smem"] == plan["stages"] * stage + 16 * plan["stages"] + 1024
    # the accumulators fit the register budget the plan states, with room
    # for the addresses, descriptors and epilogue
    assert plan["threads"] == 384 and plan["reg_budget"] == 232
    assert (128 * cm_conv.PRODUCER_REGS + 256 * plan["reg_budget"]
            <= cm_conv.REGISTERS)
    assert plan["acc_regs"] == 24 * plan["mt"] <= plan["reg_budget"] - 48
    # the tiles cover Cout and T, with less than one tile to spare
    gx, gy, gz = plan["grid"]
    assert gz == b
    assert gx * plan["bn"] >= t > (gx - 1) * plan["bn"]
    assert gy * plan["bm"] >= cout > gy * plan["bm"] - 64
    assert plan["k_stages"] == 9 * -(-c // 64)
    # the token-major copy of x: guard rows reach the most negative tap
    _, rows, cp = plan["scratch"]
    assert rows == t + wp + 1 and cp % 8 == 0 and c <= cp < c + 8
    assert min(cm_conv.tap_offsets(wp)) + (rows - t) >= 0


def test_conv_plan_study_shape():
    """All 320 output channels in one block (five m64 tiles, 120
    accumulators a thread), 48 token tiles of 96 a frame, of which 45 hold
    a live mask value: 225 blocks compute (two waves of 132 SMs) and 15
    write zeros."""
    plan = cm_conv._plan(cm_conv_study.B, cm_conv_study.C,
                         cm_conv_study.COUT, cm_conv_study.TPAD,
                         cm_conv_study.WP)
    assert plan["mt"] == 5 and plan["acc_regs"] == 120
    assert plan["grid"] == (48, 1, 5) and plan["k_stages"] == 45
    assert plan["smem"] == 214080
    # the blocks whose 96 tokens hold a nonzero mask value compute
    live = cm_conv_study.interior_mask_pad().reshape(-1, plan["bn"]) != 0
    assert int(live.any(dim=1).sum()) == 45


@pytest.mark.parametrize("b,c,cout,t,wp", [
    (1, 16, 40, 61, 7), (1, 16, 36, 64, 7), (0, 16, 40, 64, 7),
    (1, 0, 40, 64, 7), (1, 16, 0, 64, 7), (1, 16, 40, 64, 0)])
def test_conv_plan_refuses(b, c, cout, t, wp):
    with pytest.raises(ValueError):
        cm_conv._plan(b, c, cout, t, wp)


# kernel B: (b, f, n, c) of every temporal-attention site of a story, 8
# heads: UNet levels 0-3 and the prior (CFG batch 2, 97 tokens, dh 256)
FRAME_SITES = [(1, 5, 4096, 320), (1, 5, 1024, 640), (1, 5, 256, 1280),
               (1, 5, 64, 1280), (2, 5, 97, 2048)]


def _frame_layout_bytes(f, dh, tokens, group, split):
    """The tiled kernel's shared memory (csrc/frame_attention.cu
    TiledLayout): two stages of 3 f frame slots, each the tile's rows
    rounded up to 128 bytes plus 16 x split mod 128; the split threads'
    fp32 partial scores; two mbarriers."""
    threads = tokens * group * f * split
    slot = -(-tokens * group * dh * 2 // 128) * 128 + 16 * split % 128
    partials = threads * f * 4 if split > 1 else 0
    return 2 * 3 * f * slot + partials + 16


@pytest.mark.parametrize("f", range(1, frame_attention_ops.MAX_FRAMES + 1))
@pytest.mark.parametrize("b,f5,n,c", FRAME_SITES)
def test_frame_plan_fits(b, f5, n, c, f):
    plan = frame_attention_ops._plan(b, f, n, c, 8)
    dh = c // 8
    tokens, group, split = plan["tokens"], plan["group"], plan["split"]
    assert plan["smem"] == _frame_layout_bytes(f, dh, tokens, group, split)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["threads"] == tokens * group * f * split
    assert plan["threads"] <= frame_attention_ops.MAX_THREADS
    # a stage's q, k, v fit, and each thread takes at most 5 chunks
    assert 3 * f * tokens * group * dh * 2 <= frame_attention_ops.STAGE_MAX
    assert -(-dh // 8 // split) <= frame_attention_ops.MAX_CHUNKS
    assert split == 1 or -(-dh // 8 // (split // 2)) > 5
    assert tokens == 1 or group == 8  # token rows are whole but for one
    assert 8 % group == 0
    assert plan["tiles"] == b * -(-n // tokens) * (8 // group)
    assert plan["grid"] == min(plan["tiles"], 132 * plan["blocks_per_sm"])
    # the blocks that share an SM fit its shared memory
    assert plan["blocks_per_sm"] * (plan["smem"] + 1024) <= 233472


def test_frame_plan_story_shapes():
    """Level 0 in tiles of 4 token rows (2 blocks an SM walk 1024 tiles),
    level 1 of 2; levels 2 and 3 and the prior split each token's heads
    so that every SM gets two tiles: 512, 512 and 388 blocks, not 256, 64
    and 194."""
    plans = [frame_attention_ops._plan(*site, 8) for site in FRAME_SITES]
    assert [(p["tokens"], p["group"], p["split"]) for p in plans] == [
        (4, 8, 1), (2, 8, 2), (1, 4, 4), (1, 1, 4), (1, 4, 8)]
    assert [p["threads"] for p in plans] == [160, 160, 80, 20, 160]
    assert [p["grid"] for p in plans] == [264, 264, 512, 512, 388]
    assert [p["tiles"] for p in plans] == [1024, 512, 512, 512, 388]
    assert all(p["tiles"] >= 2 * 132 for p in plans)


@pytest.mark.parametrize("b,f,n,c,heads", [
    (1, 5, 64, 300, 8), (1, 0, 64, 320, 8), (1, 9, 64, 320, 8),
    (1, 5, 64, 320, 3), (1, 5, 0, 320, 8), (1, 5, 64, 520, 1)])
def test_frame_plan_refuses(b, f, n, c, heads):
    with pytest.raises(ValueError):
        frame_attention_ops._plan(b, f, n, c, heads)


def test_frame_plan_every_taken_width_fits():
    """Every head dim the tiled kernel takes, at 1 and 8 frames: a stage
    holds a (token, head) and the split threads of a head share a warp."""
    for dh in range(8, frame_attention_ops.MAX_TILED_DH + 1, 8):
        for f in (1, 8):
            plan = frame_attention_ops._plan(1, f, 97, 4 * dh, 4)
            assert plan["split"] <= 32 and 32 % plan["split"] == 0
            assert plan["smem"] <= SMEM_LIMIT, (dh, f)
            assert plan["threads"] <= frame_attention_ops.MAX_THREADS


# the serve path at --max-batch 4 with the CFG branches batched
# (`sequential_cfg=False`): 4 stories x 2 branches x 5 frames = 40 UNet
# frames, 8 prior rows of 5 frames, 20 CLIP images
SERVE_FRAMES = 40
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)
INT32_MAX = 2 ** 31 - 1


def _fits_grid(grid):
    grid = tuple(grid) + (1,) * (3 - len(tuple(grid)))
    return all(1 <= g <= lim for g, lim in zip(grid, GRID_LIMITS))


@pytest.mark.parametrize("batch,heads,sq,skv,dh", [
    (SERVE_FRAMES, 8, s, skv, dh)
    for s, dh in ((4096, 40), (1024, 80), (256, 160)) for skv in (s, 91)
] + [(20, 16, 257, 257, 104)])
def test_attention_plan_at_the_serve_shapes(batch, heads, sq, skv, dh):
    """Kernel A's grid (query blocks, batch x heads) and its operands'
    element counts stay within the grid limits and int32."""
    plan = flash._plan(dh, "rounded")
    assert plan["smem"] <= SMEM_LIMIT
    assert _fits_grid((-(-sq // plan["bq"]), batch * heads))
    assert batch * max(sq, skv) * heads * dh <= INT32_MAX


@pytest.mark.parametrize("b,f,n,c", [
    (8, 5, 4096, 320), (8, 5, 1024, 640), (8, 5, 256, 1280),
    (8, 5, 64, 1280), (8, 5, 97, 2048)])
def test_frame_plan_at_the_serve_shapes(b, f, n, c):
    plan = frame_attention_ops._plan(b, f, n, c, 8)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["tiles"] <= 2 ** 30  # the C entry point's own bound
    assert _fits_grid((plan["grid"],))
    assert b * f * n * c <= INT32_MAX


@pytest.mark.parametrize("rows,c,geglu_", [
    (SERVE_FRAMES * 4096, 320, True), (SERVE_FRAMES * 1024, 640, True),
    (SERVE_FRAMES * 256, 1280, True), (SERVE_FRAMES * 64, 1280, True),
    (8 * 5 * 97, 2048, True), (8 * 5 * 97, 2048, False)])
def test_ff_plan_at_the_serve_shapes(rows, c, geglu_):
    """Level 0's 163,840 rows: pass 1's 1280 row blocks fit grid.y, and
    the widest operand (rows x the GEGLU's 2 x inner) stays in int32."""
    inner = 4 * c
    plan = geglu._plan(rows, c, inner, geglu_)
    for name in ("pass1", "pass2"):
        assert plan[name]["smem"] <= SMEM_LIMIT
        assert _fits_grid(plan[name]["grid"]), (name, plan[name]["grid"])
    assert plan["pass1"]["grid"][1] == -(-rows // 128)
    assert rows * (2 if geglu_ else 1) * inner <= INT32_MAX


# the fused GroupNorm: every GroupNorm input of the story UNet, (frames,
# tokens, channels) at 512 px, statistics per frame, 32 groups: the
# ResNet blocks' norm1 (their input, skip concatenations included) and
# norm2, the spatial and temporal transformers' norms and conv_norm_out,
# at levels 0-3 (64 x 64 ... 8 x 8 latents), down, mid and up
STORY_GN = [(n, c) for n, cs in ((4096, (320, 640, 960)),
                                 (1024, (320, 640, 960, 1280, 1920)),
                                 (256, (640, 1280, 1920, 2560)),
                                 (64, (1280, 2560)))
            for c in cs]
GN_SHAPES = sorted({(5 * b, n, c) for b in (1, 2) for n, c in STORY_GN}
                   | set(gn_fused_study.SHAPES) | {(5, 4096, 960)})


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,n,c", GN_SHAPES)
def test_gn_plan_fits_and_covers(b, n, c, itemsize):
    groups = 32
    p = group_norm_ops._plan(b, n, c, groups, itemsize)
    sg, k, rows = p["slab_groups"], p["cluster"], p["rows"]
    assert groups % sg == 0                       # whole groups
    width = sg * c // groups
    assert p["width"] == width and p["row_bytes"] == width * itemsize
    assert p["row_bytes"] % 16 == 0               # 16-byte slab rows
    assert rows == -(-n // k)                     # k runs: every token
    assert k in group_norm_ops.CLUSTERS
    assert p["smem"] <= SMEM_LIMIT
    assert p["smem"] >= rows * p["row_bytes"] + 8 * (2 * sg + 8)
    vr = p["row_bytes"] // 16
    rl = p["threads"] // vr
    assert p["threads"] == vr * rl <= 512 and rl & (rl - 1) == 0 \
        and 2 * p["threads"] > 512
    assert p["ctas"] == b * groups // sg * k >= group_norm_ops.SMS


def test_gn_plan_takes_what_the_first_kernel_refused():
    """(5, 4096, 960), up level 0's first ResNet block: a 245,760-byte
    group slab, more than one block may hold."""
    assert 4096 * 30 * 2 > SMEM_LIMIT
    p = group_norm_ops._plan(5, 4096, 960, 32, 2)
    assert p["rows"] * p["row_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("b,n,c,groups,itemsize", [
    (1, 64, 36, 4, 2),        # rows of 72 bytes: not a multiple of 16
    (1, 64, 6, 2, 4),         # rows of 24 bytes
    (1, 64, 100, 32, 2),      # groups do not divide c
    (1, 1 << 20, 64, 2, 2),   # 1M tokens: no cluster holds a slab
    (0, 64, 64, 2, 2),
])
def test_gn_plan_refuses(b, n, c, groups, itemsize):
    with pytest.raises(ValueError):
        group_norm_ops._plan(b, n, c, groups, itemsize)


def test_gn_plan_edges():
    """Groups narrower than 16 bytes share a slab (6-byte groups, 8 of
    them); a ragged token count leaves the last CTA fewer (or no) rows;
    a token run that fits only in clusters of 16 takes them."""
    assert group_norm_ops._plan(1, 64, 96, 32, 2)["slab_groups"] % 8 == 0
    p = group_norm_ops._plan(2, 7, 64, 4, 2)
    assert p["cluster"] * p["rows"] >= 7
    p = group_norm_ops._plan(1, 16 * 3000, 64, 2, 2)  # 3000 rows at k 16
    assert p["cluster"] == 16 and p["smem"] <= SMEM_LIMIT


# kernels F and G (TMA + wgmma tile kernels, `smallk._scores_plan` and
# `_pv_plan`): every width the wrappers take, channel-major F dh 8-48 and
# token-major 128; G widths 8-48 in the dh-40 layouts and 128, over
# generated and input P
STAGING = {n: 8 * 16 * s * 4 for n, s in ((40, 40), (48, 56), (128, 136))}
SCORE_WIDTHS = [(True, dk) for dk in range(8, 49, 8)] + [(False, 128)]
PV_WIDTHS = [("tm128", 128)] + [(layout, w) for layout in ("tm40", "cm40")
                                for w in range(8, 49, 8)]


def _tile_plan_holds(p, fixed, stage):
    assert p["rows"] == 128 and p["warpgroups"] == 2
    assert p["threads"] == 32 * (4 * p["warpgroups"] + 1)  # + producer warp
    assert p["stage_bytes"] == stage and stage % 1024 == 0  # swizzled boxes
    assert fixed % 1024 == 0
    assert 2 <= p["stages"] <= 8 and p["stages"] * stage <= 96 * 1024
    assert p["smem"] == 1024 + max(fixed + p["stages"] * stage,
                                   STAGING[p["n"]]) + 8 * (2 * p["stages"]
                                                           + 1)
    assert p["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("cm,dk", SCORE_WIDTHS)
def test_scores_plan_fits_and_pads(cm, dk):
    p = smallk._scores_plan(cm, dk)
    assert p["n"] == 128                        # one m64n128 accumulator
    assert p["kp"] % 16 == 0 and dk <= p["kp"] < dk + 16  # k16 steps
    box = p["kp"] * 128 if cm else 128 * 128    # [kp d][64 j] / [128 j][64 d]
    _tile_plan_holds(p, 2 * (p["kp"] * 128 if cm else 2 * 64 * 128),
                     2 * box)


@pytest.mark.parametrize("cm,dk", [(True, 0), (True, 44), (True, 56),
                                   (False, 40), (False, 136)])
def test_scores_plan_refuses(cm, dk):
    with pytest.raises(ValueError):
        smallk._scores_plan(cm, dk)


@pytest.mark.parametrize("gen", [True, False], ids=["gen", "input"])
@pytest.mark.parametrize("layout,width", PV_WIDTHS)
def test_pv_plan_fits_and_pads(layout, width, gen):
    p = smallk._pv_plan(layout, width, gen)
    # wgmma's n: a multiple of 8; n40 for dh <= 40, n48 past it
    assert p["n"] == (128 if layout == "tm128" else 40 if width <= 40
                      else 48)
    assert p["n"] % 8 == 0 and width <= p["n"] <= 256
    assert p["keys"] == 64
    v_box = p["n"] * 128 if layout == "cm40" else 64 * 128
    stage = (0 if gen else 2 * 64 * 128) \
        + (2 if layout == "tm128" else 1) * v_box
    # generated P: a 1 KiB table of its products ahead of the ring
    _tile_plan_holds(p, 1024 if gen else 0, stage)


@pytest.mark.parametrize("layout,width", [("tm128", 40), ("tm40", 56),
                                          ("cm40", 44), ("cm40", 0),
                                          ("tm40", 128), ("cm", 40)])
def test_pv_plan_refuses(layout, width):
    with pytest.raises(ValueError):
        smallk._pv_plan(layout, width, True)


def test_tile_plans_at_the_study_variants():
    """The seven study variants: the dh-40 ones leave room for two blocks
    an SM (228 KiB, 1 KiB a block reserved); token-major F, with 32 KiB
    key groups, takes one."""
    plans = {"score_nt": smallk._scores_plan(True, 40),
             "score_base": smallk._scores_plan(False, 128),
             "pv_base": smallk._pv_plan("tm128", 128, True),
             "pv_narrow": smallk._pv_plan("tm40", 40, True),
             "pv_nt": smallk._pv_plan("cm40", 40, True),
             "pv_lanes": smallk._pv_plan("cm40", 40, False),
             "pv_std": smallk._pv_plan("tm128", 128, False)}
    for name, p in plans.items():
        blocks = 228 * 1024 // (p["smem"] + 1024)
        assert blocks >= (1 if name == "score_base" else 2), (name, p)
    assert plans["score_nt"]["kp"] == 48 and plans["pv_nt"]["n"] == 40


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, rounded to nearest even."""
    b = x.astype(np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _walked_p(rows: int, cols: int, seed_bits: int) -> np.ndarray:
    """G's generated P as `attn_pv_kernel` builds it: a table of 173 bf16
    pairs (x mod 117, x + 1 mod 117) times the seed, one rounding each; the
    fragment registers of row r, columns c0, c0 + 1 of k16 step k of a
    64-column stage (c0 = 2t, t = lane % 4; and c0 + 8) read the pairs at
    x + 16 k (and x + 16 k + 8), where x starts as (7 r + c0) mod 117 and
    walks 64 columns a stage: an add and a subtract of 117 where the sum
    reaches it."""
    seed = np.array([seed_bits << 16], np.uint32).view(np.float32)[0]
    k = np.arange(173)
    table = np.stack([_bf16_bits((k % 117).astype(np.float32) * seed),
                      _bf16_bits(((k + 1) % 117).astype(np.float32) * seed)],
                     axis=1)                         # (173, 2): low, high
    out = np.empty((rows, cols), np.uint16)
    for c0 in range(0, 8, 2):
        x = (7 * np.arange(rows) + c0) % 117
        for stage in range(cols // 64):
            for step in range(4):
                for dc in (0, 8):
                    c = 64 * stage + 16 * step + c0 + dc
                    out[:, c:c + 2] = table[x + 16 * step + dc]
            x = x + 64
            x = np.where(x >= 117, x - 117, x)
    return out


def test_generated_p_fragment_covers_each_k16_tile_once():
    """wgmma's RS A fragment as the kernel fills it (lane g = lane / 4,
    t = lane % 4 of warp w: a[0] row g, columns 2t, 2t+1; a[1] row g + 8;
    a[2] row g, columns 2t+8, 2t+9; a[3] row g + 8) covers each (row,
    column) of a warp's 16 x 16 tile once, so the walk above is the
    kernel's, one element at a time."""
    seen = collections.Counter()
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            for half in range(2):
                seen[(g + dr, 2 * t + dc + half)] += 1
    assert seen == {(r, c): 1 for r in range(16) for c in range(16)}


@pytest.mark.parametrize("seed", [0.5, -1.3046875, 3.7e-3, 96.0, -0.0])
def test_generated_p_walk_equals_gen_p(seed):
    """The walk, bit for bit, against `smallk.gen_p` over every (r, c) of
    a 512 x 4096 cell."""
    seeds = torch.full((1, 8, 128), seed, dtype=torch.bfloat16)
    ref = smallk.gen_p(seeds, 512, 4096)[0].view(torch.int16).numpy() \
        .view(np.uint16)
    bits = int(seeds[0, 0, 0].view(torch.int16).item()) & 0xFFFF
    np.testing.assert_array_equal(_walked_p(512, 4096, bits), ref)


# ---- H: the row kernel ------------------------------------------------------

# (cells, blk, Skv, gen): the studies' shape (generated and input P), one
# key group, an odd count of groups, long rows (16384)
SOFTMAX_SHAPES = [(8, 512, 4096, True), (8, 512, 4096, False),
                  (1, 512, 128, True), (3, 128, 128, False),
                  (1, 129, 640, False), (3, 512, 640, True),
                  (1, 512, 16384, True), (8, 512, 16384, False)]


@pytest.mark.parametrize("cells,blk,skv,gen", SOFTMAX_SHAPES)
def test_softmax_plan_fits(cells, blk, skv, gen):
    """H's plan fits one block's shared memory, a warp a cell of its
    group (at most 8), two row buffers, and runs of up to 8 rows (the
    studies' shape: 8 cells, 8 rows a block, 16 KB)."""
    p = smallk._softmax_plan(cells, blk, skv, gen)
    assert p["smem"] <= SMEM_LIMIT
    assert p["threads"] == 32 * p["cells_per_block"] <= 256
    assert p["smem"] == smallk._softmax_smem(gen, p["stages"], skv)
    assert p["cells_per_block"] * p["groups"] >= cells
    assert p["stages"] == 2 and p["rows"] == min(8, blk)
    if (cells, skv) == (8, 4096):
        assert (p["rows"], p["threads"]) == (8, 256)
        assert p["smem"] == 2 * 2 * 4096 + (512 if gen else 32)


@pytest.mark.parametrize("gen", [True, False], ids=["gen", "input"])
def test_softmax_plan_refuses_a_row_that_does_not_fit(gen):
    """The longest row H takes is one buffer in 232,448 bytes; one key
    group more raises, and a row that fits once but not twice takes one
    stage."""
    top = smallk._softmax_plan(1, 16, 128, gen)["max_skv"]
    assert smallk._softmax_smem(gen, 1, top) <= SMEM_LIMIT
    assert smallk._softmax_smem(gen, 1, top + 128) > SMEM_LIMIT
    p = smallk._softmax_plan(1, 16, top, gen)
    assert p["stages"] == 1 and p["smem"] <= SMEM_LIMIT
    with pytest.raises(ValueError):
        smallk._softmax_plan(1, 16, top + 128, gen)
    for bad in ((0, 16, 128), (1, 0, 128), (1, 16, 100), (1, 16, 0)):
        with pytest.raises(ValueError):
            smallk._softmax_plan(*bad, gen)


def _softmax_warps(plan: dict, batch: int, cells: int, blk: int):
    """The (batch, cell, row) of every warp that computes one, as
    `attn_softmax_kernel` maps its grid: warp w of block (x, y, z) is
    cell y * cpb + w of batch row z, and takes rows x * rows ... (none
    past blk)."""
    cpb, rows = plan["cells_per_block"], plan["rows"]
    gx, gy = plan["grid"]
    seen = collections.Counter()
    for z in range(batch):
        for y in range(gy):
            for x in range(gx):
                for w in range(plan["threads"] // 32):
                    cell, first = y * cpb + w, x * rows
                    if cell >= cells:
                        continue
                    for r in range(first, min(first + rows, blk)):
                        seen[(z, cell, r)] += 1
    return seen


@pytest.mark.parametrize("cells", [1, 3, 8, 9])
@pytest.mark.parametrize("blk", [512, 129])
def test_softmax_grid_gives_each_row_its_own_warp(cells, blk):
    """Every (batch, cell, row) is computed, by exactly one warp: no cell
    shares another's result, whatever the count of cells or rows."""
    plan = smallk._softmax_plan(cells, blk, 4096, False)
    seen = _softmax_warps(plan, 2, cells, blk)
    assert seen == {(z, c, r): 1 for z in range(2) for c in range(cells)
                    for r in range(blk)}


def _lane_sums(values: np.ndarray) -> np.ndarray:
    """H's lane layout over one row (Skv values): lane l reads 16-byte
    chunk 32 k + l of pair k (columns 256 k + 8 l ... + 7: group 2 k for
    lanes 0-15, 2 k + 1 for lanes 16-31) and chunk 32 pairs + l of an odd
    last group (lanes 0-15), adding column i of each chunk into its sum i;
    lanes l and l + 16 add their 8 sums (shuffle xor 16); lane l writes
    float4 2 (l % 16) + l // 16 of the 128 outputs: sums 0-3 (l < 16) or
    4-7."""
    chunks = values.reshape(-1, 8)
    groups = len(values) // 128
    pairs, odd = groups // 2, groups % 2
    acc = np.zeros((32, 8))
    for lane in range(32):
        for k in range(pairs):
            acc[lane] += chunks[32 * k + lane]
        if odd and lane < 16:
            acc[lane] += chunks[32 * pairs + lane]
    acc = acc + acc[np.arange(32) ^ 16]
    out = np.full(128, np.nan)
    for lane in range(32):
        at = 2 * (lane % 16) + lane // 16
        out[4 * at:4 * at + 4] = acc[lane, 4 * (lane // 16):][:4]
    return out


@pytest.mark.parametrize("skv", [128, 256, 640, 4096])
def test_softmax_lanes_write_each_column_sum_once(skv):
    """The lanes' reads, their half-warp combine and their float4 stores
    give every one of the 128 outputs the sum of its column over all key
    groups."""
    values = np.random.default_rng(skv).normal(size=skv)
    np.testing.assert_allclose(_lane_sums(values),
                               values.reshape(-1, 128).sum(0), rtol=1e-12)


def _generated_rows(seed_bits: int, first: int, n: int, skv: int,
                    threads: int) -> np.ndarray:
    """Rows first ... first + n - 1 of generated P as a block of `threads`
    threads writes them: a table of 123 bf16 pairs (k mod 117, k + 1 mod
    117) times the seed; thread tid's chunks j = tid, tid + threads, ...
    (columns 8 j ... + 7) hold the pairs at x, x + 2, x + 4, x + 6, where
    x starts at (7 first + 8 tid) mod 117, walks 8 threads mod 117 a chunk
    and 7 a row, each with a conditional subtract of 117."""
    seed = np.array([seed_bits << 16], np.uint32).view(np.float32)[0]
    k = np.arange(123)
    table = np.stack([_bf16_bits((k % 117).astype(np.float32) * seed),
                      _bf16_bits(((k + 1) % 117).astype(np.float32) * seed)],
                     axis=1)
    chunks, step = skv // 8, 8 * threads % 117
    tid = np.arange(threads)
    xr = (7 * first + 8 * tid) % 117
    out = np.zeros((n, skv), np.uint16)
    for i in range(n):
        x = xr.copy()
        for j0 in range(0, chunks, threads):
            j, xs = j0 + tid, x
            keep = j < chunks
            for q in range(4):
                out[i, 8 * j[keep] + 2 * q] = table[xs[keep] + 2 * q, 0]
                out[i, 8 * j[keep] + 2 * q + 1] = table[xs[keep] + 2 * q, 1]
            x = x + step
            x = np.where(x >= 117, x - 117, x)
        xr = xr + 7
        xr = np.where(xr >= 117, xr - 117, xr)
    return out


@pytest.mark.parametrize("cells", [8, 3])
@pytest.mark.parametrize("seed", [0.5, -1.3046875, 96.0])
def test_softmax_generated_row_equals_gen_p(seed, cells):
    """H's table-and-walk rows, block by block as its plan cuts a 512 x
    4096 cell, bit for bit against `smallk.gen_p`."""
    seeds = torch.full((1, 8, 128), seed, dtype=torch.bfloat16)
    ref = smallk.gen_p(seeds, 512, 4096)[0].view(torch.int16).numpy() \
        .view(np.uint16)
    bits = int(seeds[0, 0, 0].view(torch.int16).item()) & 0xFFFF
    plan = smallk._softmax_plan(cells, 512, 4096, True)
    threads, span = 32 * plan["cells_per_block"], plan["rows"]
    for first in range(0, 512, span):
        n = min(span, 512 - first)
        np.testing.assert_array_equal(
            _generated_rows(bits, first, n, 4096, threads),
            ref[first:first + n])


def _softmax_model(bits: np.ndarray, scale: float, op: str) -> np.ndarray:
    """H's arithmetic on rows of bf16 bits: the row's max (min for a
    negative scale) of the bf16 values, m; e = 2^fma(x, a, -(m a)), a =
    scale * log2 e in fp32, the fma rounded once; the 128 column sums of e
    over the key groups, then over l, their sum. op "sum": the column sums
    of x."""
    x = (bits.astype(np.uint32) << 16).view(np.float32)
    if op == "sum":
        return x.reshape(len(x), -1, 128).sum(1, dtype=np.float32)
    m = x.min(1) if scale < 0 else x.max(1)
    if scale != 0:  # the bf16 extreme, scaled, is the scaled row's max
        np.testing.assert_array_equal(
            m * np.float32(scale), (x * np.float32(scale)).max(1))
    a = np.float32(scale) * np.float32(smallk.LOG2E)
    mb = -(m * a)
    arg = (x.astype(np.float64) * np.float64(a)
           + mb[:, None].astype(np.float64)).astype(np.float32)
    e = np.exp2(arg.astype(np.float64)).astype(np.float32)
    acc = e.reshape(len(e), -1, 128).sum(1, dtype=np.float32)
    return acc * (np.float32(1) / acc.sum(1, keepdims=True))


@pytest.mark.parametrize("op", ["exp", "exp2", "sum"])
@pytest.mark.parametrize("scale", [1000.0, 100.0, 1.0, -0.5, -100.0, 0.0])
@pytest.mark.parametrize("gen", [True, False], ids=["gen", "input"])
def test_softmax_model_matches_plain(scale, op, gen):
    """The kernel's pair max and FFMA argument, in numpy, within 1e-4 of
    `attn_softmax_plain` (max |diff| / max |plain|), for generated P and
    for an input P (uniform in [0, 0.001) at scale 1000, as the study's,
    else normal), at an odd count of key groups; at scale +-100 a row's
    scaled values span past 88, where e needs the row's extreme."""
    rng = np.random.default_rng(int(abs(scale)) + 3 * gen)
    skv, cells = 640, 2
    if gen:
        seeds = torch.from_numpy(rng.normal(size=(2, 8, 128)).astype(
            np.float32)).bfloat16()
        kw, p = dict(seeds=seeds, skv=skv), smallk.gen_p(seeds, 512, skv)
    else:
        x = rng.uniform(0, 1e-3, (2, 64, skv)) if scale == 1000.0 else \
            rng.normal(size=(2, 64, skv))
        p = torch.from_numpy(x.astype(np.float32)).bfloat16()
        kw = dict(p=p)
    ref = smallk.attn_softmax_plain(op=op, scale=scale, cells=cells, **kw)
    blk = p.shape[1]
    for b in range(2):
        bits = p[b].view(torch.int16).numpy().view(np.uint16)
        got = _softmax_model(bits, scale, op)
        for c in range(cells):
            want = ref[b, c * blk:(c + 1) * blk].numpy()
            rel = np.abs(got - want).max() / np.abs(want).max()
            assert rel <= 1e-4, (b, c, rel)
