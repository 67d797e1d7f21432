"""The launch plans of the port's redesigned bf16 kernels, on the CPU.

`rcdms_tpu_torch/ops/flash.py::_plan` (kernel A, `mma.sync` attention),
`rcdms_tpu_torch/ops/geglu.py::_plan` (kernels C and D, two TMA + `wgmma`
GEMM passes), `rcdms_tpu_torch/ops/smallk.py::_plan` (kernel E, the
studies' whole attention block on `mma.sync`) and
`rcdms_tpu_torch/ops/cm_conv.py::_plan` (the bf16 3x3 conv, an implicit
GEMM on TMA + `wgmma`) and `rcdms_tpu_torch/ops/frame_attention.py::_plan`
(kernel B's tiled bf16 kernel: TMA bulk copies, one thread a (token, head,
frame) and channel slice) and `rcdms_tpu_torch/ops/group_norm.py::_plan`
(the fused GroupNorm + SiLU over a thread block cluster, bf16 and fp32)
are pure Python: they choose the tile shapes and
compute the shared memory that the CUDA kernels lay out (the kernels refuse
a plan whose bytes differ from their own). Here every shape of the story's
main path and the study shapes (those `chip_smoke.py` and the card tests
hold the kernels to) must fit one block's 232,448 bytes of shared memory on
the H100, the padded widths must be the designs', and shapes the kernels do
not take must raise."""

import importlib

import pytest

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


@pytest.mark.parametrize("label,dh", ATTENTION_SITES)
def test_attention_plan_fits_and_pads(label, dh):
    row_sum = "fp32" if label == "clip vision" else "rounded"
    plan = flash._plan(dh, row_sum)
    assert plan["row_sum"] == int(row_sum == "rounded")
    assert plan["smem"] <= SMEM_LIMIT, label
    assert plan["dp"] % 16 == 0 and dh <= plan["dp"] < dh + 16
    assert plan["n_tiles"] * 8 == dh  # the output side is not padded
    assert plan["n_tiles"] in flash.OUTPUT_TILES[plan["dp"]]
    assert plan["bq"] == (128 if plan["dp"] <= 128 else 64)
    assert plan["rows_per_warp"] == (32 if plan["dp"] <= 64 else 16)
    assert plan["threads"] * plan["rows_per_warp"] == 32 * plan["bq"]
    rows = plan["bq"] + 4 * flash.KV_TILE  # Q, then K and V, two stages
    assert plan["smem"] == rows * (plan["dp"] + 8) * 2


@pytest.mark.parametrize("dh,dp", [(40, 48), (104, 112), (80, 80),
                                   (160, 160), (8, 48), (256, 256)])
def test_attention_plan_padded_widths(dh, dp):
    assert flash._plan(dh, "rounded")["dp"] == dp


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
    for dh in range(8, flash.MAX_HEAD_DIM + 1, 8):
        plan = flash._plan(dh, "rounded")
        assert plan["dp"] in flash.OUTPUT_TILES
        assert dh <= 8 * plan["n_tiles"] <= plan["dp"]
        assert plan["smem"] <= SMEM_LIMIT, dh


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
