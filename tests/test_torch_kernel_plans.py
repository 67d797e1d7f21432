"""The launch plans of the port's redesigned bf16 kernels, on the CPU.

`rcdms_tpu_torch/ops/flash.py::_plan` (kernel A, `mma.sync` attention),
`rcdms_tpu_torch/ops/geglu.py::_plan` (kernels C and D, two TMA + `wgmma`
GEMM passes), `rcdms_tpu_torch/ops/smallk.py::_plan` (kernel E, the
studies' whole attention block on `mma.sync`) and
`rcdms_tpu_torch/ops/cm_conv.py::_plan` (the bf16 3x3 conv, an implicit
GEMM on TMA + `wgmma`) are pure Python: they choose the tile shapes and
compute the shared memory that the CUDA kernels lay out (the kernels refuse
a plan whose bytes differ from their own). Here every shape of the story's
main path and the study shapes (those `chip_smoke.py` and the card tests
hold the kernels to) must fit one block's 232,448 bytes of shared memory on
the H100, the padded widths must be the designs', and shapes the kernels do
not take must raise."""

import pytest

from rcdms_tpu_torch.ops import cm_conv, flash, geglu, smallk
from rcdms_tpu_torch.tools import cm_conv_study

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
    plan = flash._plan(dh)
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
    assert flash._plan(dh)["dp"] == dp


@pytest.mark.parametrize("dh", [0, 20, 44, 260, 264])
def test_attention_plan_refuses(dh):
    with pytest.raises(ValueError):
        flash._plan(dh)


def test_attention_plan_every_supported_width_fits():
    for dh in range(8, flash.MAX_HEAD_DIM + 1, 8):
        plan = flash._plan(dh)
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
