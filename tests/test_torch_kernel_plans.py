"""The launch plans of the port's two redesigned bf16 kernels, on the CPU.

`rcdms_tpu_torch/ops/flash.py::_plan` (kernel A, `mma.sync` attention) and
`rcdms_tpu_torch/ops/geglu.py::_plan` (kernels C and D, two TMA + `wgmma`
GEMM passes) are pure Python: they choose the tile shapes and compute the
shared memory that the CUDA kernels lay out (the kernels refuse a plan
whose bytes differ from their own). Here every shape of the story's main
path (those `chip_smoke.py` holds the kernels to) must fit one block's
232,448 bytes of shared memory on the H100, the padded widths must be the
designs', and shapes the kernels do not take must raise."""

import pytest

from rcdms_tpu_torch.ops import flash, geglu

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
