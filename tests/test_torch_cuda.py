"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a CUDA card and is marked `gpu`; without one it
skips. The file imports no JAX, so it runs on a machine with the card and
no JAX (the repository's conftest.py configures JAX, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu

Tolerance: max|kernel - plain| / max|plain| <= 1e-4 in fp32 (TF32 off: the
two differ in summation order only) and 2e-2 in bf16 (kernel A, B and
the FF kernels round where their plain versions round, and sum in another
order; the conv and GroupNorm kernels round once, as their plain versions
do; the small-head-dim kernels E-H take bf16 only and round where their
plain versions round). Under autograd A-D run inside their
`torch.autograd.Function`s (`ops/_grad.py`): gradients to the same
tolerances."""

import copy
import importlib
import math

import pytest
import torch

from rcdms_tpu_torch import ops
from rcdms_tpu_torch.core.attention import SpatialTransformer
from rcdms_tpu_torch.core.layers import init_like_flax_
from rcdms_tpu_torch.ops.flash import (
    attention_plain,
    attention_reference,
    flash_attention,
)
from rcdms_tpu_torch.ops.frame_attention import (
    frame_attention,
    frame_attention_plain,
)
from rcdms_tpu_torch.ops.cm_conv import cm_conv3x3, cm_conv3x3_plain
from rcdms_tpu_torch.ops.geglu import (
    geglu_ff,
    geglu_ff_plain,
    geglu_ff_reference,
    gelu_ff,
    gelu_ff_plain,
    gelu_ff_reference,
)
from rcdms_tpu_torch.ops.group_norm import (
    _plan as gn_plan,
    gn_moments,
    gn_moments_plain,
    group_norm_act,
    group_norm_act_plain,
    group_norm_act_slab,
)
from rcdms_tpu_torch.ops.smallk import (
    BLK,
    attn_pv,
    attn_pv_plain,
    attn_scores,
    attn_scores_plain,
    attn_softmax,
    attn_softmax_plain,
    gen_p,
    smallk_attention,
    smallk_attention_plain,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
fa = importlib.import_module("rcdms_tpu_torch.ops.frame_attention")


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    """Each kernel against its plain version at small shapes with ragged
    edges (200 queries, 91 keys, 97 tokens, 70 rows)."""
    g = torch.Generator(cuda).manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(dtype)

    ops.reset_launch_counts()
    q, k, v = r(3, 200, 80), r(3, 91, 80), r(3, 91, 80)
    # bf16 runs the mma kernel (dh 80 and 40), fp32 the CUDA-core one; one
    # site of each row-sum family
    for heads, row_sum in zip((1, 2) if dtype == torch.bfloat16 else (2, 4),
                              ("rounded", "fp32")):
        dh = 80 // heads
        assert _rel(flash_attention(q, k, v, heads, row_sum=row_sum),
                    attention_plain(q, k, v, heads, dh ** -0.5,
                                    row_sum=row_sum)) <= TOL[dtype]
    # bf16 runs the tiled kernel (dh 32), fp32 the general one
    q, k, v = r(2, 5, 97, 96), r(2, 5, 97, 96), r(2, 5, 97, 96)
    assert _rel(frame_attention(q, k, v, 3),
                frame_attention_plain(q, k, v, 3, 32 ** -0.5)) <= TOL[dtype]
    # bf16: the two GEMM passes (c 104: a K tail past the 64-deep stage);
    # fp32: the fused CUDA-core kernel (c 100: no multiple of 8)
    for c in (96, 104) if dtype == torch.bfloat16 else (96, 100):
        x, inner = r(70, c), 4 * c
        args = (x, r(2 * inner, c, scale=0.1), r(2 * inner, scale=0.1),
                r(c, inner, scale=0.05), r(c, scale=0.1))
        assert _rel(geglu_ff(*args), geglu_ff_plain(*args)) <= TOL[dtype]
        args = (x, r(inner, c, scale=0.1), r(inner, scale=0.1),
                r(c, inner, scale=0.05), r(c, scale=0.1))
        assert _rel(gelu_ff(*args), gelu_ff_plain(*args)) <= TOL[dtype]
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"attention": 2, "frame_attention": 1,
                                   "geglu_ff": 2, "gelu_ff": 2,
                                   "cm_conv3x3": 0, "gn_moments": 0,
                                   "group_norm_act": 0,
                                   "smallk_attention": 0, "attn_scores": 0,
                                   "attn_pv": 0, "attn_softmax": 0}


def _frame_mask(h, w, tokens, g, dev, dtype):
    """The padded frame's interior mask (h x w frame in an (h+2) x (w+2)
    ring, zero tail up to `tokens`), scaled by random positive values so
    the multiply is exercised too."""
    m = torch.zeros(h + 2, w + 2, device=dev)
    m[1:-1, 1:-1] = 1.0
    m = torch.nn.functional.pad(m.reshape(-1), (0, tokens - m.numel()))
    return (m * (0.5 + torch.rand(tokens, generator=g, device=dev))).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_study_kernels_match_plain(cuda, dtype):
    """The conv, moments and fused GroupNorm kernels against their plain
    versions at small ragged shapes: a 10 x 13 frame (wp 15) padded to 200
    tokens, 24 -> 40 channels, and a 20 x 18 frame (wp 20) padded to 512
    tokens, 100 -> 360 channels (both the tensor-core conv in bf16: partial
    channel chunks, a Cout tile cut short, token tiles past the frame; the
    launch-path counter shows they took it), and 61 tokens with every mask
    value live, 5 -> 6 channels (the CUDA-core conv; taps read past both
    ends); moments over 100 and 37 rows (16-byte and scalar loads);
    GroupNorm with 3 and 16 channels a group over 50 and 7 rows."""
    g = torch.Generator(cuda).manual_seed(1)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(dtype)

    ops.reset_launch_counts()
    cm_conv3x3.tensor_launches = 0
    conv_cases = [
        (r(2, 24, 200), r(9, 24, 40, scale=0.07), r(40),
         _frame_mask(10, 13, 200, g, cuda, dtype), 15),
        (r(1, 100, 512), r(9, 100, 360, scale=0.03), r(360),
         _frame_mask(20, 18, 512, g, cuda, dtype), 20),
        (r(1, 5, 61), r(9, 5, 6, scale=0.15), r(6),
         (0.5 + torch.rand(61, generator=g, device=cuda)).to(dtype), 7),
    ]
    for x, w9, bias, mask, wp in conv_cases:
        for shifts in (True, False):
            assert _rel(cm_conv3x3(x, w9, bias, mask, wp, shifts),
                        cm_conv3x3_plain(x, w9, bias, mask, wp,
                                         shifts)) <= TOL[dtype]
    for shape in ((3, 100, 24), (2, 37, 13)):
        x = r(*shape)
        for out, ref in zip(gn_moments(x), gn_moments_plain(x)):
            assert _rel(out, ref) <= TOL[dtype]
    for shape, groups, act in (((3, 50, 96), 32, "silu"),
                               ((2, 7, 64), 4, "none")):
        c = shape[-1]
        args = (r(*shape), torch.rand(c, generator=g, device=cuda) + 0.5,
                torch.randn(c, generator=g, device=cuda) * 0.2, groups, 1e-6,
                act)
        assert _rel(group_norm_act(*args),
                    group_norm_act_plain(*args)) <= TOL[dtype]
    torch.cuda.synchronize()
    assert cm_conv3x3.tensor_launches == (4 if dtype == torch.bfloat16 else 0)
    assert ops.launch_counts("studies") == {
        "cm_conv3x3": 6, "gn_moments": 2, "group_norm_act": 2,
        "smallk_attention": 0, "attn_scores": 0, "attn_pv": 0,
        "attn_softmax": 0}
    assert set(ops.launch_counts("story").values()) == {0}


@pytest.mark.gpu
def test_cuda_group_norm_refuses_a_slab_beyond_shared_memory(cuda):
    """8192 rows x 32 channels a group of bf16, a 512 KB group slab, which
    the first port's kernel refused: a cluster of 8 CTAs takes it now, and
    agrees with the plain version. 1M rows overflow clusters of 16 too:
    the plan refuses them."""
    x = torch.randn(1, 8192, 64, device=cuda).to(torch.bfloat16)
    ones = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        group_norm_act_slab(x, ones, ones, 2, 1e-6, "silu")
    assert _rel(group_norm_act(x, ones, ones, 2, 1e-6, "silu"),
                group_norm_act_plain(x, ones, ones, 2, 1e-6, "silu")) \
        <= TOL[torch.bfloat16]
    big = torch.zeros(1, 1 << 20, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        group_norm_act(big, ones, ones, 2, 1e-6, "silu")


# the fused GroupNorm in clusters: c / groups = 10, 20, 30, 40, 60, 80 (the
# story UNet's widths in 32 groups), token counts that leave the last CTA
# of a cluster a shorter run (or none: 7 tokens), and whole rows (c 64)
GN_CASES = [(2, 1000, 320, 32), (5, 77, 640, 32), (1, 4096, 960, 32),
            (3, 257, 1280, 32), (2, 130, 1920, 32), (5, 64, 2560, 32),
            (2, 7, 64, 4)]


def _gn_inputs(shape, dtype, dev):
    """x with a mean and a spread per channel; fp32 scale and bias."""
    c = shape[-1]
    g = torch.Generator(dev).manual_seed(c + shape[1])
    x = (torch.randn(shape, generator=g, device=dev) * 2.0
         + torch.randn(c, generator=g, device=dev)).to(dtype)
    return (x, torch.rand(c, generator=g, device=dev) + 0.5,
            torch.randn(c, generator=g, device=dev) * 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("case", GN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_norm_act_clusters(cuda, dtype, case, act):
    """The cluster kernel against its plain version, and bit-stable
    between two runs (every CTA adds the ranks' partials in one order)."""
    *shape, groups = case
    x, scale, bias = _gn_inputs(shape, dtype, cuda)
    ops.reset_launch_counts()
    out = group_norm_act(x, scale, bias, groups, 1e-6, act)
    again = group_norm_act(x, scale, bias, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert group_norm_act.launches == 2
    assert torch.equal(out, again)
    assert _rel(out, group_norm_act_plain(x, scale, bias, groups, 1e-6,
                                          act)) <= TOL[dtype], case


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_norm_act_non_portable_cluster(cuda, dtype):
    """A token run whose slab fits a CTA only in a cluster of 16 (the
    non-portable size, allowed once a process)."""
    n = 48000 if dtype == torch.bfloat16 else 20000
    x, scale, bias = _gn_inputs((1, n, 64), dtype, cuda)
    assert gn_plan(1, n, 64, 2, x.element_size())["cluster"] == 16
    assert _rel(group_norm_act(x, scale, bias, 2, 1e-6, "silu"),
                group_norm_act_plain(x, scale, bias, 2, 1e-6, "silu")) \
        <= TOL[dtype]


@pytest.mark.gpu
def test_cuda_group_norm_act_slab_matches_plain(cuda):
    """The first port's kernel, kept for the device-time comparison, at a
    shape it takes."""
    g = torch.Generator(cuda).manual_seed(9)
    x = torch.randn(3, 256, 320, generator=g, device=cuda).bfloat16()
    scale = torch.rand(320, generator=g, device=cuda) + 0.5
    bias = torch.randn(320, generator=g, device=cuda) * 0.2
    assert _rel(group_norm_act_slab(x, scale, bias, 32, 1e-6, "silu"),
                group_norm_act_plain(x, scale, bias, 32, 1e-6, "silu")) \
        <= TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("row_sum", ["rounded", "fp32"])
def test_cuda_attention_rounds_p_as_the_plain_version(cuda, row_sum):
    """Kernel A rounds P against the row's final maximum and sums l from
    the rounded (UNet level 0, self and 91-token cross) or the fp32 P
    (CLIP vision), as its plain version and the TPU kernels do: besides
    the tolerance, at most 5% of its bf16 outputs differ from the plain
    version's bits (where exp and the summation order round apart; a
    kernel that rounds P against a running maximum moved 38% at level
    0)."""
    g = torch.Generator(cuda).manual_seed(11)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    if row_sum == "rounded":
        sites = [(r(5, 1024, 320), r(5, skv, 320), r(5, skv, 320), 8)
                 for skv in (1024, 91)]
    else:
        sites = [(r(2, 257, 1664), r(2, 257, 1664), r(2, 257, 1664), 16)]
    for q, k, v, heads in sites:
        dh = q.shape[-1] // heads
        out = flash_attention(q, k, v, heads, row_sum=row_sum)
        ref = attention_plain(q, k, v, heads, dh ** -0.5, row_sum=row_sum)
        assert _rel(out, ref) <= TOL[torch.bfloat16]
        off = (out != ref).float().mean().item()
        assert off <= 0.05, (row_sum, k.shape, off)


@pytest.mark.gpu
def test_cuda_study_wrappers_raise_on_bad_operands(cuda):
    h = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        gn_moments(h)
    with pytest.raises(TypeError):
        group_norm_act(h, torch.ones(16, device=cuda),
                       torch.zeros(16, device=cuda), 4, 1e-6, "silu")
    with pytest.raises(TypeError):
        cm_conv3x3(h, h.new_zeros(9, 8, 8), h.new_zeros(8), h.new_ones(16), 4)
    t = torch.zeros(1, 16, 8, device=cuda).transpose(1, 2)  # (1, 8, 16)
    with pytest.raises(ValueError):
        gn_moments(t)
    with pytest.raises(ValueError):
        group_norm_act(t, torch.ones(16, device=cuda),
                       torch.zeros(16, device=cuda), 4, 1e-6, "none")
    with pytest.raises(ValueError):
        cm_conv3x3(t, torch.zeros(9, 8, 8, device=cuda),
                   torch.zeros(8, device=cuda), torch.ones(16, device=cuda), 4)
    x = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(TypeError):  # scale and bias must be float32
        group_norm_act(x.bfloat16(), torch.ones(16, device=cuda).bfloat16(),
                       torch.zeros(16, device=cuda).bfloat16(), 4, 1e-6,
                       "silu")


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [40, 80, 104, 160, 256])
def test_cuda_attention_tile_edges(cuda, dh):
    """The bf16 wgmma kernel at every head dim of the main path and at 256,
    ragged on both sides, batch 3 (so a query block and a key tile end at
    a batch's last row): 1, 63 and 65 queries (a partial warpgroup, one
    warpgroup and a row of the second) and 200 (a partial 128-query
    block) against 1, 91, 127, 129 and 200 keys (partial 64- and 128-key
    tiles, and one key); 2 heads, so a head is a stride inside the token
    row."""
    g = torch.Generator(cuda).manual_seed(3)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    ops.reset_launch_counts()
    launches = 0
    for sq in (1, 63, 65, 200):
        for skv in (1, 91, 127, 129, 200):
            q, k, v = r(3, sq, 2 * dh), r(3, skv, 2 * dh), r(3, skv, 2 * dh)
            for row_sum in ("rounded", "fp32"):
                out = flash_attention(q, k, v, 2, row_sum=row_sum)
                launches += 1
                assert _rel(out, attention_plain(q, k, v, 2, dh ** -0.5,
                                                 row_sum=row_sum)) \
                    <= TOL[torch.bfloat16], (dh, sq, skv, row_sum)
    torch.cuda.synchronize()
    assert ops.launch_counts("story")["attention"] == launches


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [40, 104])
def test_cuda_attention_reads_no_other_head(cuda, dh):
    """At a dh the kernel pads (40 -> 48, 104 -> 112), the pad columns of
    its tiles are TMA's zeros, not the next head's or the next token's
    columns: with the other head's columns of q, k and v all NaN, a head's
    output equals, bit for bit, its output beside finite values."""
    g = torch.Generator(cuda).manual_seed(5)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    q, k, v = r(3, 200, 2 * dh), r(3, 129, 2 * dh), r(3, 129, 2 * dh)
    for row_sum in ("rounded", "fp32"):
        finite = flash_attention(q, k, v, 2, row_sum=row_sum)
        assert torch.isfinite(finite).all()
        for head in (0, 1):  # the head whose columns are NaN
            cols = slice(head * dh, (head + 1) * dh)
            keep = slice((1 - head) * dh, (2 - head) * dh)
            nq, nk, nv = (t.clone() for t in (q, k, v))
            for t in (nq, nk, nv):
                t[..., cols] = float("nan")
            out = flash_attention(nq, nk, nv, 2, row_sum=row_sum)
            assert torch.equal(out[..., keep], finite[..., keep]), \
                (dh, row_sum, head)


# kernel B: (b, f, n, c) with 8 heads: the story's five sites at a cut n
# (UNet levels 0-3 as tiles of 4 and 2 token rows and of one token and 4
# heads and 1 head, the prior's dh 256 as one token and 4 heads), one
# token and 2 heads, level 0 whole (each block walks about four tiles
# through the ring), then n = 1, an n one row past a whole number of
# 4-row tiles, dh 8, and f 1, 3 and 8
FRAME_CASES = [(1, 5, 1056, 320), (1, 5, 528, 640), (1, 5, 132, 1280),
               (1, 5, 64, 1280), (2, 5, 97, 2048), (1, 5, 66, 1280),
               (1, 5, 4096, 320), (1, 5, 1, 320), (1, 5, 1057, 320),
               (1, 5, 200, 64), (1, 1, 300, 320), (1, 3, 200, 640),
               (2, 8, 50, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FRAME_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_frame_attention_tiles(cuda, dtype, shape):
    """B against its plain version: bf16 takes the tiled kernel (its
    launch counter shows it), fp32 the general one."""
    g = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    dh = shape[-1] // 8
    ops.reset_launch_counts()
    out = frame_attention(q, k, v, 8)
    assert _rel(out, frame_attention_plain(q, k, v, 8, dh ** -0.5)) \
        <= TOL[dtype], shape
    torch.cuda.synchronize()
    assert frame_attention.launches == 1
    assert frame_attention.tiled_launches == int(dtype == torch.bfloat16)


@pytest.mark.gpu
def test_cuda_frame_attention_general_shapes(cuda):
    """bf16 operands the tiled kernel does not take run the general kernel
    with the same rounding: views 2 bytes off 16-byte alignment, and a
    head dim (12) that is no multiple of 8."""
    g = torch.Generator(cuda).manual_seed(6)

    def r(shape, offset=0):
        flat = torch.randn(math.prod(shape) + offset, generator=g,
                           device=cuda).bfloat16()
        return flat[offset:].view(shape)

    ops.reset_launch_counts()
    for shape, heads, offset in (((1, 5, 130, 320), 8, 1),
                                 ((2, 5, 97, 96), 8, 0)):
        q, k, v = r(shape, offset), r(shape, offset), r(shape, offset)
        assert q.is_contiguous()
        dh = shape[-1] // heads
        assert _rel(frame_attention(q, k, v, heads),
                    frame_attention_plain(q, k, v, heads, dh ** -0.5)) \
            <= TOL[torch.bfloat16], shape
    torch.cuda.synchronize()
    assert frame_attention.tiled_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("geglu", [True, False])
@pytest.mark.parametrize("c", [320, 640, 1280, 2048])
@pytest.mark.parametrize("rows", [70, 970])
def test_cuda_ff_tile_edges(cuda, rows, c, geglu):
    """The two bf16 GEMM passes at every width of the main path (inner =
    4c) and row counts ragged against the 128-row block: 70 (one partial
    block) and 970 (the prior's rows, 7 full blocks and a partial one)."""
    g = torch.Generator(cuda).manual_seed(4)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(
            torch.bfloat16)

    inner = 4 * c
    up = 2 * inner if geglu else inner
    args = (r(rows, c), r(up, c, scale=c ** -0.5), r(up, scale=0.1),
            r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
    fn, plain = (geglu_ff, geglu_ff_plain) if geglu else (gelu_ff,
                                                           gelu_ff_plain)
    ops.reset_launch_counts()
    out = fn(*args)
    assert out.shape == (rows, c)
    assert _rel(out, plain(*args)) <= TOL[torch.bfloat16]
    torch.cuda.synchronize()
    assert ops.launch_counts("story")[fn.__name__] == 1


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_operands(cuda):
    x = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(x, x, x, 2, row_sum="rounded")
    y = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention(y, y, y, 2, row_sum="rounded")
    f = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError):  # w1 is (inner, c), not (c, inner)
        gelu_ff(f, torch.zeros(16, 64, device=cuda),
                torch.zeros(64, device=cuda), torch.zeros(16, 64, device=cuda),
                torch.zeros(16, device=cuda))
    # operands the bf16 kernels refuse: no fallback runs them
    ops.reset_launch_counts()
    h = torch.zeros(2, 8, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # dh 20: not a multiple of 8
        flash_attention(h, h, h, 2, row_sum="rounded")
    wide = torch.zeros(1, 8, 528, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # dh 264 > 256
        flash_attention(wide, wide, wide, 2, row_sum="rounded")
    flat = torch.zeros(2 * 8 * 32 + 1, device=cuda, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 8, 32)  # contiguous, 2 bytes off 16
    with pytest.raises(ValueError):
        flash_attention(odd, odd, odd, 1, row_sum="rounded")
    many = torch.zeros(65536, 1, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a grid row of 65536 (batch, head)s
        flash_attention(many, many, many, 1, row_sum="rounded")
    xb = torch.zeros(4, 100, device=cuda, dtype=torch.bfloat16)
    w1 = torch.zeros(400, 100, device=cuda, dtype=torch.bfloat16)
    b1 = torch.zeros(400, device=cuda, dtype=torch.bfloat16)
    w2 = torch.zeros(100, 400, device=cuda, dtype=torch.bfloat16)
    b2 = torch.zeros(100, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # c 100: not a multiple of 8
        gelu_ff(xb, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}


SMALLK_ROWS = [  # (channel_major, dk, norm, split, dscore) of every E row
    (False, 128, "post", 1, False), (False, 40, "post", 1, False),
    (True, None, "pre", 1, False), (True, None, "rounded", 1, False),
    (True, None, "rounded", 2, False), (True, None, "rounded", 4, False),
    (True, None, "rounded", 1, True)]


def _smallk_rows(r, bsz, sq, skv, dh):
    """E at every row of the studies against its plain version; dh is the
    channel-major width and the token-major rows' narrow contraction."""
    qt, kt, vt = r(bsz, dh, sq), r(bsz, dh, skv), r(bsz, dh, skv)
    # token-major width 128, zero past dh
    tok = [torch.nn.functional.pad(t.transpose(1, 2), (0, 128 - dh))
           .contiguous() for t in (qt, kt, vt)]
    for cm, dk, norm, split, dscore in SMALLK_ROWS:
        args = (qt, kt, vt) if cm else tok
        kw = dict(channel_major=cm, dk=dh if dk == 40 else dk, norm=norm,
                  split=split, dscore=dscore)
        out = smallk_attention(*args, dh ** -0.5, **kw)
        assert out.shape == args[0].shape
        assert _rel(out, smallk_attention_plain(*args, dh ** -0.5, **kw)
                    ) <= TOL[torch.bfloat16], (kw, bsz, sq, skv, dh)


@pytest.mark.gpu
def test_cuda_smallk_kernels_match_plain(cuda):
    """E-H against their plain versions in every layout and variant of the
    studies: E at B = 2 batch-heads, 256 queries and keys, dh 40; F-H at
    B = 4, full Skv = 4096 and dh 40, 1024 queries (two 512-row cells)."""
    g = torch.Generator(cuda).manual_seed(2)
    bsz, sq, skv, dh = 4, 1024, 4096, 40

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    ops.reset_launch_counts()
    _smallk_rows(r, 2, 256, 256, dh)
    qt, kt, vt = r(bsz, dh, sq), r(bsz, dh, skv), r(bsz, dh, skv)
    q128, k128 = r(bsz, sq, 128), r(bsz, skv, 128)
    for q, k, cm in ((q128, k128, False), (qt, kt, True)):
        assert _rel(attn_scores(q, k, channel_major=cm),
                    attn_scores_plain(q, k, channel_major=cm)) <= 1e-4
    seeds = r(bsz, 8, 128)
    p_in = (torch.rand(bsz, 512, skv, generator=g, device=cuda)
            * 0.001).to(torch.bfloat16)
    cells = sq // 512
    for v, cm, src in ((r(bsz, skv, 128), False, "gen"),
                       (r(bsz, skv, dh), False, "gen"), (vt, True, "gen"),
                       (vt, True, "p"), (r(bsz, skv, 128), False, "p")):
        kw = dict(channel_major=cm, cells=cells,
                  **({"seeds": seeds} if src == "gen" else {"p": p_in}))
        out = attn_pv(v, **kw)
        assert _rel(out, attn_pv_plain(v, **kw)) <= 1e-4, (cm, src)
        assert (out[..., v.shape[1 if cm else 2]:] == 0).all()
    for kw in (dict(seeds=seeds, skv=skv), dict(p=p_in, scale=1000.0),
               dict(p=p_in, scale=1000.0, op="exp2"), dict(p=p_in, op="sum")):
        assert _rel(attn_softmax(cells=cells, **kw),
                    attn_softmax_plain(cells=cells, **kw)) <= 1e-4, kw
    torch.cuda.synchronize()
    assert ops.launch_counts("studies") == {
        "cm_conv3x3": 0, "gn_moments": 0, "group_norm_act": 0,
        "smallk_attention": 7, "attn_scores": 2, "attn_pv": 5,
        "attn_softmax": 4}


# F's edges: (channel_major, dh, B, Sq, Skv): one k16 step of dh (8), two
# (24), three with no pad (48); one 128-row block against one key group;
# more key groups (9) than the ring's 8 stages; token-major's 3-stage ring
# wrapped
SCORE_EDGES = [(True, 8, 1, 128, 128), (True, 24, 3, 128, 1152),
               (True, 48, 3, 256, 384), (False, 128, 1, 128, 128),
               (False, 128, 3, 256, 512)]
# G's edges: (layout, width, B, cells, Skv): n40 over dh 8 and 24, n48 at
# dh 48; one 64-key stage; 9 and 10 stages (past the ring's 8); input P
# blocks of 128 and 256 rows (the generated P's cells are 512)
PV_EDGES = [("tm128", 128, 1, 1, 64), ("tm128", 128, 3, 2, 576),
            ("tm40", 8, 3, 2, 64), ("tm40", 24, 1, 1, 576),
            ("tm40", 48, 3, 1, 192), ("cm40", 8, 1, 1, 576),
            ("cm40", 24, 3, 2, 64), ("cm40", 48, 1, 1, 640)]


@pytest.mark.gpu
@pytest.mark.parametrize("cm,dh,bsz,sq,skv", SCORE_EDGES)
def test_cuda_attn_scores_edges(cuda, cm, dh, bsz, sq, skv):
    """F against its plain version at the tile kernel's edges: pad rows in
    every channel-major box (dh 8, 24), batch rows that must not read each
    other's channels, rings shorter and longer than the key groups."""
    g = torch.Generator(cuda).manual_seed(7)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    q, k = (r(bsz, dh, sq), r(bsz, dh, skv)) if cm else (r(bsz, sq, dh),
                                                         r(bsz, skv, dh))
    ops.reset_launch_counts()
    out = attn_scores(q, k, channel_major=cm)
    assert out.shape == (bsz, sq, 128)
    assert _rel(out, attn_scores_plain(q, k, channel_major=cm)) <= 1e-4
    torch.cuda.synchronize()
    assert ops.launch_counts("studies")["attn_scores"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("src", ["gen", "p"])
@pytest.mark.parametrize("layout,width,bsz,cells,skv", PV_EDGES)
def test_cuda_attn_pv_edges(cuda, layout, width, bsz, cells, skv, src):
    """G against its plain version at the tile kernel's edges, P generated
    from nonzero seeds that differ between batch rows, or an input P whose
    rows all differ (blocks of 128 or 256 rows, so a block's rows and its
    cell's place are exercised); zeros past the width of v."""
    g = torch.Generator(cuda).manual_seed(8)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    cm = layout == "cm40"
    v = r(bsz, width, skv) if cm else r(bsz, skv, width)
    if src == "gen":
        seeds = r(bsz, 8, 128) + 2.0
        assert (seeds[:, 0, 0] != 0).all()
        kw = dict(seeds=seeds)
    else:
        blk = 128 * (1 + bsz % 2)
        p = torch.rand(bsz, blk, skv, generator=g, device=cuda
                       ).to(torch.bfloat16)
        assert (p[:, 1:] != p[:, :-1]).any(-1).all()
        kw = dict(p=p)
    kw.update(channel_major=cm, cells=cells)
    ops.reset_launch_counts()
    out = attn_pv(v, **kw)
    ref = attn_pv_plain(v, **kw)
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-4, (layout, width, src)
    assert (out[..., width:] == 0).all()
    torch.cuda.synchronize()
    assert ops.launch_counts("studies")["attn_pv"] == 1


# H's edges: (Skv, cells, scale, blk of the input P; B = 3): one key group
# (128), an odd count of groups (640); one cell (a block of one warp) and
# three (a block of 3 warps); a negative and a zero scale; 129 rows, so a
# block's last run is one row and its second row buffer stays unused; a
# row of 65536 that fits one buffer, not two (one stage); scale +-100, at
# which a row's scaled values span past 88, so e overflows or underflows
# unless the kernel takes the row's max (min for a negative scale)
SOFTMAX_EDGES = [(128, 1, -0.5, 128), (640, 3, 0.0, 128),
                 (640, 1, -0.5, 129), (128, 3, 0.0, 129),
                 (65536, 2, 1.0, 16), (640, 3, 100.0, 129),
                 (128, 1, -100.0, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("skv,cells,scale,blk", SOFTMAX_EDGES)
def test_cuda_attn_softmax_edges(cuda, skv, cells, scale, blk):
    """H against its plain version at the row kernel's edges, every op
    over P generated from seeds that differ between batch rows and over an
    input P whose rows all differ: one launch a call."""
    g = torch.Generator(cuda).manual_seed(9)
    bsz = 3
    seeds = (torch.randn(bsz, 8, 128, generator=g, device=cuda) + 2.0
             ).to(torch.bfloat16)
    assert (seeds[:, 0, 0] != 0).all()
    p = torch.randn(bsz, blk, skv, generator=g, device=cuda
                    ).to(torch.bfloat16)
    assert (p[:, 1:] != p[:, :-1]).any(-1).all()
    if abs(scale) >= 100:  # every row spans past exp's range
        for x in (p.float(), gen_p(seeds, BLK, skv).float()):
            assert ((x.amax(-1) - x.amin(-1)) * abs(scale) > 88).all()
    ops.reset_launch_counts()
    for src in (dict(seeds=seeds, skv=skv), dict(p=p)):
        for op in ("exp", "exp2", "sum"):
            kw = dict(op=op, scale=scale, cells=cells, **src)
            out = attn_softmax(**kw)
            ref = attn_softmax_plain(**kw)
            assert out.shape == ref.shape
            assert _rel(out, ref) <= 1e-4, (op, "seeds" in src)
    torch.cuda.synchronize()
    assert ops.launch_counts("studies")["attn_softmax"] == 6


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,dh", [(128, 64, 40), (256, 192, 48),
                                       (128, 128, 16)])
def test_cuda_smallk_attention_edges(cuda, sq, skv, dh):
    """E's seven rows at one 128-query block against one 64-key tile (the
    two-stage ring's shortest run), at an odd count of key tiles with the
    widest channel-major dh (48: six output tiles, no pad), and at a
    narrow dh (16: pad rows in every tile)."""
    g = torch.Generator(cuda).manual_seed(5)

    def r(*s):
        return torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)

    ops.reset_launch_counts()
    _smallk_rows(r, 3, sq, skv, dh)
    torch.cuda.synchronize()
    assert ops.launch_counts("studies")["smallk_attention"] == 7


@pytest.mark.gpu
def test_cuda_smallk_wrappers_raise_on_bad_operands(cuda):
    f = torch.zeros(1, 40, 512, device=cuda)
    with pytest.raises(TypeError):  # the kernels take bf16 only
        smallk_attention(f, f, f, 0.1, channel_major=True, norm="pre")
    with pytest.raises(TypeError):
        attn_scores(f, f, channel_major=True)
    with pytest.raises(TypeError):
        attn_pv(f, p=torch.zeros(1, 512, 512, device=cuda),
                channel_major=True, cells=1)
    with pytest.raises(TypeError):
        attn_softmax(p=torch.zeros(1, 512, 512, device=cuda), cells=1)
    h = f.bfloat16()
    t = torch.zeros(1, 512, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous
        smallk_attention(t.transpose(1, 2), h, h, 0.1, channel_major=True,
                         norm="pre")
    with pytest.raises(ValueError):
        attn_scores(t.transpose(1, 2), h, channel_major=True)
    with pytest.raises(ValueError):  # Sq not a multiple of 128
        smallk_attention(h[..., :200].contiguous(), h, h, 0.1,
                         channel_major=True, norm="pre")
    flat = torch.zeros(40 * 512 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # contiguous, 2 bytes off 16 (cp.async)
        smallk_attention(flat[1:].view(1, 40, 512), h, h, 0.1,
                         channel_major=True, norm="pre")
    with pytest.raises(ValueError):  # dh past the kernel's 48
        z = torch.zeros(1, 56, 512, device=cuda, dtype=torch.bfloat16)
        attn_scores(z, z, channel_major=True)
    with pytest.raises(ValueError):  # P blocks of 200 rows
        attn_pv(h, p=torch.zeros(1, 200, 512, device=cuda,
                                 dtype=torch.bfloat16), channel_major=True)
    # contiguous, 2 bytes off 16: F's and G's TMA maps need 16-byte aligned
    # operands
    ops.reset_launch_counts()
    odd = flat[1:].view(1, 40, 512)
    with pytest.raises(ValueError):
        attn_scores(odd, h, channel_major=True)
    with pytest.raises(ValueError):
        attn_pv(odd, seeds=torch.ones(1, 8, 128, device=cuda,
                                      dtype=torch.bfloat16),
                channel_major=True, cells=1)
    # H: a row past one buffer of shared memory (the plan's max_skv),
    # generated or an input; an input P off 16-byte alignment (TMA)
    with pytest.raises(ValueError):
        attn_softmax(p=torch.zeros(1, 1, 116224, device=cuda,
                                   dtype=torch.bfloat16), cells=1)
    with pytest.raises(ValueError):
        attn_softmax(seeds=torch.ones(1, 8, 128, device=cuda,
                                      dtype=torch.bfloat16), skv=116096,
                     cells=1)
    with pytest.raises(ValueError):
        attn_softmax(p=flat[1:].view(1, 40, 512), cells=1)
    torch.cuda.synchronize()
    assert ops.launch_counts("studies")["attn_scores"] == 0
    assert ops.launch_counts("studies")["attn_pv"] == 0
    assert ops.launch_counts("studies")["attn_softmax"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_grads_match_their_reference(cuda, dtype):
    """A-D on operands that require grad: one kernel launch a call, and
    the gradients of autograd through the function the JAX backward
    differentiates, on the same card."""
    g = torch.Generator(cuda).manual_seed(1)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(
            dtype).requires_grad_()

    c, inner = 96, 384
    cases = [
        ("attention", lambda *a: flash_attention(*a, 2, row_sum="rounded"),
         lambda *a: attention_reference(*a, 2, 48 ** -0.5),
         [r(2, 300, 96), r(2, 91, 96), r(2, 91, 96)]),
        ("attention", lambda *a: flash_attention(*a, 2, row_sum="fp32"),
         lambda *a: attention_reference(*a, 2, 48 ** -0.5),
         [r(2, 257, 96) for _ in range(3)]),
        ("frame_attention", lambda *a: frame_attention(*a, 3),
         lambda *a: fa.frame_attention_reference(*a, 3, 32 ** -0.5),
         [r(2, 5, 97, 96) for _ in range(3)]),
        ("geglu_ff", geglu_ff, geglu_ff_reference,
         [r(70, c), r(2 * inner, c, scale=0.1), r(2 * inner, scale=0.1),
          r(c, inner, scale=0.05), r(c, scale=0.1)]),
        ("gelu_ff", gelu_ff, gelu_ff_reference,
         [r(70, c), r(inner, c, scale=0.1), r(inner, scale=0.1),
          r(c, inner, scale=0.05), r(c, scale=0.1)]),
    ]
    for name, op, ref, leaves in cases:
        ops.reset_launch_counts()
        out = op(*leaves)
        assert ops.launch_counts("story")[name] == 1, name
        cot = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
        got = torch.autograd.grad(out, leaves, cot)
        want = torch.autograd.grad(ref(*leaves), leaves, cot)
        for a, b in zip(got, want):
            assert a.dtype == dtype and _rel(a, b) <= TOL[dtype], name
        with torch.no_grad():  # no Function: the kernel alone
            assert torch.equal(op(*leaves), out), name


@pytest.mark.gpu
def test_cuda_spatial_transformer_trains_like_the_cpu(cuda):
    """A level-0 spatial transformer (320 channels, 8 heads of 40, 91
    context tokens; 5 frames of 32 x 32) in bf16 with weights that require
    grad: every parameter gets a gradient on the card, within 2e-2 of its
    tensor's max of the same module's on the CPU. Before the kernels ran
    under autograd, the card left the attention projections and the FF
    without gradients."""
    g = torch.Generator().manual_seed(2)
    block = SpatialTransformer(320, 8, 40, 768, 32)
    init_like_flax_(block, g)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    block = block.to(torch.bfloat16)
    x = torch.randn(1, 5, 32, 32, 320, generator=g).bfloat16()
    ctx = torch.randn(1, 5, 91, 768, generator=g).bfloat16()
    card = copy.deepcopy(block).to(cuda)
    ops.reset_launch_counts()
    for module, args in ((block, (x, ctx)),
                         (card, (x.to(cuda), ctx.to(cuda)))):
        module(*args).float().square().mean().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts("story")
    assert counts["attention"] == 2 and counts["geglu_ff"] == 1, counts
    for (n, p), q in zip(card.named_parameters(), block.parameters()):
        assert p.grad is not None, n
        assert _rel(p.grad.cpu(), q.grad) <= 2e-2, n


@pytest.mark.gpu
def test_cuda_native_feeder_at_full_shape(cuda):
    """The feeder, built with g++ on the card machine's host, packs
    Flintstones stories (5 frames of 128 px -> 512 px, 224 px CLIP) equal
    to the numpy protocol bit for bit."""
    import numpy as np

    from rcdms_tpu_torch.configs import DatasetConfig
    from rcdms_tpu_torch.data.native_feeder import NativeFeeder
    from rcdms_tpu_torch.data.protocol import (
        StoryTokenizer,
        build_story_example,
    )

    cfg = DatasetConfig(name="flintstones")
    rng = np.random.RandomState(4)
    stories = [rng.randint(0, 256, (5, 128, 128, 3), np.uint8)
               for _ in range(3)]
    feeder = NativeFeeder(num_threads=4)
    try:
        out = feeder.pack_batch(stories, [0, 1, 4], cfg.image_size,
                                cfg.clip_size)
        for i, (story, known) in enumerate(zip(stories, (0, 1, 4))):
            want = build_story_example(list(story), ["c"] * 5, known,
                                       StoryTokenizer(cfg), cfg=cfg)
            for key in ("target", "source", "reference_clip", "source_clip",
                        "mask_clip", "mask_label"):
                assert np.array_equal(out[key][i], want[key]), (key, i)
    finally:
        feeder.close()


@pytest.mark.gpu
def test_cuda_train_stage2_run_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """One tiny `cli.train_stage2.run` (3 steps, fp32, one repeated 32 px
    story) on the card against the same run on the CPU: every loss within
    1e-4 relative. The card's generators draw other numbers than the
    CPU's, so here every draw of both runs (the towers' init, the
    posterior noise, the step's noise) comes from a CPU generator of the
    same seed as the device generator the CLI made, and is moved to the
    device."""
    import json

    from rcdms_tpu_torch.cli import common, train_stage2
    from rcdms_tpu_torch.configs import DatasetConfig
    from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset
    from rcdms_tpu_torch.train import loop, stage2

    twins = {}

    def on_cpu(generator):
        key = id(generator)
        if key not in twins:  # the generator is kept, so its id is unique
            twins[key] = (generator, torch.Generator().manual_seed(
                generator.initial_seed()))
        return twins[key][1]

    init = common.init_like_flax_

    def init_on_cpu(module, generator):
        twin = copy.deepcopy(module).to("cpu")
        init(twin, on_cpu(generator))
        with torch.no_grad():
            for p, q in zip(module.state_dict().values(),
                            twin.state_dict().values()):
                p.copy_(q)

    monkeypatch.setattr(common, "init_like_flax_", init_on_cpu)
    draw = loop.TrainNoise.draw.__func__

    def draw_on_cpu(cls, generator, *args):
        *shapes, device = args
        return draw(cls, on_cpu(generator), *shapes, "cpu").to(device)

    monkeypatch.setattr(loop.TrainNoise, "draw", classmethod(draw_on_cpu))
    monkeypatch.setattr(stage2, "draw_noise", lambda shape, generator,
                        device: torch.randn(shape, generator=on_cpu(
                            generator)).to(device))

    class OneBatch:
        cfg = DatasetConfig(image_size=32, clip_size=28)

        def batches(self, batch_size, **_):
            batch = next(SyntheticStoryDataset(cfg=self.cfg).batches(1))
            while True:
                yield batch

    losses = {}
    for device in ("cpu", "cuda"):
        out = str(tmp_path / device)
        train_stage2.run(train_stage2.parse_args([
            "--synthetic", "--device", device, "--dtype", "float32",
            "--batch-size", "1", "--max-train-steps", "3", "--log-every",
            "1", "--warmup-steps", "0", "--learning-rate", "1e-4",
            "--report-to", "none", "--output-dir", out]), OneBatch())
        with open(f"{out}/metrics.jsonl") as fh:
            losses[device] = [json.loads(line)["loss"] for line in fh]
    assert len(losses["cpu"]) == 3
    for a, b in zip(losses["cpu"], losses["cuda"]):
        assert abs(a - b) <= 1e-4 * abs(a), losses
