"""Kernels C and D: the transformer feed-forward — the port's counterparts
of `rcdms_tpu/ops/geglu.py::geglu_ff` and `::gelu_ff`.

    geglu_ff: y = (x W1h^T + b1h) * gelu(x W1g^T + b1g) W2^T + b2
    gelu_ff:  y = gelu(x W1^T + b1) W2^T + b2

Weights keep torch's Linear layout: w1 (up, c), b1 (up,), w2 (c, inner),
b2 (c,), with up = 2*inner for geglu (hidden half first, gate half second,
as diffusers' GEGLU splits it). The FF is pointwise over tokens, so all
leading dims of x flatten into one row axis (a view); the kernels take the
ragged row tail, so the JAX package's `ff_flat` pad to 128 rows is gone.

Each wrapper dispatches on where x lies: on the CPU it runs its plain
version; on a CUDA device it launches `csrc/ff.cu` or raises. bf16 runs two
passes of the TMA + `wgmma` GEMM kernel with the plan of `_plan` (c and
inner multiples of 8, 16-byte aligned x, w1, w2: every FF of the main
path): pass 1 writes the activated (rows, inner) intermediate, pass 2 the
output. fp32 runs the fused CUDA-core kernel. `.launches` counts wrapper
calls (one FF, whatever its passes). Where autograd records it, the same
forward runs inside a `torch.autograd.Function` whose backward
differentiates `geglu_ff_reference` / `gelu_ff_reference`
(`ops/_grad.py`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops._grad import differentiable
from rcdms_tpu_torch.utils.logging import recording, span

BM, BK, STAGES = 128, 64, 4  # rows a block, K a stage, depth of the ring
SMS = 132                    # an H100 SXM's multiprocessors: one wave
MODES = {"bias": 0, "gelu": 1, "geglu": 2}
# column tiles the default plans choose from, per epilogue (per W half for
# geglu, which holds two accumulators)
TILE_WIDTHS = {"geglu": (128, 64), "gelu": (256, 128),
               "bias": (256, 160, 128, 64)}
# every column tile the GEMM kernel is built for (`csrc/ff.cu::
# dispatch_gemm`): TILE_WIDTHS and the widths a plan override may sweep
LIBRARY_WIDTHS = {"geglu": (32, 64, 96, 128), "gelu": (64, 128, 192, 256),
                  "bias": (32, 64, 96, 128, 160, 192, 256)}
PASS_MODES = {"pass1": ("geglu", "gelu"), "pass2": ("bias",)}

_plan_override: dict = {}  # pass name -> its column tile, while one is set


def set_plan_override(pass1_bn: int | None,
                      pass2_bn: int | None = None) -> None:
    """Study and test hook, not a production knob: every bf16 FF from now
    on takes column tile `pass1_bn` in pass 1 and `pass2_bn` in pass 2
    (None: that pass's default plan); `set_plan_override(None)` resets
    both. Raises ValueError for a width that no mode of its pass has in
    the library; `_plan` raises, before any launch, where the call's
    mode lacks the width."""
    override = {}
    for name, bn in (("pass1", pass1_bn), ("pass2", pass2_bn)):
        if bn is None:
            continue
        if not any(bn in LIBRARY_WIDTHS[m] for m in PASS_MODES[name]):
            raise ValueError(f"{name}: the library has no column tile {bn} "
                             f"for {PASS_MODES[name]}")
        override[name] = bn
    global _plan_override
    _plan_override = override


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemm_plan(m: int, n: int, mode: str, bn: int | None = None) -> dict:
    """Plan of one GEMM pass, Y (m, n) = epilogue(X W^T): the column tile
    `bn` (by default the one that gives the fewest waves of blocks over
    the card, each wave weighted by a block's width (its W tiles plus a
    constant for its X tile), ties to the wider tile); the grid, the
    ring's `stages` and the block's shared memory (`smem`: the ring of X
    and W tiles, the stages' two mbarriers, 1024 bytes to align the
    ring)."""
    nw = 2 if mode == "geglu" else 1
    m_blocks = _cdiv(m, BM)

    def cost(bn):
        return _cdiv(m_blocks * _cdiv(n, bn), SMS) * (nw * bn + 64), -bn

    if bn is None:
        bn = min(TILE_WIDTHS[mode], key=cost)
    elif bn not in LIBRARY_WIDTHS[mode]:
        raise ValueError(f"the library has no {mode} column tile {bn}: "
                         f"{LIBRARY_WIDTHS[mode]}")
    smem = STAGES * (BM * BK * 2 + nw * bn * BK * 2) + 2 * STAGES * 8 + 1024
    return dict(mode=mode, bm=BM, bn=bn, stages=STAGES, smem=smem,
                grid=(_cdiv(n, bn), m_blocks))


def _plan(rows: int, c: int, inner: int, geglu: bool) -> dict:
    """Launch plan of the bf16 FF: pass 1 (x -> the activated intermediate
    of shape `intermediate`) and pass 2 (-> y), with the column tiles of
    `set_plan_override` where one is set. Raises ValueError for a shape
    the kernel does not take."""
    if rows <= 0 or c <= 0 or inner <= 0 or c % 8 or inner % 8:
        raise ValueError(f"the bf16 FF kernel takes c and inner multiples "
                         f"of 8, got rows {rows}, c {c}, inner {inner}")
    return dict(pass1=_gemm_plan(rows, inner, "geglu" if geglu else "gelu",
                                 _plan_override.get("pass1")),
                pass2=_gemm_plan(rows, c, "bias", _plan_override.get("pass2")),
                intermediate=(rows, inner))


def _up(x, w1, b1) -> torch.Tensor:
    """x W1^T + b1 in fp32: the products of x.dtype operands summed in
    fp32, the bias in x.dtype (as `_ff_pallas` casts b1) added in fp32."""
    return F.linear(x.float(), w1.float(), b1.to(x.dtype).float())


def _down(a, w2, b2, dtype) -> torch.Tensor:
    """The fp32 activation rounded once to dtype, then a W2^T + b2 summed
    in fp32 and rounded once."""
    a = a.to(dtype).float()
    return F.linear(a, w2.float(), b2.to(dtype).float()).to(dtype)


def geglu_ff_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of kernel C, rounded where the TPU kernel
    rounds: h + b, g + b and h * gelu(g) in fp32, one rounding of the
    product to x.dtype."""
    h, gate = _up(x, w1, b1).chunk(2, dim=-1)
    return _down(h * F.gelu(gate), w2, b2, x.dtype)


def gelu_ff_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of kernel D: gelu(h + b) in fp32, rounded
    once to x.dtype."""
    return _down(F.gelu(_up(x, w1, b1)), w2, b2, x.dtype)


def geglu_ff_reference(x, w1, b1, w2, b2):
    """The function C's backward differentiates,
    `rcdms_tpu/ops/geglu.py::_xla_reference` (:64-72): both products and
    bias adds in x.dtype, each rounded, the gate's gelu in fp32 rounded to
    x.dtype, and h * gelu(g) rounded."""
    dtype = x.dtype
    h, gate = (x @ w1.to(dtype).t() + b1.to(dtype)).chunk(2, dim=-1)
    h = h * F.gelu(gate.float()).to(dtype)
    return h @ w2.to(dtype).t() + b2.to(dtype)


def gelu_ff_reference(x, w1, b1, w2, b2):
    """The function D's backward differentiates,
    `rcdms_tpu/ops/geglu.py::_xla_gelu_reference` (:75-82): as
    `geglu_ff_reference` without the gate."""
    dtype = x.dtype
    h = F.gelu((x @ w1.to(dtype).t() + b1.to(dtype)).float()).to(dtype)
    return h @ w2.to(dtype).t() + b2.to(dtype)


def _gemm(p: dict, x, w, bias, y, m: int, n: int, k: int) -> None:
    code = _build.library().lib.rcdms_ff_gemm(
        MODES[p["mode"]], p["bn"], p["smem"], x.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), m, n, k, _build.stream(x))
    _build.check(code, "rcdms_ff_gemm")


def _ff(name: str, geglu: bool, x, w1, b1, w2, b2):
    c = x.shape[-1]
    inner = w2.shape[-1]
    up = 2 * inner if geglu else inner
    if w1.shape != (up, c) or b1.shape != (up,) or w2.shape != (c, inner) \
            or b2.shape != (c,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
                         f"b2 {tuple(b2.shape)}")
    _build.cuda_operands(name, x, w1, b1, w2, b2)
    rows = x.numel() // c
    out = torch.empty_like(x)
    if rows == 0:  # an empty block of a split story: nothing to launch
        return out
    if x.dtype == torch.float32:
        code = _build.library().lib.rcdms_ff_fwd(
            int(geglu), x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, c, inner,
            _build.stream(x))
        _build.check(code, "rcdms_ff_fwd")
        return out
    plan = _plan(rows, c, inner, geglu)
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError(f"{name}: the bf16 kernel takes 16-byte aligned x, "
                         f"w1, w2")
    act = torch.empty(plan["intermediate"], device=x.device, dtype=x.dtype)
    _gemm(plan["pass1"], x, w1, b1, act, rows, inner, c)
    _gemm(plan["pass2"], act, w2, b2, out, rows, c, inner)
    return out


def _forward(geglu: bool, x, w1, b1, w2, b2) -> torch.Tensor:
    """C's or D's forward: the plain version on the CPU, the kernel on a
    card."""
    if x.device.type == "cpu":
        plain = geglu_ff_plain if geglu else gelu_ff_plain
        return plain(x, w1, b1, w2, b2)
    op = geglu_ff if geglu else gelu_ff
    # an empty block of a split story launches nothing, in no span
    if not (x.numel() and recording()):
        return _launch(op, geglu, x, w1, b1, w2, b2)
    with span("launch." + op.__name__):
        return _launch(op, geglu, x, w1, b1, w2, b2)


def _launch(op, geglu: bool, x, w1, b1, w2, b2) -> torch.Tensor:
    """C's or D's kernels on a card, from the operand checks to the last
    launch, counted in `op.launches`."""
    out = _ff(op.__name__, geglu, x, w1, b1, w2, b2)
    if x.numel():  # an empty block of a split story launches nothing
        op.launches += 1
    return out


def geglu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """GEGLU feed-forward over x (..., c). Differentiable: gradients of
    `geglu_ff_reference` (`ops/_grad.py`)."""
    return differentiable(functools.partial(_forward, True),
                          geglu_ff_reference, x, w1, b1, w2, b2)


def gelu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """GELU feed-forward over x (..., c). Differentiable: gradients of
    `gelu_ff_reference` (`ops/_grad.py`)."""
    return differentiable(functools.partial(_forward, False),
                          gelu_ff_reference, x, w1, b1, w2, b2)


geglu_ff.launches = 0
gelu_ff.launches = 0
