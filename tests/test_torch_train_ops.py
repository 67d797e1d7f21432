"""The story kernels' wrappers under autograd (rcdms_tpu_torch/ops/_grad.py)
against the JAX package's custom-VJP ops, on the CPU.

A (both families: `flash_attention_nt`'s UNet sites and `flash_attention`'s
CLIP sites), B (`frame_attention_bfnc`), C (`geglu_ff`) and D (`gelu_ff`):
the port's gradients for one seeded cotangent against `jax.vjp` of the
JAX op on the same numpy-seeded inputs, the Pallas forwards in interpret
mode as `tests/test_kernel_grads.py` runs them. Both sides differentiate
the same unfused reference function, so they differ only in summation
order: tolerance max|port - jax| / max|jax| <= 1e-5 in fp32 and 2e-2 in
bf16 (the products, casts and bias adds round to bf16 at the same places,
each a half ulp of 2^-8 relative, and the order of the fp32 sums can move
a rounding by one ulp).

Also: every operand that requires grad gets one (and only those); the
Function saves only its operands; under no_grad nothing is saved and the
output is the plain version's, bit for bit; and a raw kernel launch
refuses operands that require grad while grad mode is on.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.ops import frame_attention as jframe
from rcdms_tpu.ops import geglu as jgeglu
from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops import flash, geglu
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

# the module, which the package's `frame_attention` function shadows
fa = importlib.import_module("rcdms_tpu_torch.ops.frame_attention")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def interpret():
    """The JAX package's Pallas kernels in interpret mode for the module."""
    jflash.set_kernel_interpret(True)
    yield
    jflash.set_kernel_interpret(False)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(port, ref) -> float:
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _torch_grads(fn, arrays, dtype, cotangent):
    """The op's output and the gradients of its inputs for `cotangent`."""
    ts = [torch.from_numpy(a).to(TDT[dtype]).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(cotangent).to(out.dtype))
    return out, [t.grad.float().numpy() for t in ts]


@functools.lru_cache(maxsize=None)
def _jax_vjp(fn):
    """jit of (inputs..., cotangent) -> the VJP of `fn`, once per op."""
    return jax.jit(lambda *a: jax.vjp(fn, *a[:-1])[1](a[-1]))


def _jax_grads(fn, arrays, dtype, cotangent):
    args = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    return [np.asarray(g.astype(jnp.float32)) for g in _jax_vjp(fn)(
        *args, jnp.asarray(cotangent, JDT[dtype]))]


def _heads_cm(t, heads):
    """(b, S, H*dh) -> the channel-major (b, H*dh, S) of `_nt_pallas`."""
    return np.ascontiguousarray(np.swapaxes(t, -1, -2))


# (label, Sq, Skv): the UNet's self attention and its cross attention
# (ragged keys, which the JAX layer pads to 128 and masks by kv_len)
A_UNET = [("self", 256, 256), ("cross", 256, 91)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site,sq,skv", A_UNET)
def test_attention_grads_unet_sites_match_jax(dtype, site, sq, skv):
    heads, dh = 2, 16
    c = heads * dh
    q, k, v = _rand(0, 2, sq, c), _rand(1, 2, skv, c), _rand(2, 2, skv, c)
    g = _rand(3, 2, sq, c)
    scale = dh ** -0.5
    _, got = _torch_grads(lambda q, k, v: flash.flash_attention(
        q, k, v, heads, row_sum="rounded"), (q, k, v), dtype, g)
    pad = -skv % 128

    def padded(t):  # channel-major, keys zero-padded to a lane multiple
        return np.pad(_heads_cm(t, heads), ((0, 0), (0, 0), (0, pad)))

    fn = functools.partial(_nt_vjp_fn, heads=heads, scale=scale, kv_len=skv)
    want = _jax_grads(fn, (_heads_cm(q, heads), padded(k), padded(v)),
                      dtype, _heads_cm(g, heads))
    want = [np.swapaxes(w, -1, -2)[:, :n] for w, n in zip(want,
                                                          (sq, skv, skv))]
    for name, a, b in zip("qkv", got, want):
        assert _rel(a, b) <= TOL[dtype], (site, name, _rel(a, b))


def _nt_vjp_fn(qt, kt, vt, *, heads, scale, kv_len):
    return jflash.flash_attention_nt(qt, kt, vt, heads, scale,
                                     jflash.DEFAULT_Q_BLOCK, kv_len)


def _clip_vjp_fn(q, k, v, *, heads, scale):
    """The token-major op over (b, S, H*dh) operands split into heads."""
    def split(t):
        return jnp.swapaxes(t.reshape(t.shape[:-1] + (heads, -1)), -3, -2)

    o = jflash.flash_attention(split(q), split(k), split(v), scale,
                               jflash.DEFAULT_Q_BLOCK, True)
    return jnp.swapaxes(o, -3, -2).reshape(q.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grads_clip_sites_match_jax(dtype):
    """CLIP vision's 257 tokens (the fp32 row-sum family)."""
    heads, dh, s = 2, 16, 257
    q, k, v = (_rand(i, 2, s, heads * dh) for i in (4, 5, 6))
    g = _rand(7, 2, s, heads * dh)
    _, got = _torch_grads(lambda q, k, v: flash.flash_attention(
        q, k, v, heads, row_sum="fp32"), (q, k, v), dtype, g)
    fn = functools.partial(_clip_vjp_fn, heads=heads, scale=dh ** -0.5)
    want = _jax_grads(fn, (q, k, v), dtype, g)
    for name, a, b in zip("qkv", got, want):
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))


def _bfnc_vjp_fn(q, k, v, *, heads, c_real):
    return jframe.frame_attention_bfnc(q, k, v, heads, c_real, None, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_attention_grads_match_jax(dtype):
    """B over (b, f, n, c) = (2, 5, 24, 32), 2 heads; the JAX op takes the
    channels zero-padded to 128 lanes."""
    heads, shape = 2, (2, 5, 24, 32)
    q, k, v = (_rand(i, *shape) for i in (8, 9, 10))
    g = _rand(11, *shape)
    _, got = _torch_grads(lambda q, k, v: fa.frame_attention(q, k, v, heads),
                          (q, k, v), dtype, g)

    def lanes(t):
        return np.pad(t, ((0, 0),) * 3 + ((0, 128 - shape[-1]),))

    fn = functools.partial(_bfnc_vjp_fn, heads=heads, c_real=shape[-1])
    want = _jax_grads(fn, [lanes(t) for t in (q, k, v)], dtype, lanes(g))
    for name, a, b in zip("qkv", got, want):
        assert _rel(a, b[..., :shape[-1]]) <= TOL[dtype], (name, _rel(
            a, b[..., :shape[-1]]))


def _ff_arrays(seed, c, inner, geglu_):
    """x (2, 128, c) and torch-layout weights w1 (up, c), b1, w2 (c, inner),
    b2."""
    up = 2 * inner if geglu_ else inner
    return (_rand(seed, 2, 128, c), _rand(seed + 1, up, c, scale=c ** -0.5),
            _rand(seed + 2, up, scale=0.5),
            _rand(seed + 3, c, inner, scale=inner ** -0.5),
            _rand(seed + 4, c, scale=0.1))


def _ff_vjp_fn(x, w1, b1, w2, b2, *, geglu_):
    """The JAX op on the torch-layout weights (flax's (in, out) is their
    transpose)."""
    fn = jgeglu.geglu_ff if geglu_ else jgeglu.gelu_ff
    return fn(x, w1.T, b1, w2.T, b2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geglu_", [True, False], ids=["C", "D"])
def test_ff_grads_match_jax(dtype, geglu_):
    arrays = _ff_arrays(12, 64, 256, geglu_)
    g = _rand(20, 2, 128, 64)
    op = geglu.geglu_ff if geglu_ else geglu.gelu_ff
    _, got = _torch_grads(op, arrays, dtype, g)
    want = _jax_grads(functools.partial(_ff_vjp_fn, geglu_=geglu_), arrays,
                      dtype, g)
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))


def _ops():
    """(name, op, operands, the plain version) at small CPU shapes."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    q3 = [r(2, 256, 32) for _ in range(3)]
    q4 = [r(2, 5, 6, 32) for _ in range(3)]
    ff_c = [r(3, 16), r(128, 16), r(128), r(16, 64), r(16)]
    ff_d = [r(3, 16), r(64, 16), r(64), r(16, 64), r(16)]
    return [
        ("A rounded", lambda *a: flash.flash_attention(*a, 2,
                                                       row_sum="rounded"),
         q3, lambda *a: flash.attention_plain(*a, 2, 16 ** -0.5,
                                              row_sum="rounded")),
        ("A fp32", lambda *a: flash.flash_attention(*a, 2, row_sum="fp32"),
         q3, lambda *a: flash.attention_plain(*a, 2, 16 ** -0.5,
                                              row_sum="fp32")),
        ("B", lambda *a: fa.frame_attention(*a, 2), q4,
         lambda *a: fa.frame_attention_plain(*a, 2, 16 ** -0.5)),
        ("C", geglu.geglu_ff, ff_c, geglu.geglu_ff_plain),
        ("D", geglu.gelu_ff, ff_d, geglu.gelu_ff_plain),
    ]


class _SavedCount:
    """Counts the tensors autograd saves while it is entered."""

    def __enter__(self):
        self.n = 0

        def pack(t):
            self.n += 1
            return t

        self._hooks = torch.autograd.graph.saved_tensors_hooks(pack,
                                                               lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(5))
def test_every_operand_that_requires_grad_gets_one(case, dtype):
    name, op, operands, _ = _ops()[case]
    for i in range(len(operands)):  # all of them, then each alone
        needs = [True] * len(operands) if i == 0 else [
            j == i for j in range(len(operands))]
        ts = [t.to(dtype, copy=True).requires_grad_(n)
              for t, n in zip(operands, needs)]
        with _SavedCount() as saved:
            out = op(*ts)
        assert type(out.grad_fn).__name__.lstrip("_").endswith("Backward")
        assert saved.n == len(operands), (name, saved.n)  # operands only
        out.float().square().sum().backward()
        for t, n in zip(ts, needs):
            assert (t.grad is not None) == n, (name, needs)
            if n:
                assert t.grad.dtype == dtype and torch.isfinite(
                    t.grad).all() and t.grad.abs().sum() > 0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(5))
def test_no_grad_saves_nothing_and_returns_the_plain_output(case, dtype):
    name, op, operands, plain = _ops()[case]
    ts = [t.to(dtype, copy=True).requires_grad_() for t in operands]
    with torch.no_grad(), _SavedCount() as saved:
        out = op(*ts)
        want = plain(*ts)
    assert saved.n == 0 and out.grad_fn is None, name
    assert torch.equal(out, want), name
    with _SavedCount() as saved:  # operands that need no grad: no Function
        out = op(*operands)
    assert saved.n == 0 and out.grad_fn is None, name


def test_a_raw_launch_refuses_operands_that_require_grad():
    """The kernels' common gate (`_build.cuda_operands`) and each story
    op's raw launch, reached here on meta tensors as a stand-in device:
    with grad mode on and an operand that requires grad they raise before
    anything else; under no_grad they go on to refuse the device."""
    meta = functools.partial(torch.zeros, device="meta")
    raw = [
        lambda *a: flash._attention(*a, 2, 16 ** -0.5, "rounded"),
        lambda *a: fa._frame_attention(*a, 2, 16 ** -0.5),
        lambda *a: geglu._forward(True, *a),
        lambda *a: geglu._forward(False, *a),
    ]
    operands = [[meta(2, 256, 32) for _ in range(3)],
                [meta(2, 5, 6, 32) for _ in range(3)],
                [meta(3, 16), meta(128, 16), meta(128), meta(16, 64),
                 meta(16)],
                [meta(3, 16), meta(64, 16), meta(64), meta(16, 64),
                 meta(16)]]
    for launch, ops in zip(raw, operands):
        ops[-1].requires_grad_()
        with pytest.raises(RuntimeError, match="require grad"):
            launch(*ops)
        with torch.no_grad(), pytest.raises(ValueError,
                                            match="CUDA device"):
            launch(*ops)
    cpu = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="require grad"):
        _build.cuda_operands("op", cpu)
