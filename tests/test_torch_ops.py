"""The port's four kernel ops (rcdms_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, on the same
numpy inputs. On the CPU each wrapper runs its plain PyTorch version;
tests/test_torch_cuda.py launches the CUDA kernels on a card.

Tolerance: 2e-5 absolute/relative in fp32. Both sides compute in fp32 and
differ only in summation order (and in the TPU kernel's A&S erf, |err|
<= 1.5e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.ops.frame_attention import frame_attention_bfnc
from rcdms_tpu.ops.geglu import ff_flat, geglu_ff as jgeglu_ff, \
    gelu_ff as jgelu_ff
from rcdms_tpu_torch import ops
from rcdms_tpu_torch.ops import attention as attention_ops
from rcdms_tpu_torch.ops.attention import multihead_attention
from rcdms_tpu_torch.ops.flash import flash_attention
from rcdms_tpu_torch.ops.frame_attention import frame_attention
from rcdms_tpu_torch.ops.geglu import geglu_ff, gelu_ff

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jflash.set_kernel_interpret(True)
    try:
        yield
    finally:
        jflash.set_kernel_interpret(False)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- kernel A -------------------------------------------------------------


@pytest.mark.parametrize("b,heads,dh,sq,skv,kv_len", [
    (2, 2, 8, 256, 256, 256),   # self-attention
    (2, 2, 16, 256, 128, 7),    # cross-attention, 7 real context tokens
])
def test_attention_matches_flash_nt(b, heads, dh, sq, skv, kv_len):
    rng = _rng(0)
    c = heads * dh
    qt, kt, vt = (_f32(rng, b, c, s) for s in (sq, skv, skv))
    ref = jflash.flash_attention_nt(jnp.asarray(qt), jnp.asarray(kt),
                                    jnp.asarray(vt), heads, dh ** -0.5, 128,
                                    kv_len)
    # the port is token-major and takes the context unpadded
    q = torch.from_numpy(qt).transpose(1, 2).contiguous()
    k = torch.from_numpy(kt[..., :kv_len]).transpose(1, 2).contiguous()
    v = torch.from_numpy(vt[..., :kv_len]).transpose(1, 2).contiguous()
    out = flash_attention(q, k, v, heads, row_sum="rounded")
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               **TOL)


def test_attention_matches_token_major_flash():
    """The CLIP vision site: token-major, 257 tokens, dh not a power of 2."""
    rng = _rng(1)
    b, heads, s, dh = 2, 2, 257, 24
    q, k, v = (_f32(rng, b, heads, s, dh) for _ in range(3))
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), dh ** -0.5, 128, True)

    def tm(a):  # (b, heads, s, dh) -> (b, s, heads*dh)
        return torch.from_numpy(a).permute(0, 2, 1, 3).reshape(b, s, -1)

    out = flash_attention(tm(q), tm(k), tm(v), heads, row_sum="fp32")
    np.testing.assert_allclose(
        out.reshape(b, s, heads, dh).permute(0, 2, 1, 3).numpy(),
        np.asarray(ref), **TOL)


# --- kernel B -------------------------------------------------------------


@pytest.mark.parametrize("shape,heads,c_real", [
    ((1, 5, 64, 128), 2, 128),
    ((2, 5, 7, 128), 2, 48),    # ragged tokens, zero-padded lanes
])
def test_frame_attention_matches_bfnc(shape, heads, c_real):
    rng = _rng(2)
    qkv = [_f32(rng, *shape) for _ in range(3)]
    for a in qkv:
        a[..., c_real:] = 0.0   # the TPU kernel's padded-lane contract
    ref = frame_attention_bfnc(*map(jnp.asarray, qkv), heads, c_real)
    out = frame_attention(*(torch.from_numpy(a[..., :c_real].copy())
                            for a in qkv), heads)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref)[..., :c_real], **TOL)


# --- kernels C and D ------------------------------------------------------


def _ff_params(rng, c, inner, up):
    return (_f32(rng, c, up, scale=0.05), _f32(rng, up, scale=0.1),
            _f32(rng, inner, c, scale=0.05), _f32(rng, c, scale=0.1))


def _torch_ff_args(x, w1, b1, w2, b2):
    """flax kernels (in, out) -> torch Linear weights (out, in)."""
    return (torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
            torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
            torch.from_numpy(b2))


@pytest.mark.parametrize("geglu", [True, False])
@pytest.mark.parametrize("lead,n", [((2,), 128), ((2, 5), 7)])
def test_ff_matches_pallas(geglu, lead, n):
    """(2, 128) rows tile directly; (2, 5, 7) = 70 ragged rows go through
    the JAX package's ff_flat pad, and through no pad in the port."""
    rng = _rng(3)
    c, inner = 32, 128
    up = 2 * inner if geglu else inner
    x = _f32(rng, *lead, n, c)
    w1, b1, w2, b2 = _ff_params(rng, c, inner, up)
    jfn = jgeglu_ff if geglu else jgelu_ff
    jargs = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    ref = jfn(*jargs) if n == 128 else ff_flat(jfn, *jargs)
    fn = geglu_ff if geglu else gelu_ff
    out = fn(*_torch_ff_args(x, w1, b1, w2, b2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [40, 44, 256, 264])
def test_attention_router(monkeypatch, dtype, dh):
    """Kernel A takes unmasked sites of at least 256 queries and dh <= 256;
    in bf16 (the `wgmma` kernel) dh must also be a multiple of 8."""
    takes = dh <= 256 and (dtype == torch.float32 or dh % 8 == 0)
    routed = []
    monkeypatch.setattr(attention_ops, "flash_attention",
                        lambda *a, **kw: routed.append(a) or a[0])
    for sq, mask in ((256, None), (255, None),
                     (256, torch.zeros(1, 1, 256, 8, dtype=dtype))):
        q = torch.zeros(1, sq, 2 * dh, dtype=dtype)
        kv = torch.zeros(1, 8, 2 * dh, dtype=dtype)
        routed.clear()
        out = multihead_attention(q, kv, kv, 2, mask, row_sum="rounded")
        assert out.shape == q.shape
        assert bool(routed) is (takes and sq == 256 and mask is None), \
            (sq, mask is None)
    assert attention_ops.uses_kernel(dtype, dh, 256, False) is takes


def test_cpu_wrappers_do_not_count():
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 8)
    flash_attention(x, x, x, 2, row_sum="rounded")
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
