"""The port's opt-in w8a8 int8 route (rcdms_tpu_torch/ops/quant.py and
`core/layers.py::FrameConv`) against the JAX package's on the CPU: the
quantizers and their edge cases (tests/test_quant.py's), the int8 3x3 conv
against `rcdms_tpu.core.layers._taps9_conv_int8` called directly (the
int32 sums are exact on both sides, so 1e-6 relative), the gate (the same
convs of a tiny UNet take int8 as under the JAX rule), the exact path with
the mode off, and the per-module weight cache."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import StoryUNetConfig
from rcdms_tpu.core import layers as jlayers
from rcdms_tpu.io import convert
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.ops import quant as jquant
from rcdms_tpu_torch.core import layers as tlayers
from rcdms_tpu_torch.core.layers import FrameConv
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.ops import quant
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_models import _weights, _x


@pytest.fixture(autouse=True)
def _reset_modes():
    try:
        yield
    finally:
        quant.set_quant_mode(None)
        jquant.set_quant_mode(None)


def test_quantize_act_matches_jax_and_is_zero_safe():
    x = _x(0, 64, 128) * 3.0
    q, s = quant.quantize_act(torch.from_numpy(x))
    jq, js = jquant.quantize_act(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = np.abs(q.numpy().astype(np.float32) * float(s) - x)
    assert err.max() <= float(s) * 0.5 + 1e-7  # round-to-nearest bound
    q0, s0 = quant.quantize_act(torch.zeros(8, 8))
    assert (q0 == 0).all() and np.isfinite(float(s0))


def test_quantize_weight_per_channel_matches_jax():
    w = _x(1, 3, 3, 16, 8)
    w[..., 0] *= 100.0  # one loud channel keeps the others' resolution
    w[..., 3] = 0.0     # a zero-init channel (temporal proj_out) stays 0
    q, s = quant.quantize_weight(torch.from_numpy(w), out_axis=-1)
    jq, js = jquant.quantize_weight(jnp.asarray(w), out_axis=-1)
    assert s.shape == (8,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = q.numpy().astype(np.float32) * s.numpy()
    for c in range(8):
        assert np.abs(deq - w)[..., c].max() <= float(s[c]) * 0.5 + 1e-7
    assert (q[..., 3] == 0).all() and torch.isfinite(s).all()


def test_mode_validation():
    with pytest.raises(ValueError):
        quant.set_quant_mode("int4")
    quant.set_quant_mode("int8")
    assert quant.int8_enabled() and quant.get_quant_mode() == "int8"
    quant.set_quant_mode(None)
    assert not quant.int8_enabled()


def test_quant_mode_reads_rcdms_quant_at_import():
    code = ("from rcdms_tpu_torch.ops import quant; "
            "print(quant.get_quant_mode())")
    base = {k: v for k, v in os.environ.items() if k != "RCDMS_QUANT"}
    for env, want in (({"RCDMS_QUANT": "int8"}, "int8"), ({}, "None")):
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             env={**base, **env}, timeout=120)
        assert out.stdout.strip() == want, out.stderr[-2000:]


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 320), (128, 64),
                                      (128, 320), (64, 4)])
def test_int8_conv_matches_taps9_conv_int8(cin, cout):
    x = _x(2, 1, 2, 8, 8, cin)
    conv = FrameConv(cin, cout, 3, padding=1)
    g = torch.Generator().manual_seed(cin + cout)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
        conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
    kernel = conv.weight.detach().permute(2, 3, 1, 0).numpy()
    ref = jlayers._taps9_conv_int8(jnp.asarray(x), jnp.asarray(kernel),
                                   jnp.asarray(conv.bias.detach().numpy()),
                                   jnp.float32)
    quant.set_quant_mode("int8")
    calls = quant.int8_conv3x3.calls
    with torch.no_grad():
        out = conv(torch.from_numpy(x))
    assert quant.int8_conv3x3.calls == calls + 1
    assert out.shape == (1, 2, 8, 8, cout)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref)).max())


def test_int_matmul_is_exact_and_checks_operands():
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (40, 576), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (576, 64), generator=g, dtype=torch.int8)
    ref = a.to(torch.int64) @ b.to(torch.int64)
    out = quant.int_matmul(a, b)
    assert out.dtype == torch.int32
    assert torch.equal(out.to(torch.int64), ref)
    with pytest.raises(ValueError):
        quant.int_matmul(a.float(), b)
    with pytest.raises(ValueError):
        quant.int_matmul(a, b[:64])


def _unet_convs_taking_int8(channels):
    """(Cin, Cout) of each conv that takes the int8 route in one forward of
    the tiny story UNet, in call order: the port's and the JAX
    package's (its gate's dispatch switched on for the CPU)."""
    cfg = StoryUNetConfig.tiny(block_channels=channels)
    unet = StoryUNet(port_config(cfg)).eval()
    params = {"params": convert.convert_rcdms_unet3d(_weights(unet, 3), cfg)}
    sample, ctx = _x(4, 1, 5, 8, 8, 9), _x(5, 1, 5, 7, 24)
    jax_calls, port_calls = [], []
    real_j, real_t = jlayers._taps9_conv_int8, tlayers.int8_conv3x3

    def rec_j(x, kernel, bias, dtype):
        jax_calls.append((x.shape[-1], kernel.shape[-1]))
        return real_j(x, kernel, bias, dtype)

    def rec_t(x, qw, scale, bias, dtype):
        port_calls.append((x.shape[-1], scale.numel()))
        return real_t(x, qw, scale, bias, dtype)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jlayers, "_taps9_conv_int8", rec_j)
        mp.setattr(jlayers, "_use_taps9_int8", jquant.int8_enabled)
        mp.setattr(tlayers, "int8_conv3x3", rec_t)
        jquant.set_quant_mode("int8")
        quant.set_quant_mode("int8")
        junet.StoryUNet(cfg).apply(params, sample, np.array([500]), ctx)
        with torch.no_grad():
            unet(torch.from_numpy(sample), torch.tensor([500]),
                 torch.from_numpy(ctx))
    finally:
        mp.undo()
    return jax_calls, port_calls


@pytest.mark.parametrize("channels", [(32, 64), (64, 128)])
def test_int8_gate_admits_the_convs_the_jax_rule_admits(channels):
    jax_calls, port_calls = _unet_convs_taking_int8(channels)
    assert port_calls == jax_calls
    assert port_calls  # the route engaged
    assert all(cin % 64 == 0 for cin, _ in port_calls)


def test_int8_off_means_the_exact_path():
    conv = FrameConv(128, 64, 3, padding=1)
    x = torch.from_numpy(_x(6, 1, 2, 8, 8, 128))
    with torch.no_grad():
        ref = torch.nn.Conv2d.forward(
            conv, x.reshape(2, 8, 8, 128).permute(0, 3, 1, 2)
        ).permute(0, 2, 3, 1).reshape(1, 2, 8, 8, 64)
        out = conv(x)
        quant.set_quant_mode("int8")
        out_q = conv(x)
        quant.set_quant_mode(None)
        out_again = conv(x)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(out_again, ref, rtol=0, atol=0)
    assert not torch.equal(out_q, ref)  # the mode engaged
    rel_rms = ((out_q - ref).pow(2).mean() / ref.pow(2).mean()).sqrt()
    assert rel_rms < 0.02


def test_int8_weight_is_quantized_once_per_weight_version(monkeypatch):
    conv = FrameConv(64, 64, 3, padding=1)
    x = torch.from_numpy(_x(7, 1, 2, 8, 8, 64))
    quantized = []
    real = tlayers.conv_weight_int8
    monkeypatch.setattr(tlayers, "conv_weight_int8",
                        lambda w: quantized.append(1) or real(w))
    quant.set_quant_mode("int8")
    with torch.no_grad():
        first = conv(x)
        for _ in range(3):
            torch.testing.assert_close(conv(x), first, rtol=0, atol=0)
        assert len(quantized) == 1
        conv.weight.mul_(2.0)  # a new weight version
        assert not torch.equal(conv(x), first)
    assert len(quantized) == 2


def _seeded_conv(cin, cout, seed):
    conv = FrameConv(cin, cout, 3, padding=1)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
        conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
    return conv


def test_bf16_model_int8_weights_come_from_the_fp32_params():
    """A bf16 UNet cast in int8 mode holds, for every gated conv, the int8
    weight and scales `quantize_weight` gives the fp32 kernel, and the
    fp32 bias, as `_taps9_conv_int8` takes them from `_ConvParams`."""
    from rcdms_tpu_torch.sample.pipeline import for_inference

    cfg = StoryUNetConfig.tiny(block_channels=(64, 128))
    unet = StoryUNet(port_config(cfg)).eval()
    _weights(unet, 3)
    quant.set_quant_mode("int8")
    gated = [m for m in unet.modules()
             if isinstance(m, FrameConv) and m._takes_int8()]
    fp32 = [(m.weight.detach().permute(2, 3, 1, 0).numpy().copy(),
             m.bias.detach().numpy().copy()) for m in gated]
    for_inference(unet, torch.bfloat16)
    assert gated and all(m.weight.dtype == torch.bfloat16 for m in gated)
    for m, (kernel, bias) in zip(gated, fp32):
        qw, scale, b = m._int8_weight()
        jq, js = jquant.quantize_weight(jnp.asarray(kernel), out_axis=-1)
        cout = kernel.shape[-1]
        np.testing.assert_array_equal(
            qw[:, :cout].numpy(), np.asarray(jq).reshape(-1, cout))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), bias)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 320), (64, 4)])
def test_bf16_int8_conv_matches_taps9_conv_int8(cin, cout):
    conv = _seeded_conv(cin, cout, cin + cout)
    kernel = conv.weight.detach().permute(2, 3, 1, 0).numpy().copy()
    bias = conv.bias.detach().numpy().copy()
    x = torch.from_numpy(_x(2, 1, 2, 8, 8, cin)).to(torch.bfloat16)
    ref = jlayers._taps9_conv_int8(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(kernel), jnp.asarray(bias), jnp.bfloat16)
    quant.set_quant_mode("int8")
    conv.to(torch.bfloat16)
    with torch.no_grad():
        out = conv(x)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_int8_mode_after_a_bf16_cast_raises():
    conv = _seeded_conv(64, 64, 0).to(torch.bfloat16)
    x = torch.from_numpy(_x(3, 1, 2, 8, 8, 64)).to(torch.bfloat16)
    quant.set_quant_mode("int8")
    with pytest.raises(RuntimeError, match="before casting"):
        with torch.no_grad():
            conv(x)


def test_int8_cast_keeps_the_exact_path_and_follows_the_module():
    """A conv cast to bf16 in int8 mode computes the exact bf16 conv with
    the mode off, and its fp32-made int8 weight survives a layout change
    and a reload of the same weight's version only until it changes."""
    conv = _seeded_conv(64, 64, 1)
    plain = _seeded_conv(64, 64, 1).to(torch.bfloat16)
    x = torch.from_numpy(_x(4, 1, 2, 8, 8, 64)).to(torch.bfloat16)
    quant.set_quant_mode("int8")
    conv.to(torch.bfloat16)
    made = [t.clone() for t in conv._int8_weight()]
    conv.to(memory_format=torch.channels_last)
    for a, b in zip(conv._int8_weight(), made):
        assert torch.equal(a, b)
    quant.set_quant_mode(None)
    with torch.no_grad():
        torch.testing.assert_close(conv(x), plain(x), rtol=0, atol=0)
        conv.weight.mul_(2.0)  # the fp32 values behind it are gone
    quant.set_quant_mode("int8")
    with pytest.raises(RuntimeError, match="before casting"):
        with torch.no_grad():
            conv(x)
