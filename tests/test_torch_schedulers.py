"""The port's DDIM and UnCLIP schedulers against the golden values of
tests/test_schedulers.py (independent float64 numpy) and against the JAX
package's schedulers on the same inputs.

Tolerance: rtol 1e-4 / atol 1e-5 against the goldens, as
tests/test_schedulers.py holds the JAX package; 1e-5 against JAX, whose
coefficients are fp32 where the port's are float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.core import schedulers as jsched
from rcdms_tpu_torch.core.schedulers import (
    DDIMSchedule,
    UnCLIPSchedule,
    cfg_combine,
    make_betas,
)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("name", ["linear", "squaredcos_cap_v2"])
def test_beta_tables_match(name):
    np.testing.assert_array_equal(make_betas(name, 1000, 0.00085, 0.012),
                                  jsched.make_betas(name, 1000, 0.00085,
                                                    0.012))


def test_timestep_tables():
    ddim = DDIMSchedule.stage2_inference()
    assert ddim.timesteps(20).tolist() == list(range(950, -1, -50))
    assert ddim.prev_timesteps(20).tolist() == list(range(900, -51, -50))
    un = UnCLIPSchedule()
    expect = np.round(np.arange(20) * (999 / 19))[::-1].astype(int)
    assert un.timesteps(20).tolist() == expect.tolist()
    prev = un.prev_timesteps(20)
    assert prev[:-1].tolist() == expect[1:].tolist()
    assert prev[-1] == expect[-1] - 1
    assert un.timesteps(1).tolist() == [999]


def test_ddim_step_golden_eta0():
    sched = DDIMSchedule.stage2_inference()
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4).astype(np.float32)
    eps = rng.randn(2, 4).astype(np.float32)
    out = sched.step(_t(eps), 950, 900, _t(x)).numpy()
    acp = sched.alphas_cumprod
    a_t, a_prev = acp[950], acp[900]
    x0 = np.clip((x - np.sqrt(1 - a_t) * eps) / np.sqrt(a_t), -1, 1)
    eps2 = (x - np.sqrt(a_t) * x0) / np.sqrt(1 - a_t)
    expect = np.sqrt(a_prev) * x0 + np.sqrt(1 - a_prev) * eps2
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_ddim_final_step_alpha_to_one():
    sched = DDIMSchedule.stage2_inference()
    out = sched.step(torch.zeros(1, 2), 0, -50, torch.full((1, 2), 0.3))
    x0 = 0.3 / np.sqrt(sched.alphas_cumprod[0])
    np.testing.assert_allclose(out.numpy(), np.clip(x0, -1, 1), rtol=1e-5)


def test_unclip_step_golden_sample_prediction():
    sched = UnCLIPSchedule()
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8).astype(np.float32)
    pred = (rng.randn(2, 8) * 3).astype(np.float32)
    z = rng.randn(2, 8).astype(np.float32)
    out = sched.step(_t(pred), 999, 946, _t(x), _t(z)).numpy()
    acp = sched.alphas_cumprod
    a_t, a_prev = acp[999], acp[946]
    beta = 1 - a_t / a_prev
    x0 = np.clip(pred, -10, 10)
    mean = (np.sqrt(a_prev) * beta / (1 - a_t) * x0
            + np.sqrt(1 - beta) * (1 - a_prev) / (1 - a_t) * x)
    std = np.sqrt(np.clip((1 - a_prev) / (1 - a_t) * beta, 1e-20, None))
    np.testing.assert_allclose(out, mean + std * z, rtol=1e-4, atol=1e-5)


def test_unclip_adjacent_step_uses_beta_table():
    sched = UnCLIPSchedule()
    out = sched.step(torch.zeros(1, 4), 5, 4, torch.ones(1, 4),
                     torch.zeros(1, 4))
    acp = sched.alphas_cumprod
    mean = np.sqrt(1 - sched.betas[5]) * (1 - acp[4]) / (1 - acp[5])
    np.testing.assert_allclose(out.numpy(), mean, rtol=1e-5)


def test_whole_chains_match_jax():
    """Every step of both 20-step chains against the JAX schedulers."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 6).astype(np.float32)
    ddim, jddim = DDIMSchedule.stage2_inference(), \
        jsched.DDIMSchedule.stage2_inference()
    un, jun = UnCLIPSchedule(), jsched.UnCLIPSchedule()
    for sched, jref, noisy in ((ddim, jddim, False), (un, jun, True)):
        for t, pt in zip(sched.timesteps(20), sched.prev_timesteps(20)):
            out = rng.randn(3, 6).astype(np.float32)
            z = rng.randn(3, 6).astype(np.float32)
            targs = (_t(out), int(t), int(pt), _t(x))
            jargs = (jnp.asarray(out), jnp.int32(t), jnp.int32(pt),
                     jnp.asarray(x))
            if noisy:
                got = sched.step(*targs, _t(z)).numpy()
                ref = np.asarray(jref.step(*jargs, jnp.asarray(z)))
            else:
                got = sched.step(*targs).numpy()
                ref = np.asarray(jref.step(*jargs))
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_cfg_combine():
    assert cfg_combine(torch.tensor([1.0]), torch.tensor([3.0]),
                       2.0).item() == 5.0
