"""The port's optimizer (rcdms_tpu_torch/train/optim.py) against optax as
the JAX package chains it (`rcdms_tpu/train/optim.py`), on the same
gradients: the learning-rate schedules at counts 0..N, clipping above and
below the limit, three AdamW steps, and accumulation as `optax.MultiSteps`
with k = 2, also across the bridge (`io/bridge.py::train_state_dicts`)
in the middle of an accumulation.

Tolerance 1e-6 relative: the same fp32 arithmetic in the same order, one
rounding of an op apart (the global norm sums in another order); a value
that a step takes near zero keeps an absolute error of a rounding of the
update, so the floor is a millionth of the learning rate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcdms_tpu.configs import OptimizerConfig as JOptimizerConfig
from rcdms_tpu.train.optim import make_optimizer as jmake_optimizer
from rcdms_tpu.train.optim import make_schedule as jmake_schedule
from rcdms_tpu.train.train_state import TrainState as JTrainState
from rcdms_tpu_torch.configs import OptimizerConfig
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.train.optim import make_optimizer, make_schedule
from rcdms_tpu_torch.train.train_state import TrainState

LR = 1e-3
SHAPES = {"bias": (3,), "weight": (3, 4), "conv": (2, 3, 3, 3)}


def _jcfg(cfg: OptimizerConfig) -> JOptimizerConfig:
    return JOptimizerConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("cfg", [
    OptimizerConfig(learning_rate=LR, warmup_steps=5),
    OptimizerConfig(learning_rate=LR, warmup_steps=0),
    OptimizerConfig(learning_rate=LR, schedule="constant"),
    OptimizerConfig(learning_rate=LR, schedule="cosine", warmup_steps=3,
                    max_steps=20),
    OptimizerConfig(learning_rate=LR, schedule="cosine", warmup_steps=0,
                    max_steps=7),
], ids=["warmup5", "warmup0", "constant", "cosine", "cosine_nowarmup"])
def test_schedules_match_optax(cfg):
    got, want = make_schedule(cfg), jmake_schedule(_jcfg(cfg))
    for count in range(26):
        np.testing.assert_allclose(
            np.float32(got(count)), np.float32(want(jnp.int32(count))),
            rtol=1e-6, atol=1e-6 * LR, err_msg=str(count))


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _t(arrays):
    return {n: torch.tensor(a) for n, a in arrays.items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6 * LR, err_msg=what)


def _run_both(cfg, grad_sets):
    """Every micro-step of `grad_sets` on both sides; yields after each
    (port params, port state, the returned norm, JAX params, JAX state)."""
    tx = jmake_optimizer(_jcfg(cfg))
    jparams = _arrays(0)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    opt = make_optimizer(cfg)
    params = _t(jparams)
    state = opt.init(params)
    for grads in grad_sets:
        norm = opt.update(params, _t(grads), state)
        updates, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        yield params, state, norm, jparams, jstate, grads


def _adam_state(jstate):
    return next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu"))


@pytest.mark.parametrize("clip,scale", [(1.0, 10.0), (100.0, 1.0),
                                        (None, 1.0)],
                         ids=["above", "below", "none"])
def test_three_adamw_steps_match_optax(clip, scale):
    """Warmup 2 (lr 0, then lr / 2), decay 1e-2 on every parameter; the
    gradients' global norm far above the limit, below it, or no limit."""
    cfg = OptimizerConfig(learning_rate=LR, warmup_steps=2,
                          grad_clip_norm=clip, weight_decay=1e-2)
    grad_sets = [_arrays(10 + i, scale) for i in range(3)]
    for i, (params, state, norm, jparams, jstate, grads) in enumerate(
            _run_both(cfg, grad_sets)):
        _close(norm, optax.global_norm(grads), "norm")
        adam = _adam_state(jstate)
        assert state.count == int(adam.count) == i + 1
        for n in SHAPES:
            _close(params[n], jparams[n], f"step {i} {n}")
            _close(state.mu[n], adam.mu[n], f"step {i} mu {n}")
            _close(state.nu[n], adam.nu[n], f"step {i} nu {n}")


def test_clipping_scales_only_above_the_limit():
    """The first Adam step's update is lr * g / (|g| + eps) whatever the
    scale of g, so clipping is read off the first moment: mu = (1 - b1) g
    clipped."""
    for scale, limit in ((10.0, 1.0), (0.01, 1.0)):
        cfg = OptimizerConfig(learning_rate=LR, warmup_steps=0,
                              grad_clip_norm=limit)
        opt = make_optimizer(cfg)
        grads = _t(_arrays(20, scale))
        norm = float(torch.linalg.vector_norm(torch.cat(
            [g.flatten() for g in grads.values()])))
        params = _t(_arrays(0))
        state = opt.init(params)
        want = {n: g * (limit / norm if norm > limit else 1.0)
                for n, g in grads.items()}
        opt.update(params, {n: g.clone() for n, g in grads.items()}, state)
        for n in SHAPES:
            torch.testing.assert_close(state.mu[n], (1 - 0.9) * want[n],
                                       rtol=1e-6, atol=0)


def test_accumulation_matches_multisteps():
    """k = 2 over four micro-steps: the parameters stay as they were on
    the first of each pair, the mean of the two gradients is applied on
    the second, and the Adam count advances once a pair."""
    cfg = OptimizerConfig(learning_rate=LR, warmup_steps=0,
                          grad_clip_norm=1.0, accumulate_steps=2)
    grad_sets = [_arrays(30 + i) for i in range(4)]
    before = _t(_arrays(0))
    for i, (params, state, norm, jparams, jstate, _) in enumerate(
            _run_both(cfg, grad_sets)):
        assert (state.mini_step, state.gradient_step) == (
            int(jstate.mini_step), int(jstate.gradient_step))
        assert state.count == int(_adam_state(jstate).count) == (i + 1) // 2
        if i % 2 == 0:
            assert norm is None
            for n in SHAPES:
                assert torch.equal(params[n], before[n])
                _close(state.acc[n], jstate.acc_grads[n], f"acc {i} {n}")
        else:
            assert norm is not None
            before = {n: p.clone() for n, p in params.items()}
        for n in SHAPES:
            _close(params[n], jparams[n], f"micro-step {i} {n}")


class _Params(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for n, s in SHAPES.items():
            self.register_parameter(n, torch.nn.Parameter(torch.zeros(s)))


def test_bridged_state_continues_an_accumulation():
    """A JAX TrainState after one micro-step of k = 2 (its accumulated
    gradient, moments, counts and step) bridged into the port; the next
    micro-step applies on both sides alike."""
    cfg = OptimizerConfig(learning_rate=LR, warmup_steps=1,
                          grad_clip_norm=1.0, accumulate_steps=2)
    jstate = JTrainState.create(_arrays(0), jmake_optimizer(_jcfg(cfg)))
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for i in range(3):  # an update, then half of the next
        jstate = apply(jstate, _arrays(40 + i))
    state = TrainState.create(_Params(), make_optimizer(cfg))
    state.load_state_dicts(bridge.train_state_dicts(jax.device_get(jstate),
                                                    dict))
    assert (state.step, state.opt_state.count, state.opt_state.mini_step) \
        == (3, 1, 1)
    grads = _arrays(43)
    state.apply_gradients(_t(grads))
    jstate = jax.device_get(apply(jstate, grads))
    want = bridge.train_state_dicts(jstate, dict)
    assert (state.step, state.opt_state.count, state.opt_state.mini_step,
            state.opt_state.gradient_step) == (want["step"], want["count"],
                                               want["mini_step"],
                                               want["gradient_step"])
    for n, p in state.module.named_parameters():
        _close(p.detach(), want["params"][n], n)
        _close(state.opt_state.mu[n], want["mu"][n], f"mu {n}")
        _close(state.opt_state.nu[n], want["nu"][n], f"nu {n}")
