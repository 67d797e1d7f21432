"""One bf16 training step of each stage of the port
(rcdms_tpu_torch/train/) against the JAX trainers at `dtype=bf16`, their
Pallas kernels in interpret mode, on the CPU at the tiny pipeline's
configs; weights, batches and injected noise as test_torch_training.py
builds them.

Tolerances: the loss at 2e-2 relative; the gradient, all tensors as one
vector, at 2e-2 of its L2 norm; the parameters after the step at
2 * lr. A single tensor's bf16 gradient can lie further off: a conv
bias's gradient sums a cotangent over every position, and the two
frameworks round its terms apart (stage 2's conv_out.bias differs by
20%; against the fp32 gradients, the port's bf16 ones lie 1.5% off in L2
and the JAX package's 2.0%). Adam's first update is
lr * g / (|g| + eps), so noise in a near-zero gradient moves a parameter
by up to 2 * lr whatever the gradients' agreement. The compute module's
bf16 copies must equal the masters rounded after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import OptimizerConfig as JOptimizerConfig
from rcdms_tpu.ops import flash as jflash
from rcdms_tpu.ops.attention import set_default_attention_impl
from rcdms_tpu.train.optim import make_optimizer as jmake_optimizer
from rcdms_tpu.train.train_state import TrainState as JTrainState
from rcdms_tpu_torch.configs import OptimizerConfig
from rcdms_tpu_torch.train import loop
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.train_state import TrainState
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)
from tests.test_torch_training import (  # noqa: F401 (fixtures)
    LR,
    _close,
    _noise,
    _np,
    _port_batch,
    _trainers,
    batches,
    encoded,
    tiny,
)


@pytest.fixture
def jax_kernels():
    """The JAX layers routed to their Pallas kernels in interpret mode."""
    jflash.set_kernel_interpret(True)
    set_default_attention_impl("pallas")
    try:
        yield
    finally:
        set_default_attention_impl("auto")
        jflash.set_kernel_interpret(False)


@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_step_matches_jax(tiny, batches, jax_kernels, stage):
    """One bf16 step over fp32 masters against the JAX trainer at
    dtype=bf16; the compute module's bf16 copies equal the masters
    rounded after it."""
    jm, params = tiny
    jtrainer, jparams, trainer, to_sd = _trainers(
        jm, params["live"], jnp.bfloat16)[stage]
    batch, key = batches[stage], jax.random.PRNGKey(5)
    kw = dict(learning_rate=LR, warmup_steps=0, grad_clip_norm=10.0)
    loss, jgrads = jax.jit(jax.value_and_grad(jtrainer.loss_fn))(
        jparams, batch, key)
    state = TrainState.create(trainer, make_optimizer(OptimizerConfig(**kw)),
                              torch.bfloat16)
    got_loss, grads = loop.compute_gradients(
        state, _port_batch(batch), _noise(jtrainer, batch, key))
    _close(got_loss, loss, 2e-2, "loss")
    want = to_sd(jax.tree.map(np.asarray, jgrads))
    assert all(g.dtype == torch.float32 for g in grads.values())
    diff = np.sqrt(sum(np.sum((_np(g) - want[n]) ** 2)
                       for n, g in grads.items()))
    norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert diff <= 2e-2 * norm, diff / norm
    jstate = JTrainState.create(jparams, jmake_optimizer(
        JOptimizerConfig(**kw)))
    jstate = jax.device_get(jax.jit(lambda s, g: s.apply_gradients(g))(
        jstate, jgrads))
    state.apply_gradients(grads)
    new = to_sd(jstate.params)
    for n, p in state.module.named_parameters():
        master = state.params[n]
        np.testing.assert_allclose(master.detach().numpy(), new[n],
                                   rtol=0, atol=2 * LR, err_msg=n)
        assert torch.equal(p, master.to(p.dtype)), n  # rounded again
