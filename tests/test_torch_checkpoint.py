"""The port's training checkpoints (rcdms_tpu_torch/io/checkpoint.py)
against the JAX package's orbax ones (rcdms_tpu/io/checkpoint.py): the
same API, layout rules and resume semantics, bit for bit.

* a round trip keeps every tensor's bits and dtype, the step and the
  metadata; `max_to_keep`; `latest_step`; a missing or empty directory
  raises; a temporary directory left by a save that was cut short is not
  a step;
* a save at or below the latest step on disk is skipped, the first one
  kept, as orbax's `CheckpointManager` skips it (both run in one test);
* a JAX stage-1 `TrainState` saved and restored by orbax, carried across
  by `io/bridge.py::train_state_dicts`, then saved and restored by the
  port, equals the JAX arrays bit for bit, and so does the port
  `TrainState` it loads into (`state_dicts`, the inverse of
  `load_state_dicts`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcdms_tpu.configs import OptimizerConfig as JOptimizerConfig
from rcdms_tpu.io import checkpoint as jckpt
from rcdms_tpu.models.prior import FramePrior as JPrior
from rcdms_tpu.train.optim import make_optimizer as jmake_optimizer
from rcdms_tpu.train.train_state import TrainState as JTrainState
from rcdms_tpu_torch.configs import OptimizerConfig, PriorConfig
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.io.checkpoint import (
    METADATA_FILE,
    STATE_FILE,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from rcdms_tpu_torch.models.prior import FramePrior
from rcdms_tpu_torch.train.optim import make_optimizer
from rcdms_tpu_torch.train.stage1 import Stage1Trainer
from rcdms_tpu_torch.train.train_state import TrainState
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)


def _tree(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(3, 4, generator=g),
                   "b": torch.randn(4, generator=g).bfloat16()},
        "ids": torch.randint(0, 9, (5,), generator=g),
        "mask": torch.rand(6, generator=g) > 0.5,
        "acc": None, "count": 7, "step": 14,
    }


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _equal(got, want, where="state"):
    """The same tree, each tensor of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        if want.is_floating_point():  # the bits: signed zeros, NaNs
            got, want = (x.view(_BITS[x.itemsize]) for x in (got, want))
        assert torch.equal(got, want), where
    else:
        assert got == want, where


def test_round_trip_keeps_bits_dtypes_step_and_metadata(tmp_path):
    d = str(tmp_path / "ckpt")
    a, b = _tree(0), _tree(1)
    assert save_checkpoint(d, 7, a, {"last_global_step": 7, "epoch": 1})
    assert save_checkpoint(d, 14, b, {"last_global_step": 14, "epoch": 2})
    assert latest_step(d) == 14
    assert sorted(os.listdir(os.path.join(d, "14"))) == [METADATA_FILE,
                                                         STATE_FILE]
    state, meta, step = restore_checkpoint(d)
    assert step == 14 and meta == {"last_global_step": 14, "epoch": 2}
    _equal(state, b)
    state7, meta7, step7 = restore_checkpoint(d, step=7)
    assert step7 == 7 and meta7["epoch"] == 1
    _equal(state7, a)


def test_restore_into_a_target_keeps_its_tensors(tmp_path):
    d = str(tmp_path / "ckpt")
    src = _tree(2)
    save_checkpoint(d, 3, src)
    target = _tree(5)
    w = target["params"]["w"]
    got, _, _ = restore_checkpoint(d, target)
    assert got["params"]["w"] is w  # copied into the target's tensor
    _equal(got, src)
    with pytest.raises(KeyError, match="keys differ"):
        restore_checkpoint(d, {"params": {"w": torch.zeros(3, 4)}})
    bad = _tree(5)
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="state.params.w"):
        restore_checkpoint(d, bad)


def test_max_to_keep_keeps_the_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(d, step, {"step": step}, max_to_keep=2)
    assert sorted(os.listdir(d)) == ["4", "5"]
    assert restore_checkpoint(d)[0] == {"step": 5}


def test_missing_empty_and_partial_directories(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))
    assert latest_step(str(tmp_path / "none")) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(empty))
    assert latest_step(str(empty)) is None
    # a save cut short leaves its temporary sibling: never a step
    d = tmp_path / "ckpt"
    save_checkpoint(str(d), 2, {"step": 2})
    (d / ".9.tmp-123").mkdir()
    (d / ".9.tmp-123" / STATE_FILE).write_bytes(b"partial")
    assert latest_step(str(d)) == 2
    assert restore_checkpoint(str(d))[2] == 2
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(d), step=9)


def test_a_second_save_at_a_step_keeps_the_first_as_orbax_does(tmp_path):
    """The training CLIs save step N twice when N is a multiple of
    --checkpointing-steps (the periodic save and the final one); orbax
    keeps the first, and so does the port. A save below the latest step
    is skipped too."""
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    for i, step in enumerate((2, 2, 1)):
        jckpt.save_checkpoint(jd, step, {"w": jnp.full((2,), float(i))},
                              {"last_global_step": step, "save": i})
        save_checkpoint(pd, step, {"w": torch.full((2,), float(i))},
                        {"last_global_step": step, "save": i})
    jstate, jmeta, jstep = jckpt.restore_checkpoint(jd, {"w": jnp.zeros(2)})
    state, meta, step = restore_checkpoint(pd)
    assert (jstep, jmeta) == (step, meta) == (2, {"last_global_step": 2,
                                                  "save": 0})
    np.testing.assert_array_equal(np.asarray(jstate["w"]),
                                  state["w"].numpy())
    assert jckpt.latest_step(jd) == latest_step(pd) == 2
    assert sorted(os.listdir(pd)) == ["2"]


def _jax_stage1_state(cfg):
    """A tiny JAX stage-1 TrainState three micro-steps in (MultiSteps
    k = 2: one AdamW update, then a live accumulator), on seeded numpy
    parameters and gradients."""
    f, t, dim = cfg.num_frames, cfg.num_text_tokens, cfg.embedding_dim
    z = jnp.zeros
    shapes = jax.eval_shape(
        JPrior(cfg).init, jax.random.PRNGKey(0), z((1, f, dim)),
        z((1, f), jnp.int32), z((1, f, dim)), z((1, f, t, dim)),
        z((1, f, dim)), z((1, f, dim)), jnp.ones((1, f, t), bool))
    rng = np.random.default_rng(3)

    def draw(leaf, scale=0.1):
        return jnp.asarray(scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    state = JTrainState.create(
        jax.tree.map(draw, shapes), jmake_optimizer(JOptimizerConfig(
            learning_rate=1e-3, warmup_steps=0, accumulate_steps=2)))
    for _ in range(3):
        state = state.apply_gradients(grads=jax.tree.map(draw, shapes))
    return state


def test_jax_state_through_the_port_checkpoint(tmp_path):
    from rcdms_tpu.configs import PriorConfig as JPriorConfig

    jcfg = JPriorConfig.tiny()
    cfg = port_config(jcfg)
    assert isinstance(cfg, PriorConfig)
    jstate = _jax_stage1_state(jcfg)
    jd = str(tmp_path / "jax")
    tree = {"params": jstate.params, "opt_state": jstate.opt_state,
            "step": jstate.step}
    jckpt.save_checkpoint(jd, 3, tree, {"last_global_step": 3})
    restored, jmeta, _ = jckpt.restore_checkpoint(jd, tree)
    jstate = jax.device_get(jstate.replace(**restored))

    def to_sd(p):
        return bridge.stage1_state_dict(p, cfg)

    want = bridge.train_state_dicts(jstate, to_sd)
    assert want["acc"] is not None and want["mini_step"] == 1
    as_tensors = {k: v if not isinstance(v, dict) else {
        n: torch.from_numpy(np.array(a)) for n, a in v.items()}
        for k, v in want.items()}
    pd = str(tmp_path / "port")
    save_checkpoint(pd, 3, as_tensors, jmeta)
    got, meta, step = restore_checkpoint(pd)
    assert (step, meta) == (3, {"last_global_step": 3})
    for key in ("params", "mu", "nu", "acc"):
        assert set(got[key]) == set(want[key]), key
        for n, a in want[key].items():
            t = got[key][n]
            assert t.dtype == torch.float32, (key, n)
            np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                          np.asarray(a).view(np.uint32),
                                          err_msg=f"{key} {n}")
    for key in ("count", "mini_step", "gradient_step", "step"):
        assert got[key] == want[key], key

    # into a port TrainState of the same prior, and out again
    state = TrainState.create(Stage1Trainer(FramePrior(cfg)), make_optimizer(
        OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                        accumulate_steps=2)))
    state.load_state_dicts(got)
    out = state.state_dicts()
    for key, own in (("params", state.params), ("mu", state.opt_state.mu)):
        assert all(out[key][n].data_ptr() == t.data_ptr()
                   for n, t in own.items()), key  # the state's own tensors
    _equal(out, got)
