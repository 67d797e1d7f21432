"""The training step: the port's counterpart of the step that
`rcdms_tpu/train/loop.py` compiles.

`train_step` zeroes the gradients, computes the trainer's loss on the
batch and its noise, runs the backward pass, widens the gradients to
fp32, and lets the optimizer clip them and step the fp32 masters, whose
values are then rounded into the compute module's copies
(`TrainState.apply_gradients`). The loss comes back as a device tensor,
so a step does not wait for the card, unless the caller asks for a float.

Under a process group (`train/distributed.py`) each rank runs this step
on its rows of the global batch: its noise is its rows of the global
draw (`TrainNoise.draw`), its loss the mean over its rows, and the
optimizer averages the gradients over the ranks before it steps
(`train/optim.py`). With equal local batches, the mean of the ranks'
means is the mean over the global batch, so N ranks compute the JAX
package's sharded step (`make_sharded_train_step`, gradients
replicated). A trainer is a module whose parameters are the trainable
set, with `loss_fn(batch, noise)` and `draw_noise(batch, generator)`
(`train/stage1.py`, `train/stage2.py`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from rcdms_tpu_torch.train.distributed import keep_rows
from rcdms_tpu_torch.train.train_state import TrainState


class TrainNoise(NamedTuple):
    """Every random draw of one training loss, as the JAX trainers draw
    them from their key's three splits: `noise` (fp32 standard normal, the
    target's shape), `offset` (fp32 standard normal, one value a frame in
    stage 1 and a channel of a frame in stage 2; None without a noise
    offset) and the timesteps `t` (int64, one a frame in stage 1 and one a
    story in stage 2)."""

    noise: torch.Tensor
    offset: Optional[torch.Tensor]
    t: torch.Tensor

    @classmethod
    def draw(cls, generator: Optional[torch.Generator], shape: tuple,
             offset_shape: Optional[tuple], t_shape: tuple,
             num_timesteps: int, device) -> "TrainNoise":
        """Drawn from `generator` in this order: noise, offset, t; each of
        the shapes (whose first axis is the local batch) drawn for the
        global batch, this rank keeping its rows
        (`distributed.keep_rows`)."""
        if generator is None:
            raise ValueError("pass explicit noise or a torch.Generator")

        def randn(s):
            return torch.randn(s, generator=generator, device=device)

        noise = keep_rows(randn, shape)
        offset = None if offset_shape is None else keep_rows(randn,
                                                             offset_shape)
        t = keep_rows(lambda s: torch.randint(
            0, num_timesteps, s, generator=generator, device=device),
            t_shape)
        return cls(noise, offset, t)

    def to(self, device) -> "TrainNoise":
        return TrainNoise(*(None if x is None else x.to(device)
                            for x in self))


def compute_gradients(state: TrainState, batch, noise: TrainNoise
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss (a detached 0-dim tensor) and the fp32 gradients of the
    trainable parameters by name, the module's own gradients zeroed
    before and released after."""
    for p in state.module.parameters():
        p.grad = None
    loss = state.module.loss_fn(batch, noise)
    loss.backward()
    return loss.detach(), state.gradients()


def train_step(state: TrainState, batch, noise: Optional[TrainNoise] = None,
               generator: Optional[torch.Generator] = None,
               return_float: bool = False):
    """One (micro-)step on `batch` with `noise`, or noise the trainer
    draws from `generator`; updates `state` in place and returns the loss
    (a 0-dim device tensor, a float with `return_float`)."""
    if noise is None:
        noise = state.module.draw_noise(batch, generator)
    loss, grads = compute_gradients(state, batch, noise)
    state.apply_gradients(grads)
    return loss.item() if return_float else loss
