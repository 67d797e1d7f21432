"""AdamW, gradient clipping, accumulation and the learning-rate schedules
of `OptimizerConfig`, computed as optax computes them: the port's
counterpart of `rcdms_tpu/train/optim.py`, which chains
`clip_by_global_norm`, `adamw` and, for `accumulate_steps > 1`,
`optax.MultiSteps`.

Written by hand, because the library versions round otherwise:
`torch.optim.AdamW` decays p by (1 - lr * wd) first and divides
sqrt(nu) by sqrt(1 - b2 ** count), and `clip_grad_norm_` scales by
max / (norm + 1e-6). Here, in optax's order:

  * clipping: g * max / norm where norm > max, else g unchanged;
  * Adam: mu and nu as moving averages, bias-corrected by
    1 - b ** count in fp32 (count after its increment), update
    mu_hat / (sqrt(nu_hat) + eps) (eps_root 0);
  * decoupled decay on every parameter: + weight_decay * p, then
    times -lr, lr read from the schedule at the count before the
    increment;
  * accumulation: the running mean of k micro-gradients (optax's
    acc + (g - acc) / (n + 1)); the parameters are untouched between
    updates and the count advances once per k.

The schedules are evaluated on the host in fp32, as jnp evaluates
optax's. The moments and the parameters are tensors keyed by parameter
name, the moments in their parameter's dtype (fp32 masters, or bf16 ones
with bf16 moments, as optax keeps a bf16 tree's: `TrainState.create`'s
`params_dtype`); the update runs as `torch._foreach_*` ops over chunks of
the tensors, so a step launches a few kernels a chunk and never
synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from rcdms_tpu_torch.configs import OptimizerConfig
from rcdms_tpu_torch.train import distributed
from rcdms_tpu_torch.train.sharding import Shards, chunks

Tensors = Dict[str, torch.Tensor]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: (init - end) * (1 - count / steps) + end."""
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count: int) -> np.float32:
        done = np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * (1 - done) + np.float32(end)
    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"the cosine schedule needs max_steps above "
                         f"warmup_steps, got {decay_steps} decay steps")

    def schedule(count: int) -> np.float32:
        count = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(np.pi) * count / np.float32(decay_steps)))
        return np.float32(init) * cosine
    return schedule


def _join(first: Callable, then: Callable, boundary: int) -> Callable:
    """optax.join_schedules: `first` before the boundary, `then` at
    count - boundary from it."""
    return lambda count: (first(count) if count < boundary
                          else then(count - boundary))


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], np.float32]:
    """The learning rate at an update count, as an fp32 scalar."""
    lr, warmup = cfg.learning_rate, cfg.warmup_steps
    if cfg.schedule == "constant_with_warmup":
        return _join(_linear(0.0, lr, warmup),
                     lambda count: np.float32(lr), warmup)
    if cfg.schedule == "constant":
        return lambda count: np.float32(lr)
    if cfg.schedule == "cosine":
        return _join(_linear(0.0, lr, warmup),
                     _cosine(lr, cfg.max_steps - warmup), warmup)
    raise ValueError(cfg.schedule)


@dataclasses.dataclass
class OptState:
    """Adam's moments and count (updates applied), and the accumulation
    state: micro-steps gathered toward the next update (`mini_step`),
    updates emitted (`gradient_step`) and the running mean (`acc`)."""

    mu: Tensors
    nu: Tensors
    count: int = 0
    mini_step: int = 0
    gradient_step: int = 0
    acc: Optional[Tensors] = None


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in fp32, as jnp computes it (pow on fp32)."""
    f32 = torch.float32
    pow_ = torch.tensor(decay, dtype=f32).pow(torch.tensor(count, dtype=f32))
    return float(1.0 - pow_)


class AdamW:
    """`make_optimizer`'s chain over fp32 parameters and gradients keyed
    by name; `update` changes the parameters in place.

    Under a process group (`train/distributed.py`), `init` cuts the
    optimizer state as the JAX package's ZeRO-2 does (`zero2`; everything
    replicated without it, as its `--no-zero2`), and `update` first
    replaces the gradients by their mean over the ranks, then steps this
    rank's cut of the moments and the masters and all-gathers the
    masters (`train/sharding.py::Shards`). The clip norm is the global
    norm of the full mean gradients, with or without ZeRO-2."""

    def __init__(self, cfg: OptimizerConfig, zero2: bool = True):
        if cfg.accumulate_steps < 1:
            raise ValueError(f"accumulate_steps {cfg.accumulate_steps}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.zero2 = zero2
        self.shards: Optional[Shards] = None

    def init(self, params: Tensors) -> OptState:
        """Zero moments (and accumulator): this rank's cuts under a
        process group, the full tensors without one."""
        if distributed.active():
            self.shards = Shards({n: p.shape for n, p in params.items()},
                                 self.zero2)

        def zeros():
            return {n: torch.zeros_like(self.cut(n, p))
                    for n, p in params.items()}
        return OptState(mu=zeros(), nu=zeros(),
                        acc=zeros() if self.cfg.accumulate_steps > 1
                        else None)

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's cut of the full tensor `t` of parameter `name` (a
        view; `t` itself with no group or where it is replicated)."""
        return t if self.shards is None else self.shards.cut(name, t)

    @torch.no_grad()
    def update(self, params: Tensors, grads: Tensors,
               state: OptState) -> Optional[torch.Tensor]:
        """One micro-step: accumulate `grads` and, on every
        `accumulate_steps`-th call, clip, take the AdamW step on `params`
        and advance `state.count`. Returns the global norm of the
        gradients the step applied (before clipping, a 0-dim device
        tensor), None on a micro-step that only accumulated. `grads` may
        be changed in place."""
        names = list(params)
        k = self.cfg.accumulate_steps
        if self.shards is not None:
            self.shards.all_reduce_mean_(grads)
        mine = {n: self.cut(n, grads[n]) for n in names}
        if k > 1:
            acc = [state.acc[n] for n in names]
            diff = torch._foreach_sub([mine[n] for n in names], acc)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(acc, diff)
            del diff
            if state.mini_step < k - 1:
                state.mini_step += 1
                return None
            state.mini_step = 0
            state.gradient_step += 1
            mine = state.acc
        if k > 1 and self.shards is not None:
            norm = self.shards.global_norm(mine)
        else:  # the full gradients, on every rank
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([(mine if k > 1 else grads)[n]
                                     for n in names])))
        limit = self.cfg.grad_clip_norm
        if limit is not None:  # g / norm * limit where norm >= limit
            below = norm < limit
            g = [mine[n] for n in names]
            torch._foreach_div_(g, torch.where(below, 1.0, norm))
            torch._foreach_mul_(g, torch.where(below, 1.0,
                                               torch.full_like(norm, limit)))
        self._adamw({n: self.cut(n, params[n]) for n in names}, mine, state,
                    names)
        if self.shards is not None:
            self.shards.all_gather_(params)
        if k > 1:
            torch._foreach_zero_([state.acc[n] for n in names])
        return norm

    def _adamw(self, params: Tensors, grads: Tensors, state: OptState,
               names: list) -> None:
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        lr = float(self.schedule(state.count))
        state.count += 1
        bc1 = _bias_correction(b1, state.count)
        bc2 = _bias_correction(b2, state.count)
        for run in chunks(names, params):
            p = [params[n] for n in run]
            g = [grads[n] for n in run]
            mu = [state.mu[n] for n in run]
            nu = [state.nu[n] for n in run]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2, alpha=1 - b2)
            del g2
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, p, alpha=cfg.weight_decay)
            torch._foreach_add_(p, u, alpha=-lr)


def make_optimizer(cfg: OptimizerConfig, zero2: bool = True) -> AdamW:
    return AdamW(cfg, zero2)
