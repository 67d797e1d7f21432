"""Diffusion schedulers over float64 tables.

The port's counterpart of `rcdms_tpu/core/schedulers.py`:

  * stage-1 sampling: UnCLIP (squaredcos_cap_v2 betas, prediction
    'sample', fixed_small_log variance, clip 10) with an explicit
    `prev_timestep`;
  * stage-2 sampling: DDIM (linear 0.00085 -> 0.012, 'leading' spacing,
    set_alpha_to_one, clip 1), eta = 0 by default; eta > 0 adds the
    stochastic term, on noise the caller supplies;
  * training: DDPM (stage 1 squaredcos_cap_v2 with 'sample' prediction,
    stage 2 scaled_linear 0.00085 -> 0.012 with 'epsilon'), its forward
    process `add_noise`, the v target `velocity` and the ancestral `step`.

The samplers' timesteps are plain ints (PyTorch runs eagerly), so their
per-step coefficients are Python floats taken from the float64 tables.
Training draws a timestep per story or per frame, so DDPM's methods take
an integer tensor t of shape (b,) or (b, f) and gather fp32 coefficients
from the tables, as the JAX package's `_gather` does: a (b, f) t
broadcasts over the sample's trailing axes, and a bf16 sample promotes to
fp32 against them, as jnp's promotion makes it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import numpy as np
import torch


def make_betas(schedule: str, num_train_timesteps: int = 1000,
               beta_start: float = 0.0001,
               beta_end: float = 0.02) -> np.ndarray:
    """Beta tables with diffusers semantics (float64)."""
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(num_train_timesteps, dtype=np.float64)
        betas = 1.0 - alpha_bar((ts + 1) / num_train_timesteps) / alpha_bar(
            ts / num_train_timesteps)
        return np.minimum(betas, 0.999)
    raise ValueError(f"unknown beta schedule: {schedule}")


@dataclass(frozen=True)
class DiffusionSchedule:
    """Shared alpha/beta tables and the x0 prediction."""

    beta_schedule: str = "linear"
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    prediction_type: str = "epsilon"   # epsilon | sample | v_prediction
    clip_sample: bool = False
    clip_sample_range: float = 1.0

    @cached_property
    def betas(self) -> np.ndarray:
        return make_betas(self.beta_schedule, self.num_train_timesteps,
                          self.beta_start, self.beta_end)

    @cached_property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @cached_property
    def one_minus_alphas_cumprod(self) -> np.ndarray:
        # in float64, against fp32 cancellation at small t
        return 1.0 - self.alphas_cumprod

    def _acp(self, t: int) -> float:
        """alphas_cumprod[t], and 1.0 before the start (set_alpha_to_one)."""
        return float(self.alphas_cumprod[t]) if t >= 0 else 1.0

    @staticmethod
    def _gather(table: np.ndarray, t: torch.Tensor,
                ndim: int) -> torch.Tensor:
        """table[t] in fp32, shaped (t.shape + (1,) * ...) to broadcast
        against a sample of `ndim` dims whose leading axes are t's."""
        vals = torch.as_tensor(table, dtype=torch.float32,
                               device=t.device)[t]
        return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))

    def _sqrt_coefs(self, t, ndim: int):
        """(sqrt(acp_t), sqrt(1 - acp_t)): Python floats from the float64
        tables for an int t (the samplers), fp32 tensors gathered by
        `_gather` for an integer tensor t (DDPM)."""
        if isinstance(t, torch.Tensor):
            return (self._gather(self.alphas_cumprod, t, ndim).sqrt(),
                    self._gather(self.one_minus_alphas_cumprod, t,
                                 ndim).sqrt())
        acp = self._acp(t)
        return math.sqrt(acp), math.sqrt(1.0 - acp)

    def pred_x0(self, model_output: torch.Tensor, sample: torch.Tensor,
                t) -> torch.Tensor:
        """x0 from the model output at timestep t (an int or an integer
        tensor, `_sqrt_coefs`)."""
        sqrt_acp, sqrt_omacp = self._sqrt_coefs(t, sample.dim())
        if self.prediction_type == "epsilon":
            x0 = (sample - sqrt_omacp * model_output) / sqrt_acp
        elif self.prediction_type == "sample":
            x0 = model_output
        elif self.prediction_type == "v_prediction":
            x0 = sqrt_acp * sample - sqrt_omacp * model_output
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        return x0


@dataclass(frozen=True)
class DDPMSchedule(DiffusionSchedule):
    """diffusers `DDPMScheduler` with fixed-small variance: the training
    forward process and the ancestral step, over integer tensor t."""

    @classmethod
    def stage1_train(cls) -> "DDPMSchedule":
        return cls(beta_schedule="squaredcos_cap_v2",
                   prediction_type="sample", clip_sample=True,
                   clip_sample_range=1.0)

    @classmethod
    def stage2_train(cls) -> "DDPMSchedule":
        return cls(beta_schedule="scaled_linear", beta_start=0.00085,
                   beta_end=0.012, prediction_type="epsilon",
                   clip_sample=True, clip_sample_range=1.0)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) noise."""
        sqrt_acp, sqrt_omacp = self._sqrt_coefs(t, x0.dim())
        return sqrt_acp * x0 + sqrt_omacp * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """The v-prediction target sqrt(acp_t) noise - sqrt(1 - acp_t) x0."""
        sqrt_acp, sqrt_omacp = self._sqrt_coefs(t, x0.dim())
        return sqrt_acp * noise - sqrt_omacp * x0

    def step(self, model_output: torch.Tensor, t: torch.Tensor,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One ancestral step x_t -> x_{t-1} on caller-supplied noise; no
        noise where t = 0."""
        ndim = sample.dim()
        first = (t > 0).reshape(t.shape + (1,) * (ndim - t.dim()))
        prev = (t - 1).clamp_min(0)
        acp_prev = torch.where(
            first, self._gather(self.alphas_cumprod, prev, ndim), 1.0)
        beta_prod_prev = torch.where(
            first, self._gather(self.one_minus_alphas_cumprod, prev, ndim),
            0.0)
        beta_t = self._gather(self.betas, t, ndim)
        beta_prod_t = self._gather(self.one_minus_alphas_cumprod, t, ndim)
        x0 = self.pred_x0(model_output, sample, t)
        mean = (acp_prev.sqrt() * beta_t / beta_prod_t * x0
                + (1.0 - beta_t).sqrt() * beta_prod_prev / beta_prod_t
                * sample)
        var = (beta_prod_prev / beta_prod_t * beta_t).clamp_min(1e-20)
        return mean + first.to(mean.dtype) * var.sqrt() * noise


@dataclass(frozen=True)
class DDIMSchedule(DiffusionSchedule):
    """diffusers `DDIMScheduler`, 'leading' spacing."""

    clip_sample: bool = True

    @classmethod
    def stage2_inference(cls) -> "DDIMSchedule":
        return cls(beta_schedule="linear", beta_start=0.00085,
                   beta_end=0.012)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        return ts.astype(np.int64)

    def prev_timesteps(self, num_inference_steps: int) -> np.ndarray:
        return (self.timesteps(num_inference_steps)
                - self.num_train_timesteps // num_inference_steps)

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM step x_t -> x_{prev_t}; prev_t < 0 on the last step.
        eta > 0 takes sigma = eta * sqrt(var) off the direction term and
        adds sigma * noise; it raises without `noise`."""
        acp_t, acp_prev = self._acp(t), self._acp(prev_t)
        omacp_t, omacp_prev = 1.0 - acp_t, 1.0 - acp_prev
        x0 = self.pred_x0(model_output, sample, t)
        # epsilon re-derived from the (clipped) x0, as diffusers does
        eps = (sample - math.sqrt(acp_t) * x0) / math.sqrt(omacp_t)
        sigma = 0.0
        if eta > 0.0:
            if noise is None:
                raise ValueError("eta>0 requires externally supplied noise")
            var = (omacp_prev / omacp_t) * (1.0 - acp_t / acp_prev)
            sigma = eta * math.sqrt(var)
        prev = math.sqrt(acp_prev) * x0 + math.sqrt(
            omacp_prev - sigma ** 2) * eps
        return prev + sigma * noise if eta > 0.0 else prev


@dataclass(frozen=True)
class UnCLIPSchedule(DiffusionSchedule):
    """diffusers `UnCLIPScheduler` with explicit prev_timestep
    (Kandinsky-2.2 prior config)."""

    beta_schedule: str = "squaredcos_cap_v2"
    prediction_type: str = "sample"
    clip_sample: bool = True
    clip_sample_range: float = 10.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """'trailing linspace' spacing."""
        if num_inference_steps == 1:
            return np.array([self.num_train_timesteps - 1], dtype=np.int64)
        step_ratio = (self.num_train_timesteps - 1) / (num_inference_steps - 1)
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        return ts.astype(np.int64)

    def prev_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The next entry of the table; t - 1 after the last."""
        ts = self.timesteps(num_inference_steps)
        return np.concatenate([ts[1:], ts[-1:] - 1])

    def step(self, model_output: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One UnCLIP ancestral step x_t -> x_{prev_t}."""
        acp_t, acp_prev = self._acp(t), self._acp(prev_t)
        beta_prod_t, beta_prod_prev = 1.0 - acp_t, 1.0 - acp_prev
        if prev_t == t - 1:
            beta = float(self.betas[t])
        else:
            beta = 1.0 - acp_t / acp_prev
        x0 = self.pred_x0(model_output, sample, t)
        mean = (math.sqrt(acp_prev) * beta / beta_prod_t * x0
                + math.sqrt(1.0 - beta) * beta_prod_prev / beta_prod_t
                * sample)
        if t <= 0:
            return mean
        var = max(beta_prod_prev / beta_prod_t * beta, 1e-20)
        return mean + math.exp(0.5 * math.log(var)) * noise


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Classifier-free guidance mix."""
    return uncond + scale * (cond - uncond)
