"""Reverse-diffusion sampling (the JAX ``diffusion/sampler.py``): DDPM

  x_prev = (1/sqrt(a_t)) * (x - (1-a_t)/sqrt(1-abar_t) * eps_hat)
           + [t > 0] * sqrt(b_t) * z,   z ~ N(0, I)

and DDIM (deterministic at eta = 0), on a respaced schedule: for K < T
steps the timestep subsequence is strided and per-step betas are
re-derived from the cumprod ratio. The K-step loop is a Python loop; the
per-step coefficients are fp32 scalars, as in JAX. Both samplers take one
noise draw per step (DDIM too, even where sigma is 0, as JAX draws from
``fold_in(key, i)`` every step), from a ``torch.Generator`` or supplied as
``noise_seq``. Each iteration is a ``sampler.step`` span (attr ``step``, the
loop index; ``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span
from .schedule import NoiseSchedule


def respaced_timesteps(num_train_steps: int,
                       num_sample_steps: int) -> np.ndarray:
    """Descending timestep subsequence, evenly strided, always ending at 0."""
    if not 1 <= num_sample_steps <= num_train_steps:
        raise ValueError(f"num_sample_steps {num_sample_steps} outside "
                         f"[1, {num_train_steps}]")
    taus = np.linspace(0, num_train_steps - 1, num_sample_steps)
    taus = np.unique(np.round(taus).astype(np.int64))
    return taus[::-1].copy()


def _respaced_coeffs(schedule: NoiseSchedule, timesteps: np.ndarray):
    """Per-step (taus, abar_t, abar_prev, beta_t, alpha_t), fp32 on the CPU."""
    ac = schedule.alphas_cumprod
    taus = torch.from_numpy(np.asarray(timesteps, np.int64))
    abar = ac[taus]
    abar_prev = torch.cat([ac[taus[1:]], torch.ones(1, dtype=ac.dtype)])
    beta = 1.0 - abar / abar_prev
    alpha = 1.0 - beta
    return taus, abar, abar_prev, beta, alpha


def to_eps(pred, x, abar_t, prediction_type: str):
    """The eps implied by a model output under the eps / x0 / v targets."""
    if prediction_type == "eps":
        return pred
    if prediction_type == "x0":
        return (x - torch.sqrt(abar_t) * pred) / torch.sqrt(1.0 - abar_t)
    if prediction_type == "v":
        return torch.sqrt(1.0 - abar_t) * x + torch.sqrt(abar_t) * pred
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def _clip_eps(x, eps, abar_t, clip: float):
    """Clamp the implied x0_hat to [-clip, clip]; return the matching eps."""
    x0_hat = (x - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
    x0_hat = torch.clamp(x0_hat, -clip, clip)
    return (x - torch.sqrt(abar_t) * x0_hat) / torch.sqrt(1.0 - abar_t)


def ddpm_sample(model_fn: Callable, x_init, schedule: NoiseSchedule,
                timesteps: np.ndarray, *, noise_seq=None,
                generator: Optional[torch.Generator] = None,
                clip_denoised: Optional[float] = None,
                prediction_type: str = "eps"):
    """DDPM ancestral sampling.

    model_fn(x, t) -> model output, t: [B] int64 (original timestep index).
    noise_seq: optional [K, B, ...] noise, one draw per step; otherwise z is
    drawn from ``generator`` on x's device.
    """
    taus, abar, _, beta, alpha = _respaced_coeffs(schedule, timesteps)
    x = x_init
    batch = x.shape[0]
    for i in range(taus.shape[0]):
        with span("sampler.step", step=i):
            t = int(taus[i])
            abar_t, beta_t, alpha_t = abar[i], beta[i], alpha[i]
            t_vec = torch.full((batch,), t, dtype=torch.int64,
                               device=x.device)
            eps = to_eps(model_fn(x, t_vec), x, abar_t, prediction_type)
            if clip_denoised is not None:
                eps = _clip_eps(x, eps, abar_t, clip_denoised)
            mean = (x - (1.0 - alpha_t) / torch.sqrt(1.0 - abar_t) * eps) \
                / torch.sqrt(alpha_t)
            if noise_seq is None:
                z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
            else:
                z = noise_seq[i]
            nonzero = 1.0 if t > 0 else 0.0
            x = mean + nonzero * torch.sqrt(beta_t) * z
    return x


def ddim_sample(model_fn: Callable, x_init, schedule: NoiseSchedule,
                timesteps: np.ndarray, *, eta: float = 0.0, noise_seq=None,
                generator: Optional[torch.Generator] = None,
                clip_denoised: Optional[float] = None,
                prediction_type: str = "eps"):
    """DDIM sampling (deterministic at eta = 0) on a respaced schedule.

    Arguments as ``ddpm_sample``. The clipped x0 gives back its eps;
    sigma = eta * sqrt((1 - abar_prev) / (1 - abar_t))
    * sqrt(1 - abar_t / abar_prev)."""
    taus, abar, abar_prev, _, _ = _respaced_coeffs(schedule, timesteps)
    x = x_init
    batch = x.shape[0]
    for i in range(taus.shape[0]):
        with span("sampler.step", step=i):
            t = int(taus[i])
            abar_t, abar_p = abar[i], abar_prev[i]
            t_vec = torch.full((batch,), t, dtype=torch.int64,
                               device=x.device)
            eps = to_eps(model_fn(x, t_vec), x, abar_t, prediction_type)
            x0 = (x - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
            if clip_denoised is not None:
                x0 = torch.clamp(x0, -clip_denoised, clip_denoised)
                eps = (x - torch.sqrt(abar_t) * x0) \
                    / torch.sqrt(1.0 - abar_t)
            sigma = eta * torch.sqrt((1.0 - abar_p) / (1.0 - abar_t)) \
                * torch.sqrt(1.0 - abar_t / abar_p)
            dir_xt = torch.sqrt(torch.clamp(1.0 - abar_p - sigma ** 2,
                                            min=0.0)) * eps
            if noise_seq is None:
                z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
            else:
                z = noise_seq[i]
            nonzero = 1.0 if t > 0 else 0.0
            x = torch.sqrt(abar_p) * x0 + dir_xt + nonzero * sigma * z
    return x
