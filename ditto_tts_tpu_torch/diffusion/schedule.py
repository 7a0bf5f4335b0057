"""Noise schedules and forward diffusion (the JAX ``diffusion/schedule.py``).

Cosine beta schedule: alphas_cumprod(x) = cos^2(((x/T)+s)/(1+s) * pi/2)
normalized at 0, betas = 1 - cumprod ratio, clipped to [1e-4, 0.9999].

Quirk #1: the reference trains q_sample against the *betas* as if they
were alpha-bar; ``q_sample(..., ref_compat=True)`` reproduces that, the
default is the correct forward process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule betas, computed in float64 then cast (stable tail)."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1.0 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0.0001, 0.9999).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor            # [T] fp32, on the CPU unless moved
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor

    @classmethod
    def cosine(cls, timesteps: int, s: float = 0.008) -> "NoiseSchedule":
        betas = torch.from_numpy(cosine_beta_schedule(timesteps, s))
        alphas = 1.0 - betas
        return cls(betas=betas, alphas=alphas,
                   alphas_cumprod=torch.cumprod(alphas, dim=0))

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "NoiseSchedule":
        """The same tables on ``device`` (a training step indexes them
        with t drawn there, without a host round trip)."""
        return NoiseSchedule(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


def q_sample(schedule: NoiseSchedule, x_start, t, noise, *,
             ref_compat: bool = False):
    """x_t ~ q(x_t | x_0). t: [B] int on either device (it indexes the
    tables where they lie); x_start / noise: [B, ...]."""
    coef = schedule.betas if ref_compat else schedule.alphas_cumprod
    c = coef[t.to(coef.device)].to(x_start.device)
    c = c.reshape((-1,) + (1,) * (x_start.dim() - 1))
    return torch.sqrt(c) * x_start + torch.sqrt(1.0 - c) * noise
