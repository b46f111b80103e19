"""Gaussian diffusion schedule (port of ``medfusion_tpu/core/schedules.py``).

The tables are built in float64 numpy exactly as the JAX package builds them
and stored as float32 tensors, so both packages hold bit-equal buffers. Every
step function is a plain function of ``(schedule, tensors)``; tensors may be
in any layout, since the math is elementwise per sample.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _make_betas(timesteps: int, schedule_strategy: str, beta_start: float,
                beta_end: float,
                betas: Optional[Sequence[float]] = None) -> np.ndarray:
    """Float64 beta table (``medfusion_tpu/core/schedules.py:25``)."""
    if betas is not None:
        return np.asarray(betas, dtype=np.float64)
    if schedule_strategy == "linear":
        return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)
    if schedule_strategy == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, timesteps,
                           dtype=np.float64) ** 2
    if schedule_strategy == "cosine":
        s = 0.008
        x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
        ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
        ac = ac / ac[0]
        return np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)
    raise NotImplementedError(f"unknown schedule_strategy {schedule_strategy!r}")


@dataclasses.dataclass(frozen=True)
class GaussianDiffusionSchedule:
    """Float32 schedule tables of length T on one device."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_variance: torch.Tensor
    timesteps: int = 1000
    T: int = 1000

    @classmethod
    def create(cls, timesteps: int = 1000, schedule_strategy: str = "cosine",
               beta_start: float = 0.0001, beta_end: float = 0.02,
               betas: Optional[Sequence[float]] = None,
               device="cpu") -> "GaussianDiffusionSchedule":
        b = _make_betas(timesteps, schedule_strategy, beta_start, beta_end, betas)
        alphas = 1.0 - b
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        tables = dict(
            betas=b,
            alphas=alphas,
            alphas_cumprod=ac,
            alphas_cumprod_prev=ac_prev,
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
            posterior_mean_coef1=b * np.sqrt(ac_prev) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
            posterior_variance=b * (1.0 - ac_prev) / (1.0 - ac),
        )
        as_t = lambda v: torch.from_numpy(
            np.asarray(v, np.float64).astype(np.float32)).to(device)
        return cls(**{k: as_t(v) for k, v in tables.items()},
                   timesteps=timesteps, T=timesteps)

    def ddim_timesteps_host(self, steps: int, spacing: str = "linspace") -> np.ndarray:
        """Ascending sub-sampled grid of length ``steps`` (int32 numpy)."""
        if spacing == "linspace":
            vals = np.linspace(0.0, float(self.T - 1), steps)
            return vals.astype(np.int64).astype(np.int32)
        if spacing == "trailing":
            # index-multiply form round(i*T/steps)-1, as the JAX package
            i = np.arange(1, steps + 1, dtype=np.float64)
            vals = np.round(i * (self.T / steps)).astype(np.int64) - 1
            return vals.astype(np.int32)
        raise ValueError(f"unknown timestep spacing {spacing!r}")


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] broadcast to ``ndim`` dims: [B] -> [B, 1, 1, ...]."""
    out = a[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def clip_x0(x_0: torch.Tensor, m: float = 1.0) -> torch.Tensor:
    return torch.clamp(x_0, -m, m)


def _per_sample(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(-1, *([1] * (ndim - 1)))


def q_sample(sched, x_0, t, x_T):
    """Forward diffusion q(x_t | x_0); t<0 -> x_0, t>=T -> x_T."""
    ndim = x_0.ndim
    tc = torch.clamp(t, 0, sched.T - 1)
    x_t = (extract(sched.sqrt_alphas_cumprod, tc, ndim) * x_0
           + extract(sched.sqrt_one_minus_alphas_cumprod, tc, ndim) * x_T)
    tb = _per_sample(t, ndim)
    x_t = torch.where(tb < 0, x_0, x_t)
    return torch.where(tb >= sched.T, x_T, x_t)


def estimate_x_0(sched, x_t, x_T, t, clip: bool = True):
    """Invert q to get x_0 from (x_t, eps)."""
    ndim = x_t.ndim
    x_0 = (extract(sched.sqrt_recip_alphas_cumprod, t, ndim) * x_t
           - extract(sched.sqrt_recipm1_alphas_cumprod, t, ndim) * x_T)
    return clip_x0(x_0) if clip else x_0


def estimate_x_T(sched, x_t, x_0, t, clip: bool = True):
    """Invert q to get eps from (x_t, x_0)."""
    ndim = x_t.ndim
    x_0 = clip_x0(x_0) if clip else x_0
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, ndim) * x_t - x_0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, ndim))


def posterior_mean(sched, x_t, x_0, t):
    ndim = x_t.ndim
    return (extract(sched.posterior_mean_coef1, t, ndim) * x_0
            + extract(sched.posterior_mean_coef2, t, ndim) * x_t)


def posterior_log_variance(sched, t, ndim: int, var_scale=0.0, eps: float = 1e-20):
    """Log posterior variance, interpolated between the posterior (min) and
    beta (max) by ``var_scale``."""
    min_log = torch.log(torch.clamp(extract(sched.posterior_variance, t, ndim), min=eps))
    max_log = torch.log(torch.clamp(extract(sched.betas, t, ndim), min=eps))
    return var_scale * max_log + (1 - var_scale) * min_log


def ancestral_step(sched, x_t, t, x_0, noise, clip: bool = True, var_scale=0.0):
    """DDPM step x_t -> x_{t-1} given predicted x_0. Returns (x_prior, x_0)."""
    ndim = x_t.ndim
    x_0 = clip_x0(x_0) if clip else x_0
    mean = posterior_mean(sched, x_t, x_0, t)
    std = torch.exp(0.5 * posterior_log_variance(sched, t, ndim, var_scale))
    std = torch.where(_per_sample(t, ndim) == 0, torch.zeros_like(std), std)
    return mean + std * noise, x_0


def ancestral_step_from_eps(sched, x_t, t, x_T, noise, clip: bool = True,
                            var_scale=0.0):
    x_0 = estimate_x_0(sched, x_t, x_T, t, clip=clip)
    return ancestral_step(sched, x_t, t, x_0, noise, clip, var_scale)


def ddim_sigma(sched, t, t_next, eta):
    alpha = sched.alphas_cumprod[t]
    alpha_next = sched.alphas_cumprod[t_next]
    return eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))


def ddim_step(sched, x_0, x_T, t, t_next, noise, eta=1.0):
    """DDIM re-mix x_{t_next} = x_0*sqrt(a') + c*eps + sigma*noise."""
    alpha_next = sched.alphas_cumprod[t_next]
    sigma = ddim_sigma(sched, t, t_next, eta)
    # the radicand is clamped at 0: one f32 ulp can make it negative where
    # sigma^2 equals 1 - abar_next exactly in real arithmetic
    c = torch.sqrt(torch.clamp(1 - alpha_next - sigma**2, min=0.0))
    return x_0 * torch.sqrt(alpha_next) + c * x_T + sigma * noise


def estimate_x_0_from_v(sched, x_t, v, t, clip: bool = True):
    """x_0 = sqrt(abar_t)*x_t - sqrt(1-abar_t)*v."""
    ndim = x_t.ndim
    x_0 = (extract(sched.sqrt_alphas_cumprod, t, ndim) * x_t
           - extract(sched.sqrt_one_minus_alphas_cumprod, t, ndim) * v)
    return clip_x0(x_0) if clip else x_0
