"""Gaussian diffusion schedule (port of ``medfusion_tpu/core/schedules.py``).

The tables are built in float64 numpy exactly as the JAX package builds them
and stored as float32 tensors, so both packages hold bit-equal buffers. Every
step function is a plain function of ``(schedule, tensors)``; tensors may be
in any layout, since the math is elementwise per sample.

A zero-terminal-SNR schedule (``create(zero_terminal_snr=True)``) has
abar_T = 0 exactly, so its reciprocal tables hold +inf at the terminal step
by construction, as the JAX package's do; nothing is clamped. The ``_safe``
and ``_from_v`` inversions stay finite there.
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


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Betas whose terminal SNR is exactly zero (arXiv:2305.08891 Alg. 1):
    sqrt(abar) shifted to 0 at T and rescaled to keep sqrt(abar_1)."""
    b = np.asarray(betas, dtype=np.float64)
    abar_sqrt = np.sqrt(np.cumprod(1.0 - b))
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar = ((abar_sqrt - aT) * (a0 / (a0 - aT))) ** 2
    return 1.0 - np.concatenate([abar[:1], abar[1:] / abar[:-1]])


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
    zero_terminal_snr: bool = False

    @classmethod
    def create(cls, timesteps: int = 1000, schedule_strategy: str = "cosine",
               beta_start: float = 0.0001, beta_end: float = 0.02,
               betas: Optional[Sequence[float]] = None,
               device="cpu", zero_terminal_snr: bool = False) -> "GaussianDiffusionSchedule":
        b = _make_betas(timesteps, schedule_strategy, beta_start, beta_end, betas)
        if zero_terminal_snr:
            b = rescale_zero_terminal_snr(b)
        alphas = 1.0 - b
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        with np.errstate(divide="ignore"):  # 1/abar_T = inf at zero terminal SNR
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
                   timesteps=timesteps, T=timesteps, zero_terminal_snr=zero_terminal_snr)

    def timesteps_host(self) -> np.ndarray:
        """The ancestral grid [0 .. T-1] (int64 numpy)."""
        return np.linspace(0, self.T - 1, self.timesteps).astype(np.int64)

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


def estimate_x_T_safe(sched, x_t, x_0, t, clip: bool = True):
    """eps from (x_t, x_0) as (x_t - sqrt(abar)*x_0) / sqrt(1-abar): the
    form of :func:`estimate_x_T` that stays finite at abar_t = 0."""
    ndim = x_t.ndim
    x_0 = clip_x0(x_0) if clip else x_0
    return ((x_t - extract(sched.sqrt_alphas_cumprod, t, ndim) * x_0)
            / extract(sched.sqrt_one_minus_alphas_cumprod, t, ndim))


def posterior_variance(sched, t, ndim: int, log: bool = True, var_scale=0.0,
                       eps: float = 1e-20):
    """Posterior variance (its log with ``log``), interpolated between the
    posterior (min) and beta (max) by ``var_scale``."""
    min_var = extract(sched.posterior_variance, t, ndim)
    max_var = extract(sched.betas, t, ndim)
    if log:
        min_var = torch.log(torch.clamp(min_var, min=eps))
        max_var = torch.log(torch.clamp(max_var, min=eps))
    return var_scale * max_var + (1 - var_scale) * min_var


def ancestral_step(sched, x_t, t, x_0, noise, clip: bool = True, var_scale=0.0):
    """DDPM step x_t -> x_{t-1} given predicted x_0. Returns (x_prior, x_0)."""
    ndim = x_t.ndim
    x_0 = clip_x0(x_0) if clip else x_0
    mean = posterior_mean(sched, x_t, x_0, t)
    std = torch.exp(0.5 * posterior_variance(sched, t, ndim, var_scale=var_scale))
    std = torch.where(_per_sample(t, ndim) == 0, torch.zeros_like(std), std)
    return mean + std * noise, x_0


def ancestral_step_from_eps(sched, x_t, t, x_T, noise, clip: bool = True,
                            var_scale=0.0):
    x_0 = estimate_x_0(sched, x_t, x_T, t, clip=clip)
    return ancestral_step(sched, x_t, t, x_0, noise, clip, var_scale)


def cold_diffusion_step(sched, x_t, t, x_0, clip: bool = True):
    """Cold-diffusion step: x_t - (D(x_0, t) - D(x_0, t-1)), D re-noising
    with the eps implied by (x_t, x_0). Returns (x_prior, x_0)."""
    x_0 = clip_x0(x_0) if clip else x_0
    x_T_est = estimate_x_T_safe(sched, x_t, x_0, t, clip=False)
    x_t_est = q_sample(sched, x_0, t, x_T_est)
    x_t_prior = q_sample(sched, x_0, t - 1, x_T_est)
    return x_t - (x_t_est - x_t_prior), x_0


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


def v_target(sched, x_0, eps, t):
    """v-prediction target v = sqrt(abar_t)*eps - sqrt(1-abar_t)*x_0."""
    ndim = x_0.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, ndim) * eps
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, ndim) * x_0)


def estimate_x_T_from_v(sched, x_t, v, t):
    """eps = sqrt(1-abar_t)*x_t + sqrt(abar_t)*v, finite for every t."""
    ndim = x_t.ndim
    return (extract(sched.sqrt_one_minus_alphas_cumprod, t, ndim) * x_t
            + extract(sched.sqrt_alphas_cumprod, t, ndim) * v)


def snr(sched, t):
    """abar_t / (1 - abar_t) per sample ([B])."""
    ab = sched.alphas_cumprod[t]
    return ab / (1.0 - ab)


def min_snr_weight(sched, t, gamma: float, objective: str):
    """Min-SNR-gamma per-sample loss weight (arXiv:2303.09556) in the
    objective's space: eps min(SNR, g)/SNR, x_0 min(SNR, g), v
    min(SNR, g)/(SNR+1); 1 at SNR = 0 (a zero-SNR terminal step) for v and
    x_0, as the JAX package keeps the terminal step trained."""
    s = snr(sched, t)
    clamped = torch.clamp(s, max=gamma)
    if objective == "x_T":
        return clamped / torch.clamp(s, min=1e-20)
    one = torch.ones_like(s)
    if objective == "v":
        return torch.where(s == 0.0, one, clamped / (s + 1.0))
    return torch.where(s == 0.0, one, clamped)


def kdiff_sigmas(sched):
    """k-diffusion noise levels sqrt((1-abar_t)/abar_t), [T] ascending."""
    ab = sched.alphas_cumprod
    return torch.sqrt((1.0 - ab) / ab)


def karras_sigma_grid(sigma_min, sigma_max, n: int, rho: float = 7.0):
    """``n`` levels from sigma_max down to sigma_min, even in sigma^(1/rho)
    (arXiv:2206.00364 eq. 5), then 0: length n + 1, float32. The ramp is
    i/(n-1) in float32, as ``jnp.linspace(0, 1, n)`` makes it."""
    sigma_min = torch.as_tensor(sigma_min, dtype=torch.float32)
    sigma_max = torch.as_tensor(sigma_max, dtype=torch.float32, device=sigma_min.device)
    dev = sigma_min.device
    ramp = torch.arange(n, dtype=torch.float32, device=dev) / max(n - 1, 1)
    inv_rho = 1.0 / rho
    hi = sigma_max ** inv_rho
    sig = (hi + ramp * (sigma_min ** inv_rho - hi)) ** rho
    return torch.cat([sig, torch.zeros(1, device=dev)])


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` (constant beyond the ends), its arithmetic
    step for step."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def sigma_to_t_frac(sched, sigma):
    """The fractional timestep of a k-diffusion sigma: log-sigma
    interpolated over the schedule's own table (float32)."""
    log_tab = torch.log(kdiff_sigmas(sched))
    grid = torch.arange(sched.T, dtype=torch.float32, device=log_tab.device)
    x = torch.log(torch.clamp(torch.as_tensor(sigma, dtype=torch.float32,
                                              device=log_tab.device), min=1e-20))
    return _interp(x.reshape(-1), log_tab, grid).reshape(x.shape)


def kl_gaussians(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) per element."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


# Stable Diffusion's schedule helpers: host numpy in float64, as the JAX
# package builds them.

def sd_make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                          linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """SD's ``make_beta_schedule``: its 'linear' is linear in sqrt(beta)
    (this package's 'scaled_linear'), 'sqrt_linear' linear in beta, 'sqrt'
    the square root of that, 'cosine' the cosine alpha-bar clipped at
    0.999."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        x = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(x / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


def sd_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                      method: str = "uniform") -> np.ndarray:
    """SD's ``make_ddim_timesteps``: 'uniform' strided or 'quad' quadratic
    subsampling of the DDPM steps, plus one."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                             num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{method}"')
    return steps + 1


def sd_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                eta: float):
    """SD's ``make_ddim_sampling_parameters``: per step (sigma, alpha,
    alpha_prev) of the DDIM sampler (arXiv:2010.02502)."""
    alphacums = np.asarray(alphacums)
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Betas that discretise a continuous alpha-bar(t) on [0, 1], each
    capped at ``max_beta``."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)
