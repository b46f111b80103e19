"""EDM / Karras sampler (arXiv:2206.00364 Alg. 2)
(port of ``medfusion_tpu/pipelines/diffusion/edm.py``).

The discretely trained VP model runs off its grid through the k-diffusion
change of variables: sigma_t = sqrt((1-abar)/abar), x_k = x_vp / sqrt(abar),
c_in = 1/sqrt(1+sigma^2), and a **fractional** float32 timestep from
:func:`~medfusion_tpu_torch.core.schedules.sigma_to_t_frac`, which reaches
the sinusoidal time embedding as a float (nothing casts it to an integer).
The churn draws are explicit: ``churn_noise`` [n, *x_t.shape], one a step,
or a ``torch.Generator``.

Only the Heun integrator is ported, with the paper's churn window and noise
scale (S_tmin = 0, S_tmax = inf, S_noise = 1): these are the JAX package's
defaults, and no sampling CLI sets them otherwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from medfusion_tpu_torch.core.draws import normal
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.utils.profiling import annotate


class EDMSamplerMixin:
    @torch.no_grad()
    def denoise_edm(self, x_t, condition=None, steps: Optional[int] = None,
                    guidance_scale: float = 1.0, un_cond=None, decode: bool = True,
                    rho: float = 7.0, s_churn: float = 0.0,
                    guidance_rescale: float = 0.0,
                    churn_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """Karras grid + Heun (2n-1 estimator forwards; the correction is
        skipped on the last transition, to sigma 0), with optional churn
        (``s_churn`` > 0) on every step. ``x_t`` is a channels-last standard-normal VP prior
        draw. Self-conditioning and zero-terminal-SNR schedules are refused,
        as in the JAX package."""
        if self.use_self_conditioning:
            raise ValueError("edm sampler: self-cond unsupported")
        if s_churn > 0.0 and churn_noise is None and generator is None:
            raise ValueError("edm sampler: s_churn > 0 draws noise; pass "
                             "churn_noise or generator")
        sched = self.scheduler
        if self._terminal_safe:
            raise ValueError(
                "edm sampler: zero-terminal-SNR schedules have sigma_max = inf "
                "in the k-diffusion parameterization; use denoise(trailing) or "
                "denoise_dpmpp(timestep_spacing='trailing') instead")
        n = sched.timesteps if steps is None else steps
        if n < 1:
            raise ValueError("edm sampler needs steps >= 1")
        if churn_noise is not None and tuple(churn_noise.shape) != (n, *x_t.shape):
            raise ValueError(f"churn_noise must have shape {(n, *x_t.shape)}, "
                             f"got {tuple(churn_noise.shape)}")
        x = _to_nchw(x_t)
        b = x.shape[0]
        if churn_noise is not None:
            churn_noise = churn_noise.to(x.device).movedim(-1, 2)

        sig_tab = S.kdiff_sigmas(sched)
        sigma_max = sig_tab[-1]
        sigmas = S.karras_sigma_grid(sig_tab[0], sigma_max, n, rho)  # descending, n + 1

        def denoised_at(x, sigma):
            """D(x, sigma): the data prediction in k-space."""
            c_in = 1.0 / torch.sqrt(1.0 + sigma ** 2)
            t_b = S.sigma_to_t_frac(sched, sigma).expand(b)
            pred = self._guided_pred(x * c_in, t_b, condition, guidance_scale,
                                     guidance_rescale, un_cond)
            pred, _ = self._split_variance(pred)
            if self.estimator_objective == "x_T":
                den = x - sigma * pred
            elif self.estimator_objective == "v":
                den = x / (1.0 + sigma ** 2) - (sigma / torch.sqrt(1.0 + sigma ** 2)) * pred
            else:
                den = pred  # the model saw x_vp = x * c_in; x_0 is data-space
            return S.clip_x0(den) if self.clip_x0 else den

        gamma_max = min(s_churn / n, math.sqrt(2.0) - 1.0)
        # 1 + gamma in float32, as the JAX sampler adds it
        churn_scale = 1.0 + torch.full((), gamma_max, dtype=sigmas.dtype, device=sigmas.device)
        x = x * torch.sqrt(1.0 + sigma_max ** 2)  # VP prior -> k-space
        for i in range(n):
            with annotate("sample.step"):
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                if s_churn > 0.0:
                    sigma_hat = sigma * churn_scale
                    z = (churn_noise[i] if churn_noise is not None else
                         normal(x.shape, generator, x.device))
                    x = x + torch.sqrt(torch.clamp(sigma_hat ** 2 - sigma ** 2, min=0.0)) * z
                else:
                    sigma_hat = sigma
                d = (x - denoised_at(x, sigma_hat)) / sigma_hat
                dt = sigma_next - sigma_hat
                x_euler = x + dt * d
                if i < n - 1:  # Heun: sigma_next > 0 on every transition but the last
                    d2 = (x_euler - denoised_at(x_euler, sigma_next)) / sigma_next
                    x = x + dt * 0.5 * (d + d2)
                else:
                    x = x_euler
        if decode:
            x = self.decode_latent(x)
        return _to_nhwc(x)
