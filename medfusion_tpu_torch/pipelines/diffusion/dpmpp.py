"""DPM-Solver++(2M) multistep sampler (arXiv:2211.01095)
(port of ``medfusion_tpu/pipelines/diffusion/dpmpp.py``).

Deterministic: it takes no noise. The step coefficients are float32
0-d tensors on the schedule's device, as the JAX scan computes them; at a
zero-SNR terminal step lambda = -inf, and the update relies on IEEE
arithmetic there (``expm1(-inf) = -1``, ``r = inf / h``), as JAX does, with
no epsilon added.
"""

from __future__ import annotations

from typing import Optional

import torch

from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.utils.profiling import annotate


class DPMSolverMixin:
    @torch.no_grad()
    def denoise_dpmpp(self, x_t, condition=None, steps: Optional[int] = None,
                      guidance_scale: float = 1.0, un_cond=None, decode: bool = True,
                      guidance_rescale: float = 0.0,
                      timestep_spacing: str = "linspace", classifier_grad=None,
                      classifier_scale: float = 0.0):
        """DPM-Solver++(2M) from the channels-last latent ``x_t``: ``steps``
        estimator forwards (2 <= steps <= T); the first step is first order
        and the last returns the data prediction at the lowest grid level.
        Works for every objective through the x_0 prediction; classifier
        guidance (``classifier_grad``, ``classifier_scale``: see
        :meth:`estimate`) steers the eps objective's."""
        if self.use_self_conditioning:
            raise ValueError("dpmpp sampler: self-cond unsupported")
        if classifier_grad is not None:
            self._check_classifier_guidance()
        sched = self.scheduler
        n = sched.timesteps if steps is None else steps
        if not 2 <= n <= sched.timesteps:
            raise ValueError(
                f"DPM-Solver++(2M) needs 2 <= steps <= T={sched.timesteps}; a grid "
                f"denser than T duplicates timesteps (h=0 -> NaN in the 2M update)")
        ts_rev = [int(v) for v in sched.ddim_timesteps_host(n, spacing=timestep_spacing)[::-1]]
        ab = sched.alphas_cumprod
        lam = 0.5 * (torch.log(ab) - torch.log1p(-ab))  # log(alpha_t / sigma_t)
        alpha = sched.sqrt_alphas_cumprod
        sigma = sched.sqrt_one_minus_alphas_cumprod

        x = _to_nchw(x_t)
        b = x.shape[0]

        def x0_pred(x, t):
            t_b = torch.full((b,), t, dtype=torch.long, device=x.device)
            pred = self._guided_pred(x, t_b, condition, guidance_scale,
                                     guidance_rescale, un_cond)
            pred, _ = self._split_variance(pred)
            if classifier_grad is not None:
                pred = self._classifier_shift(x, t_b, pred, classifier_grad,
                                              classifier_scale)
            return self._x0_of(x, pred, t_b, self.clip_x0)

        d_prev = h_prev = None
        for t_cur, t_next in zip(ts_rev[:-1], ts_rev[1:]):
            with annotate("sample.step"):
                d = x0_pred(x, t_cur)
                h = lam[t_next] - lam[t_cur]  # > 0: the noise decreases
                if d_prev is None:  # first order (DDIM) on the first step
                    d_bar = d
                else:
                    r = h_prev / h
                    d_bar = (1.0 + 1.0 / (2.0 * r)) * d - (1.0 / (2.0 * r)) * d_prev
                x = (sigma[t_next] / sigma[t_cur]) * x - alpha[t_next] * torch.expm1(-h) * d_bar
                d_prev, h_prev = d, h
        x = x0_pred(x, ts_rev[-1])
        if decode:
            x = self.decode_latent(x)
        return _to_nhwc(x)
