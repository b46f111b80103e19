"""Latent diffusion pipeline for sampling
(port of ``medfusion_tpu/pipelines/diffusion/core.py``).

The modules are NCHW; the public ``sample`` / ``denoise`` take and return
the JAX package's channels-last layout (see ``ddim.py``). Classifier-free
guidance runs [uncond | cond] as one batched forward with a per-sample
``cond_mask`` that zeroes the label embedding. Schedule math stays float32;
``compute_dtype`` casts the estimator's and the decoder's inputs, and the
modules themselves are cast once at construction (the JAX package casts its
float32 master params on every call, which gives the same values).

Not ported: training (``train_loss``), self-conditioning, an explicit
unconditional label (``un_cond``), classifier guidance, cold diffusion,
zero-terminal-SNR schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.pipelines.diffusion.ddim import DDIMSamplerMixin


@dataclasses.dataclass
class DiffusionPipeline(DDIMSamplerMixin):
    scheduler: GaussianDiffusionSchedule
    noise_estimator: Any  # nn.Module: (x_t, t, condition, cond_mask) -> (y, y_ver)
    latent_embedder: Any = None  # nn.Module with encode/decode, or None
    estimator_objective: str = "x_T"  # 'x_T' (eps), 'x_0' or 'v'
    estimate_variance: bool = False
    clip_x0: bool = True
    compute_dtype: Optional[torch.dtype] = None
    latent_scale: float = 1.0
    latent_shift: float = 0.0

    def __post_init__(self):
        if self.estimator_objective not in ("x_T", "x_0", "v"):
            raise ValueError(f"unknown estimator_objective {self.estimator_objective!r}")
        if self.compute_dtype is not None:
            self.noise_estimator.to(self.compute_dtype)
            if self.latent_embedder is not None:
                self.latent_embedder.to(self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return next(self.noise_estimator.parameters()).device

    # -- model application --------------------------------------------------

    def _apply_estimator(self, x_t, t, condition, cond_mask):
        if self.compute_dtype is not None:
            x_t = x_t.to(self.compute_dtype)
        y, y_ver = self.noise_estimator(x_t, t, condition, cond_mask)
        if self.compute_dtype is not None:
            y = y.float()
            y_ver = [v.float() for v in y_ver]
        return y, y_ver

    def encode_latent(self, x, noise=None, sample: bool = True):
        """NCHW image -> latent, then (z - shift) * scale."""
        if self.latent_embedder is None:
            return x
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            noise = None if noise is None else noise.to(self.compute_dtype)
        z = self.latent_embedder.encode(x, noise, sample=sample)
        if self.compute_dtype is not None:
            z = z.float()
        if self.latent_scale != 1.0 or self.latent_shift != 0.0:
            z = (z - self.latent_shift) * self.latent_scale
        return z

    def decode_latent(self, z):
        """NCHW latent -> NCHW image (float32 when compute_dtype is set)."""
        if self.latent_embedder is None:
            return z
        if self.latent_scale != 1.0 or self.latent_shift != 0.0:
            z = z / self.latent_scale + self.latent_shift
        if self.compute_dtype is not None:
            z = z.to(self.compute_dtype)
        out = self.latent_embedder.decode(z)
        return out.float() if self.compute_dtype is not None else out

    # -- one reverse step ---------------------------------------------------

    def _guided_pred(self, x_t, t, condition=None, guidance_scale: float = 1.0,
                     guidance_rescale: float = 0.0):
        """The estimator's output; under CFG, [uncond | cond] in one forward
        with the label embedding zeroed on the uncond half."""
        b = x_t.shape[0]
        ones = torch.ones((b,), dtype=x_t.dtype, device=x_t.device)
        if condition is not None and guidance_scale != 1.0:
            x2 = torch.cat([x_t, x_t], dim=0)
            t2 = torch.cat([t, t], dim=0)
            cond2 = torch.cat([torch.zeros_like(condition), condition], dim=0)
            mask2 = torch.cat([torch.zeros_like(ones), ones], dim=0)
            pred2, _ = self._apply_estimator(x2, t2, cond2, mask2)
            pred_uncond, pred_cond = pred2[:b], pred2[b:]
            guided = pred_uncond + guidance_scale * (pred_cond - pred_uncond)
            if guidance_rescale > 0.0:
                if self.estimate_variance:
                    g_eps, g_var = torch.chunk(guided, 2, dim=1)
                    c_eps, _ = torch.chunk(pred_cond, 2, dim=1)
                    g_eps = self._rescale_guided(g_eps, c_eps, guidance_rescale)
                    guided = torch.cat([g_eps, g_var], dim=1)
                else:
                    guided = self._rescale_guided(guided, pred_cond, guidance_rescale)
            return guided
        cond_mask = None if condition is None else ones
        pred, _ = self._apply_estimator(x_t, t, condition, cond_mask)
        return pred

    @staticmethod
    def _rescale_guided(guided, cond, phi):
        """std-pin the guided prediction to the conditional one, lerp by phi."""
        axes = tuple(range(1, guided.ndim))
        std_cond = torch.std(cond, dim=axes, keepdim=True, correction=0)
        std_guided = torch.std(guided, dim=axes, keepdim=True, correction=0)
        rescaled = guided * (std_cond / torch.clamp(std_guided, min=1e-8))
        return phi * rescaled + (1 - phi) * guided

    def estimate(self, x_t, t, noise, condition=None, guidance_scale: float = 1.0,
                 guidance_rescale: float = 0.0):
        """One reverse step: returns (x_t_prior, x_0, x_T). ``noise`` is the
        ancestral step's standard-normal draw."""
        pred = self._guided_pred(x_t, t, condition, guidance_scale, guidance_rescale)
        if self.estimate_variance:
            pred, pred_var = torch.chunk(pred, 2, dim=1)
            var_scale = pred_var / 2 + 0.5
        else:
            var_scale = 0.0
        return self._pred_to_states(x_t, t, pred, noise, var_scale=var_scale)

    def _pred_to_states(self, x_t, t, pred, noise, var_scale=0.0):
        sched = self.scheduler
        if self.estimator_objective == "x_0":
            x_t_prior, x_0 = S.ancestral_step(sched, x_t, t, pred, noise,
                                              clip=self.clip_x0, var_scale=var_scale)
            x_T = S.estimate_x_T(sched, x_t, x_0=pred, t=t, clip=self.clip_x0)
            return x_t_prior, x_0, x_T
        if self.estimator_objective == "v":
            x_0v = S.estimate_x_0_from_v(sched, x_t, pred, t, clip=self.clip_x0)
            x_t_prior, x_0 = S.ancestral_step(sched, x_t, t, x_0v, noise,
                                              clip=self.clip_x0, var_scale=var_scale)
            x_T = S.estimate_x_T(sched, x_t, x_0=x_0v, t=t, clip=self.clip_x0)
            return x_t_prior, x_0, x_T
        x_t_prior, x_0 = S.ancestral_step_from_eps(
            sched, x_t, t, pred, noise, clip=self.clip_x0, var_scale=var_scale)
        return x_t_prior, x_0, pred

    # -- noise -> images ----------------------------------------------------

    @torch.no_grad()
    def sample(self, num_samples: int, img_size, condition=None,
               generator: Optional[torch.Generator] = None, **kwargs):
        """Noise -> images. ``img_size`` is the channels-last latent shape,
        e.g. (32, 32, 8); returns channels-last images [B, H, W, C]."""
        if (kwargs.get("use_ddim") is False
                and kwargs.get("steps") not in (None, self.scheduler.timesteps)):
            raise ValueError(
                "sample(use_ddim=False, steps<T) would start the ancestral "
                "loop mid-schedule on pure noise; use use_ddim=True")
        x_T = torch.randn((num_samples, *img_size), generator=generator,
                          device=self.device)
        return self.denoise(x_T, condition=condition, generator=generator, **kwargs)
