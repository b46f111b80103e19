"""Editing: SDEdit img2img (arXiv:2108.01073), latent interpolation,
inpainting from noise (arXiv:2201.09865) and deterministic DDIM inversion
(arXiv:2010.02502 §4.3) (port of ``medfusion_tpu/pipelines/diffusion/editing.py``).

Every tensor is channels-last, as in :meth:`denoise`. Draws are explicit
keyword tensors, each standing for one key of the JAX package's split, or a
``torch.Generator`` draws those not given: ``img2img``'s ``enc_noise``,
``x_noise`` and the loop's ``noise`` are ``split(rng, 3)``;
``interpolate``'s ``noise1``, ``noise2`` and ``noise`` likewise;
``sample_inpaint``'s ``x_T`` and ``noise`` are ``split(rng)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc


def _randn(shape, like, generator):
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def slerp(z1: torch.Tensor, z2: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of each sample of ``z1`` and ``z2`` [B, ...]
    (the angle per sample), at ``lam`` broadcasting against [B, 1, ...]
    (a column of lambdas [n, 1, ...] against B = 1 gives n mixes); a lerp
    where a pair is near parallel."""
    b = z1.shape[0]
    f1, f2 = z1.reshape(b, -1), z2.reshape(b, -1)
    norms = torch.linalg.vector_norm(f1, dim=-1) * torch.linalg.vector_norm(f2, dim=-1)
    cos = (f1 * f2).sum(-1) / torch.clamp(norms, min=1e-12)
    omega = torch.arccos(torch.clamp(cos, -1.0, 1.0)).reshape(b, *(1,) * (z1.ndim - 1))
    so = torch.sin(omega)
    far = so > 1e-6
    so = torch.clamp(so, min=1e-6)
    w1 = torch.where(far, torch.sin((1.0 - lam) * omega) / so, 1.0 - lam)
    w2 = torch.where(far, torch.sin(lam * omega) / so, lam)
    return w1 * z1 + w2 * z2


class EditingMixin:
    @torch.no_grad()
    def img2img(self, image, strength: float = 0.6, condition=None,
                steps: Optional[int] = None, use_ddim: bool = True,
                timestep_spacing: str = "linspace", enc_noise=None, x_noise=None,
                noise=None, generator: Optional[torch.Generator] = None, **kwargs):
        """Encode the data-space ``image`` [B, H, W, C] (centred as in
        training), q-sample it to the grid level nearest ``strength`` and run
        the tail of :meth:`denoise` from there; ``kwargs`` go to
        :meth:`denoise`. ``enc_noise`` is the encoder's sampling draw (latent
        shape), ``x_noise`` the q-sample's, ``noise`` the loop's."""
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        grid_desc = self._grid(steps, use_ddim, timestep_spacing)[::-1]
        n = len(grid_desc)
        start_idx = n - max(1, int(round(strength * n)))
        x = _to_nchw(image)
        if self.latent_embedder is not None and enc_noise is None:
            with torch.no_grad():
                shape = self.encode_latent(x, sample=False).shape
            enc_noise = _to_nhwc(_randn(shape, x, generator))
        x_0 = self.encode_latent(x, None if enc_noise is None else _to_nchw(enc_noise))
        if self.do_input_centering:
            x_0 = 2 * x_0 - 1
        x_0 = _to_nhwc(x_0)
        if x_noise is None:
            x_noise = _randn(x_0.shape, x_0, generator)
        t_b = torch.full(x_0.shape[:1], int(grid_desc[start_idx]), dtype=torch.long,
                         device=x_0.device)
        x_t = S.q_sample(self.scheduler, x_0, t_b, x_noise.to(x_0.device))
        return self.denoise(x_t, condition=condition, steps=steps, use_ddim=use_ddim,
                            timestep_spacing=timestep_spacing, start_idx=start_idx,
                            noise=noise, generator=generator, **kwargs)

    @torch.no_grad()
    def interpolate(self, img1, img2, i: Optional[int] = None, condition=None,
                    lam: float = 0.5, noise1=None, noise2=None, noise=None,
                    generator: Optional[torch.Generator] = None, **kwargs):
        """Noise both latents to step ``i`` (default T-1), lerp by ``lam``,
        and :meth:`denoise` with ``steps=i``."""
        sched = self.scheduler
        t_scalar = sched.T - 1 if i is None else i
        t = torch.full(img1.shape[:1], t_scalar, dtype=torch.long, device=img1.device)
        noise1 = _randn(img1.shape, img1, generator) if noise1 is None else noise1
        noise2 = _randn(img2.shape, img2, generator) if noise2 is None else noise2
        img = ((1 - lam) * S.q_sample(sched, img1, t, noise1)
               + lam * S.q_sample(sched, img2, t, noise2))
        return self.denoise(img, condition=condition, steps=t_scalar, noise=noise,
                            generator=generator, **kwargs)

    @torch.no_grad()
    def sample_inpaint(self, known, mask, condition=None, x_T=None, noise=None,
                       generator: Optional[torch.Generator] = None, **kwargs):
        """From pure noise, :meth:`denoise` with the known-region projection
        (``resample_steps``/``jump_length`` in ``kwargs`` for RePaint).
        ``known`` is a latent in the sampler's working space."""
        x_T = _randn(known.shape, known, generator) if x_T is None else x_T
        return self.denoise(x_T, condition=condition, known=known, mask=mask,
                            noise=noise, generator=generator, **kwargs)

    @torch.no_grad()
    def invert(self, x_0, condition=None, steps: Optional[int] = None,
               guidance_scale: float = 1.0, un_cond=None, guidance_rescale: float = 0.0,
               timestep_spacing: str = "linspace"):
        """Deterministic DDIM inversion of the working-space latent ``x_0``:
        each transition evaluated at its lower level (t = 0 first), the
        predictions unclipped, so that ``denoise(eta=0)`` over the same grid
        reconstructs ``x_0`` up to discretisation."""
        if self.use_self_conditioning:
            raise ValueError("invert: self-conditioned pipelines unsupported")
        sched = self.scheduler
        n = sched.timesteps if steps is None else steps
        ts = [int(v) for v in sched.ddim_timesteps_host(n, spacing=timestep_spacing)]
        x = _to_nchw(x_0)
        b = x.shape[0]

        def full(t):
            return torch.full((b,), t, dtype=torch.long, device=x.device)

        for t_eval, t_to in zip([0] + ts[:-1], ts):
            t_b = full(t_eval)
            pred = self._guided_pred(x, t_b, condition, guidance_scale,
                                     guidance_rescale, un_cond)
            pred, _ = self._split_variance(pred)
            x0p = self._x0_of(x, pred, t_b, clip=False)
            if self.estimator_objective == "x_T":
                eps = pred
            elif self.estimator_objective == "v":
                eps = S.estimate_x_T_from_v(sched, x, pred, t_b)
            else:
                est = S.estimate_x_T_safe if self._terminal_safe else S.estimate_x_T
                eps = est(sched, x, x_0=pred, t=t_b, clip=False)
            sa = S.extract(sched.sqrt_alphas_cumprod, full(t_to), x.ndim)
            so = S.extract(sched.sqrt_one_minus_alphas_cumprod, full(t_to), x.ndim)
            x = sa * x0p + so * eps
        return _to_nhwc(x)
