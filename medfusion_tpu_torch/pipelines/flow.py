"""Rectified-flow / flow-matching pipeline (port of
``medfusion_tpu/pipelines/flow.py``).

The linear path x_t = (1 - t) x_0 + t eps, t in [0, 1] (t = 1 is pure
noise); the estimator regresses the path's velocity eps - x_0 at model time
``t * time_scale`` (:data:`TIME_SCALE` by default); sampling integrates
dx/dt = v(x, t) from t = 1 down to 0 by Euler or Heun (the last step plain
Euler), on a grid warped by the SD3
resolution shift (:func:`shift_time`). It runs on the diffusion family's
UNet, VAE, train step and CLIs: ``encode_latent``, ``decode_latent``,
``_apply_estimator`` and the classifier-free guidance batching
(``_guided_pred``) are :class:`DiffusionPipeline`'s own functions.

Every public tensor is channels-last, as in the diffusion samplers. The
JAX package runs each sampler as one ``lax.scan`` and Heun's first or last
step under ``lax.cond``; here they are Python loops and branches. The
schedule-free arithmetic (the grid, the steps' dt, the inpainting
coefficients) is float32, as the scan computes it, while the estimator may
run in ``compute_dtype``.

Randomness is explicit, laid out as the JAX package splits its keys:

* :meth:`train_draws`: ``enc_noise``, ``t_draw`` (the standard normal
  before the sigmoid for ``logit_normal``, else the uniform), ``eps`` and
  the CFG ``drop``, as ``split(rng, 4)`` -> (k_enc, k_t, k_noise, k_cfg);
* :meth:`denoise` with ``known``: ``noise`` [steps, resample_steps, 2,
  *x.shape], row (i, r) the projection draw and the renoise draw of
  repeat r of step i (``keys = split(rng, steps)``, then ``k_proj, k_re,
  key = split(key, 3)`` before each repeat);
* :meth:`img2img`: ``enc_noise`` and ``x_noise`` (``split(rng)``);
  :meth:`sample_inpaint`: ``x_T`` and the loop's ``noise``
  (``split(rng)``); :meth:`interpolate`: ``noise1``, ``noise2`` and the
  loop's ``noise`` (``split(rng, 3)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Mapping, Optional

import numpy as np
import torch

from medfusion_tpu_torch.core.draws import normal
from medfusion_tpu_torch.nn.functional import interpolate_area
from medfusion_tpu_torch.pipelines.diffusion.core import _LOSSES, DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.pipelines.diffusion.editing import _randn, slerp
from medfusion_tpu_torch.utils.profiling import annotate

f32 = np.float32
TIME_SCALE = 1000.0  # model time = t * TIME_SCALE: the embedder's [0, 1000) range


def shift_time(t, shift: float):
    """SD3 resolution shift (arXiv:2403.03206 eq. 23), monotone on [0, 1]:
    the identity at shift 1; shift > 1 moves mass toward t = 1."""
    return shift * t / (1.0 + (shift - 1.0) * t)


def _grid(start: float, stop: float, steps: int, shift: float) -> np.ndarray:
    """``linspace(start, stop, steps + 1)`` in float32, warped by ``shift``."""
    u = np.linspace(start, stop, steps + 1).astype(f32)
    return shift_time(u, f32(shift)).astype(f32) if shift != 1.0 else u


@dataclasses.dataclass
class FlowMatchingPipeline:
    """The JAX pipeline's fields and methods, eager: ``loss`` is the
    elementwise loss of the velocity ('l1', or 'l2' = 'mse'), ``time_scale``
    the factor of the model time. Its ``jit_sampler`` (a ``jax.jit`` of
    :meth:`sample`) has no counterpart."""

    # nn.Module: (x_t, t, condition, cond_mask) -> (y, y_ver), t a float
    noise_estimator: Any
    latent_embedder: Any = None
    classifier_free_guidance_dropout: float = 0.5
    do_input_centering: bool = True
    loss: str = "l2"  # flow matching is an L2 regression (arXiv:2210.02747 eq. 9)
    compute_dtype: Optional[torch.dtype] = None
    latent_scale: float = 1.0
    latent_shift: float = 0.0
    time_scale: float = TIME_SCALE
    timestep_sampling: str = "logit_normal"  # or 'uniform'
    logit_mean: float = 0.0
    logit_std: float = 1.0
    shift: float = 1.0  # of the training draw and the default sampling grid
    # no learned variance and no self-conditioning in the flow family
    estimate_variance: ClassVar[bool] = False

    def __post_init__(self):
        if self.timestep_sampling not in ("uniform", "logit_normal"):
            raise ValueError(f"unknown timestep_sampling {self.timestep_sampling!r}")
        if self.loss not in _LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.shift < 1.0:
            raise ValueError("shift must be >= 1 (1 = identity)")

    device = DiffusionPipeline.device
    encode_latent = DiffusionPipeline.encode_latent
    decode_latent = DiffusionPipeline.decode_latent
    _apply_estimator = DiffusionPipeline._apply_estimator
    _guided_pred = DiffusionPipeline._guided_pred

    # -- training -----------------------------------------------------------

    def train_draws(self, batch_size: int, latent_shape,
                    generator=None) -> Dict[str, torch.Tensor]:
        """The random inputs of one :meth:`train_loss`, in the order of the
        JAX package's ``split(rng, 4)``: ``enc_noise`` and ``eps`` [B,
        *latent_shape] (channels-last) standard normal, ``t_draw`` [B] (a
        standard normal for ``logit_normal``, else uniform in [0, 1)), and
        ``drop``, one boolean for the whole batch."""
        shape = (batch_size, *latent_shape)
        kw = dict(generator=generator, device=self.device)
        enc_noise = torch.randn(shape, **kw)
        t_draw = (torch.randn((batch_size,), **kw) if self.timestep_sampling == "logit_normal"
                  else torch.rand((batch_size,), **kw))
        return {"enc_noise": enc_noise, "t_draw": t_draw, "eps": torch.randn(shape, **kw),
                "drop": torch.rand((), **kw) < self.classifier_free_guidance_dropout}

    def _sample_t(self, t_draw: torch.Tensor) -> torch.Tensor:
        """The training time of the raw draw: sigmoid(mean + std * z) for
        ``logit_normal``, the uniform itself otherwise; then the shift."""
        if self.timestep_sampling == "logit_normal":
            t = torch.sigmoid(self.logit_mean + self.logit_std * t_draw.float())
        else:
            t = t_draw.float()
        return shift_time(t, self.shift) if self.shift != 1.0 else t

    def train_loss(self, batch: Mapping[str, torch.Tensor],
                   draws: Mapping[str, torch.Tensor],
                   estimator_params: Optional[Mapping[str, torch.Tensor]] = None):
        """One conditional-flow-matching loss, the mean of ``loss`` (squared
        error by default) of the velocity: ``batch`` ``source`` images [B, H, W, C] and optional
        ``target`` labels [B]; ``draws`` as :meth:`train_draws` makes them.
        The deep-supervision heads regress the velocity at their resolution
        (area-downsampled), weighted 1/2^i and normalised. Returns (loss,
        metrics ``loss``, ``L2`` and ``moe_aux``, the estimator's
        mixture-of-experts aux loss, added to the velocity loss before the
        deep-supervision weighting, as in the JAX package; 0 for a dense
        estimator)."""
        x_in = _to_nchw(batch["source"])
        condition = batch.get("target")
        b = x_in.shape[0]
        with torch.no_grad():
            noise = draws.get("enc_noise")
            x_0 = self.encode_latent(x_in, None if noise is None else _to_nchw(noise))
        if self.do_input_centering:
            x_0 = 2 * x_0 - 1
        t = self._sample_t(draws["t_draw"])
        eps = _to_nchw(draws["eps"])
        t_b = t.reshape((b,) + (1,) * (x_0.ndim - 1))
        x_t = (1.0 - t_b) * x_0 + t_b * eps
        target = eps - x_0

        cond_mask = None
        if condition is not None:
            drop = torch.as_tensor(draws["drop"], device=x_0.device)
            cond_mask = torch.where(drop, 0.0, 1.0).to(x_0.dtype).expand(b)
        pred, pred_vertical, moe_aux = self._apply_estimator(
            x_t, t * self.time_scale, condition, cond_mask, estimator_params, with_aux=True)
        elt = _LOSSES[self.loss]
        loss = elt(pred - target).mean() + moe_aux
        if pred_vertical:
            weights = [1 / 2**i for i in range(1 + len(pred_vertical))]
            weights = [w / sum(weights) for w in weights]
            loss = loss * weights[0]
            for i, pred_i in enumerate(pred_vertical):
                target_i = interpolate_area(target, pred_i.shape[2:])
                loss = loss + elt(pred_i - target_i).mean() * weights[i + 1]
        return loss, {"loss": loss, "L2": ((pred - target) ** 2).mean(), "moe_aux": moe_aux}

    # -- sampling -----------------------------------------------------------

    def _velocity(self, x, t: float, condition, guidance_scale: float, un_cond):
        """The (CFG-batched) velocity of NCHW ``x`` at the scalar time ``t``."""
        t_b = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                         device=x.device) * self.time_scale
        return self._guided_pred(x, t_b, condition, guidance_scale, un_cond=un_cond)

    def _step(self, x, t_cur, t_next, t_eval, correct: bool, velocity):
        """Euler from ``t_cur`` to ``t_next`` with the slope at ``t_eval``,
        and Heun's correction at ``t_next`` where ``correct``."""
        dt = f32(t_next) - f32(t_cur)
        v1 = velocity(x, t_eval)
        x_euler = x + float(dt) * v1
        if not correct:
            return x_euler
        v2 = velocity(x_euler, t_next)
        return x + float(dt * f32(0.5)) * (v1 + v2)

    @torch.no_grad()
    def denoise(self, x_t, condition=None, steps: int = 25, guidance_scale: float = 1.0,
                un_cond=None, decode: bool = True, heun: bool = True,
                shift: Optional[float] = None, t_start: float = 1.0, known=None,
                mask=None, resample_steps: int = 1, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Integrate the probability-flow ODE from ``t_start`` down to 0 from
        the channels-last latent ``x_t`` (noised to ``t_start`` in shifted
        time): Heun (2 steps - 1 forwards, the last step Euler) or Euler.
        ``shift`` overrides the pipeline's grid shift. ``known``/``mask``
        (channels-last, 1 = keep) project the kept region onto the path at
        each new level, fresh noise a step (exactly ``known`` at t = 0);
        ``resample_steps`` r > 1 redoes each transition r times, renoising
        t_next -> t_cur between repeats. Draws: ``noise`` (module doc) or
        ``generator``."""
        if not 0.0 < t_start <= 1.0:
            raise ValueError("t_start must be in (0, 1]")
        if (known is None) != (mask is None):
            raise ValueError("inpainting needs BOTH known and mask (or neither)")
        if resample_steps < 1:
            raise ValueError("resample_steps must be >= 1")
        if resample_steps > 1 and known is None:
            raise ValueError("resample_steps > 1 requires known + mask")
        if noise is not None and tuple(noise.shape) != (steps, resample_steps, 2,
                                                        *x_t.shape):
            raise ValueError(f"noise must have shape {(steps, resample_steps, 2, *x_t.shape)}, "
                             f"got {tuple(noise.shape)}")
        sh = self.shift if shift is None else shift
        # t_start is in shifted (physical) time: un-warp it for the grid
        u_start = t_start / (sh - sh * t_start + t_start) if sh != 1.0 else t_start
        ts = _grid(u_start, 0.0, steps, sh)

        x = _to_nchw(x_t)
        if known is not None:
            known = _to_nchw(known.to(x.device))
            mask = _to_nchw(mask.to(x.device)).to(x.dtype)
        if noise is not None:
            noise = noise.to(x.device).movedim(-1, 4)

        def draw(i, r, j):
            if noise is not None:
                return noise[i, r, j].contiguous()
            return normal(x.shape, generator, x.device, x.dtype)

        def velocity(x, t):
            return self._velocity(x, t, condition, guidance_scale, un_cond)

        for i in range(steps):
            with annotate("sample.step"):
                t_cur, t_next = ts[i], ts[i + 1]
                # the last step is Euler: Heun's correction would query t = 0
                correct = heun and i < steps - 1
                for r in range(1 if known is None else resample_steps):
                    x = self._step(x, t_cur, t_next, t_cur, correct, velocity)
                    if known is None:
                        continue
                    known_t = float(f32(1.0) - t_next) * known + float(t_next) * draw(i, r, 0)
                    x = mask * known_t + (1.0 - mask) * x
                    if r < resample_steps - 1:
                        # marginal-preserving move up the path, t_next -> t_cur
                        a = (f32(1.0) - t_cur) / (f32(1.0) - t_next)
                        b = np.sqrt(np.maximum(t_cur * t_cur - (a * t_next) ** 2, f32(0.0)))
                        x = float(a) * x + float(b) * draw(i, r, 1)
        if decode:
            x = self.decode_latent(x)
        return _to_nhwc(x)

    @torch.no_grad()
    def sample(self, num_samples: int, latent_shape, condition=None,
               generator: Optional[torch.Generator] = None, **kwargs):
        """Pure noise (t = 1) -> images; ``kwargs`` go to :meth:`denoise`."""
        x_T = torch.randn((num_samples, *latent_shape), generator=generator,
                          device=self.device)
        return self.denoise(x_T, condition=condition, generator=generator, **kwargs)

    @torch.no_grad()
    def img2img(self, image, strength: float = 0.6, condition=None, enc_noise=None,
                x_noise=None, generator: Optional[torch.Generator] = None, **kwargs):
        """SDEdit on the flow path: encode the data-space ``image`` [B, H, W,
        C], jump to t = ``strength`` on the straight path and integrate down
        (``kwargs`` go to :meth:`denoise`)."""
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        x = _to_nchw(image)
        if self.latent_embedder is not None and enc_noise is None:
            shape = self.encode_latent(x, sample=False).shape
            enc_noise = _to_nhwc(_randn(shape, x, generator))
        x_0 = self.encode_latent(x, None if enc_noise is None else _to_nchw(enc_noise))
        if self.do_input_centering:
            x_0 = 2 * x_0 - 1
        x_0 = _to_nhwc(x_0)
        eps = _randn(x_0.shape, x_0, generator) if x_noise is None else x_noise.to(x_0.device)
        x_t = (1.0 - strength) * x_0 + strength * eps
        return self.denoise(x_t, condition=condition, t_start=strength,
                            generator=generator, **kwargs)

    @torch.no_grad()
    def sample_inpaint(self, known, mask, condition=None, x_T=None, noise=None,
                       generator: Optional[torch.Generator] = None, **kwargs):
        """From pure noise, :meth:`denoise` with the known-region projection;
        ``known`` is a latent in the sampler's working space."""
        x_T = _randn(known.shape, known, generator) if x_T is None else x_T
        return self.denoise(x_T, condition=condition, known=known, mask=mask, noise=noise,
                            generator=generator, **kwargs)

    @torch.no_grad()
    def invert(self, x_0, condition=None, steps: int = 25, guidance_scale: float = 1.0,
               un_cond=None, heun: bool = True, shift: Optional[float] = None):
        """Deterministic ODE inversion of the working-space latent ``x_0`` up
        the grid :meth:`denoise` descends, its exact time mirror: Euler's
        slope at the higher end of each interval, Heun on every step but the
        first (which touches t = 0), so t = 0 is never queried."""
        sh = self.shift if shift is None else shift
        ts = _grid(0.0, 1.0, steps, sh)
        x = _to_nchw(x_0)

        def velocity(x, t):
            return self._velocity(x, t, condition, guidance_scale, un_cond)

        for i in range(steps):
            t_cur, t_next = ts[i], ts[i + 1]
            t_eval = t_cur if heun and i > 0 else t_next
            x = self._step(x, t_cur, t_next, t_eval, heun and i > 0, velocity)
        return _to_nhwc(x)

    @torch.no_grad()
    def interpolate(self, img1, img2, strength: float = 1.0, condition=None,
                    lam: float = 0.5, ode_invert: bool = False, noise1=None, noise2=None,
                    noise=None, generator: Optional[torch.Generator] = None, **kwargs):
        """Latent interpolation of working-space latents: both placed at t =
        ``strength`` on the path (fresh noise each), lerped by ``lam`` and
        integrated down; or, with ``ode_invert``, both inverted to t = 1
        (:meth:`invert`, unguided), slerped per sample and integrated from
        there. ``kwargs`` go to :meth:`denoise` (``steps``, ``heun`` and
        ``shift`` to :meth:`invert` too)."""
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        if ode_invert:
            inv = dict(condition=condition, steps=kwargs.get("steps", 25),
                       heun=kwargs.get("heun", True), shift=kwargs.get("shift"))
            z = slerp(self.invert(img1, **inv), self.invert(img2, **inv),
                      torch.tensor(lam, device=img1.device))
            return self.denoise(z, condition=condition, noise=noise, generator=generator,
                                **kwargs)
        e1 = _randn(img1.shape, img1, generator) if noise1 is None else noise1
        e2 = _randn(img2.shape, img2, generator) if noise2 is None else noise2
        x1 = (1.0 - strength) * img1 + strength * e1
        x2 = (1.0 - strength) * img2 + strength * e2
        return self.denoise((1 - lam) * x1 + lam * x2, condition=condition,
                            t_start=strength, noise=noise, generator=generator, **kwargs)
