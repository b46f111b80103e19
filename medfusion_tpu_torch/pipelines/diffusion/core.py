"""Latent diffusion pipeline: the training loss and sampling
(port of ``medfusion_tpu/pipelines/diffusion/core.py``).

The modules are NCHW; the public ``train_loss``, ``sample`` and ``denoise``
take and return the JAX package's channels-last layout (see ``ddim.py``).
Classifier-free guidance runs [uncond | cond] as one batched forward with a
per-sample ``cond_mask`` that zeroes the label embedding. Schedule and loss
math stays float32; ``compute_dtype`` casts the estimator's, the encoder's
and the decoder's inputs. The pipeline never casts its modules:
``cli/presets.py::build_pipeline`` casts them once for sampling, which gives
the values of the JAX package's per-call cast of its float32 params, and the
train step casts the estimator's float32 master parameters on every step
(``train/diffusion.py``).

Randomness is explicit: ``train_loss`` takes its draws (encoder noise, t,
x_T and the one CFG-drop boolean) as inputs, which :meth:`train_draws`
makes from a ``torch.Generator``.

Not ported: self-conditioning, a learned variance and deep supervision in
the training loss, Min-SNR weighting, an explicit unconditional label
(``un_cond``), classifier guidance, cold diffusion, zero-terminal-SNR
schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch.func import functional_call

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.pipelines.diffusion.ddim import (
    DDIMSamplerMixin,
    _to_nchw,
)

_LOSSES = {"l1": lambda d: d.abs(), "l2": lambda d: d * d}


@dataclasses.dataclass
class DiffusionPipeline(DDIMSamplerMixin):
    scheduler: GaussianDiffusionSchedule
    noise_estimator: Any  # nn.Module: (x_t, t, condition, cond_mask) -> (y, y_ver)
    latent_embedder: Any = None  # nn.Module with encode/decode, or None
    estimator_objective: str = "x_T"  # 'x_T' (eps), 'x_0' or 'v'
    estimate_variance: bool = False
    classifier_free_guidance_dropout: float = 0.5
    do_input_centering: bool = True
    clip_x0: bool = True
    loss: str = "l1"
    compute_dtype: Optional[torch.dtype] = None
    latent_scale: float = 1.0
    latent_shift: float = 0.0

    def __post_init__(self):
        if self.estimator_objective not in ("x_T", "x_0", "v"):
            raise ValueError(f"unknown estimator_objective {self.estimator_objective!r}")
        if self.loss not in _LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; expected one of {sorted(_LOSSES)}")

    @property
    def device(self) -> torch.device:
        return next(self.noise_estimator.parameters()).device

    # -- model application --------------------------------------------------

    def _apply_estimator(self, x_t, t, condition, cond_mask,
                         params: Optional[Mapping[str, torch.Tensor]] = None):
        """The estimator on NCHW ``x_t``; ``params`` (name -> tensor) stand
        in for its own parameters, as the train step's cast copies do."""
        if self.compute_dtype is not None:
            x_t = x_t.to(self.compute_dtype)
        args = (x_t, t, condition, cond_mask)
        if params is None:
            y, y_ver = self.noise_estimator(*args)
        else:
            y, y_ver = functional_call(self.noise_estimator, dict(params), args)
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

    # -- training -----------------------------------------------------------

    def train_draws(self, batch_size: int, latent_shape,
                    generator=None) -> Dict[str, torch.Tensor]:
        """The random inputs of one :meth:`train_loss`, in the order the JAX
        package splits its key (encoder, t, noise, CFG): ``enc_noise`` and
        ``x_T`` [B, *latent_shape] (channels-last) standard normal, ``t``
        [B] uniform in [0, T), and ``drop``, one boolean for the whole batch
        that is true with probability ``classifier_free_guidance_dropout``."""
        shape = (batch_size, *latent_shape)
        kw = dict(generator=generator, device=self.device)
        return {"enc_noise": torch.randn(shape, **kw),
                "t": torch.randint(0, self.scheduler.T, (batch_size,), **kw),
                "x_T": torch.randn(shape, **kw),
                "drop": torch.rand((), **kw) < self.classifier_free_guidance_dropout}

    def train_loss(self, batch: Mapping[str, torch.Tensor],
                   draws: Mapping[str, torch.Tensor],
                   estimator_params: Optional[Mapping[str, torch.Tensor]] = None):
        """One training-loss evaluation. ``batch``: ``source`` images
        [B, H, W, C] (channels-last) and optional integer ``target`` labels
        [B]; ``draws``: as :meth:`train_draws` makes them (``enc_noise`` is
        read only when a latent embedder samples). The frozen encoder runs
        without gradients. Returns (loss, metrics) with the metrics ``loss``,
        ``L1`` and ``L2``, all f32 scalars."""
        if self.estimate_variance:
            raise NotImplementedError(
                "the learned-variance training loss is not ported (ROADMAP)")
        sched = self.scheduler
        x_in = _to_nchw(batch["source"])
        condition = batch.get("target")
        b = x_in.shape[0]
        with torch.no_grad():
            noise = draws.get("enc_noise")
            x_0 = self.encode_latent(x_in, None if noise is None else _to_nchw(noise))
        if self.do_input_centering:
            x_0 = 2 * x_0 - 1
        t = draws["t"]
        x_T = _to_nchw(draws["x_T"])
        x_t = S.q_sample(sched, x_0, t, x_T)
        cond_mask = None
        if condition is not None:  # no host sync on the drop draw
            drop = torch.as_tensor(draws["drop"], device=x_0.device)
            cond_mask = torch.where(drop, 0.0, 1.0).to(x_0.dtype).expand(b)
        pred, pred_vertical = self._apply_estimator(x_t, t, condition, cond_mask,
                                                    estimator_params)
        if pred_vertical:
            raise NotImplementedError(
                "the deep-supervision loss terms are not ported (ROADMAP)")
        if self.estimator_objective == "x_T":
            target = x_T
        elif self.estimator_objective == "v":
            target = S.v_target(sched, x_0, x_T, t)
        else:
            target = x_0
        diff = pred - target
        loss = _LOSSES[self.loss](diff).mean()
        metrics = {"loss": loss, "L1": diff.abs().mean(), "L2": (diff * diff).mean()}
        return loss, metrics

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
