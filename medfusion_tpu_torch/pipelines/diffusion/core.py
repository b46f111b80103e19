"""Latent diffusion pipeline: the training loss and sampling
(port of ``medfusion_tpu/pipelines/diffusion/core.py``).

The modules are NCHW; the public ``train_loss``, ``sample`` and the
samplers take and return the JAX package's channels-last layout (see
``ddim.py``). Classifier-free guidance runs [uncond | cond] as one batched
forward with a per-sample ``cond_mask`` that zeroes the label embedding, or
with an explicit ``un_cond`` label whose embedding is kept. Schedule and
loss math stays float32; ``compute_dtype`` casts the estimator's, the
encoder's and the decoder's inputs. The pipeline never casts its modules:
``cli/presets.py::build_pipeline`` casts them once for sampling, which gives
the values of the JAX package's per-call cast of its float32 params, and the
train step casts the estimator's float32 master parameters on every step
(``train/diffusion.py``).

The options of the JAX pipeline are here: self-conditioning, a learned
variance (its KL/NLL term in the loss), deep-supervision terms, Min-SNR
weighting, zero-terminal-SNR schedules (``_terminal_safe``: the inversions
that stay finite at abar_t = 0; the eps objective is refused there), an
explicit ``un_cond`` and cold diffusion. The samplers are mixed in:
``ddim.py`` (DDIM/ancestral, inpainting, RePaint), ``dpmpp.py``,
``edm.py``, ``fast.py`` (encoder propagation) and ``editing.py``.
Classifier guidance (``guidance.py``) shifts the eps prediction in
:meth:`estimate` (DDIM) and in ``denoise_dpmpp``.

Randomness is explicit: ``train_loss`` takes its draws (encoder noise, t,
x_T and the one CFG-drop boolean) as inputs, which :meth:`train_draws`
makes from a ``torch.Generator``; the self-conditioning pre-pass reuses the
same x_t and needs no draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch.func import functional_call

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.nn.functional import interpolate_area
from medfusion_tpu_torch.pipelines.diffusion.ddim import (
    DDIMSamplerMixin,
    _to_nchw,
)
from medfusion_tpu_torch.pipelines.diffusion.dpmpp import DPMSolverMixin
from medfusion_tpu_torch.pipelines.diffusion.editing import EditingMixin
from medfusion_tpu_torch.pipelines.diffusion.edm import EDMSamplerMixin
from medfusion_tpu_torch.pipelines.diffusion.fast import FastSamplerMixin

_LOSSES = {"l1": lambda d: d.abs(), "l2": lambda d: d * d, "mse": lambda d: d * d}


def gaussian_nll(pred, target, var, eps: float = 1e-6):
    """``F.gaussian_nll_loss(reduction='none')`` without its constant, var
    clamped at ``eps``."""
    var = torch.clamp(var, min=eps)
    return 0.5 * (torch.log(var) + (pred - target) ** 2 / var)


@dataclasses.dataclass
class DiffusionPipeline(DDIMSamplerMixin, DPMSolverMixin, EDMSamplerMixin,
                        FastSamplerMixin, EditingMixin):
    scheduler: GaussianDiffusionSchedule
    # nn.Module: (x_t, t, condition, cond_mask, self_cond=None) -> (y, y_ver)
    noise_estimator: Any
    latent_embedder: Any = None  # nn.Module with encode/decode, or None
    estimator_objective: str = "x_T"  # 'x_T' (eps), 'x_0' or 'v'
    estimate_variance: bool = False
    use_self_conditioning: bool = False
    classifier_free_guidance_dropout: float = 0.5
    do_input_centering: bool = True
    clip_x0: bool = True
    loss: str = "l1"
    compute_dtype: Optional[torch.dtype] = None
    # per-sample weight min(SNR_t, gamma) in the objective's space; None: off
    min_snr_gamma: Optional[float] = None
    latent_scale: float = 1.0
    latent_shift: float = 0.0

    def __post_init__(self):
        if self.estimator_objective not in ("x_T", "x_0", "v"):
            raise ValueError(f"unknown estimator_objective {self.estimator_objective!r}")
        if self.loss not in _LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; expected one of {sorted(_LOSSES)}")
        if self._terminal_safe and self.estimator_objective == "x_T":
            raise ValueError(
                "zero-terminal-SNR schedules cannot use the eps ('x_T') "
                "objective: x_0 is unrecoverable from eps at abar_T = 0 "
                "(arXiv:2305.08891 §3.1); train with objective 'v' (or 'x_0')")

    @property
    def _terminal_safe(self) -> bool:
        """True when the abar_t = 0-safe inversions must be used: the
        schedule was made with ``zero_terminal_snr=True``."""
        return self.scheduler.zero_terminal_snr

    @property
    def device(self) -> torch.device:
        return next(self.noise_estimator.parameters()).device

    # -- model application --------------------------------------------------

    def _apply_estimator(self, x_t, t, condition, cond_mask,
                         params: Optional[Mapping[str, torch.Tensor]] = None,
                         self_cond=None, with_aux: bool = False):
        """The estimator on NCHW ``x_t``; ``params`` (name -> tensor) stand
        in for its own parameters, as the train step's cast copies do.
        ``with_aux`` (the training forward only) also returns the summed
        mixture-of-experts aux loss, a float32 scalar: the estimator's own
        (``returns_aux``, the DiT), else 0."""
        if self.compute_dtype is not None:
            x_t = x_t.to(self.compute_dtype)
            self_cond = None if self_cond is None else self_cond.to(self.compute_dtype)
        args = (x_t, t, condition, cond_mask)
        kwargs = {} if self_cond is None else {"self_cond": self_cond}
        asks_aux = with_aux and getattr(self.noise_estimator, "returns_aux", False)
        if asks_aux:
            kwargs["with_aux"] = True
        if params is None:
            out = self.noise_estimator(*args, **kwargs)
        else:
            out = functional_call(self.noise_estimator, dict(params), args, kwargs)
        y, y_ver = out[:2]
        if self.compute_dtype is not None:
            y = y.float()
            y_ver = [v.float() for v in y_ver]
        if not with_aux:
            return y, y_ver
        aux = out[2] if asks_aux else torch.zeros((), device=y.device)
        return y, y_ver, aux

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
        read only when a latent embedder samples). The frozen encoder and
        the self-conditioning pre-pass (on the same x_t, with the labels
        never dropped, as the JAX package calls it) run without gradients.
        Returns (loss, metrics) with the metrics ``loss``, ``L1`` and ``L2``
        of the main output, ``moe_aux`` (the estimator's mixture-of-experts
        aux loss, added to ``loss``; 0 for a dense estimator), and
        ``variance_scale`` and ``variance_loss`` with a learned variance,
        all f32 scalars."""
        sched = self.scheduler
        loss_fn = _LOSSES[self.loss]
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

        self_cond = None
        if self.use_self_conditioning:
            with torch.no_grad():
                pred_sc, _ = self._apply_estimator(x_t, t, condition, None,
                                                   estimator_params)
                pred_sc, _ = self._split_variance(pred_sc)
                if self.estimator_objective == "x_0":  # x_0's self-cond carry is x_T
                    est = S.estimate_x_T_safe if self._terminal_safe else S.estimate_x_T
                    self_cond = est(sched, x_t, pred_sc, t, clip=self.clip_x0)
                else:
                    self_cond = self._x0_of(x_t, pred_sc, t, self.clip_x0)

        cond_mask = None
        if condition is not None:  # no host sync on the drop draw
            drop = torch.as_tensor(draws["drop"], device=x_0.device)
            cond_mask = torch.where(drop, 0.0, 1.0).to(x_0.dtype).expand(b)
        pred, pred_vertical, moe_aux = self._apply_estimator(
            x_t, t, condition, cond_mask, estimator_params, self_cond, with_aux=True)
        pred_var = None
        if self.estimate_variance:
            pred, pred_var = torch.chunk(pred, 2, dim=1)
        if self.estimator_objective == "x_T":
            target = x_T
        elif self.estimator_objective == "v":
            target = S.v_target(sched, x_0, x_T, t)
        else:
            target = x_0

        # pyramid weights 1/2^i, normalised
        weights = [1 / 2**i for i in range(1 + len(pred_vertical))]
        weights = [w / sum(weights) for w in weights]
        diff = pred - target
        if self.min_snr_gamma is not None:
            w_snr = S.min_snr_weight(sched, t, self.min_snr_gamma,
                                     self.estimator_objective)
            per_sample = loss_fn(diff).mean(dim=tuple(range(1, diff.ndim)))
            loss = (w_snr * per_sample).mean() * weights[0]
        else:
            loss = loss_fn(diff).mean() * weights[0]
        metrics: Dict[str, torch.Tensor] = {}

        if self.estimate_variance:
            var_scale = (pred_var + 1) / 2
            ndim = x_t.ndim
            pred_logvar = S.posterior_variance(sched, t, ndim, var_scale=var_scale)
            if self.estimator_objective == "x_T":
                # the true noise reconstructs x_0, as the reference does: the
                # KL then trains var_scale alone
                pred_x_0 = S.estimate_x_0(sched, x_t, x_T, t, clip=self.clip_x0)
            elif self.estimator_objective == "v":
                pred_x_0 = S.estimate_x_0_from_v(sched, x_t, target, t, clip=self.clip_x0)
            else:
                pred_x_0 = pred
            pred_mean = S.posterior_mean(sched, x_t, pred_x_0, t).detach()
            true_mean = S.posterior_mean(sched, x_t, x_0, t).detach()
            true_logvar = S.posterior_variance(sched, t, ndim)
            axes = tuple(range(1, ndim))
            kl = S.kl_gaussians(true_mean, true_logvar, pred_mean, pred_logvar).mean(dim=axes)
            nll = gaussian_nll(pred_x_0, x_0, torch.exp(pred_logvar)).mean(dim=axes)
            var_loss = torch.where(t == 0, nll, kl).mean()
            loss = loss + var_loss
            metrics["variance_scale"] = var_scale.mean()
            metrics["variance_loss"] = var_loss

        for i, pred_i in enumerate(pred_vertical):
            target_i = interpolate_area(target, pred_i.shape[2:])
            loss = loss + loss_fn(pred_i - target_i).mean() * weights[i + 1]

        # the mixture-of-experts aux loss (weighted inside the layers; 0 for a
        # dense estimator): without it the router gets no load-balancing
        # gradient
        loss = loss + moe_aux
        metrics.update(moe_aux=moe_aux, loss=loss, L1=diff.abs().mean(), L2=(diff * diff).mean())
        return loss, metrics

    # -- one reverse step ---------------------------------------------------

    def _guided_pred(self, x_t, t, condition=None, guidance_scale: float = 1.0,
                     guidance_rescale: float = 0.0, un_cond=None, self_cond=None,
                     estimator=None):
        """The estimator's output; under CFG, [uncond | cond] in one forward,
        the uncond half with its label embedding zeroed, or with ``un_cond``
        as its label (mask 1). ``self_cond`` goes to both halves.
        ``estimator`` stands in for :meth:`_apply_estimator` (same call, same
        return), as the fast sampler's cached-encoder UNet does."""
        apply = self._apply_estimator if estimator is None else estimator
        b = x_t.shape[0]
        ones = torch.ones((b,), dtype=x_t.dtype, device=x_t.device)
        if condition is not None and guidance_scale != 1.0:
            x2 = torch.cat([x_t, x_t], dim=0)
            t2 = torch.cat([t, t], dim=0)
            cond_u = torch.zeros_like(condition) if un_cond is None else un_cond
            cond2 = torch.cat([cond_u, condition], dim=0)
            mask_u = torch.zeros_like(ones) if un_cond is None else ones
            mask2 = torch.cat([mask_u, ones], dim=0)
            sc2 = None if self_cond is None else torch.cat([self_cond, self_cond], dim=0)
            pred2, _ = apply(x2, t2, cond2, mask2, self_cond=sc2)
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
        pred, _ = apply(x_t, t, condition, cond_mask, self_cond=self_cond)
        return pred

    @staticmethod
    def _rescale_guided(guided, cond, phi):
        """std-pin the guided prediction to the conditional one, lerp by phi."""
        axes = tuple(range(1, guided.ndim))
        std_cond = torch.std(cond, dim=axes, keepdim=True, correction=0)
        std_guided = torch.std(guided, dim=axes, keepdim=True, correction=0)
        rescaled = guided * (std_cond / torch.clamp(std_guided, min=1e-8))
        return phi * rescaled + (1 - phi) * guided

    def _split_variance(self, pred):
        """(pred, var_scale) of an output with a learned variance."""
        if not self.estimate_variance:
            return pred, 0.0
        pred, pred_var = torch.chunk(pred, 2, dim=1)
        return pred, pred_var / 2 + 0.5

    def _x0_of(self, x_t, pred, t, clip: bool):
        """x_0 from the objective-space ``pred`` (the eps inversion is not
        terminal-safe)."""
        if self.estimator_objective == "x_T":
            return S.estimate_x_0(self.scheduler, x_t, pred, t, clip=clip)
        if self.estimator_objective == "v":
            return S.estimate_x_0_from_v(self.scheduler, x_t, pred, t, clip=clip)
        return S.clip_x0(pred) if clip else pred

    def estimate(self, x_t, t, noise=None, condition=None, guidance_scale: float = 1.0,
                 guidance_rescale: float = 0.0, un_cond=None, self_cond=None,
                 cold_diffusion: bool = False, classifier_grad=None,
                 classifier_scale: float = 0.0):
        """One reverse step: returns (x_t_prior, x_0, x_T, new_self_cond).
        ``noise`` is the ancestral step's standard-normal draw (zeros when
        None). ``classifier_grad(x_t, t)`` (``guidance.py``) shifts the eps
        prediction by ``-classifier_scale * sqrt(1 - abar_t) * grad``."""
        pred = self._guided_pred(x_t, t, condition, guidance_scale, guidance_rescale,
                                 un_cond, self_cond)
        pred, var_scale = self._split_variance(pred)
        if classifier_grad is not None:
            pred = self._classifier_shift(x_t, t, pred, classifier_grad, classifier_scale)
        if noise is None:
            noise = torch.zeros_like(x_t)
        return self._pred_to_states(x_t, t, pred, noise, cold_diffusion, var_scale)

    def _check_classifier_guidance(self):
        if self.estimator_objective != "x_T":
            raise ValueError("classifier guidance shifts the eps prediction; use the "
                             "eps ('x_T') objective")

    def _classifier_shift(self, x_t, t, pred, classifier_grad, scale: float):
        """The eps prediction steered by the classifier (arXiv:2105.05233
        Alg. 2): ``pred - scale * sqrt(1 - abar_t) * grad``."""
        self._check_classifier_guidance()
        shift = S.extract(self.scheduler.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
        return pred - scale * shift * classifier_grad(x_t, t)

    def _pred_to_states(self, x_t, t, pred, noise, cold_diffusion: bool = False,
                        var_scale=0.0):
        """Objective-space ``pred`` -> (x_t_prior, x_0, x_T, new_self_cond),
        with the terminal-safe inversions; shared by every sampler."""
        sched, clip = self.scheduler, self.clip_x0
        safe = self._terminal_safe
        if self.estimator_objective == "x_0":
            if cold_diffusion:
                x_prior, x_0 = S.cold_diffusion_step(sched, x_t, t, pred, clip=clip)
            else:
                x_prior, x_0 = S.ancestral_step(sched, x_t, t, pred, noise, clip=clip,
                                                var_scale=var_scale)
            est = S.estimate_x_T_safe if safe else S.estimate_x_T
            x_T = est(sched, x_t, x_0=pred, t=t, clip=clip)
            return x_prior, x_0, x_T, x_T
        if self.estimator_objective == "v":
            x_0v = self._x0_of(x_t, pred, t, clip)
            if cold_diffusion:
                x_prior, x_0 = S.cold_diffusion_step(sched, x_t, t, x_0v, clip=clip)
            else:
                x_prior, x_0 = S.ancestral_step(sched, x_t, t, x_0v, noise, clip=clip,
                                                var_scale=var_scale)
            if safe and not clip:
                x_T = S.estimate_x_T_from_v(sched, x_t, pred, t)
            elif safe:
                x_T = S.estimate_x_T_safe(sched, x_t, x_0=x_0v, t=t, clip=clip)
            else:
                x_T = S.estimate_x_T(sched, x_t, x_0=x_0v, t=t, clip=clip)
            return x_prior, x_0, x_T, x_0
        if cold_diffusion:
            x_0c = self._x0_of(x_t, pred, t, clip)
            x_prior, x_0 = S.cold_diffusion_step(sched, x_t, t, x_0c, clip=clip)
        else:
            x_prior, x_0 = S.ancestral_step_from_eps(sched, x_t, t, pred, noise, clip=clip,
                                                     var_scale=var_scale)
        return x_prior, x_0, pred, x_0

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
