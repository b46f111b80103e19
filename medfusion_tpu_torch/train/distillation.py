"""Progressive distillation (port of ``medfusion_tpu/train/distillation.py``;
Salimans & Ho, arXiv:2202.00512): a student that samples in N DDIM steps
learns what its teacher does in 2N, and stages chain N -> N/2 -> ... -> 1.

* The student's levels are t_i = round(i T / N) - 1, i in 1..N; a draw i
  noises x_0 to z_t at t_i, the teacher takes two deterministic DDIM (eta
  0) half-steps t_i -> t_mid -> t_end (t_mid = round((i - 0.5) T / N) - 1,
  t_end = t_{i-1}, and t = -1 means clean: alpha 1, sigma 0);
* the target is the x-prediction with which one student DDIM step from z_t
  lands on the teacher's z_end (paper eq. 9), and the loss the truncated
  SNR weight max(alpha^2 / sigma^2, 1) times the x-space squared error.

Teacher and student are one architecture: the pipeline's estimator module
runs on either parameter dict (name -> tensor) through ``functional_call``.
Randomness is explicit: :func:`distillation_draws` makes the draws the JAX
loss takes from its key (``split(rng)`` -> i, then the noise), as tensors
the loss takes. Public tensors are channels-last, as in the pipelines.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.train.diffusion import frozen_params, train_on, with_compute_dtype
from medfusion_tpu_torch.train.state import TrainState

Params = Optional[Mapping[str, torch.Tensor]]


def _alpha_sigma(sched, t, ndim):
    """(sqrt(abar_t), sqrt(1 - abar_t)), with alpha 1 and sigma 0 at t = -1."""
    tc = torch.clamp(t, min=0)
    a = S.extract(sched.sqrt_alphas_cumprod, tc, ndim)
    s = S.extract(sched.sqrt_one_minus_alphas_cumprod, tc, ndim)
    neg = (t < 0).reshape(-1, *([1] * (ndim - 1)))
    return torch.where(neg, 1.0, a), torch.where(neg, 0.0, s)


def with_params(pipeline, params: Params) -> Callable:
    """The pipeline's ``_apply_estimator`` on ``params`` (None: the module's
    own), in the call form ``_guided_pred`` takes for ``estimator``."""
    def apply(x, t, condition, cond_mask, self_cond=None):
        return pipeline._apply_estimator(x, t, condition, cond_mask, params, self_cond)
    return apply


def predict(pipeline, params: Params, x, t, condition, guidance_scale: float = 1.0,
            un_cond=None):
    """One estimator output on NCHW ``x`` (its learned-variance half
    dropped): the CFG-combined prediction where ``guidance_scale`` != 1 and
    there is a condition, else one conditional (or unconditional) forward."""
    apply = with_params(pipeline, params)
    if guidance_scale != 1.0 and condition is not None:
        pred = pipeline._guided_pred(x, t, condition, guidance_scale, un_cond=un_cond,
                                     estimator=apply)
    else:
        cond_mask = (None if condition is None
                     else torch.ones((x.shape[0],), dtype=x.dtype, device=x.device))
        pred, _ = apply(x, t, condition, cond_mask)
    if pipeline.estimate_variance:
        pred, _ = torch.chunk(pred, 2, dim=1)
    return pred


def _x0_eps(pipeline, params: Params, z, t, condition, guidance_scale: float = 1.0,
            un_cond=None):
    """(x0, eps) of one (guided) forward, unclipped: clipping would break the
    target's algebra."""
    pred = predict(pipeline, params, z, t, condition, guidance_scale, un_cond)
    sched = pipeline.scheduler
    if pipeline.estimator_objective == "x_T":
        return S.estimate_x_0(sched, z, pred, t, clip=False), pred
    if pipeline.estimator_objective == "v":
        return (S.estimate_x_0_from_v(sched, z, pred, t, clip=False),
                S.estimate_x_T_from_v(sched, z, pred, t))
    return pred, S.estimate_x_T_safe(sched, z, x_0=pred, t=t, clip=False)


def _ddim_to(pipeline, params, z, t_from, t_to, condition, guidance_scale=1.0, un_cond=None):
    """One deterministic DDIM transition: alpha_to x0 + sigma_to eps."""
    x0, eps = _x0_eps(pipeline, params, z, t_from, condition, guidance_scale, un_cond)
    a_to, s_to = _alpha_sigma(pipeline.scheduler, t_to, z.ndim)
    return a_to * x0 + s_to * eps


def student_timestep_grid(T: int, student_steps: int) -> Callable:
    """``grid(i) -> (t_i, t_mid, t_end)`` long tensors for i in 1..N, looked
    up in float64 host tables (a float32 round of i T / N would put some
    exact halves on the other side), so t_i equals
    ``ddim_timesteps_host(N, 'trailing')``: the student samples on the
    grid it was trained on."""
    i_host = np.arange(1, student_steps + 1, dtype=np.float64)
    t_tab = (np.round(i_host * (T / student_steps)) - 1).astype(np.int64)
    t_mid_tab = (np.round((i_host - 0.5) * (T / student_steps)) - 1).astype(np.int64)
    t_end_tab = np.concatenate([[-1], t_tab[:-1]])  # i = 1 ends fully clean
    tabs = [torch.from_numpy(a) for a in (t_tab, t_mid_tab, t_end_tab)]

    def grid(i):
        idx = i.long() - 1
        return tuple(tab.to(i.device)[idx] for tab in tabs)

    return grid


def _targets(pipeline, teacher_params, x_0, i, noise, student_steps, condition=None,
             teacher_guidance_scale=1.0, un_cond=None):
    """:func:`distillation_targets` on NCHW tensors."""
    sched = pipeline.scheduler
    t, t_mid, t_end = student_timestep_grid(sched.T, student_steps)(i)
    z_t = S.q_sample(sched, x_0, t, noise)
    with torch.no_grad():
        z_mid = _ddim_to(pipeline, teacher_params, z_t, t, t_mid, condition,
                         teacher_guidance_scale, un_cond)
        z_end = _ddim_to(pipeline, teacher_params, z_mid, t_mid, t_end, condition,
                         teacher_guidance_scale, un_cond)
    a_t, s_t = _alpha_sigma(sched, t, x_0.ndim)
    a_e, s_e = _alpha_sigma(sched, t_end, x_0.ndim)
    ratio = s_e / s_t  # s_t > 0: t >= round(T/N) - 1 >= 1 for N <= T // 2
    x_tilde = (z_end - ratio * z_t) / (a_e - ratio * a_t)
    w = torch.clamp((a_t / s_t) ** 2, min=1.0)  # truncated SNR (App. E)
    return z_t, t, x_tilde, w


def distillation_targets(pipeline: DiffusionPipeline, teacher_params: Params, x_0, i,
                         noise, student_steps: int, condition=None,
                         teacher_guidance_scale: float = 1.0, un_cond=None):
    """(z_t, t, x_tilde, w) for channels-last ``x_0`` and ``noise`` and the
    drawn ``i`` [B] in 1..N: noise to the student's level, two teacher
    half-steps (the CFG-combined teacher where ``teacher_guidance_scale`` !=
    1, guided distillation at a fixed weight, arXiv:2210.03142), the
    one-step x-target (paper eq. 9) and the truncated-SNR weight [B, 1, 1,
    1]. z_t and x_tilde come back channels-last; no gradient reaches the
    teacher."""
    z_t, t, x_tilde, w = _targets(pipeline, teacher_params, _to_nchw(x_0), i,
                                  _to_nchw(noise), student_steps, condition,
                                  teacher_guidance_scale, un_cond)
    return _to_nhwc(z_t), t, _to_nhwc(x_tilde), w


def make_distillation_loss(pipeline: DiffusionPipeline, student_steps: int,
                           teacher_guidance_scale: float = 1.0) -> Callable:
    """Returns ``loss_fn(student_params, teacher_params, batch, draws) ->
    (loss, metrics)``. ``batch['source']`` is a channels-last latent in the
    diffusion working space (encoded upstream, outside the step),
    ``batch['target']`` the labels, ``batch['un_cond']`` the guided
    teacher's negative labels; ``draws`` as :func:`distillation_draws`
    makes them. Metrics: ``loss``, ``x_mse`` and ``weight_mean``."""
    sched = pipeline.scheduler
    if not 1 <= student_steps <= sched.T // 2:
        raise ValueError(
            f"student_steps must be in [1, T//2={sched.T // 2}]: the teacher takes two "
            f"half-steps per student step on the T={sched.T} grid")
    if pipeline.use_self_conditioning:
        raise ValueError("distillation: self-conditioning unsupported")
    if pipeline.estimate_variance:
        raise ValueError("distillation: learned-variance estimators unsupported")

    def loss_fn(student_params, teacher_params, batch: Mapping, draws: Mapping):
        x_0 = _to_nchw(batch["source"])
        condition = batch.get("target")
        z_t, t, x_tilde, w = _targets(pipeline, teacher_params, x_0, draws["i"],
                                      _to_nchw(draws["noise"]), student_steps, condition,
                                      teacher_guidance_scale, batch.get("un_cond"))
        x_hat, _ = _x0_eps(pipeline, student_params, z_t, t, condition)
        per_sample = ((x_tilde - x_hat) ** 2).mean(dim=tuple(range(1, x_0.ndim)))
        loss = (w.reshape(-1) * per_sample).mean()
        return loss, {"loss": loss, "x_mse": per_sample.mean(), "weight_mean": w.mean()}

    return loss_fn


def distillation_draws(batch_size: int, latent_shape, student_steps: int,
                       generator=None, device=None) -> Dict[str, torch.Tensor]:
    """The draws of one distillation loss, in the JAX key's order: ``i`` [B]
    uniform in 1..N, then ``noise`` [B, *latent_shape] (channels-last)
    standard normal."""
    kw = dict(generator=generator, device=device)
    return {"i": torch.randint(1, student_steps + 1, (batch_size,), **kw),
            "noise": torch.randn((batch_size, *latent_shape), **kw)}


def make_distillation_train_step(pipeline: DiffusionPipeline, student_steps: int,
                                 compute_dtype=None,
                                 teacher_guidance_scale: float = 1.0) -> Callable:
    """Returns ``step_fn(state, teacher, batch, draws) -> metrics``: the
    loss of :func:`make_distillation_loss` on ``state.model``'s parameters
    and the frozen ``teacher`` module's (the same architecture), one AdamW
    step of the student. ``compute_dtype`` = bf16 runs the teacher's and the
    student's forwards and the backward in bf16 on float32 masters (the
    teacher's parameters cast on each step, a no-op for a bf16 copy)."""
    pipeline = with_compute_dtype(pipeline, compute_dtype)
    dtype = pipeline.compute_dtype
    loss_fn = make_distillation_loss(pipeline, student_steps, teacher_guidance_scale)

    def step_fn(state: TrainState, teacher: torch.nn.Module, batch, draws):
        teacher_params = frozen_params(teacher, dtype)
        return train_on(state, dtype,
                        lambda params: loss_fn(params, teacher_params, batch, draws))

    return step_fn


def next_stage_steps(student_steps: int) -> Optional[int]:
    """The next halving, or None once the 1-step student is reached."""
    return None if student_steps <= 1 else max(1, student_steps // 2)


def student_sample_timesteps(sched, student_steps: int) -> torch.Tensor:
    """The ascending DDIM grid an N-step student was trained for, t_i =
    round(i T / N) - 1: the sampler's ``timestep_spacing='trailing'`` grid,
    so a student samples with ``denoise(steps=N, use_ddim=True, eta=0.0,
    timestep_spacing='trailing')`` on a ``clip_x0=False`` pipeline."""
    i = np.arange(1, student_steps + 1, dtype=np.float64)
    return torch.from_numpy(np.round(i * (sched.T / student_steps)).astype(np.int64) - 1)
