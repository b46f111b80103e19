"""Consistency distillation and consistency training (port of
``medfusion_tpu/train/consistency.py``; Song et al., arXiv:2303.01469, with
the improved techniques of arXiv:2310.14189).

Points live in k-space, x = x0 + sigma eps with sigma_t = sqrt((1 - abar_t)
/ abar_t); the VP estimator is queried at x * c_in with the fractional t of
``sigma_to_t_frac``, as ``denoise_edm`` queries it.

* :func:`consistency_function`: f(x, sigma) = c_skip x + c_out F(x, sigma),
  c_skip = sd^2 / ((sigma - sigma_min)^2 + sd^2), c_out = sd (sigma -
  sigma_min) / sqrt(sigma^2 + sd^2), F the estimator's x0-prediction, so
  f(x, sigma_min) = x for any parameters;
* consistency distillation (CD): noise to sigma_{n+1} on a Karras grid,
  one teacher probability-flow step (Euler, or Heun) to sigma_n, and the
  distance (squared L2, or pseudo-Huber) between the student's f at
  sigma_{n+1} and the target's (the student's EMA, or the student itself,
  without gradient) at sigma_n;
* consistency training (CT): no teacher; both points on the trajectory
  of one shared eps, the grid index drawn lognormally (§3.5), each sample
  weighted 1/(sigma_{n+1} - sigma_n), and the discretization doubling
  stage by stage (:func:`ct_curriculum_grid`);
* :func:`consistency_sample`: f at sigma_max, then renoise-and-f on a
  descending Karras grid for the steps after the first.

Parameters are dicts (name -> tensor) run through the pipeline's estimator
module, as in ``train/distillation.py``; the draws are tensors: ``n`` and
``eps`` for the losses (the JAX key's ``split(rng)`` order), one renoise
draw a step after the first for the sampler (the JAX sampler's
``fold_in(rng, i)``). Public tensors are channels-last.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.train.diffusion import frozen_params, train_on, with_compute_dtype
from medfusion_tpu_torch.train.distillation import Params, predict
from medfusion_tpu_torch.train.state import TrainState

SOLVERS = ("euler", "heun")


def _sigma_bounds(sched):
    sig = S.kdiff_sigmas(sched)
    return sig[0], sig[-1]


def _bcast(sigma, ndim: int, b: int, device):
    """A scalar or [B] sigma as [B, 1, 1, ...] float32."""
    s = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    return torch.broadcast_to(s, (b,)).reshape(b, *([1] * (ndim - 1)))


def _x0_from_model(pipeline, params: Params, x_k, sigma, condition,
                   guidance_scale: float = 1.0, un_cond=None):
    """The estimator's x0-prediction at the NCHW k-space point ``x_k``
    (unclipped), queried in VP space at the fractional timestep of
    ``sigma``; the CFG-combined prediction where ``guidance_scale`` != 1."""
    sched = pipeline.scheduler
    b, dev = x_k.shape[0], x_k.device
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    c_in = 1.0 / torch.sqrt(1.0 + sigma ** 2)
    t_b = torch.broadcast_to(S.sigma_to_t_frac(sched, sigma), (b,)).float()
    x_vp = x_k * _bcast(c_in, x_k.ndim, b, dev)
    pred = predict(pipeline, params, x_vp, t_b, condition, guidance_scale, un_cond)
    s_b = _bcast(sigma, x_k.ndim, b, dev)
    if pipeline.estimator_objective == "x_T":
        return x_k - s_b * pred
    if pipeline.estimator_objective == "v":
        return x_k / (1.0 + s_b ** 2) - (s_b / torch.sqrt(1.0 + s_b ** 2)) * pred
    return pred


def _f(pipeline, params: Params, x_k, sigma, condition=None, sigma_data: float = 0.5):
    """:func:`consistency_function` on NCHW tensors."""
    sigma_min, _ = _sigma_bounds(pipeline.scheduler)
    s = _bcast(sigma, x_k.ndim, x_k.shape[0], x_k.device)
    c_skip = sigma_data ** 2 / ((s - sigma_min) ** 2 + sigma_data ** 2)
    c_out = sigma_data * (s - sigma_min) / torch.sqrt(s ** 2 + sigma_data ** 2)
    out = c_skip * x_k + c_out * _x0_from_model(pipeline, params, x_k, sigma, condition)
    return torch.clamp(out, -1.0, 1.0) if pipeline.clip_x0 else out


def consistency_function(pipeline: DiffusionPipeline, params: Params, x_k, sigma,
                         condition=None, sigma_data: float = 0.5):
    """f(x, sigma) on a channels-last k-space point, with the boundary
    parameterization: f(x, sigma_min) = x for any ``params`` (None: the
    estimator's own)."""
    return _to_nhwc(_f(pipeline, params, _to_nchw(x_k), sigma, condition, sigma_data))


def _check_pipeline(pipeline, what: str, n_grid: int) -> None:
    if pipeline.use_self_conditioning:
        raise ValueError(f"{what}: self-cond unsupported")
    if pipeline.clip_x0:
        raise ValueError(
            "consistency training/distillation needs clip_x0=False: clipping f breaks "
            "the boundary parameterization and zeroes gradients where |f| > 1 (common "
            "at mid/large sigma early in training)")
    if pipeline.scheduler.zero_terminal_snr:
        raise ValueError(f"{what} runs in k-space (sigma_max = inf on zero-terminal-SNR "
                         f"schedules); use a standard schedule")
    if n_grid < 2:
        raise ValueError("n_grid must be >= 2")


def sigma_grid(sched, n_grid: int, rho: float = 7.0) -> torch.Tensor:
    """The ascending Karras grid sigma_1 .. sigma_N (float32)."""
    sigma_min, sigma_max = _sigma_bounds(sched)
    return torch.flip(S.karras_sigma_grid(sigma_min, sigma_max, n_grid, rho)[:-1], (0,))


def _distance(diff, huber_c: Optional[float]):
    """Per-sample mean squared error, or pseudo-Huber sqrt(|d|^2 + c^2) - c."""
    axes = tuple(range(1, diff.ndim))
    if huber_c is None:
        return (diff ** 2).mean(dim=axes)
    return torch.sqrt((diff ** 2).sum(dim=axes) + huber_c ** 2) - huber_c


def make_consistency_distillation_loss(
        pipeline: DiffusionPipeline, n_grid: int = 18, rho: float = 7.0,
        sigma_data: float = 0.5, huber_c: Optional[float] = None,
        teacher_guidance_scale: float = 1.0, solver: str = "euler") -> Callable:
    """Returns ``loss_fn(student_params, target_params, teacher_params,
    batch, draws) -> (loss, metrics)``: ``n_grid`` the grid's size N,
    ``huber_c`` None for squared L2, ``solver`` the teacher's step ('euler',
    or 'heun': one more teacher forward for an O(h^2) target);
    ``batch['source']`` a channels-last x_0 in the working space (and
    ``target``, ``un_cond``); ``draws`` ``n`` [B] in 0..N-2 and ``eps``
    (channels-last). Metrics ``loss`` and ``f_gap``."""
    _check_pipeline(pipeline, "consistency distillation", n_grid)
    if solver not in SOLVERS:
        raise ValueError(f"solver must be 'euler' or 'heun', got {solver!r}")
    sched = pipeline.scheduler

    def loss_fn(student_params, target_params, teacher_params, batch: Mapping,
                draws: Mapping):
        x_0 = _to_nchw(batch["source"])
        condition, un_cond = batch.get("target"), batch.get("un_cond")
        b, nd, dev = x_0.shape[0], x_0.ndim, x_0.device
        grid = sigma_grid(sched, n_grid, rho)
        n = draws["n"].to(dev)
        s_lo, s_hi = grid[n], grid[n + 1]
        x_hi = x_0 + _bcast(s_hi, nd, b, dev) * _to_nchw(draws["eps"])

        with torch.no_grad():  # one teacher probability-flow step sigma_{n+1} -> sigma_n
            h = _bcast(s_lo - s_hi, nd, b, dev)
            d = (x_hi - _x0_from_model(pipeline, teacher_params, x_hi, s_hi, condition,
                                       teacher_guidance_scale, un_cond)) / _bcast(s_hi, nd, b, dev)
            x_lo = x_hi + h * d
            if solver == "heun":
                d2 = (x_lo - _x0_from_model(pipeline, teacher_params, x_lo, s_lo, condition,
                                            teacher_guidance_scale, un_cond)
                      ) / _bcast(s_lo, nd, b, dev)
                x_lo = x_hi + h * 0.5 * (d + d2)
            f_target = _f(pipeline, target_params, x_lo, s_lo, condition, sigma_data)

        diff = _f(pipeline, student_params, x_hi, s_hi, condition, sigma_data) - f_target
        loss = _distance(diff, huber_c).mean()
        return loss, {"loss": loss, "f_gap": diff.abs().mean()}

    return loss_fn


def consistency_draws(batch_size: int, latent_shape, n_grid: int, generator=None,
                      device=None) -> Dict[str, torch.Tensor]:
    """The draws of one CD loss: ``n`` [B] uniform in 0..N-2, then ``eps``
    [B, *latent_shape] standard normal."""
    kw = dict(generator=generator, device=device)
    return {"n": torch.randint(0, n_grid - 1, (batch_size,), **kw),
            "eps": torch.randn((batch_size, *latent_shape), **kw)}


def make_consistency_train_step(
        pipeline: DiffusionPipeline, n_grid: int = 18, rho: float = 7.0,
        sigma_data: float = 0.5, huber_c: Optional[float] = None,
        teacher_guidance_scale: float = 1.0, solver: str = "euler",
        compute_dtype=None) -> Callable:
    """Returns ``step_fn(state, teacher, batch, draws) -> metrics``: the CD
    loss with ``teacher`` (a frozen module of the student's architecture)
    and the target network: the state's EMA where it has one (the paper's
    target network; ``apply_gradients`` updates it), else the student
    without gradient (arXiv:2310.14189); one AdamW step of the student."""
    pipeline = with_compute_dtype(pipeline, compute_dtype)
    dtype = pipeline.compute_dtype
    loss_fn = make_consistency_distillation_loss(pipeline, n_grid, rho, sigma_data, huber_c,
                                                 teacher_guidance_scale, solver)

    def step_fn(state: TrainState, teacher: torch.nn.Module, batch, draws):
        teacher_params = frozen_params(teacher, dtype)
        target_params = frozen_params(state.inference_model, dtype)
        return train_on(state, dtype, lambda params: loss_fn(
            params, target_params, teacher_params, batch, draws))

    return step_fn


def ct_grid_logits(sched, n_grid: int, rho: float = 7.0, p_mean: float = -1.1,
                   p_std: float = 2.0) -> torch.Tensor:
    """CT's categorical log-probabilities over the N - 1 adjacent grid pairs
    (float32): p(n) proportional to erf((ln sigma_{n+1} - P_mean) / (sqrt2
    P_std)) - erf(the same at sigma_n), floored at 1e-12, as the JAX
    package computes them (erf in float32 on a float64 argument)."""
    g = sigma_grid(sched, n_grid, rho).double().cpu().numpy()
    arg = ((np.log(g) - p_mean) / (np.sqrt(2.0) * p_std)).astype(np.float32)
    cdf = torch.erf(torch.from_numpy(arg)).numpy()
    probs = np.clip(cdf[1:] - cdf[:-1], 1e-12, None)
    return torch.from_numpy(np.log(probs / probs.sum()).astype(np.float32))


def make_consistency_training_loss(
        pipeline: DiffusionPipeline, n_grid: int = 18, rho: float = 7.0,
        sigma_data: float = 0.5, huber_c: Optional[float] = None) -> Callable:
    """Teacher-free consistency training (arXiv:2303.01469 Alg. 3 with
    arXiv:2310.14189): ``loss_fn(student_params, batch, draws) -> (loss,
    metrics)``, ``draws`` ``n`` (:func:`ct_draws`, lognormal over the grid)
    and ``eps``; the target is the student without gradient. Metrics
    ``loss``, ``f_gap`` and ``sigma_hi_mean``."""
    _check_pipeline(pipeline, "consistency training", n_grid)
    sched = pipeline.scheduler

    def loss_fn(student_params, batch: Mapping, draws: Mapping):
        x_0 = _to_nchw(batch["source"])
        condition = batch.get("target")
        b, nd, dev = x_0.shape[0], x_0.ndim, x_0.device
        grid = sigma_grid(sched, n_grid, rho)
        n = draws["n"].to(dev)
        s_lo, s_hi = grid[n], grid[n + 1]
        eps = _to_nchw(draws["eps"])
        # the SAME eps puts both points on one estimated trajectory
        x_hi = x_0 + _bcast(s_hi, nd, b, dev) * eps
        x_lo = x_0 + _bcast(s_lo, nd, b, dev) * eps
        with torch.no_grad():
            target = {k: v.detach() for k, v in student_params.items()}
            f_target = _f(pipeline, target, x_lo, s_lo, condition, sigma_data)
        diff = _f(pipeline, student_params, x_hi, s_hi, condition, sigma_data) - f_target
        loss = ((1.0 / (s_hi - s_lo)) * _distance(diff, huber_c)).mean()
        return loss, {"loss": loss, "f_gap": diff.abs().mean(),
                      "sigma_hi_mean": s_hi.mean()}

    return loss_fn


def ct_draws(logits: torch.Tensor, batch_size: int, latent_shape, generator=None,
             device=None) -> Dict[str, torch.Tensor]:
    """The draws of one CT loss: ``n`` [B] from the categorical ``logits``
    (:func:`ct_grid_logits`), then ``eps`` standard normal."""
    probs = torch.softmax(logits.to(device), dim=0)
    n = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
    return {"n": n, "eps": torch.randn((batch_size, *latent_shape), generator=generator,
                                       device=device)}


def make_consistency_training_step(
        pipeline: DiffusionPipeline, n_grid: int = 18, rho: float = 7.0,
        sigma_data: float = 0.5, huber_c: Optional[float] = None,
        compute_dtype=None) -> Callable:
    """``step_fn(state, batch, draws) -> metrics`` for consistency training
    (no teacher)."""
    pipeline = with_compute_dtype(pipeline, compute_dtype)
    loss_fn = make_consistency_training_loss(pipeline, n_grid, rho, sigma_data, huber_c)

    def step_fn(state: TrainState, batch, draws):
        return train_on(state, pipeline.compute_dtype,
                        lambda params: loss_fn(params, batch, draws))

    return step_fn


def ct_curriculum_grid(total_iters: int, s0: int = 10, s1: int = 1280,
                       doublings: Optional[int] = None):
    """The iCT discretization curriculum (arXiv:2310.14189 §3.6): ``(start
    iteration, n_grid)`` stages with N(k) = min(s0 2^k, s1) + 1, doubling
    up to and clamped at s1 + 1, each stage an equal share of
    ``total_iters``; ``doublings`` caps the number of stages."""
    ns = []
    n = s0
    while True:
        ns.append(min(n, s1) + 1)
        if n >= s1:
            break
        n *= 2
    if doublings is not None:
        ns = ns[: max(1, doublings)]
    share = max(1, total_iters // len(ns))
    return [(i * share, ns[i]) for i in range(len(ns))]


@torch.no_grad()
def consistency_sample(pipeline: DiffusionPipeline, x_T_vp, noise=None, steps: int = 1,
                       condition=None, sigma_data: float = 0.5, rho: float = 7.0,
                       decode: bool = True, generator=None):
    """One- or few-step consistency sampling (paper Alg. 1): f at sigma_max
    from the standard-normal VP prior draw ``x_T_vp`` (channels-last), then
    ``steps`` - 1 renoise-to-sigma_i-and-f rounds on the Karras grid's
    intermediate levels, with the pipeline's estimator. ``noise`` [steps -
    1, *x_T_vp.shape] holds the renoise draws (else ``generator`` draws
    them). Returns channels-last images (latents without ``decode``)."""
    if noise is not None and tuple(noise.shape) != (steps - 1, *x_T_vp.shape):
        raise ValueError(f"noise must have shape {(steps - 1, *x_T_vp.shape)}, got "
                         f"{tuple(noise.shape)}")
    sched = pipeline.scheduler
    sigma_min, sigma_max = _sigma_bounds(sched)
    x = _to_nchw(x_T_vp) * torch.sqrt(1.0 + sigma_max ** 2)  # VP prior -> k-space
    out = _f(pipeline, None, x, sigma_max, condition, sigma_data)
    if steps > 1:
        grid = S.karras_sigma_grid(sigma_min, sigma_max, steps + 1, rho)[1:steps]
        for i in range(steps - 1):
            z = (_to_nchw(noise[i].to(out.device)) if noise is not None
                 else torch.randn(out.shape, generator=generator, device=out.device))
            s = grid[i]
            s_eff = torch.sqrt(torch.clamp(s ** 2 - sigma_min ** 2, min=0.0))
            out = _f(pipeline, None, out + s_eff * z, s, condition, sigma_data)
    if decode:
        out = pipeline.decode_latent(out)
    return _to_nhwc(out)
