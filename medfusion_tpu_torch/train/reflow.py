"""Reflow: rectified-flow straightening and one-step distillation (port of
``medfusion_tpu/train/reflow.py``; Liu et al., arXiv:2209.03003 §3), the
flow family's counterpart of progressive distillation.

1. Pairs: from z1 ~ N(0, I) the teacher's probability-flow ODE gives z0,
   a deterministic coupling (:func:`generate_reflow_pairs`; z1 is an
   input, drawn by the caller).
2. Reflow: the flow-matching loss on the straight path x_t = (1 - t) z0 +
   t z1 between coupled pairs, whose velocity z1 - z0 is constant
   (:func:`make_reflow_loss`).
3. ``distill_t`` fixes t (1.0 trains the one-Euler-step generator z0 = z1 -
   v(z1, 1)).

The loss's time draw is the pipeline's raw draw (``t_draw``, as
``FlowMatchingPipeline.train_draws`` makes it), passed as a tensor.
Public tensors are channels-last.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.train.diffusion import train_on, with_compute_dtype
from medfusion_tpu_torch.train.state import TrainState


@torch.no_grad()
def generate_reflow_pairs(pipeline: FlowMatchingPipeline, z1, condition=None,
                          steps: int = 32, heun: bool = True,
                          guidance_scale: float = 1.0, un_cond=None):
    """``(z1, z0)``: z0 the solution at t = 0 of the ODE of ``pipeline``'s
    estimator (the teacher) from the channels-last standard-normal ``z1``,
    in latent space (no decode). ``guidance_scale`` != 1 bakes the
    CFG-combined teacher into the coupling."""
    z0 = pipeline.denoise(z1, condition=condition, steps=steps,
                          guidance_scale=guidance_scale, un_cond=un_cond, decode=False,
                          heun=heun)
    return z1, z0


def make_reflow_loss(pipeline: FlowMatchingPipeline,
                     distill_t: Optional[float] = None) -> Callable:
    """Returns ``loss_fn(student_params, batch, draws) -> (loss, metrics)``:
    ``batch`` the coupled pairs ``z0``, ``z1`` (channels-last) and
    optional labels ``target``; t from ``draws['t_draw']`` through the
    pipeline's time distribution and shift, or ``distill_t``; the loss the
    mean squared error of the student's velocity against z1 - z0, its one
    metric ``loss``."""
    if distill_t is not None and not 0.0 < distill_t <= 1.0:
        raise ValueError("distill_t must be in (0, 1]")

    def loss_fn(student_params, batch: Mapping, draws: Mapping):
        z0, z1 = _to_nchw(batch["z0"]), _to_nchw(batch["z1"])
        condition = batch.get("target")
        b = z0.shape[0]
        if distill_t is None:
            t = pipeline._sample_t(draws["t_draw"].to(z0.device))
        else:
            t = torch.full((b,), distill_t, dtype=torch.float32, device=z0.device)
        t_b = t.reshape((b,) + (1,) * (z0.ndim - 1))
        x_t = (1.0 - t_b) * z0 + t_b * z1
        cond_mask = None if condition is None else torch.ones((b,), dtype=z0.dtype,
                                                              device=z0.device)
        pred, _ = pipeline._apply_estimator(x_t, t * pipeline.time_scale, condition, cond_mask,
                                            student_params)
        loss = ((pred - (z1 - z0)) ** 2).mean()
        return loss, {"loss": loss}

    return loss_fn


def reflow_draws(pipeline: FlowMatchingPipeline, batch_size: int, generator=None,
                 device=None) -> Dict[str, torch.Tensor]:
    """The reflow loss's draw: ``t_draw`` [B], a standard normal for the
    logit-normal time, else uniform in [0, 1)."""
    kw = dict(generator=generator, device=device)
    draw = torch.randn if pipeline.timestep_sampling == "logit_normal" else torch.rand
    return {"t_draw": draw((batch_size,), **kw)}


def make_reflow_train_step(pipeline: FlowMatchingPipeline, distill_t: Optional[float] = None,
                           compute_dtype=None) -> Callable:
    """``step_fn(state, batch, draws) -> metrics`` over pre-generated pair
    batches: the teacher appears only through the pairs, so one pool serves
    many steps. ``compute_dtype`` = bf16 on float32 masters."""
    pipeline = with_compute_dtype(pipeline, compute_dtype)
    loss_fn = make_reflow_loss(pipeline, distill_t)

    def step_fn(state: TrainState, batch, draws):
        return train_on(state, pipeline.compute_dtype,
                        lambda params: loss_fn(params, batch, draws))

    return step_fn
