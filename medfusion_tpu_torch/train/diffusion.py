"""Diffusion train step (port of ``medfusion_tpu/train/diffusion.py``):
AdamW over the noise estimator only; the latent embedder is frozen.

Mixed precision (``compute_dtype=torch.bfloat16``): the estimator's
parameters are cast from the float32 masters on every step, inside the
autograd graph, so that the gradients come back to the masters through the
cast in float32; activations run in bf16, while the master parameters, the
optimizer state and the loss stay float32. The frozen latent embedder runs
in the compute dtype too, from a private cast copy made once (the JAX
package casts its parameters on every call, to the same values). There is
no jit and no buffer donation: the step runs eagerly and updates the state
in place.

On a mesh (``parallel/mesh.py::shard_params``, or a DiT whose expert-MLP
blocks are expert-parallel) the same step runs on each rank's rows of the
batch and of the draws (``shard_batch``): :func:`estimator_params`
all-gathers each FSDP slice where it builds the parameter dict, before the
cast, and :func:`train_on` reduces the gradients and the metrics to their
means over the ranks the rows are split over, so the loss is the global
batch's mean, as the JAX package's is."""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Mapping

import torch

from medfusion_tpu_torch.parallel import mesh as parallel_mesh
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.train.state import TrainState


def with_compute_dtype(pipeline: DiffusionPipeline, compute_dtype=None) -> DiffusionPipeline:
    """``pipeline`` at ``compute_dtype`` (None keeps the pipeline's), with a
    private cast copy of its frozen latent embedder where that embedder's
    parameters are in another dtype."""
    if compute_dtype is not None:
        pipeline = dataclasses.replace(pipeline, compute_dtype=compute_dtype)
    dtype = pipeline.compute_dtype
    frozen = pipeline.latent_embedder
    if dtype is not None and frozen is not None and any(
            p.dtype != dtype for p in frozen.parameters()):
        frozen = copy.deepcopy(frozen).to(dtype).requires_grad_(False)
        pipeline = dataclasses.replace(pipeline, latent_embedder=frozen)
    return pipeline


def estimator_params(model: torch.nn.Module, dtype=None) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, cast to ``dtype`` inside the autograd
    graph (so that gradients reach the masters in their own dtype); an FSDP
    slice all-gathered first (its gradient comes back reduce-scattered)."""
    params = dict(model.named_parameters())
    plan = getattr(model, "parallel_plan", None)
    if plan is not None:
        params = {k: plan.gather_fsdp(k, p) for k, p in params.items()}
    if dtype is None:
        return params
    return {k: p.to(dtype) for k, p in params.items()}


def frozen_params(model: torch.nn.Module, dtype=None) -> Dict[str, torch.Tensor]:
    """A frozen model's parameters by name, detached, cast to ``dtype``
    (a no-op where they are in it already): a teacher or a target network
    the loss reads and does not train."""
    return {k: (p.detach() if dtype is None else p.detach().to(dtype))
            for k, p in model.named_parameters()}


def train_on(state: TrainState, compute_dtype, loss_fn: Callable) -> Dict[str, torch.Tensor]:
    """One loss and gradient of ``state.model`` and one AdamW + EMA update:
    ``loss_fn(params) -> (loss, metrics)`` on the model's parameters cast to
    ``compute_dtype`` (:func:`estimator_params`); on a mesh the gradients
    and the metrics are the means over the data ranks. Returns the metrics,
    detached."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(estimator_params(state.model, compute_dtype))
    loss.backward()
    for p in state.model.parameters():
        # a parameter the loss does not reach (the projections skipped by
        # cross-attention to one token) gets a zero gradient, so that AdamW
        # still decays it, as optax's adamw does
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics = {k: v.detach() for k, v in metrics.items()}
    group = parallel_mesh.data_parallel_group(state.model)
    if group is not None:
        parallel_mesh.sync_gradients(state.model, group)
        metrics = parallel_mesh.mean_metrics(metrics, group)
    state.apply_gradients()
    return metrics


def make_diffusion_train_step(pipeline: DiffusionPipeline,
                              compute_dtype=None) -> Callable:
    """Returns ``step_fn(state, batch, draws) -> metrics``: one loss and
    gradient of ``state.model`` (:meth:`DiffusionPipeline.train_loss` on
    ``batch`` and ``draws``), one AdamW + EMA update of ``state``, and the
    loss metrics (detached f32 scalars on the model's device).
    ``compute_dtype`` overrides the pipeline's."""
    pipeline = with_compute_dtype(pipeline, compute_dtype)

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor],
                draws: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return train_on(state, pipeline.compute_dtype,
                        lambda params: pipeline.train_loss(batch, draws,
                                                           estimator_params=params))

    return step_fn
