"""Flow-matching train step (port of ``medfusion_tpu/train/flow.py``).

:class:`~medfusion_tpu_torch.pipelines.flow.FlowMatchingPipeline` keeps the
diffusion pipeline's ``train_loss(batch, draws, estimator_params)`` and
``compute_dtype`` contract, so its step is the diffusion step: AdamW over the
estimator only, the frozen latent embedder, EMA, bf16 compute on float32
master weights."""

from __future__ import annotations

from typing import Callable

from medfusion_tpu_torch.train.diffusion import make_diffusion_train_step


def make_flow_train_step(pipeline, compute_dtype=None) -> Callable:
    """``step_fn(state, batch, draws) -> metrics`` for a flow pipeline
    (:func:`make_diffusion_train_step`, the same semantics)."""
    return make_diffusion_train_step(pipeline, compute_dtype=compute_dtype)
