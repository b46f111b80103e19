"""Noisy-latent classifier training for classifier guidance (port of
``medfusion_tpu/train/classifier.py``): the classifier learns
(x_t, t) -> label on latents q-sampled to uniform timesteps
(arXiv:2105.05233 §4), so that it sees the noise levels the guided sampler
queries it at. The latent embedder is frozen.

The draws are explicit, as the JAX package splits its key
(``k_enc, k_t, k_noise, k_drop = split(rng, 4)``): ``enc_noise``, ``t``
and ``eps``; the classifier has no dropout, so ``k_drop`` has no
counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping

import torch

from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw
from medfusion_tpu_torch.train.state import TrainState


@dataclasses.dataclass
class ClassifierTrainer:
    """``classifier`` maps (x_t NCHW, t [B]) to logits [B, K]
    (``models/unet_openai.py::EncoderUNetOpenAI``); ``latent_embedder`` is
    the frozen VAE, or None for a classifier on the images themselves."""

    classifier: Any
    scheduler: GaussianDiffusionSchedule
    latent_embedder: Any = None

    def draws(self, batch_size: int, latent_shape, generator=None) -> Dict[str, torch.Tensor]:
        """``enc_noise`` and ``eps`` [B, *latent_shape] (channels-last)
        standard normal, ``t`` [B] uniform integers in [0, T)."""
        shape = (batch_size, *latent_shape)
        kw = dict(generator=generator, device=next(self.classifier.parameters()).device)
        return {"enc_noise": torch.randn(shape, **kw),
                "t": torch.randint(0, self.scheduler.T, (batch_size,), **kw),
                "eps": torch.randn(shape, **kw)}

    def loss(self, batch: Mapping[str, torch.Tensor], draws: Mapping[str, torch.Tensor]):
        """Cross-entropy of the classifier on the q-sampled latents of
        ``batch`` (``source`` [B, H, W, C], integer ``target`` [B]); returns
        (loss, metrics ``loss`` and ``acc``)."""
        x_in = _to_nchw(batch["source"])
        labels = batch["target"].long()
        if self.latent_embedder is not None:
            with torch.no_grad():
                z = self.latent_embedder.encode(x_in, _to_nchw(draws["enc_noise"]))
        else:
            z = x_in
        t = draws["t"]
        x_t = S.q_sample(self.scheduler, z, t, _to_nchw(draws["eps"]))
        logits = self.classifier(x_t, t)
        lp = torch.log_softmax(logits.float(), dim=-1)
        ce = -lp.gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return ce, {"loss": ce, "acc": acc}


def make_classifier_train_step(trainer: ClassifierTrainer) -> Callable:
    """``step_fn(state, batch, draws) -> metrics``: one loss and gradient of
    ``state.model`` (the classifier), one AdamW update, the metrics
    detached."""

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor],
                draws: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = trainer.loss(batch, draws)
        loss.backward()
        for p in state.model.parameters():
            if p.grad is None:  # decayed all the same, as optax's adamw does
                p.grad = torch.zeros_like(p)
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn
