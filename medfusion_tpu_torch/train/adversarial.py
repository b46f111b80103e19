"""Adversarial autoencoder training, VAEGAN and VQGAN (port of
``medfusion_tpu/train/adversarial.py``).

One step takes a batch through both players, as the reference's Lightning
module does with its two optimizers; :class:`GANTrainState`'s ``step``
counts optimizer steps, two a batch.

* Generator loss: at each pyramid level, rec_loss + gan_loss_weight * lambda
  * (-sum D_level(pred_level)) at levels below 2 once step >
  start_gan_train_step, plus embedding_loss_weight * emb_loss. rec_loss
  takes each level as a top level, as the reference's ``vae_img_loss``
  does, so a perceiver's LPIPS term is in every level's rec and in the
  lambda's gradient of it. Its backward reaches the whole generator. (The JAX package applies the adversarial term
  inside its lambda closure to the out head on a stop-gradient hidden state,
  so there only the out heads get the adversarial gradient; the port takes
  the reference's.)
* Adaptive lambda (eq. 7 of arXiv:2012.09841): ||d rec/d w|| / (||d gan/d w||
  + 1e-4), clipped to [0, 1e4] and detached, with w the level's 1x1 out-head
  conv weight, from two ``torch.autograd.grad`` calls, as the reference.
* Discriminator loss: ``gan_loss`` (hinge by default) of D(target) and
  D(pred.detach()) at each level that has a discriminator, summed, once
  step + 1 > start_gan_train_step.

While a gate is closed no discriminator is called, as in the reference: the
BatchNorm statistics stay where they are, a closed term reads 0 (lambda
too, where the JAX package reports the lambda its closure computed), and
the discriminators' Adam takes no step (torch's Adam skips a parameter
without a gradient, so its bias correction starts with the GAN; optax's
counts the closed steps). The discriminators always run in train mode and
are out of the generator's backward (``requires_grad_(False)`` while the
generator steps, as Lightning's ``toggle_optimizer``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from medfusion_tpu_torch.losses.gan import hinge_d_loss
from medfusion_tpu_torch.nn.functional import interpolate_area
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw
from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer, _nchw_or_none
from medfusion_tpu_torch.train.state import GANTrainState

LAMBDA_EPS = 1e-4  # the adaptive lambda's ||d gan/d w|| + eps


@dataclasses.dataclass(frozen=True)
class AdversarialTrainer:
    """The two players' losses: ``ae_trainer`` gives the autoencoder and its
    rec_loss, ``discriminators`` one discriminator per pyramid level (the
    module that :class:`GANTrainState` trains)."""

    ae_trainer: AutoencoderTrainer
    discriminators: torch.nn.ModuleList
    gan_loss: Callable = hinge_d_loss
    gan_loss_weight: float = 1.0
    start_gan_train_step: int = 50000

    def __post_init__(self):
        levels = 1 + len(self.ae_trainer.autoencoder.outc_ver)
        if len(self.discriminators) < min(levels, 2):
            raise ValueError(f"{len(self.discriminators)} discriminators for the generator "
                             f"loss's {min(levels, 2)} adversarial levels")

    def _level(self, depth: int, pred, target, active: bool):
        """(rec + the adversarial term, its metrics) of one pyramid level."""
        rec = self.ae_trainer.rec_loss(pred, [], target)
        if depth >= 2:
            return rec, {}
        if not active:
            zero = torch.zeros((), device=pred.device)
            return rec, {f"gan_loss_{depth}": zero, f"lambda_{depth}": zero}
        w = self.ae_trainer.autoencoder.out_head(depth).weight
        gan = -self.discriminators[depth](pred).sum()
        (g_rec,) = torch.autograd.grad(rec, w, retain_graph=True)
        (g_gan,) = torch.autograd.grad(gan, w, retain_graph=True)
        lam = (torch.linalg.vector_norm(g_rec)
               / (torch.linalg.vector_norm(g_gan) + LAMBDA_EPS))
        lam = lam.clamp(0.0, 1e4).detach()
        term = self.gan_loss_weight * lam * gan
        return rec + term, {f"gan_loss_{depth}": term.detach(), f"lambda_{depth}": lam}

    def generator_loss(self, x, noise: Optional[torch.Tensor], step: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor,
                                  List[torch.Tensor]]:
        """(loss, metrics, pred, pred_vertical) of NCHW images ``x`` at
        optimizer step ``step``; ``noise`` is the VAE's draw (None for the
        VQVAE). Each deep-supervision level's target is ``x`` shrunk with
        'area' interpolation."""
        active = step > self.start_gan_train_step
        pred, pred_vertical, emb_loss = self.ae_trainer.forward(x, noise)
        img_loss, metrics = self._level(0, pred, x, active)
        for i, pred_i in enumerate(pred_vertical):
            loss_i, metrics_i = self._level(i + 1, pred_i, interpolate_area(x, pred_i.shape[2:]),
                                            active)
            img_loss = img_loss + loss_i
            metrics.update(metrics_i)
        loss = img_loss + self.ae_trainer.embedding_loss_weight * emb_loss
        with torch.no_grad():
            metrics.update(img_loss=img_loss.detach(), emb_loss=emb_loss.detach(),
                           loss_0=loss.detach(), L1=(pred - x).abs().mean(),
                           L2=((pred - x) ** 2).mean())
        return loss, metrics, pred, pred_vertical

    def discriminator_loss(self, x, pred, pred_vertical, step: int
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of the discriminators at optimizer step ``step``:
        at each level with a discriminator, D(target) then D(pred.detach())."""
        active = step > self.start_gan_train_step
        levels = [(pred, x)] + [(p, interpolate_area(x, p.shape[2:])) for p in pred_vertical]
        loss = torch.zeros((), device=x.device)
        metrics = {}
        for depth, (p, t) in enumerate(levels[:len(self.discriminators)]):
            if active:
                d = self.discriminators[depth]
                loss_i = self.gan_loss(d(t), d(p.detach()))
            else:
                loss_i = torch.zeros((), device=x.device)
            metrics[f"loss_1_{depth}"] = loss_i.detach()
            loss = loss + loss_i
        metrics["loss_1"] = loss.detach()
        return loss, metrics


def make_adversarial_train_step(trainer: AdversarialTrainer) -> Callable:
    """Returns ``step_fn(state, batch, noise) -> metrics``: on
    ``batch["source"]`` [B, H, W, C] with the channels-last draw ``noise``
    (None for the VQVAE), the generator's step at ``state.step`` and then
    the discriminators' at ``state.step + 1`` on the generator's outputs
    from before its update; ``state.step`` advances by 2."""

    def step_fn(state: GANTrainState, batch: Mapping[str, torch.Tensor],
                noise: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        x, noise = _to_nchw(batch["source"]), _nchw_or_none(noise)
        discs = state.disc.model.train()
        discs.requires_grad_(False)
        state.gen.optimizer.zero_grad(set_to_none=True)
        g_loss, metrics, pred, pred_vertical = trainer.generator_loss(x, noise, state.step)
        g_loss.backward()
        discs.requires_grad_(True)
        state.gen.apply_gradients()

        state.disc.optimizer.zero_grad(set_to_none=True)
        d_loss, d_metrics = trainer.discriminator_loss(
            x, pred.detach(), [p.detach() for p in pred_vertical], state.step + 1)
        if d_loss.requires_grad:
            d_loss.backward()
        state.disc.apply_gradients()
        state.step += 2
        return {**metrics, **d_metrics, "loss": g_loss.detach()}

    return step_fn
