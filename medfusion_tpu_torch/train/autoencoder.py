"""Autoencoder training, the VAE and VQVAE flavours (port of
``medfusion_tpu/train/autoencoder.py``).

The loss of each pyramid level is the elementwise pixel loss plus each
image's (1 - SSIM) and, with a ``perceiver`` (a frozen :class:`LPIPS`), each
image's LPIPS (weight 1) at pyramid depths below 2, both broadcast over its
elements; each deep-supervision output is held against the target shrunk
with 'nearest-exact'. The 'vae' flavour
(the reference's ``VAE.rec_loss``) sums each level's elements and divides by
the batch; the 'vqvae' flavour (``VQVAE.rec_loss``) takes each level's mean,
weighted by 1/2^i normalised to sum 1. Then ``embedding_loss_weight`` times
the KL or the quantiser's commitment loss. The perceiver's own weights take
no gradient; the autoencoder's gradient flows through it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from medfusion_tpu_torch.losses.ssim import ssim
from medfusion_tpu_torch.nn.functional import interpolate_nearest_exact
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw
from medfusion_tpu_torch.train.state import TrainState


def _pixel_elems(pred, target, kind: str):
    if kind == "l1":
        return (pred - target).abs()
    return (pred - target) ** 2


def ssim_loss_per_image(pred, target):
    """1 - relu(ssim) per image, [B, 1, 1, 1]; pred is clamped to [0, 1]
    after de-centring, target is not."""
    s = ssim(torch.clamp((pred + 1) / 2, 0, 1), (target + 1) / 2, data_range=1.0,
             size_average=False, nonnegative_ssim=True)
    return (1.0 - s).reshape(-1, *([1] * (pred.ndim - 1)))


FLAVORS = ("vae", "vqvae")


@dataclasses.dataclass(frozen=True)
class AutoencoderTrainer:
    """The AE loss of ``autoencoder`` (a :class:`VAE` for 'vae', a
    :class:`VQVAE` for 'vqvae')."""

    autoencoder: torch.nn.Module
    flavor: str = "vae"
    pixel_loss: str = "l1"
    perceiver: Optional[torch.nn.Module] = None
    embedding_loss_weight: float = 1e-6

    def __post_init__(self):
        if self.flavor not in FLAVORS:
            raise ValueError(f"unknown autoencoder flavour {self.flavor!r}; expected one "
                             f"of {FLAVORS}")
        if self.pixel_loss not in ("l1", "l2"):
            raise ValueError(f"unknown pixel loss {self.pixel_loss!r}")

    def _level_elems(self, pred, target, depth: int):
        elems = _pixel_elems(pred, target, self.pixel_loss) + ssim_loss_per_image(pred, target)
        if self.perceiver is not None and depth < 2:
            elems = elems + self.perceiver(pred, target)
        return elems

    def rec_loss(self, pred, pred_vertical, target):
        levels = [(pred, target)] + [
            (pred_i, interpolate_nearest_exact(target, pred_i.shape[2:]))
            for pred_i in pred_vertical]
        if self.flavor == "vae":
            b = pred.shape[0]
            return sum(self._level_elems(p, t, i).sum() / b for i, (p, t) in enumerate(levels))
        weights = [1 / 2**i for i in range(len(levels))]
        return sum(self._level_elems(p, t, i).mean() * (w / sum(weights))
                   for i, ((p, t), w) in enumerate(zip(levels, weights)))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """The autoencoder's training forward: (pred, deep-supervision
        outputs, KL or commitment loss); ``noise`` is the VAE's
        reparameterisation draw (the VQVAE takes none)."""
        if self.flavor == "vqvae":
            return self.autoencoder(x)
        return self.autoencoder(x, noise)

    def loss(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of NCHW images ``x`` with the reparameterisation
        draw ``noise`` (NCHW latent shape; None for the VQVAE)."""
        pred, pred_vertical, emb_loss = self.forward(x, noise)
        loss = self.rec_loss(pred, pred_vertical, x) + emb_loss * self.embedding_loss_weight
        with torch.no_grad():
            metrics = {"loss": loss, "emb_loss": emb_loss,
                       "L1": (pred - x).abs().mean(), "L2": ((pred - x) ** 2).mean(),
                       "ssim": ssim((pred + 1) / 2, (x + 1) / 2, data_range=1.0)}
        return loss, metrics


def _nchw_or_none(t):
    return None if t is None else _to_nchw(t)


def make_autoencoder_train_step(trainer: AutoencoderTrainer) -> Callable:
    """Returns ``step_fn(state, batch, noise) -> metrics``: the loss and
    gradient of ``state.model`` on ``batch["source"]`` [B, H, W, C] with
    the channels-last reparameterisation draw ``noise`` [B, h, w, emb]
    (None for the VQVAE), one optimizer update of ``state``, and the
    detached metrics."""

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor],
                noise: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = trainer.loss(_to_nchw(batch["source"]), _nchw_or_none(noise))
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn
