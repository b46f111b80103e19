"""GAN discriminator losses (port of ``medfusion_tpu/losses/gan.py``): each
takes the discriminator's logits on real and on generated images."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def exp_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.exp(-logits_real).mean() + torch.exp(logits_fake).mean())


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())
