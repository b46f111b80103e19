"""Fréchet Inception Distance (port of ``medfusion_tpu/metrics/fid.py``).

torchmetrics' ``FID()`` as the reference evaluates with: a Gaussian fit to
each set's InceptionV3-2048 features, d^2 = ||mu1 - mu2||^2 + tr(S1 + S2 -
2 (S1 S2)^{1/2}), the square root's trace as tr((S1^{1/2} S2 S1^{1/2})^{1/2})
through symmetric ``eigh``, eigenvalues clipped at 1e-12.

:class:`FrechetInceptionDistance` computes in float64 on the host (LAPACK's
``eigh``, as numpy's in the JAX package's accumulator): that is the
reference's own arithmetic for the 2048x2048 problem, and the features
themselves come from the card.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _sqrtm_psd(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    w, v = torch.linalg.eigh(a)
    w = torch.sqrt(torch.clamp(w, min=eps))
    return (v * w) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> torch.Tensor:
    s1_half = _sqrtm_psd(sigma1)
    covmean_tr = torch.trace(_sqrtm_psd(s1_half @ sigma2 @ s1_half))
    diff = mu1 - mu2
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * covmean_tr


def gaussian_stats(features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, sigma) with the unbiased covariance (torchmetrics' and np.cov's)."""
    mu = features.mean(dim=0)
    centered = features - mu
    return mu, centered.T @ centered / (features.shape[0] - 1)


class FrechetInceptionDistance:
    """Accumulator: ``update(features, real)`` / ``compute()``; features
    (any device, [N, D]) are kept on the host in float64."""

    def __init__(self):
        self._real: List[np.ndarray] = []
        self._fake: List[np.ndarray] = []

    def update(self, features, real: bool) -> None:
        if isinstance(features, torch.Tensor):
            features = features.detach().cpu().numpy()
        (self._real if real else self._fake).append(np.asarray(features, np.float64))

    def compute(self) -> float:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        mu1, s1 = np.mean(real, 0), np.atleast_2d(np.cov(real, rowvar=False))
        mu2, s2 = np.mean(fake, 0), np.atleast_2d(np.cov(fake, rowvar=False))
        return float(frechet_distance(*map(torch.from_numpy, (mu1, s1, mu2, s2))))

    def reset(self) -> None:
        self._real, self._fake = [], []
