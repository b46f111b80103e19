"""Improved precision and recall (Kynkäänniemi et al. 2019; port of
``medfusion_tpu/metrics/pr.py``).

The reference's metric: kNN (k = 3) radii of each manifold from pairwise L2
distances, precision = the share of fake features inside ANY real feature's
ball, recall the same with the roles swapped. Distances are
sqrt(clip(||x||^2 + ||y||^2 - 2 x.y, 0)) in float32, one matrix product
(not ``torch.cdist``, which rounds otherwise: membership is a strict ``<``
at a radius). PyTorch's default keeps float32 products off TF32.

``row_chunk`` bounds memory at the 10k-sample scale: rows go in blocks, so
only a [row_chunk, M] tile of distances is live, and membership ORs across
the blocks. The last block is a slice of the rows that remain, so no row is
padded. The squared norms are computed once for the whole set and sliced,
so a block's distances are the unchunked matrix's rows.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=1)


def pairwise_distances(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                       x_sq: Optional[torch.Tensor] = None,
                       y_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, M] distances; ``x_sq``/``y_sq`` are the rows' squared norms where
    the caller has them."""
    y = x if y is None else y
    x_sq = _sq_norms(x) if x_sq is None else x_sq
    y_sq = _sq_norms(y) if y_sq is None else y_sq
    d2 = x_sq[:, None] + y_sq[None, :] - 2.0 * (x @ y.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _blocks(n: int, row_chunk: Optional[int]):
    step = n if row_chunk is None else row_chunk
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def knn_radii(features: torch.Tensor, knn: int = 3,
              row_chunk: Optional[int] = None) -> torch.Tensor:
    """Distance to the (k+1)-th nearest point, self included (the reference
    takes the k+1 smallest, the 0 self-distance among them)."""
    sq = _sq_norms(features)
    return torch.cat([
        torch.topk(pairwise_distances(features[a:b], features, sq[a:b], sq), knn + 1,
                   dim=1, largest=False).values[:, -1]
        for a, b in _blocks(features.shape[0], row_chunk)])


def manifold_membership(ref: torch.Tensor, ref_radii: torch.Tensor, pred: torch.Tensor,
                        row_chunk: Optional[int] = None) -> torch.Tensor:
    """The share of ``pred`` points inside any ``ref`` ball."""
    ref_sq, pred_sq = _sq_norms(ref), _sq_norms(pred)
    inside = torch.zeros(pred.shape[0], dtype=torch.bool, device=pred.device)
    for a, b in _blocks(ref.shape[0], row_chunk):
        dist = pairwise_distances(ref[a:b], pred, ref_sq[a:b], pred_sq)
        inside |= torch.any(dist < ref_radii[a:b, None], dim=0)
    return inside.float().mean()


def precision_recall(real_features: torch.Tensor, fake_features: torch.Tensor,
                     knn: int = 3, row_chunk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    real_radii = knn_radii(real_features, knn, row_chunk)
    fake_radii = knn_radii(fake_features, knn, row_chunk)
    precision = manifold_membership(real_features, real_radii, fake_features, row_chunk)
    recall = manifold_membership(fake_features, fake_radii, real_features, row_chunk)
    return precision, recall


class ImprovedPrecisionRecall:
    """Accumulator: ``update(features, real)`` / ``compute()``. Features stay
    on their device (the card's, in the evaluation CLI) in float32, in row
    blocks of ``row_chunk`` (default 1024)."""

    def __init__(self, knn: int = 3, row_chunk: Optional[int] = 1024):
        self.knn = knn
        self.row_chunk = row_chunk
        self._real: List[torch.Tensor] = []
        self._fake: List[torch.Tensor] = []

    def update(self, features, real: bool) -> None:
        (self._real if real else self._fake).append(
            torch.as_tensor(features).detach().float())

    def compute(self) -> Tuple[float, float]:
        real, fake = torch.cat(self._real), torch.cat(self._fake)
        p, r = precision_recall(real, fake, self.knn, self.row_chunk)
        return float(p), float(r)

    def reset(self) -> None:
        self._real, self._fake = [], []
