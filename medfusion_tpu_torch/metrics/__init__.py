"""Evaluation metrics (port of ``medfusion_tpu/metrics``): FID on
InceptionV3-2048 features and improved precision/recall."""

from medfusion_tpu_torch.metrics.fid import FrechetInceptionDistance, frechet_distance
from medfusion_tpu_torch.metrics.inception import InceptionV3
from medfusion_tpu_torch.metrics.pr import ImprovedPrecisionRecall, precision_recall

__all__ = ["FrechetInceptionDistance", "ImprovedPrecisionRecall", "InceptionV3",
           "frechet_distance", "precision_recall"]
