"""Data for the port's training CLI: the synthetic dataset and the shuffled,
batched iteration of ``medfusion_tpu/data``."""

from medfusion_tpu_torch.data.datamodule import SimpleDataModule
from medfusion_tpu_torch.data.synthetic import SyntheticDataset2D

__all__ = ["SimpleDataModule", "SyntheticDataset2D"]
