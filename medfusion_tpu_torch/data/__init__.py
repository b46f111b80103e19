"""Data for the port's training CLIs (port of ``medfusion_tpu/data``): the
image datasets with their transforms and PNG reader, the 3-D volume dataset
with its NIfTI reader, the synthetic dataset, and the shuffled or weighted,
batched iteration."""

from medfusion_tpu_torch.data.datamodule import SimpleDataModule
from medfusion_tpu_torch.data.datasets_2d import (
    AIROGSDataset,
    CheXpert_2_Dataset,
    MSIvsMSS_2_Dataset,
    SimpleDataset2D,
)
from medfusion_tpu_torch.data.datasets_3d import SimpleDataset3D
from medfusion_tpu_torch.data.synthetic import SyntheticDataset2D

__all__ = ["AIROGSDataset", "CheXpert_2_Dataset", "MSIvsMSS_2_Dataset", "SimpleDataModule",
           "SimpleDataset2D", "SimpleDataset3D", "SyntheticDataset2D"]
