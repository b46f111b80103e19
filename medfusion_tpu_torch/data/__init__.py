"""Data for the port's training CLIs (port of ``medfusion_tpu/data``): the
image datasets with their transforms and PNG reader, the 3-D volume dataset
with its NIfTI reader, the synthetic dataset, the shuffled or weighted,
batched iteration, grain's epoch order, and the prefetch of batches to the
card."""

from medfusion_tpu_torch.data.datamodule import SimpleDataModule
from medfusion_tpu_torch.data.datasets_2d import (
    AIROGSDataset,
    CheXpert_2_Dataset,
    CheXpertDataset,
    MSIvsMSS_2_Dataset,
    MSIvsMSSDataset,
    SimpleDataset2D,
)
from medfusion_tpu_torch.data.datasets_3d import SimpleDataset3D
from medfusion_tpu_torch.data.grain_loader import GrainDataModule
from medfusion_tpu_torch.data.prefetch import prefetch_to_device
from medfusion_tpu_torch.data.synthetic import SyntheticDataset2D

__all__ = ["AIROGSDataset", "CheXpert_2_Dataset", "CheXpertDataset", "GrainDataModule",
           "MSIvsMSS_2_Dataset", "MSIvsMSSDataset", "SimpleDataModule", "SimpleDataset2D",
           "SimpleDataset3D", "SyntheticDataset2D", "prefetch_to_device"]
