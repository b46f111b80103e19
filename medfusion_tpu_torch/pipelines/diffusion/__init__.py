from medfusion_tpu_torch.pipelines.diffusion.core import DiffusionPipeline

__all__ = ["DiffusionPipeline"]
