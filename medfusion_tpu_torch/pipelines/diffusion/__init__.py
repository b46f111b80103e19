from medfusion_tpu_torch.pipelines.diffusion.core import DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion.ddim import repaint_op_schedule

__all__ = ["DiffusionPipeline", "repaint_op_schedule"]
