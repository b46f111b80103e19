from medfusion_tpu_torch.pipelines.diffusion.core import DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion.ddim import repaint_op_schedule
from medfusion_tpu_torch.pipelines.diffusion.guidance import make_classifier_grad

__all__ = ["DiffusionPipeline", "make_classifier_grad", "repaint_op_schedule"]
