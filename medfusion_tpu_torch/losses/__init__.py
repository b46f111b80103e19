"""Training losses (port of ``medfusion_tpu/losses``): SSIM."""

from medfusion_tpu_torch.losses.ssim import ssim

__all__ = ["ssim"]
