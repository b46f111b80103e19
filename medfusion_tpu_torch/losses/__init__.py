"""Training losses (port of ``medfusion_tpu/losses``): SSIM and the GAN
discriminator losses."""

from medfusion_tpu_torch.losses.gan import exp_d_loss, hinge_d_loss, vanilla_d_loss
from medfusion_tpu_torch.losses.ssim import ssim

__all__ = ["exp_d_loss", "hinge_d_loss", "ssim", "vanilla_d_loss"]
