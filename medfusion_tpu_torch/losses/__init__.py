"""Training and evaluation losses (port of ``medfusion_tpu/losses``): SSIM and
MS-SSIM, LPIPS, and the GAN discriminator losses."""

from medfusion_tpu_torch.losses.gan import exp_d_loss, hinge_d_loss, vanilla_d_loss
from medfusion_tpu_torch.losses.lpips import LPIPS
from medfusion_tpu_torch.losses.ssim import ms_ssim, ssim

__all__ = ["LPIPS", "exp_d_loss", "hinge_d_loss", "ms_ssim", "ssim", "vanilla_d_loss"]
