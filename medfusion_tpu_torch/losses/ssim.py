"""SSIM and MS-SSIM on NCHW images (port of ``medfusion_tpu/losses/ssim.py``).

The semantics of the ``pytorch_msssim`` package the reference trains with
(``ssim(..., data_range=1, size_average=False, nonnegative_ssim=True)``): a
Gaussian window (11 taps, sigma 1.5) applied as two depthwise 1-D
convolutions with VALID padding, K = (0.01, 0.03), each channel's map
averaged over space, then over channels. As in the JAX package, an image
smaller than the window takes the largest odd window that fits.
Differentiable throughout. MS-SSIM takes five scales with a 2x average pool
(VALID: an odd side drops its last row) between them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(win_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID blur of [B, C, H, W] along H, then W."""
    c = x.shape[1]
    k = kernel.to(x.dtype)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_per_channel(x: torch.Tensor, y: torch.Tensor, data_range: float,
                      win_size: int, win_sigma: float,
                      k: Tuple[float, float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ssim, cs), each [B, C]."""
    k1, k2 = k
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    min_sp = min(x.shape[2:])
    if win_size > min_sp:
        win_size = min_sp if min_sp % 2 == 1 else min_sp - 1
    kernel = torch.from_numpy(_gaussian_kernel1d(win_size, win_sigma)).to(x.device)

    mu_x = _gaussian_filter(x, kernel)
    mu_y = _gaussian_filter(y, kernel)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _gaussian_filter(x * x, kernel) - mu_xx
    sigma_yy = _gaussian_filter(y * y, kernel) - mu_yy
    sigma_xy = _gaussian_filter(x * y, kernel) - mu_xy

    cs_map = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         size_average: bool = True, win_size: int = 11, win_sigma: float = 1.5,
         k: Tuple[float, float] = (0.01, 0.03),
         nonnegative_ssim: bool = False) -> torch.Tensor:
    """SSIM of NCHW images: a scalar (``size_average``) or [B]."""
    s, _ = _ssim_per_channel(x, y, data_range, win_size, win_sigma, k)
    if nonnegative_ssim:
        s = torch.relu(s)
    s = s.mean(dim=1)
    return s.mean() if size_average else s


# pytorch_msssim's window, constants and scale weights, as the reference calls it.
_WIN_SIZE, _WIN_SIGMA, _K = 11, 1.5, (0.01, 0.03)
_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, size_average: bool = True) -> torch.Tensor:
    """Multi-scale SSIM of NCHW images in [0, 1]: relu(cs) at every scale but
    the last, relu(ssim) at the last, each raised to its weight and
    multiplied; a scalar (``size_average``) or [B]."""
    w = torch.tensor(_MS_WEIGHTS, dtype=x.dtype, device=x.device)
    mcs = []
    for i in range(len(_MS_WEIGHTS)):
        s, cs = _ssim_per_channel(x, y, 1.0, _WIN_SIZE, _WIN_SIGMA, _K)
        if i < len(_MS_WEIGHTS) - 1:
            mcs.append(torch.relu(cs))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    stack = torch.stack(mcs + [torch.relu(s)])  # [levels, B, C]
    out = torch.prod(stack ** w[:, None, None], dim=0).mean(dim=1)
    return out.mean() if size_average else out
