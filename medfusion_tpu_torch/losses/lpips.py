"""LPIPS perceptual distance with the VGG16 backbone (port of
``medfusion_tpu/losses/lpips.py``).

``lpips.LPIPS(net='vgg', lpips=False)``, the reference's perceptual loss:
inputs in [-1, 1] are shifted and scaled by the lpips package's
ScalingLayer constants; VGG16 features after relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3 are each unit-normalised along channels (eps 1e-10
added to the norm); per stage the channel sum of squared differences is
averaged over space, and the five stages are summed: [B, 1, 1, 1]. 3-D
inputs [B, C, D, H, W] fold depth into the batch and average over it:
[B, 1, 1, 1, 1]. ``normalize=True`` takes [0, 1] inputs; 1-channel inputs
are repeated to RGB.

:class:`VGG16Features` is torchvision's ``vgg16().features`` up to relu5_3,
so its state dict is the torchvision checkpoint's ``features.{idx}.*`` and
:func:`convert_torch_vgg16` is a key filter. Without a pretrained file
(``cli.ingest_weights vgg16``) the backbone is random, a valid but
incomparable metric.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

# lpips.ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (out_channels, convs) of each stage; a 2x2 max pool between stages
_VGG_STAGES: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    """torchvision's VGG16 ``features`` to relu5_3 (index 29); returns the
    five stage outputs. Its random init is torchvision's (He-normal over
    fan out, zero biases): with PyTorch's default conv init the deep
    stages' features all but vanish, and the unit normalisation's gradient
    at a near-zero feature amplifies rounding by orders of magnitude."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        self.stage_ends = []
        in_ch = 3
        for stage, (ch, n_convs) in enumerate(_VGG_STAGES):
            for _ in range(n_convs):
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            self.stage_ends.append(len(layers) - 1)
            if stage < len(_VGG_STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
                nn.init.zeros_(m.bias)

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.stage_ends:
                feats.append(x)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """``lpips.LPIPS(net='vgg', lpips=False)`` on NCHW (or NCDHW) images in
    [-1, 1] ([0, 1] with ``normalize``)."""

    def __init__(self, normalize: bool = False):
        super().__init__()
        self.normalize = normalize
        self.vgg = VGG16Features()

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if pred.ndim == 5:
            b, c, d = pred.shape[:3]
            fold = lambda t: t.movedim(2, 1).reshape(b * d, c, *t.shape[3:])  # noqa: E731
            val = self._lpips_2d(fold(pred), fold(target)).reshape(b, d)
            return val.mean(dim=1).reshape(b, 1, 1, 1, 1)
        return self._lpips_2d(pred, target)

    def _lpips_2d(self, pred, target):
        if self.normalize:
            pred, target = 2 * pred - 1, 2 * target - 1
        if pred.shape[1] == 1:
            pred, target = pred.repeat(1, 3, 1, 1), target.repeat(1, 3, 1, 1)
        shift = torch.tensor(_SHIFT, dtype=pred.dtype, device=pred.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, dtype=pred.dtype, device=pred.device).reshape(1, 3, 1, 1)
        total = 0.0
        for fp, ft in zip(self.vgg((pred - shift) / scale), self.vgg((target - shift) / scale)):
            diff = (_unit_normalize(fp) - _unit_normalize(ft)) ** 2
            total = total + diff.sum(dim=1).mean(dim=(1, 2))
        return total.reshape(-1, 1, 1, 1)


def convert_torch_vgg16(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision VGG16 state dict (tensors or numpy) -> the backbone's:
    its ``features.*`` entries (the classifier is dropped)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()
            if k.startswith("features.")}


def load_vgg16_npz(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """VGG16 weights from an ``.npz``: torchvision keys (``features.0.weight``)
    or the JAX package's converted flax keys (``conv_0/kernel``), the file
    its ``--vgg-weights`` flag takes."""
    from medfusion_tpu_torch.utils.weights import jax_vgg16_to_state_dict, unflatten_npz

    with np.load(path) as f:
        raw = {k: f[k] for k in f.files}
    if any("/" in k for k in raw):
        return jax_vgg16_to_state_dict(unflatten_npz(raw))
    return convert_torch_vgg16(raw)


def frozen_lpips(vgg_state: Optional[Mapping] = None, device=None,
                 normalize: bool = False) -> LPIPS:
    """An :class:`LPIPS` on ``device`` in eval mode with no parameter that
    takes a gradient; ``vgg_state`` (torchvision keys) loaded strictly."""
    net = LPIPS(normalize=normalize)
    if vgg_state is not None:
        net.vgg.load_state_dict(vgg_state, strict=True)
    return net.to(device).eval().requires_grad_(False)
