"""InceptionV3 FID feature extractor (port of ``medfusion_tpu/metrics/inception.py``).

torch-fidelity's ``FeatureExtractorInceptionV3``: the TF-Inception graph with
pytorch-fid's compatibility patches. The branch-pool average pooling has
``count_include_pad=False`` in the A, C and E_1 blocks, and the last E block
(``Mixed_7c``) has a MAX-pool branch (stride 1, pad 1). Each ``BasicConv2d``
is a conv without bias, a frozen BatchNorm (eps 1e-3, always in eval mode)
and ReLU.

Input: uint8 NCHW images with 1 or 3 channels (grey is repeated to RGB);
bilinear resize to 299x299, then (x - 128) / 128; output: the 2048-d pool3
features, the spatial mean of ``Mixed_7c``. The resize antialiases when it
shrinks, as ``jax.image.resize(..., "bilinear")`` does (``antialias=True``;
without it a 512^2 input departs from the JAX package's by up to 130 on
0-255).

Module names are torchvision's (``Mixed_5b.branch1x1.conv.weight``,
``....bn.running_var``), so a pytorch-fid / torch-fidelity checkpoint loads
with ``strict=True`` once :func:`strip_fid_blocks` has renamed its wrapper
keys and :func:`fid_state_dict` has dropped its unused heads.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Pad = Union[int, Sequence[int]]


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with torch's parameter and buffer names that always
    normalises with its running statistics."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size=(3, 3), stride: int = 1,
                 padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad_count(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_no_pad_count(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_no_pad_count(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode  # 'avg' (E_1) or 'max' (E_2, pytorch-fid's)
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "avg":
            bp = _avg_pool_no_pad_count(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """Float NCHW on 0-255 -> 299x299, bilinear with half-pixel centres,
    antialiased when it shrinks (``jax.image.resize``'s "bilinear")."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionV3(nn.Module):
    """2048-d FID features of uint8 NCHW images. Without pretrained weights
    the convs are He-normal (fan in), so that the features of the ~40
    layers deep random network keep their scale instead of vanishing."""

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        if self.resize_input and tuple(x.shape[2:]) != (299, 299):
            x = resize_299(x)
        x = (x - 128.0) / 128.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# pytorch-fid's InceptionV3 wrapper keeps the torchvision modules in four
# positional nn.Sequential blocks ('blocks.2.4.branch1x1.conv.weight'); the
# (block, index) -> module name map is static (the pools hold no
# parameters). The distributed pt_inception-2015-12-05 file and
# torch-fidelity use the bare names.
_PYTORCH_FID_BLOCKS = {
    (0, 0): "Conv2d_1a_3x3", (0, 1): "Conv2d_2a_3x3", (0, 2): "Conv2d_2b_3x3",
    (1, 0): "Conv2d_3b_1x1", (1, 1): "Conv2d_4a_3x3",
    (2, 0): "Mixed_5b", (2, 1): "Mixed_5c", (2, 2): "Mixed_5d",
    (2, 3): "Mixed_6a", (2, 4): "Mixed_6b", (2, 5): "Mixed_6c",
    (2, 6): "Mixed_6d", (2, 7): "Mixed_6e",
    (3, 0): "Mixed_7a", (3, 1): "Mixed_7b", (3, 2): "Mixed_7c",
}


def strip_fid_blocks(sd: Mapping) -> Dict:
    """Rename pytorch-fid wrapper keys 'blocks.N.M.<path>' to torchvision's
    module names; a state dict with bare names passes through unchanged."""
    if not any(k.startswith("blocks.") for k in sd):
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if not k.startswith("blocks."):
            out[k] = v
            continue
        parts = k.split(".", 3)
        name = None
        if len(parts) == 4 and parts[1].isdigit() and parts[2].isdigit():
            name = _PYTORCH_FID_BLOCKS.get((int(parts[1]), int(parts[2])))
        if name is None:
            raise ValueError(f"unrecognized pytorch-fid wrapper key: {k!r}")
        out[f"{name}.{parts[3]}"] = v
    return out


def fid_state_dict(sd: Mapping) -> Dict:
    """A torch InceptionV3 checkpoint's state dict -> the featuriser's: the
    wrapper keys renamed, the unused ``AuxLogits.*`` and ``fc.*`` heads
    dropped, and a BatchNorm ``num_batches_tracked`` of 0 put where a
    checkpoint saved without it lacks one (the featuriser never reads it)."""
    sd = {k: v for k, v in strip_fid_blocks(sd).items()
          if not k.startswith(("AuxLogits.", "fc."))}
    for k in [k for k in sd if k.endswith(".bn.running_mean")]:
        sd.setdefault(k[:-len("running_mean")] + "num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    return sd
