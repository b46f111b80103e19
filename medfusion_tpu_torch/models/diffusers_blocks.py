"""The rest of the diffusers block inventory and the FIR resamplers, NCHW
(port of ``medfusion_tpu/models/diffusers_blocks.py``).

* ``upfirdn2d``: zero insertion (``up - 1`` zeros after every row and
  column), padding, the FIR filter (the kernel flipped, then
  cross-correlated) and ``down``-strided output, as one depthwise conv;
  ``fir_upsample_2d`` / ``fir_downsample_2d`` around it, and the
  ``FirUpsample`` / ``FirDownsample`` modules (with ``use_conv``: the
  reference's transposed conv of the flipped weight, then the filter; the
  filter, then a stride-2 conv).
* The attention down and up blocks, their encoder and decoder variants,
  and the four FIR-skip blocks, with the reference quirks the JAX package
  keeps: a down block builds its downsampler from the loop-rebound
  ``in_channels`` (so ``num_layers == 1`` with ``in != out`` gives a
  downsampler of ``in`` channels); ``AttnSkipUpBlock`` takes
  ``min(res_in + res_skip // 4, 32)`` groups; ``AttnSkipUpBlock`` runs one
  attention after all its resnets, ``AttnSkipDownBlock`` one a resnet.
* ``get_down_block`` / ``get_up_block``: the 14 types of the reference's
  factories (a ``UNetRes`` prefix is dropped); the cross-attention types and
  ``DownBlock2D`` / ``UpBlock2D`` build the conditional UNet's blocks
  (``models/unet_diffusers.py``).

No dropout layer (0 in every vendored default). The GroupNorms and the
attention are plain PyTorch, as the JAX package leaves them to flax; the
modules carry the reference's torch keys (``resnets.{i}``,
``attentions.{i}.query``, ``downsamplers.0.conv``, ``Conv2d_0``,
``skip_conv``, ``skip_norm``, ``resnet_down``, ``resnet_up``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.models.latent_embedders_diffusers import (
    DAttentionBlock,
    DDownsample,
    DownEncoderBlock,
    DResnetBlock,
    DUpsample,
    UpDecoderBlock,
    _gn,
)

_SQRT2 = math.sqrt(2.0)
FIR_KERNEL = (1, 3, 3, 1)


# ---- upfirdn2d and the FIR resamplers -----------------------------------------


def setup_kernel(kernel) -> torch.Tensor:
    """A 1-D kernel's outer product (or a 2-D kernel), summing to 1."""
    k = torch.as_tensor(kernel, dtype=torch.float32)
    if k.ndim == 1:
        k = torch.outer(k, k)
    return k / k.sum()


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad: Tuple[int, int] = (0, 0)):
    """The reference's ``upfirdn2d_native`` on [B, C, H, W]: each row and
    column followed by ``up - 1`` zeros, ``pad`` (low, high) zeros on both
    axes, the flipped ``kernel`` cross-correlated (in ``x``'s dtype), every
    ``down``-th output kept."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((b, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.as_tensor(kernel).flip(0, 1).to(device=x.device, dtype=x.dtype)
    return F.conv2d(x, k[None, None].expand(c, 1, *k.shape), stride=down, groups=c)


def fir_upsample_2d(x, kernel=FIR_KERNEL, factor: int = 2, gain: float = 1.0):
    k = setup_kernel(kernel) * (gain * factor ** 2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def fir_downsample_2d(x, kernel=FIR_KERNEL, factor: int = 2, gain: float = 1.0):
    k = setup_kernel(kernel) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


class FirUpsample(nn.Module):
    """2x FIR upsampling; with ``use_conv`` a 3x3 ``Conv2d_0`` fused in as
    the reference fuses it: ``conv_transpose2d`` (stride 2) of the weight
    flipped in space with its in and out axes swapped, the filter (gain 4)
    padded ``((p + 1) // 2 + 1, p // 2 + 1)``, then the bias."""

    def __init__(self, channels: Optional[int] = None, out_channels: Optional[int] = None,
                 use_conv: bool = False, fir_kernel: Sequence[int] = FIR_KERNEL):
        super().__init__()
        self.use_conv, self.fir_kernel = use_conv, tuple(fir_kernel)
        if use_conv:
            self.Conv2d_0 = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        factor = 2
        if not self.use_conv:
            return fir_upsample_2d(x, self.fir_kernel, factor)
        w = self.Conv2d_0.weight  # [O, I, kh, kw]
        y = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), stride=factor)
        k = setup_kernel(self.fir_kernel) * factor ** 2
        p = (k.shape[0] - factor) - (w.shape[-1] - 1)
        y = upfirdn2d(y, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))
        return y + self.Conv2d_0.bias[None, :, None, None]


class FirDownsample(nn.Module):
    """2x FIR downsampling; with ``use_conv`` the filter padded for the 3x3
    ``Conv2d_0``, then that conv at stride 2 without padding."""

    def __init__(self, channels: Optional[int] = None, out_channels: Optional[int] = None,
                 use_conv: bool = False, fir_kernel: Sequence[int] = FIR_KERNEL):
        super().__init__()
        self.use_conv, self.fir_kernel = use_conv, tuple(fir_kernel)
        if use_conv:
            self.Conv2d_0 = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        factor = 2
        if not self.use_conv:
            return fir_downsample_2d(x, self.fir_kernel, factor)
        w = self.Conv2d_0.weight
        k = setup_kernel(self.fir_kernel)
        p = (k.shape[0] - factor) + (w.shape[-1] - 1)
        y = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
        return F.conv2d(y, w, self.Conv2d_0.bias, stride=factor)


# ---- the attention down and up blocks -----------------------------------------


def _resnets(in_channels, out_channels, num_layers, groups, temb_channels, eps, scale):
    return nn.ModuleList([
        DResnetBlock(in_channels if i == 0 else out_channels, out_channels, groups,
                     temb_channels, eps, output_scale_factor=scale)
        for i in range(num_layers)])


def _attentions(channels, num_layers, heads, groups, eps, scale):
    return nn.ModuleList([DAttentionBlock(channels, heads, groups, eps, scale)
                          for _ in range(num_layers)])


def _down_in(in_channels, out_channels, num_layers):
    """The downsampler's input width: the reference's loop-rebound
    ``in_channels``."""
    return in_channels if num_layers == 1 else out_channels


class AttnDownBlock(nn.Module):
    """Resnet and attention pairs, then a downsampler; returns (x, the
    states after each pair and the downsampler)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 num_layers: int = 1, eps: float = 1e-6, groups: int = 32,
                 attn_num_head_channels: Optional[int] = 1,
                 output_scale_factor: float = 1.0, downsample_padding: int = 1,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = _resnets(in_channels, out_channels, num_layers, groups,
                                temb_channels, eps, output_scale_factor)
        self.attentions = _attentions(out_channels, num_layers, attn_num_head_channels,
                                      groups, eps, output_scale_factor)
        if add_downsample:
            self.downsamplers = nn.ModuleList([DDownsample(
                _down_in(in_channels, out_channels, num_layers), downsample_padding,
                out_channels)])

    def forward(self, x, temb=None):
        states = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb))
            states += (x,)
        if hasattr(self, "downsamplers"):
            for d in self.downsamplers:
                x = d(x)
            states += (x,)
        return x, states


class AttnUpBlock(nn.Module):
    """Resnet (on x and the last skip state) and attention pairs, then a
    nearest-2x upsampler with its conv."""

    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: Optional[int], num_layers: int = 1, eps: float = 1e-6,
                 groups: int = 32, attn_num_head_channels: Optional[int] = 1,
                 output_scale_factor: float = 1.0, add_upsample: bool = True):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            resnets.append(DResnetBlock(res_in + res_skip, out_channels, groups,
                                        temb_channels, eps,
                                        output_scale_factor=output_scale_factor))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = _attentions(out_channels, num_layers, attn_num_head_channels,
                                      groups, eps, output_scale_factor)
        if add_upsample:
            self.upsamplers = nn.ModuleList([DUpsample(out_channels)])

    def forward(self, x, res_states: Sequence[torch.Tensor], temb=None):
        res_states = list(res_states)
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(torch.cat([x, res_states.pop()], dim=1), temb))
        for u in getattr(self, "upsamplers", ()):
            x = u(x)
        return x


class AttnDownEncoderBlock(nn.Module):
    """``AttnDownBlock`` without the time embedding, returning x only."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1,
                 eps: float = 1e-6, groups: int = 32,
                 attn_num_head_channels: Optional[int] = 1,
                 output_scale_factor: float = 1.0, downsample_padding: int = 1,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = _resnets(in_channels, out_channels, num_layers, groups, None, eps,
                                output_scale_factor)
        self.attentions = _attentions(out_channels, num_layers, attn_num_head_channels,
                                      groups, eps, output_scale_factor)
        if add_downsample:
            self.downsamplers = nn.ModuleList([DDownsample(
                _down_in(in_channels, out_channels, num_layers), downsample_padding,
                out_channels)])

    def forward(self, x):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x))
        for d in getattr(self, "downsamplers", ()):
            x = d(x)
        return x


class AttnUpDecoderBlock(nn.Module):
    """Resnet and attention pairs without the time embedding or skips, then
    an upsampler."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1,
                 eps: float = 1e-6, groups: int = 32,
                 attn_num_head_channels: Optional[int] = 1,
                 output_scale_factor: float = 1.0, add_upsample: bool = True):
        super().__init__()
        self.resnets = _resnets(in_channels, out_channels, num_layers, groups, None, eps,
                                output_scale_factor)
        self.attentions = _attentions(out_channels, num_layers, attn_num_head_channels,
                                      groups, eps, output_scale_factor)
        if add_upsample:
            self.upsamplers = nn.ModuleList([DUpsample(out_channels)])

    def forward(self, x):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x))
        for u in getattr(self, "upsamplers", ()):
            x = u(x)
        return x


# ---- the FIR skip blocks ------------------------------------------------------


def _skip_resnet(channels, groups, temb_channels, eps, scale, updown):
    return DResnetBlock(channels, channels, groups, temb_channels, eps, groups_out=groups,
                        output_scale_factor=scale, use_in_shortcut=True, updown=updown)


class SkipDownBlock(nn.Module):
    """Resnets (groups a quarter of the width, at most 32), then a
    FIR-downsampling resnet; the RGB skip stream is FIR-downsampled and
    merged in by a 1x1 ``skip_conv``. Returns (x, states, skip_sample)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 num_layers: int = 1, eps: float = 1e-6,
                 output_scale_factor: float = _SQRT2, add_downsample: bool = True,
                 attn_num_head_channels: Optional[int] = None):
        super().__init__()
        resnets, attentions = [], []
        for i in range(num_layers):
            res_in = in_channels if i == 0 else out_channels
            resnets.append(DResnetBlock(res_in, out_channels, min(res_in // 4, 32),
                                        temb_channels, eps,
                                        groups_out=min(out_channels // 4, 32),
                                        output_scale_factor=output_scale_factor))
            if attn_num_head_channels is not None:
                attentions.append(DAttentionBlock(out_channels, attn_num_head_channels, 32,
                                                  eps, output_scale_factor))
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if add_downsample:
            self.resnet_down = _skip_resnet(out_channels, min(out_channels // 4, 32),
                                            temb_channels, eps, output_scale_factor,
                                            "down_fir")
            self.downsamplers = nn.ModuleList([FirDownsample(in_channels, out_channels)])
            self.skip_conv = nn.Conv2d(3, out_channels, 1)

    def forward(self, x, temb=None, skip_sample=None):
        states = ()
        attns = getattr(self, "attentions", [None] * len(self.resnets))
        for r, a in zip(self.resnets, attns):
            x = r(x, temb)
            if a is not None:
                x = a(x)
            states += (x,)
        if hasattr(self, "resnet_down"):
            x = self.resnet_down(x, temb)
            for d in self.downsamplers:
                skip_sample = d(skip_sample)
            x = self.skip_conv(skip_sample) + x
            states += (x,)
        return x, states, skip_sample


class AttnSkipDownBlock(SkipDownBlock):
    """``SkipDownBlock`` with one attention (32 groups, the block's scale
    factor as its rescale) after each resnet."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 num_layers: int = 1, eps: float = 1e-6,
                 attn_num_head_channels: Optional[int] = 1,
                 output_scale_factor: float = _SQRT2, add_downsample: bool = True):
        super().__init__(in_channels, out_channels, temb_channels, num_layers, eps,
                         output_scale_factor, add_downsample,
                         attn_num_head_channels=attn_num_head_channels)


class SkipUpBlock(nn.Module):
    """Resnets on x and the skip states, then the RGB skip stream: the
    incoming skip sample FIR-upsampled, plus ``skip_conv(silu(skip_norm(x)))``,
    and a FIR-upsampling resnet. Returns (x, skip_sample)."""

    attention_after = False
    precedence_quirk = False

    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: Optional[int], num_layers: int = 1, eps: float = 1e-6,
                 output_scale_factor: float = _SQRT2, add_upsample: bool = True,
                 attn_num_head_channels: Optional[int] = 1):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            groups = (min(res_in + res_skip // 4, 32) if self.precedence_quirk
                      else min((res_in + res_skip) // 4, 32))
            resnets.append(DResnetBlock(res_in + res_skip, out_channels, groups,
                                        temb_channels, eps,
                                        groups_out=min(out_channels // 4, 32),
                                        output_scale_factor=output_scale_factor))
        self.resnets = nn.ModuleList(resnets)
        if self.attention_after:
            self.attentions = nn.ModuleList([DAttentionBlock(
                out_channels, attn_num_head_channels, 32, eps, output_scale_factor)])
        self.upsampler = FirUpsample(in_channels, out_channels=out_channels)
        if add_upsample:
            g = min(out_channels // 4, 32)
            self.resnet_up = _skip_resnet(out_channels, g, temb_channels, eps,
                                          output_scale_factor, "up_fir")
            self.skip_conv = nn.Conv2d(out_channels, 3, 3, padding=1)
            self.skip_norm = _gn(out_channels, g, eps)

    def forward(self, x, res_states: Sequence[torch.Tensor], temb=None, skip_sample=None):
        res_states = list(res_states)
        for r in self.resnets:
            x = r(torch.cat([x, res_states.pop()], dim=1), temb)
        if self.attention_after:
            x = self.attentions[0](x)
        skip_sample = self.upsampler(skip_sample) if skip_sample is not None else 0.0
        if hasattr(self, "resnet_up"):
            skip_sample = skip_sample + self.skip_conv(F.silu(self.skip_norm(x)))
            x = self.resnet_up(x, temb)
        return x, skip_sample


class AttnSkipUpBlock(SkipUpBlock):
    """``SkipUpBlock`` with one attention after all the resnets, and the
    resnets' groups ``min(res_in + res_skip // 4, 32)``."""

    attention_after = True
    precedence_quirk = True

    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: Optional[int], num_layers: int = 1, eps: float = 1e-6,
                 attn_num_head_channels: Optional[int] = 1,
                 output_scale_factor: float = _SQRT2, add_upsample: bool = True):
        super().__init__(in_channels, prev_output_channel, out_channels, temb_channels,
                         num_layers, eps, output_scale_factor, add_upsample,
                         attn_num_head_channels)


# ---- the factories ------------------------------------------------------------


def get_down_block(down_block_type: str, num_layers: int, in_channels: int,
                   out_channels: int, temb_channels: Optional[int], add_downsample: bool,
                   resnet_eps: float = 1e-6, attn_num_head_channels: Optional[int] = 1,
                   resnet_groups: Optional[int] = None,
                   cross_attention_dim: Optional[int] = None,
                   downsample_padding: Optional[int] = None) -> nn.Module:
    """The reference's ``get_down_block`` over the port's blocks."""
    from medfusion_tpu_torch.models.unet_diffusers import _DownBlock

    if down_block_type.startswith("UNetRes"):
        down_block_type = down_block_type[7:]
    groups = 32 if resnet_groups is None else resnet_groups
    pad = 1 if downsample_padding is None else downsample_padding
    if down_block_type in ("DownBlock2D", "CrossAttnDownBlock2D"):
        cross = down_block_type == "CrossAttnDownBlock2D"
        if cross and cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for CrossAttnDownBlock2D")
        return _DownBlock(in_channels, out_channels, temb_channels, num_layers, groups,
                          resnet_eps, cross=cross,
                          attn_head_dim=out_channels // (attn_num_head_channels or 1),
                          context_dim=cross_attention_dim, add_downsample=add_downsample)
    if down_block_type == "AttnDownBlock2D":
        return AttnDownBlock(in_channels, out_channels, temb_channels, num_layers,
                             resnet_eps, groups, attn_num_head_channels,
                             downsample_padding=pad, add_downsample=add_downsample)
    if down_block_type == "SkipDownBlock2D":
        return SkipDownBlock(in_channels, out_channels, temb_channels, num_layers,
                             resnet_eps, add_downsample=add_downsample)
    if down_block_type == "AttnSkipDownBlock2D":
        return AttnSkipDownBlock(in_channels, out_channels, temb_channels, num_layers,
                                 resnet_eps, attn_num_head_channels,
                                 add_downsample=add_downsample)
    if down_block_type == "DownEncoderBlock2D":
        return DownEncoderBlock(in_channels, out_channels, num_layers, groups,
                                add_downsample=add_downsample, downsample_padding=pad)
    if down_block_type == "AttnDownEncoderBlock2D":
        return AttnDownEncoderBlock(in_channels, out_channels, num_layers, resnet_eps,
                                    groups, attn_num_head_channels,
                                    downsample_padding=pad, add_downsample=add_downsample)
    raise ValueError(f"{down_block_type} does not exist.")


def get_up_block(up_block_type: str, num_layers: int, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: Optional[int],
                 add_upsample: bool, resnet_eps: float = 1e-6,
                 attn_num_head_channels: Optional[int] = 1,
                 resnet_groups: Optional[int] = None,
                 cross_attention_dim: Optional[int] = None) -> nn.Module:
    """The reference's ``get_up_block`` over the port's blocks."""
    from medfusion_tpu_torch.models.unet_diffusers import _UpBlock

    if up_block_type.startswith("UNetRes"):
        up_block_type = up_block_type[7:]
    groups = 32 if resnet_groups is None else resnet_groups
    if up_block_type in ("UpBlock2D", "CrossAttnUpBlock2D"):
        cross = up_block_type == "CrossAttnUpBlock2D"
        if cross and cross_attention_dim is None:
            raise ValueError("cross_attention_dim must be specified for CrossAttnUpBlock2D")
        return _UpBlock(in_channels, prev_output_channel, out_channels, temb_channels,
                        num_layers, groups, resnet_eps, cross=cross,
                        attn_head_dim=out_channels // (attn_num_head_channels or 1),
                        context_dim=cross_attention_dim, add_upsample=add_upsample)
    if up_block_type == "AttnUpBlock2D":
        return AttnUpBlock(in_channels, prev_output_channel, out_channels, temb_channels,
                           num_layers, resnet_eps, groups, attn_num_head_channels,
                           add_upsample=add_upsample)
    if up_block_type == "SkipUpBlock2D":
        return SkipUpBlock(in_channels, prev_output_channel, out_channels, temb_channels,
                           num_layers, resnet_eps, add_upsample=add_upsample)
    if up_block_type == "AttnSkipUpBlock2D":
        return AttnSkipUpBlock(in_channels, prev_output_channel, out_channels,
                               temb_channels, num_layers, resnet_eps,
                               attn_num_head_channels, add_upsample=add_upsample)
    if up_block_type == "UpDecoderBlock2D":
        return UpDecoderBlock(in_channels, out_channels, num_layers, groups,
                              add_upsample=add_upsample)
    if up_block_type == "AttnUpDecoderBlock2D":
        return AttnUpDecoderBlock(in_channels, out_channels, num_layers, resnet_eps, groups,
                                  attn_num_head_channels, add_upsample=add_upsample)
    raise ValueError(f"{up_block_type} does not exist.")
