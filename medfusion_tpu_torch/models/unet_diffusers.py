"""The diffusers-style conditional UNet, NCHW (port of
``medfusion_tpu/models/unet_diffusers.py``; the reference's vendored
``UNet2DConditionModel``).

Cross-attention down and up blocks and a cross-attention middle block of
pre-norm resnets (GroupNorm eps ``norm_eps``, 1e-5) and diffusers spatial
transformers (GroupNorm eps 1e-6, ``proj_out`` not zero-initialised, the
SD transformer block: self-attention, cross-attention over the context,
GEGLU MLP). The time embedding is the flip-sin-to-cos sinusoid with shift 0
(an odd width padded with a zero column) through ``time_embedding.linear_1``
/ ``linear_2``. ``attention_head_dim`` is the number of heads: a block of
width C attends with that many heads of C / ``attention_head_dim``.

The label becomes the context through ``emb`` (an ``nn.Embedding`` of
``num_classes`` rows of ``cross_attention_dim``): 1-D labels one context
token [B, 1, dim] (the JAX package's documented repair of the reference,
whose forward would give CrossAttention a 2-D context), 2-D label grids
[B, T] T tokens. ``cond_mask`` multiplies the context. The time embedding
and the context take ``x_t``'s dtype, and ``conv_norm_out`` runs in
float32.

The estimator contract is the port's other families':
``forward(x_t, t, condition=None, cond_mask=None, self_cond=None) -> (y,
[])``, so the model drops into ``DiffusionPipeline`` for ``train_loss`` and
every sampler; no CLI builds it, as none in the JAX package does. The
GroupNorms and the attention are plain PyTorch (the JAX package leaves
them to flax), and the modules carry the reference's torch keys. The
up blocks' ``Upsample2D`` alias ``Conv2d_0`` of ``conv`` is read when
loading (``DUpsample``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.models.latent_embedders_diffusers import DResnetBlock, DUpsample
from medfusion_tpu_torch.models.unet_openai import SDBasicTransformerBlock


def diffusers_timestep_embedding(t, dim: int, flip_sin_to_cos: bool = True,
                                 downscale_freq_shift: float = 0.0,
                                 max_period: float = 10000.0):
    """[B] -> [B, dim] float32: sin then cos of t * exp(-ln(max_period) * i /
    (half - downscale_freq_shift)), the halves swapped by
    ``flip_sin_to_cos``, an odd ``dim`` padded with a zero column."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class DiffusersSpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6) -> 1x1 ``proj_in`` -> ``depth`` SD transformer
    blocks over the positions -> 1x1 ``proj_out`` + residual."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, norm_groups: int = 32):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(norm_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            SDBasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner, in_channels, 1)

    def forward(self, x, context=None):
        h = self.proj_in(self.norm(x))
        tokens = h.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            tokens = block(tokens, context=context)
        return self.proj_out(tokens.transpose(1, 2).reshape(h.shape)) + x


class DDownsampleConv(nn.Module):
    """A 3x3 stride-2 conv padded 1 on every side (``downsamplers.0.conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


def _transformers(channels, num_layers, heads, context_dim, groups):
    return nn.ModuleList([
        DiffusersSpatialTransformer(channels, heads, channels // heads,
                                    context_dim=context_dim, norm_groups=groups)
        for _ in range(num_layers)])


class _DownBlock(nn.Module):
    """DownBlock2D, or with ``cross`` CrossAttnDownBlock2D (a spatial
    transformer of ``attn_head_dim`` heads after each resnet); returns (x,
    the state after each resnet and after the downsampler)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, groups: int = 32, eps: float = 1e-5,
                 cross: bool = False, attn_head_dim: int = 8,
                 context_dim: Optional[int] = None, add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            DResnetBlock(in_channels if i == 0 else out_channels, out_channels, groups,
                         temb_channels=temb_channels, eps=eps)
            for i in range(num_layers)])
        if cross:
            self.attentions = _transformers(out_channels, num_layers, attn_head_dim,
                                            context_dim, groups)
        if add_downsample:
            self.downsamplers = nn.ModuleList([DDownsampleConv(out_channels, out_channels)])

    def forward(self, x, temb, context=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, tuple(skips)


class _UpBlock(nn.Module):
    """UpBlock2D, or with ``cross`` CrossAttnUpBlock2D: each resnet takes x
    and the last of the skips, then a nearest-2x upsampler with its conv."""

    def __init__(self, in_channels: int, prev_output_channel: int, out_channels: int,
                 temb_channels: int, num_layers: int = 3, groups: int = 32,
                 eps: float = 1e-5, cross: bool = False, attn_head_dim: int = 8,
                 context_dim: Optional[int] = None, add_upsample: bool = True):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            resnets.append(DResnetBlock(res_in + res_skip, out_channels, groups,
                                        temb_channels=temb_channels, eps=eps))
        self.resnets = nn.ModuleList(resnets)
        if cross:
            self.attentions = _transformers(out_channels, num_layers, attn_head_dim,
                                            context_dim, groups)
        if add_upsample:
            self.upsamplers = nn.ModuleList([DUpsample(out_channels)])

    def forward(self, x, skips: Sequence[torch.Tensor], temb, context=None):
        skips = list(skips)
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _MidBlockCrossAttn(nn.Module):
    """Resnet -> spatial transformer -> resnet."""

    def __init__(self, channels: int, temb_channels: int, groups: int = 32,
                 eps: float = 1e-5, attn_head_dim: int = 8,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.resnets = nn.ModuleList([
            DResnetBlock(channels, channels, groups, temb_channels=temb_channels, eps=eps)
            for _ in range(2)])
        self.attentions = _transformers(channels, 1, attn_head_dim, context_dim, groups)

    def forward(self, x, temb, context=None):
        x = self.attentions[0](self.resnets[0](x, temb), context)
        return self.resnets[1](x, temb)


class _TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DConditionDiffusers(nn.Module):
    """The conditional diffusers UNet; returns ``(sample, [])``."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 down_block_types: Sequence[str] = ("CrossAttnDownBlock2D",
                                                    "CrossAttnDownBlock2D",
                                                    "CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types: Sequence[str] = ("UpBlock2D", "CrossAttnUpBlock2D",
                                                  "CrossAttnUpBlock2D",
                                                  "CrossAttnUpBlock2D"),
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 norm_eps: float = 1e-5, cross_attention_dim: int = 768,
                 attention_head_dim: int = 8, num_classes: int = 2):
        super().__init__()
        chs = list(block_out_channels)
        ted = chs[0] * 4
        g, eps = norm_num_groups, norm_eps
        self.time_dim = chs[0]
        self.emb = nn.Embedding(num_classes, cross_attention_dim)
        self.conv_in = nn.Conv2d(in_channels, chs[0], 3, padding=1)
        self.time_embedding = _TimestepEmbedding(chs[0], ted)
        down, out_ch = [], chs[0]
        for i, kind in enumerate(down_block_types):
            in_ch, out_ch = out_ch, chs[i]
            down.append(_DownBlock(in_ch, out_ch, ted, layers_per_block, g, eps,
                                   cross=kind == "CrossAttnDownBlock2D",
                                   attn_head_dim=attention_head_dim,
                                   context_dim=cross_attention_dim,
                                   add_downsample=i != len(chs) - 1))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _MidBlockCrossAttn(chs[-1], ted, g, eps, attention_head_dim,
                                            cross_attention_dim)
        rev = chs[::-1]
        up, out_ch = [], rev[0]
        for i, kind in enumerate(up_block_types):
            prev_out, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, len(chs) - 1)]
            up.append(_UpBlock(in_ch, prev_out, out_ch, ted, layers_per_block + 1, g, eps,
                               cross=kind == "CrossAttnUpBlock2D",
                               attn_head_dim=attention_head_dim,
                               context_dim=cross_attention_dim,
                               add_upsample=i != len(chs) - 1))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps=eps)
        self.conv_out = nn.Conv2d(chs[0], out_channels, 3, padding=1)

    def forward(self, x_t, t=None, condition=None, cond_mask=None, self_cond=None):
        if self_cond is not None:
            raise ValueError("UNet2DConditionDiffusers has no self-conditioning")
        context = None
        if condition is not None:
            cond = condition.long()
            context = self.emb(cond if cond.ndim > 1 else cond[:, None])  # [B, T, dim]
            if cond_mask is not None:
                context = context * cond_mask.to(context.dtype)[:, None, None]
            context = context.to(x_t.dtype)
        lin = self.time_embedding.linear_1.weight
        temb = self.time_embedding(
            diffusers_timestep_embedding(t, self.time_dim).to(lin.dtype)).to(x_t.dtype)
        h = self.conv_in(x_t)
        skips = (h,)
        for blk in self.down_blocks:
            h, s = blk(h, temb, context)
            skips += s
        h = self.mid_block(h, temb, context)
        for blk in self.up_blocks:
            n = len(blk.resnets)
            h = blk(h, skips[-n:], temb, context)
            skips = skips[:-n]
        norm = self.conv_norm_out
        h = F.group_norm(h.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
                         norm.eps).to(x_t.dtype)
        return self.conv_out(F.silu(h)), []
