"""The diffusers-style latent embedders, NCHW (port of
``medfusion_tpu/models/latent_embedders_diffusers.py``): the reference's
vendored ``AutoencoderKL`` and ``VQModel``.

Pre-norm resnet blocks (GroupNorm eps 1e-6) in the encoder and decoder, a
middle block with single-head spatial attention (separate q/k/v linears,
d^-0.25 on each side, the softmax in float32), stride-2 downsampling by a
3x3 conv of padding 0 after an asymmetric (0, 1, 0, 1) pad, nearest-2x
upsampling + 3x3 conv, and 1x1 quant / post-quant convs. Quirks of the
vendored copy kept, as the JAX package keeps them: ``block_out_channels``
has one entry more than there are levels and every level downsamples; the
decoder has ``layers_per_block + 1`` resnets a level; the posterior's
logvar is not clamped and its KL is summed over everything, then divided
by the batch. The VQ model's quantiser is the in-house
:class:`VectorQuantizer` (the vendored ``legacy=False`` loss is the same).

The contract is the in-house family's (``models/latent_embedders.py``):
``forward(x[, noise]) -> (pred, [], emb_loss)``, ``encode``, ``decode``,
with the reparameterisation draw ``noise`` given by the caller;
``forward_with_hiddens`` also returns the decoder's activation before
``conv_out`` (the adversarial lambda's anchor, ``out_head(0)``). The
GroupNorms and the attention are plain PyTorch: the JAX package runs them
in flax and XLA, outside Pallas. ``DResnetBlock``'s FIR resampling modes
(``up_fir``, ``down_fir``) run ``models/diffusers_blocks.py``'s
``fir_upsample_2d`` / ``fir_downsample_2d``. The submodules carry the
reference's torch keys (``encoder.down_blocks.{i}.resnets.{j}.norm1``,
``mid_block.attentions.0.query``, ``downsamplers.0.conv``; the codebook is
``quantize.embedder.weight``). The reference's ``Upsample2D`` registers its
conv under ``conv`` and again under ``Conv2d_0``; ``DUpsample`` loads a
state dict that carries both (the alias must equal its twin) and writes
``conv`` only, as the JAX converter drops the alias.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.models.latent_embedders import VectorQuantizer

UPDOWN = ("none", "up", "down", "up_sde", "down_sde", "up_fir", "down_fir")


def _gn(channels: int, groups: int, eps: float = 1e-6) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=eps)


def _conv3(c_in: int, c_out: int, stride: int = 1, padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=padding)


def _upsample2x(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class DResnetBlock(nn.Module):
    """GroupNorm -> act -> conv, the time embedding added, GroupNorm -> act
    -> conv, plus a 1x1 shortcut (where the width changes, or by
    ``use_in_shortcut``), divided by ``output_scale_factor``; ``updown``
    resamples both paths after the first activation (nearest 2x, a 2x2
    average pool, or the (1, 3, 3, 1) FIR filter's 2x up or down);
    ``non_linearity`` 'swish' or 'mish'."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 temb_channels: Optional[int] = None, eps: float = 1e-6,
                 groups_out: Optional[int] = None, output_scale_factor: float = 1.0,
                 use_in_shortcut: Optional[bool] = None, updown: str = "none",
                 non_linearity: str = "swish"):
        super().__init__()
        if updown not in UPDOWN:
            raise ValueError(f"unknown updown {updown!r}")
        self.updown, self.non_linearity = updown, non_linearity
        self.output_scale_factor = output_scale_factor
        self.norm1 = _gn(in_channels, groups, eps)
        self.conv1 = _conv3(in_channels, out_channels)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = _gn(out_channels, groups if groups_out is None else groups_out, eps)
        self.conv2 = _conv3(out_channels, out_channels)
        shortcut = (in_channels != out_channels if use_in_shortcut is None
                    else use_in_shortcut)
        if shortcut:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def _act(self, x):
        return F.mish(x) if self.non_linearity == "mish" else F.silu(x)

    def _resample(self, x):
        from medfusion_tpu_torch.models.diffusers_blocks import (
            fir_downsample_2d,
            fir_upsample_2d,
        )

        if self.updown in ("up", "up_sde"):
            return _upsample2x(x)
        if self.updown == "up_fir":
            return fir_upsample_2d(x)
        if self.updown == "down_fir":
            return fir_downsample_2d(x)
        return F.avg_pool2d(x, 2)

    def forward(self, x, temb=None):
        h = self._act(self.norm1(x))
        if self.updown != "none":
            x, h = self._resample(x), self._resample(h)
        h = self.conv1(h)
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(self._act(temb))[:, :, None, None]
        h = self.conv2(self._act(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        out = x + h
        if self.output_scale_factor != 1.0:
            out = out / self.output_scale_factor
        return out


class DAttentionBlock(nn.Module):
    """Spatial self-attention of ``channels // num_head_channels`` heads
    (one when None) with separate q/k/v linears, d^-0.25 on q and on k and
    the softmax in float32, a ``proj_attn`` projection and a residual."""

    def __init__(self, channels: int, num_head_channels: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6, rescale_output_factor: float = 1.0):
        super().__init__()
        self.heads = channels // num_head_channels if num_head_channels else 1
        self.rescale_output_factor = rescale_output_factor
        self.group_norm = _gn(channels, groups, eps)
        self.query, self.key, self.value, self.proj_attn = (
            nn.Linear(channels, channels) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, N, C]
        scale = (c // self.heads) ** -0.25
        q, k, v = (t.unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for t in (self.query(h), self.key(h), self.value(h)))
        attn = (q * scale) @ (k * scale).transpose(-1, -2)
        attn = attn.float().softmax(dim=-1).to(attn.dtype)
        out = self.proj_attn((attn @ v).transpose(1, 2).flatten(2))
        out = out.transpose(1, 2).reshape(b, c, hh, ww) + x
        if self.rescale_output_factor != 1.0:
            out = out / self.rescale_output_factor
        return out


class DDownsample(nn.Module):
    """3x3 stride-2 conv to ``out_channels`` (default ``channels``);
    ``padding=0`` pads (0, 1, 0, 1) first, any other value is the conv's own
    symmetric padding."""

    def __init__(self, channels: int, padding: int = 0, out_channels: Optional[int] = None):
        super().__init__()
        self.padding = padding
        self.conv = _conv3(channels, out_channels or channels, stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


def _drop_conv_alias(module, state_dict, prefix, *args):
    """Load-state-dict pre-hook: a ``Conv2d_0`` alias of ``conv`` (the
    reference's ``Upsample2D`` registers one conv under both names) is taken
    out, or read as ``conv`` when that key is absent."""
    for leaf in ("weight", "bias"):
        alias = state_dict.pop(f"{prefix}Conv2d_0.{leaf}", None)
        if alias is None:
            continue
        twin = state_dict.setdefault(f"{prefix}conv.{leaf}", alias)
        if not torch.equal(twin, alias):
            raise ValueError(f"{prefix}Conv2d_0.{leaf} differs from its twin "
                             f"{prefix}conv.{leaf}")


class DUpsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (``conv``; a ``Conv2d_0`` alias of it is
    read when loading)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)
        self.register_load_state_dict_pre_hook(_drop_conv_alias)

    def forward(self, x):
        return self.conv(_upsample2x(x))


class DownEncoderBlock(nn.Module):
    """``num_layers`` resnets, then a downsample (the encoder's pads
    asymmetrically)."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1,
                 groups: int = 32, add_downsample: bool = True, downsample_padding: int = 0):
        super().__init__()
        self.resnets = nn.ModuleList([
            DResnetBlock(in_channels if i == 0 else out_channels, out_channels, groups)
            for i in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([DDownsample(out_channels, downsample_padding)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in getattr(self, "downsamplers", ()):
            x = d(x)
        return x


class UpDecoderBlock(nn.Module):
    """``num_layers`` resnets, then an upsample."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 2,
                 groups: int = 32, add_upsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            DResnetBlock(in_channels if i == 0 else out_channels, out_channels, groups)
            for i in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([DUpsample(out_channels)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in getattr(self, "upsamplers", ()):
            x = u(x)
        return x


class MidBlock(nn.Module):
    """Resnet -> attention -> resnet."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([DResnetBlock(channels, channels, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([DAttentionBlock(channels, None, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class DiffusersEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int], layers_per_block: int = 2,
                 norm_num_groups: int = 32, double_z: bool = True):
        super().__init__()
        chs = block_out_channels
        self.conv_in = _conv3(in_channels, chs[0])
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock(chs[i], chs[i + 1], layers_per_block, norm_num_groups)
            for i in range(len(chs) - 1)])
        self.mid_block = MidBlock(chs[-1], norm_num_groups)
        self.conv_norm_out = _gn(chs[-1], norm_num_groups)
        self.conv_out = _conv3(chs[-1], 2 * out_channels if double_z else out_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(h))))


class DiffusersDecoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int], layers_per_block: int = 2,
                 norm_num_groups: int = 32):
        super().__init__()
        chs = list(reversed(block_out_channels))
        self.conv_in = _conv3(in_channels, chs[0])
        self.mid_block = MidBlock(chs[0], norm_num_groups)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock(chs[i], chs[i + 1], layers_per_block + 1, norm_num_groups)
            for i in range(len(chs) - 1)])
        self.conv_norm_out = _gn(chs[-1], norm_num_groups)
        self.conv_out = _conv3(chs[-1], out_channels)

    def hidden(self, z):
        """The activation before ``conv_out``."""
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return F.silu(self.conv_norm_out(h))

    def forward(self, z):
        return self.conv_out(self.hidden(z))


def diffusers_gaussian(moments, noise=None, sample: bool = True):
    """(z, KL) of the posterior: no logvar clamp, the KL summed over
    everything and divided by the batch; ``noise`` is the standard-normal
    draw, needed when ``sample``."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    kl = 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar) / moments.shape[0]
    if not sample:
        return mean, kl
    if noise is None:
        raise ValueError("sample=True needs a noise tensor")
    return mean + torch.exp(0.5 * logvar) * noise, kl


class _DiffusersAutoencoder(nn.Module):
    def __init__(self, in_channels, out_channels, emb_channels, block_out_channels,
                 layers_per_block, norm_num_groups, double_z):
        super().__init__()
        self.encoder = DiffusersEncoder(in_channels, emb_channels, block_out_channels,
                                        layers_per_block, norm_num_groups, double_z)
        self.decoder = DiffusersDecoder(emb_channels, out_channels, block_out_channels,
                                        layers_per_block, norm_num_groups)
        z = 2 * emb_channels if double_z else emb_channels
        self.quant_conv = nn.Conv2d(z, z, 1)
        self.post_quant_conv = nn.Conv2d(emb_channels, emb_channels, 1)

    def out_head(self, depth: int) -> nn.Conv2d:
        """The decoder's ``conv_out``, the adversarial lambda's anchor; the
        family has no deep-supervision heads."""
        if depth != 0:
            raise ValueError("the diffusers autoencoders have one out head")
        return self.decoder.conv_out

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


class AutoencoderKLDiffusers(_DiffusersAutoencoder):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, emb_channels: int = 3,
                 block_out_channels: Sequence[int] = (32, 64, 128, 128),
                 layers_per_block: int = 1, norm_num_groups: int = 32):
        super().__init__(in_channels, out_channels, emb_channels, block_out_channels,
                         layers_per_block, norm_num_groups, double_z=True)

    def moments(self, x):
        return self.quant_conv(self.encoder(x))

    def encode(self, x, noise: Optional[torch.Tensor] = None, sample: bool = True):
        return diffusers_gaussian(self.moments(x), noise, sample)[0]

    def forward(self, x, noise: Optional[torch.Tensor] = None, sample: bool = True):
        """(pred, [], KL); ``noise`` [B, emb_channels, h, w] is the
        reparameterisation draw, needed when ``sample``."""
        z, kl = diffusers_gaussian(self.moments(x), noise, sample)
        return self.decode(z), [], kl

    def forward_with_hiddens(self, x, noise: Optional[torch.Tensor] = None,
                             sample: bool = True):
        """(pred, [], KL, the decoder's activation before conv_out, [])."""
        z, kl = diffusers_gaussian(self.moments(x), noise, sample)
        h = self.decoder.hidden(self.post_quant_conv(z))
        return self.decoder.conv_out(h), [], kl, h, []


class VQModelDiffusers(_DiffusersAutoencoder):
    """``encode`` returns the quantised latent and ``decode`` takes it as it
    is, as in the JAX package."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, emb_channels: int = 3,
                 num_embeddings: int = 256,
                 block_out_channels: Sequence[int] = (32, 64, 128, 256),
                 layers_per_block: int = 1, norm_num_groups: int = 32):
        super().__init__(in_channels, out_channels, emb_channels, block_out_channels,
                         layers_per_block, norm_num_groups, double_z=False)
        self.quantize = VectorQuantizer(num_embeddings, emb_channels, beta=0.25)

    def _quantized(self, x):
        return self.quantize(self.quant_conv(self.encoder(x)))

    def encode(self, x):
        return self._quantized(x)[0]

    def forward(self, x):
        """(pred, [], the quantiser's loss)."""
        z_q, emb_loss = self._quantized(x)
        return self.decode(z_q), [], emb_loss

    def forward_with_hiddens(self, x):
        """(pred, [], the quantiser's loss, the decoder's activation before
        conv_out, [])."""
        z_q, emb_loss = self._quantized(x)
        h = self.decoder.hidden(self.post_quant_conv(z_q))
        return self.decoder.conv_out(h), [], emb_loss, h, []
