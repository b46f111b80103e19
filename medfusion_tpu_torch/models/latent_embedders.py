"""Latent embedders, NCHW (port of ``medfusion_tpu/models/latent_embedders.py``).

* :func:`diagonal_gaussian` — reparameterised posterior sample + KL.
* :class:`VectorQuantizer` — nearest code by the ||z||^2 + ||c||^2 - 2 z.c^T
  distances (one matmul), straight-through gradients, beta-commitment loss.
* :class:`Discriminator` — BasicBlock conv stack (GroupNorm 32 + SiLU) with a
  zero-init 3x3 head.
* :class:`NLayerDiscriminator` — the PatchGAN alternative (BatchNorm,
  LeakyReLU 0.2).
* :class:`VAE` — symmetric encoder/decoder over DownBlock/UpBlock (with or
  without attention), a 2x emb_channels out-encoder for (mean, logvar), and
  deep-supervision heads.
* :class:`VQVAE` — the same skeleton with a VectorQuantizer bottleneck.

The adversarial training of the reference's VAEGAN/VQGAN is in
:mod:`medfusion_tpu_torch.train.adversarial`. Submodule names are the
reference's keys (``quantizer.embedder.weight``, ``out_enc.*``, and
``inc.*``/``encoder.{i}.*``/``outc.*`` for a discriminator). A
discriminator's ``dropout`` goes to each of its BasicBlocks but the head,
between the norm and the activation. The diffusers family is
``models/latent_embedders_diffusers.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from medfusion_tpu_torch.nn.blocks import (
    BasicBlock,
    DownBlock,
    UnetBasicBlock,
    UnetResBlock,
    UpBlock,
)


def diagonal_gaussian(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                      sample: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split channels into (mean, logvar), reparameterise, return (z, kl).

    logvar is clamped to [-30, 20]; the KL is summed over every dim and
    divided by the batch. ``noise`` is the standard-normal draw (the caller
    controls the randomness); it is needed only when ``sample``."""
    mean, logvar = torch.chunk(x, 2, dim=1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    if sample:
        if noise is None:
            raise ValueError("sample=True needs a noise tensor")
        z = mean + torch.exp(0.5 * logvar) * noise
    else:
        z = mean
    kl = 0.5 * torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar) / x.shape[0]
    return z, kl


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook ``embedder.weight`` [K, C], initialised
    U(-1/K, 1/K). ``forward(z)`` on [B, C, *spatial] returns (z_q, loss):
    z_q carries z's gradient (straight-through), and loss = beta *
    mean((sg(z_q) - z)^2) + mean((z_q - sg(z))^2)."""

    def __init__(self, num_embeddings: int, emb_channels: int, beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.embedder = nn.Embedding(num_embeddings, emb_channels)
        nn.init.uniform_(self.embedder.weight, -1.0 / num_embeddings, 1.0 / num_embeddings)

    def nearest(self, z: torch.Tensor) -> torch.Tensor:
        """Each position's code index, [B * prod(spatial)] in channels-last
        order (the JAX package's flattening)."""
        flat = z.movedim(1, -1).reshape(-1, z.shape[1])
        codebook = self.embedder.weight
        dist = ((flat**2).sum(dim=1, keepdim=True) + (codebook**2).sum(dim=1)
                - 2.0 * flat @ codebook.t())
        return dist.argmin(dim=1)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self.nearest(z)
        z_q = self.embedder.weight[idx].reshape(z.shape[0], *z.shape[2:], z.shape[1])
        z_q = z_q.movedim(-1, 1)
        loss = (self.beta * torch.mean((z_q.detach() - z) ** 2)
                + torch.mean((z_q - z.detach()) ** 2))
        return z + (z_q - z).detach(), loss


class Discriminator(nn.Module):
    """Conv-stack discriminator: BasicBlocks (conv -> GroupNorm -> SiLU) at
    ``hid_chs`` and ``strides``, then a zero-init 3x3 conv to one logit
    channel."""

    def __init__(self, in_channels: int = 3, spatial_dims: int = 2,
                 hid_chs: Sequence[int] = (32, 64, 128, 256, 512),
                 kernel_sizes: Sequence = (3, 3, 3, 3, 3),
                 strides: Sequence = (1, 2, 2, 2, 2), act_name=("SWISH", {}),
                 norm_name=("GROUP", {"num_groups": 32, "affine": True}),
                 dropout: Optional[float] = None):
        super().__init__()
        n = spatial_dims
        self.inc = BasicBlock(n, in_channels, hid_chs[0], kernel_sizes[0], strides[0],
                              norm_name, act_name, dropout=dropout)
        self.encoder = nn.Sequential(*[
            BasicBlock(n, hid_chs[i - 1], hid_chs[i], kernel_sizes[i], strides[i],
                       norm_name, act_name, dropout=dropout)
            for i in range(1, len(hid_chs))])
        self.outc = BasicBlock(n, hid_chs[-1], 1, 3, 1, zero_conv=True)

    def forward(self, x):
        return self.outc(self.encoder(self.inc(x)))


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator: a 4x4 conv stack, no norm on ``inc``, BATCH
    norm after the others, LeakyReLU 0.2, then a 4x4 conv to one logit
    channel."""

    def __init__(self, in_channels: int = 3, spatial_dims: int = 2,
                 hid_chs: Sequence[int] = (64, 128, 256, 512, 512),
                 kernel_sizes: Sequence = (4, 4, 4, 4, 4),
                 strides: Sequence = (2, 2, 2, 1, 1),
                 act_name=("LEAKYRELU", {"negative_slope": 0.2}),
                 norm_name=("BATCH", {}), dropout: Optional[float] = None):
        super().__init__()
        n = spatial_dims
        self.inc = BasicBlock(n, in_channels, hid_chs[0], kernel_sizes[0], strides[0],
                              None, act_name, dropout=dropout)
        self.encoder = nn.Sequential(*[
            BasicBlock(n, hid_chs[i - 1], hid_chs[i], kernel_sizes[i], strides[i],
                       norm_name, act_name, dropout=dropout)
            for i in range(1, len(strides))])
        self.outc = BasicBlock(n, hid_chs[-1], 1, 4, 1)

    def forward(self, x):
        return self.outc(self.encoder(self.inc(x)))


class _AutoencoderBase(nn.Module):
    """The encoder/decoder skeleton of :class:`VAE` and :class:`VQVAE`; the
    subclass gives the out-encoder (:meth:`_out_encoder`). Without
    ``learnable_interpolation`` the down and up blocks average-pool and
    resize (no skips, so nothing is concatenated); ``dropout`` goes to the
    down and up blocks' conv blocks and attention, as in the JAX package
    (not to ``inc``, ``inc_dec`` or the heads)."""

    def __init__(self, in_channels: int, out_channels: int, spatial_dims: int,
                 emb_channels: int, hid_chs: Sequence[int], kernel_sizes: Sequence,
                 strides: Sequence, norm_name, act_name, use_res_block: bool,
                 deep_supervision: Union[bool, int],
                 use_attention: Union[str, Sequence[str]], learnable_interpolation: bool,
                 dropout: Optional[float]):
        super().__init__()
        depth = len(strides)
        attn = (list(use_attention) if isinstance(use_attention, (list, tuple))
                else [use_attention] * depth)
        ConvBlock = UnetResBlock if use_res_block else UnetBasicBlock
        n = spatial_dims
        self.inc = ConvBlock(n, in_channels, hid_chs[0], kernel_sizes[0],
                             strides[0], norm_name, act_name)
        self.encoders = nn.ModuleList([
            DownBlock(n, hid_chs[i - 1], hid_chs[i], kernel_sizes[i], strides[i],
                      kernel_sizes[i], norm_name, act_name, use_res_block, attn[i],
                      dropout=dropout, learnable_interpolation=learnable_interpolation)
            for i in range(1, depth)])
        self.out_enc = self._out_encoder(n, hid_chs[-1], emb_channels)
        self.inc_dec = ConvBlock(n, emb_channels, hid_chs[-1], 3, 1, norm_name,
                                 act_name)
        self.decoders = nn.ModuleList([
            UpBlock(n, hid_chs[i + 1], hid_chs[i], kernel_sizes[i + 1],
                    strides[i + 1], strides[i + 1], norm_name, act_name,
                    use_res_block, attn[i], dropout=dropout,
                    learnable_interpolation=learnable_interpolation)
            for i in range(depth - 1)])
        self.outc = BasicBlock(n, hid_chs[0], out_channels, 1, zero_conv=True)
        ds = deep_supervision
        ds = (depth - 1 if ds else 0) if isinstance(ds, bool) else int(ds)
        self.outc_ver = nn.ModuleList([
            BasicBlock(n, hid_chs[i], out_channels, 1, zero_conv=True)
            for i in range(1, ds + 1)])

    def _out_encoder(self, n: int, channels: int, emb_channels: int) -> nn.Module:
        raise NotImplementedError

    def _encode_backbone(self, x):
        h = self.inc(x)
        for enc in self.encoders:
            h = enc(h)
        return self.out_enc(h)

    def decode_with_vertical(self, z):
        """(out, deep-supervision outputs, lowest resolution first)."""
        out_hor = []
        h = self.inc_dec(z)
        for i in range(len(self.decoders) - 1, -1, -1):
            if i < len(self.outc_ver):
                out_hor.append(self.outc_ver[i](h))
            h = self.decoders[i](h)
        return self.outc(h), out_hor[::-1]

    def out_head(self, depth: int) -> nn.Conv2d:
        """The 1x1 out-head conv of pyramid level ``depth`` (0: ``outc``,
        i > 0: ``outc_ver[i - 1]``), whose weight anchors the adversarial
        trainer's adaptive lambda."""
        return (self.outc if depth == 0 else self.outc_ver[depth - 1]).conv

    def _decode(self, z):
        h = self.inc_dec(z)
        for i in range(len(self.decoders) - 1, -1, -1):
            h = self.decoders[i](h)
        return self.outc(h)


_AE_DEFAULTS = dict(in_channels=3, out_channels=3, spatial_dims=2, emb_channels=4,
                    kernel_sizes=(3, 3, 3, 3), strides=(1, 2, 2, 2), act_name=("SWISH", {}),
                    use_res_block=True, deep_supervision=False, use_attention="none",
                    learnable_interpolation=True, dropout=None)


class VAE(_AutoencoderBase):
    """KL autoencoder. ``use_attention`` ('none' | 'linear' | 'spatial', or
    one per level) puts attention in the down and up blocks."""

    def __init__(self, hid_chs: Sequence[int] = (64, 128, 256, 512),
                 norm_name=("GROUP", {"num_groups": 8, "affine": True}), **kw):
        super().__init__(hid_chs=hid_chs, norm_name=norm_name, **{**_AE_DEFAULTS, **kw})

    def _out_encoder(self, n, channels, emb_channels):
        return nn.Sequential(
            BasicBlock(n, channels, 2 * emb_channels, 3),
            BasicBlock(n, 2 * emb_channels, 2 * emb_channels, 1))

    def moments(self, x):
        return self._encode_backbone(x)

    def encode(self, x, noise: Optional[torch.Tensor] = None, sample: bool = True):
        z, _ = diagonal_gaussian(self.moments(x), noise, sample=sample)
        return z

    def forward(self, x, noise: Optional[torch.Tensor] = None, sample: bool = True):
        """The training forward (JAX ``VAE.__call__(train=True)``): (pred,
        deep-supervision outputs lowest resolution first, KL). ``noise`` is
        the standard-normal draw [B, emb_channels, h, w] of the
        reparameterisation, needed when ``sample``."""
        z, kl = diagonal_gaussian(self.moments(x), noise, sample=sample)
        pred, pred_vertical = self.decode_with_vertical(z)
        return pred, pred_vertical, kl

    def decode(self, z):
        return self._decode(z)


class VQVAE(_AutoencoderBase):
    """VQ autoencoder: the same skeleton, a 1x1 out-encoder to
    ``emb_channels`` and a :class:`VectorQuantizer` of ``num_embeddings``
    codes. ``encode`` returns the pre-quantisation latent; ``decode``
    quantises first."""

    def __init__(self, hid_chs: Sequence[int] = (32, 64, 128, 256),
                 norm_name=("GROUP", {"num_groups": 32, "affine": True}),
                 num_embeddings: int = 8192, beta: float = 0.25, **kw):
        super().__init__(hid_chs=hid_chs, norm_name=norm_name, **{**_AE_DEFAULTS, **kw})
        self.quantizer = VectorQuantizer(num_embeddings, self.out_enc.conv.out_channels, beta)

    def _out_encoder(self, n, channels, emb_channels):
        return BasicBlock(n, channels, emb_channels, 1)

    def encode(self, x):
        return self._encode_backbone(x)

    def forward(self, x):
        """(pred, deep-supervision outputs lowest resolution first, the
        quantiser's loss)."""
        z_q, emb_loss = self.quantizer(self.encode(x))
        pred, pred_vertical = self.decode_with_vertical(z_q)
        return pred, pred_vertical, emb_loss

    def decode(self, z):
        z_q, _ = self.quantizer(z)
        return self._decode(z_q)
