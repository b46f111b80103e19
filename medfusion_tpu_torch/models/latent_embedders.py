"""KL autoencoder (VAE), NCHW (port of ``medfusion_tpu/models/latent_embedders.py``).

Symmetric encoder/decoder over DownBlock/UpBlock, a 2x emb_channels
out-encoder for (mean, logvar), and deep-supervision heads. VQVAE and the
discriminators are not ported yet.
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


class VAE(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 spatial_dims: int = 2, emb_channels: int = 4,
                 hid_chs: Sequence[int] = (64, 128, 256, 512),
                 kernel_sizes: Sequence = (3, 3, 3, 3),
                 strides: Sequence = (1, 2, 2, 2),
                 norm_name=("GROUP", {"num_groups": 8, "affine": True}),
                 act_name=("SWISH", {}), use_res_block: bool = True,
                 deep_supervision: Union[bool, int] = False,
                 use_attention: Union[str, Sequence[str]] = "none"):
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
                      kernel_sizes[i], norm_name, act_name, use_res_block, attn[i])
            for i in range(1, depth)])
        self.out_enc = nn.Sequential(
            BasicBlock(n, hid_chs[-1], 2 * emb_channels, 3),
            BasicBlock(n, 2 * emb_channels, 2 * emb_channels, 1))
        self.inc_dec = ConvBlock(n, emb_channels, hid_chs[-1], 3, 1, norm_name,
                                 act_name)
        self.decoders = nn.ModuleList([
            UpBlock(n, hid_chs[i + 1], hid_chs[i], kernel_sizes[i + 1],
                    strides[i + 1], strides[i + 1], norm_name, act_name,
                    use_res_block, attn[i])
            for i in range(depth - 1)])
        self.outc = BasicBlock(n, hid_chs[0], out_channels, 1, zero_conv=True)
        ds = deep_supervision
        ds = (depth - 1 if ds else 0) if isinstance(ds, bool) else int(ds)
        self.outc_ver = nn.ModuleList([
            BasicBlock(n, hid_chs[i], out_channels, 1, zero_conv=True)
            for i in range(1, ds + 1)])

    def moments(self, x):
        h = self.inc(x)
        for enc in self.encoders:
            h = enc(h)
        return self.out_enc(h)

    def encode(self, x, noise: Optional[torch.Tensor] = None, sample: bool = True):
        z, _ = diagonal_gaussian(self.moments(x), noise, sample=sample)
        return z

    def decode_with_vertical(self, z):
        """(out, deep-supervision outputs, lowest resolution first)."""
        out_hor = []
        h = self.inc_dec(z)
        for i in range(len(self.decoders) - 1, -1, -1):
            if i < len(self.outc_ver):
                out_hor.append(self.outc_ver[i](h))
            h = self.decoders[i](h)
        return self.outc(h), out_hor[::-1]

    def decode(self, z):
        h = self.inc_dec(z)
        for i in range(len(self.decoders) - 1, -1, -1):
            h = self.decoders[i](h)
        return self.outc(h)
