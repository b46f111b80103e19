"""Time/label-conditioned UNet noise estimator, NCHW
(port of ``medfusion_tpu/models/unet.py``).

OpenAI-style UNet: in_conv; encoder of ``num_res_blocks`` conv blocks per
level with a strided conv between levels, every stage output kept as a skip;
middle conv -> conv; decoder of ``num_res_blocks + 1`` stages per level, each
consuming one skip by channel concat, with a nearest-exact up + conv after
the first stage of each level above the first; zero-init out conv (twice the
channels under ``estimate_variance``); optional deep-supervision heads.

Each conv stage of the encoder, the middle and the decoder is followed by
an attention slot (``in_blocks.i.1``, ``middle_block.1``, ``out_blocks.i.1``):
``use_attention`` 'none' | 'linear' | 'spatial', one for all levels or one
per level, with ``attn_heads`` heads of width ``level width / attn_heads``.

Classifier-free guidance zeroes the label embedding with a per-sample
``cond_mask``, as the JAX package does. With ``use_self_conditioning`` the
in conv takes ``[x_t | self_cond]`` (zeros for a missing ``self_cond``).

The forward is ``embed`` -> ``encode_features`` (in conv and encoder: the
skip stack) -> ``decode_features`` (middle and decoder), so that a sampler
can reuse an encoder's skips across steps (``pipelines/diffusion/fast.py``).

Without ``learnable_interpolation`` the down is an average pool and the
up a resize alone (no parameters); without ``use_time_embedder`` the time
is not embedded, and the blocks take the label embedding alone, or no
embedding when there is no label embedder (as in the JAX package).

``dropout`` goes to every conv block and attention. ``remat`` recomputes
each conv block in the backward (``nn/functional.py::checkpointed``), as
the JAX package's ``nn.remat`` of its ConvBlocks: their GroupNorm kernels
then launch twice a training step.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn as nn

from medfusion_tpu_torch.models.embedders import LabelEmbedder, TimeEmbedding
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES, Attention
from medfusion_tpu_torch.nn.blocks import (
    BasicBlock,
    BasicDown,
    BasicUp,
    UnetBasicBlock,
    UnetResBlock,
    conv_nd,
)
from medfusion_tpu_torch.nn.functional import checkpointed, save_add


class UnetOutBlock(nn.Module):
    """Zero-init 1x1 conv held as ``conv.conv`` (MONAI UnetOutBlock keys)."""

    def __init__(self, in_channels: int, out_channels: int, spatial_dims: int = 2):
        super().__init__()
        self.conv = nn.Sequential(OrderedDict(
            conv=conv_nd(in_channels, out_channels, 1, 1, zero_init=True,
                         spatial_dims=spatial_dims)))

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, in_ch: int = 1, out_ch: int = 1, spatial_dims: int = 2,
                 hid_chs: Sequence[int] = (256, 256, 512, 1024),
                 kernel_sizes: Sequence[int] = (3, 3, 3, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 act_name=("SWISH", {}),
                 norm_name=("GROUP", {"num_groups": 32, "affine": True}),
                 time_emb_dim: Optional[int] = None,
                 cond_emb_num_classes: Optional[int] = None,
                 deep_supervision=True, use_res_block: bool = True,
                 estimate_variance: bool = False,
                 use_attention="none", attn_heads: int = 8,
                 num_res_blocks: int = 2, use_self_conditioning: bool = False,
                 dropout: float = 0.0, remat: bool = False,
                 learnable_interpolation: bool = True, use_time_embedder: bool = True):
        super().__init__()
        depth = len(strides)
        attn = (list(use_attention) if isinstance(use_attention, (list, tuple))
                else [use_attention] * depth)
        if len(attn) != depth or any(a not in ATTENTION_TYPES for a in attn):
            raise ValueError(f"use_attention={use_attention!r}: expected one of "
                             f"{ATTENTION_TYPES} or a list of {depth} of them")
        if attn_heads < 1:
            raise ValueError(f"attn_heads must be >= 1, got {attn_heads}")
        # level i attends at hid_chs[i] (encoder, middle) and hid_chs[i - 1]
        # (the decoder's first stage)
        for i in range(1, depth):
            for ch in {hid_chs[i], hid_chs[i - 1]}:
                if attn[i] != "none" and ch % attn_heads:
                    raise ValueError(
                        f"attn_heads={attn_heads} does not divide attended "
                        f"level width {ch} (hid_chs={tuple(hid_chs)}, "
                        f"use_attention level {i}={attn[i]!r})")
        self.cond_emb_num_classes = cond_emb_num_classes
        self.use_time_embedder = use_time_embedder
        self.use_self_conditioning = use_self_conditioning
        self.remat = remat
        self.num_res_blocks = nrb = num_res_blocks
        dropout = dropout if dropout else None
        t_dim = time_emb_dim or hid_chs[0] * 4
        # the blocks take an embedding when there is one to give: the time's,
        # the label's or their sum, each t_dim wide
        e_dim = (t_dim if use_time_embedder or cond_emb_num_classes is not None
                 else None)
        ConvBlock = UnetResBlock if use_res_block else UnetBasicBlock
        n = spatial_dims

        def conv_block(cin, cout, k):
            return ConvBlock(n, cin, cout, k, 1, norm_name, act_name,
                             emb_channels=e_dim, dropout=dropout)

        def attention(ch, kind):
            return Attention(n, ch, attn_heads, ch // attn_heads, norm_name,
                             dropout, e_dim, 1, kind)

        if use_time_embedder:
            self.time_embedder = TimeEmbedding(emb_dim=t_dim)
        if cond_emb_num_classes is not None:
            self.cond_embedder = LabelEmbedder(emb_dim=t_dim,
                                               num_classes=cond_emb_num_classes)

        in_conv_ch = 2 * in_ch if use_self_conditioning else in_ch
        self.in_conv = BasicBlock(n, in_conv_ch, hid_chs[0], kernel_sizes[0], strides[0])

        skip_chs = [hid_chs[0]]
        in_blocks = []
        for i in range(1, depth):
            for k in range(nrb):
                in_blocks.append(nn.ModuleList([
                    conv_block(skip_chs[-1], hid_chs[i], kernel_sizes[i]),
                    attention(hid_chs[i], attn[i])]))
                skip_chs.append(hid_chs[i])
            if i < depth - 1:
                in_blocks.append(BasicDown(n, hid_chs[i], hid_chs[i], kernel_sizes[i],
                                           strides[i], learnable_interpolation))
                skip_chs.append(hid_chs[i])
        self.in_blocks = nn.ModuleList(in_blocks)

        self.middle_block = nn.ModuleList([
            conv_block(hid_chs[-1], hid_chs[-1], kernel_sizes[-1]),
            attention(hid_chs[-1], attn[-1]),
            conv_block(hid_chs[-1], hid_chs[-1], kernel_sizes[-1]),
        ])

        ds = deep_supervision
        if isinstance(ds, bool):
            ds = depth - 2 if ds else 0
        # Walk the decoder in execution order to size each concat input.
        n_out = (depth - 1) * (nrb + 1)
        out_specs, ver_in = {}, {}
        h_ch = hid_chs[-1]
        for idx in range(n_out, 0, -1):
            level, k = (idx - 1) // (nrb + 1) + 1, (idx - 1) % (nrb + 1)
            cin = h_ch + skip_chs.pop()
            d, j = idx // (nrb + 1), idx % (nrb + 1) - 1
            if ds >= d > 0 and j == 0:
                ver_in[d] = cin
            co = hid_chs[level - 1 if k == 0 else level]
            out_specs[idx - 1] = (level, k, cin, co)
            h_ch = co
        out_blocks = []
        for idx in range(n_out):
            level, k, cin, co = out_specs[idx]
            stage = [conv_block(cin, co, kernel_sizes[level]),
                     attention(co, attn[level])]
            if level > 1 and k == 0:
                stage.append(BasicUp(n, co, co, strides[level], strides[level],
                                     learnable_interpolation))
            out_blocks.append(nn.ModuleList(stage))
        self.out_blocks = nn.ModuleList(out_blocks)

        out_ch_hor = out_ch * 2 if estimate_variance else out_ch
        self.outc = UnetOutBlock(hid_chs[0], out_ch_hor, n)
        self.outc_ver = nn.ModuleList([
            UnetOutBlock(ver_in[d], out_ch, n) for d in range(1, ds + 1)])

    def embed(self, t=None, condition=None, cond_mask=None):
        """Summed time + label embedding; ``cond_mask`` zeroes the label part."""
        time_emb = (self.time_embedder(t)
                    if t is not None and self.use_time_embedder else None)
        cond_emb = None
        if condition is not None and self.cond_emb_num_classes is not None:
            cond_emb = self.cond_embedder(condition)
            if cond_mask is not None:
                cond_emb = cond_emb * cond_mask.to(cond_emb.dtype)[:, None]
        return save_add(time_emb, cond_emb)

    def _conv(self, block, h, emb):
        if self.remat and torch.is_grad_enabled():
            return checkpointed(block, h, emb)
        return block(h, emb)

    def encode_features(self, x_t, emb, self_cond=None):
        """In conv and encoder: the skip stack, as a tuple."""
        if self.use_self_conditioning:
            sc = torch.zeros_like(x_t) if self_cond is None else self_cond
            x_t = torch.cat([x_t, sc], dim=1)
        x = [self.in_conv(x_t)]
        for blk in self.in_blocks:
            if isinstance(blk, BasicDown):
                x.append(blk(x[-1]))
            else:
                x.append(blk[1](self._conv(blk[0], x[-1], emb), emb))
        return tuple(x)

    def decode_features(self, skips, emb):
        """Middle and decoder on the skip stack: (y, deep-supervision heads)."""
        x = list(skips)
        h = self._conv(self.middle_block[0], x[-1], emb)
        h = self.middle_block[1](h, emb)
        h = self._conv(self.middle_block[2], h, emb)

        y_ver = []
        nrb1 = self.num_res_blocks + 1
        for i in range(len(self.out_blocks), 0, -1):
            h = torch.cat([h, x.pop()], dim=1)
            d, j = i // nrb1, i % nrb1 - 1
            if (len(self.outc_ver) >= d > 0) and (j == 0):
                y_ver.append(self.outc_ver[d - 1](h))
            stage = self.out_blocks[i - 1]
            h = stage[1](self._conv(stage[0], h, emb), emb)
            if len(stage) > 2:
                h = stage[2](h)
        return self.outc(h), y_ver[::-1]

    def forward(self, x_t, t=None, condition=None, cond_mask=None, self_cond=None):
        """(y, deep-supervision outputs). ``self_cond`` comes after
        ``cond_mask`` here, where the JAX UNet takes it before: callers that
        pass ``(x_t, t, condition, cond_mask)`` keep working."""
        emb = self.embed(t, condition, cond_mask)
        if emb is not None:
            emb = emb.to(x_t.dtype)  # keep the activations in the compute dtype
        return self.decode_features(self.encode_features(x_t, emb, self_cond), emb)
