"""The legacy MONAI-flavoured UNet noise estimator, NCHW
(port of ``medfusion_tpu/models/unet_legacy.py``).

One DownBlock/UpBlock per level (the ``unet`` family has ``num_res_blocks``
stages a level): ``inc`` is a conv block with the embedding, each encoder a
strided conv -> attention -> conv block, each decoder an up-conv -> additive
skip -> attention -> conv block (with ``learnable_interpolation`` off: an
average pool, and a resize whose output the skip is concatenated to, so
the decoders' attention and first convs are wider), then a 1x1 ``outc`` and the
deep-supervision heads ``outc_ver`` on the decoder outputs. Every GroupNorm
of the blocks runs through the GroupNorm(+SiLU) kernel wrapper
(``nn/blocks.py``); ``use_attention`` ('none' | 'linear' | 'spatial', one
for all levels or one per level) adds the blocks' attention. The estimator
contract is the ``unet`` family's: ``forward(x_t, t, condition, cond_mask,
self_cond) -> (y, y_ver)``, with a per-sample ``cond_mask`` zeroing the
label embedding, and self-conditioning on ``[x_t | self_cond]``.

The submodules carry the reference's torch keys (``inc.block_seq.*``,
``encoders.{i}.down_op.down_op``, ``decoders.{i}.up_op.up_op``,
``outc.conv``, ``outc_ver.{i}.conv``), the VAE's key rules
(``utils/weights.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from medfusion_tpu_torch.models.embedders import LabelEmbedder, TimeEmbedding
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.nn.blocks import (
    BasicBlock,
    DownBlock,
    UnetBasicBlock,
    UnetResBlock,
    UpBlock,
)
from medfusion_tpu_torch.nn.functional import save_add


class UNetLegacy(nn.Module):
    def __init__(self, in_ch: int = 1, out_ch: int = 1, spatial_dims: int = 2,
                 hid_chs: Sequence[int] = (32, 64, 128, 256),
                 kernel_sizes: Sequence[int] = (1, 3, 3, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 act_name=("SWISH", {}),
                 norm_name=("GROUP", {"num_groups": 32, "affine": True}),
                 time_emb_dim: Optional[int] = None, use_time_embedder: bool = True,
                 cond_emb_num_classes: Optional[int] = None, deep_supervision=True,
                 use_res_block: bool = True, estimate_variance: bool = False,
                 use_self_conditioning: bool = False, dropout: float = 0.0,
                 use_attention="none", learnable_interpolation: bool = True):
        super().__init__()
        depth = len(strides)
        attn = (list(use_attention) if isinstance(use_attention, (list, tuple))
                else [use_attention] * depth)
        if len(attn) != depth or any(a not in ATTENTION_TYPES for a in attn):
            raise ValueError(f"use_attention={use_attention!r}: expected one of "
                             f"{ATTENTION_TYPES} or a list of {depth} of them")
        self.depth = depth
        self.use_time_embedder = use_time_embedder
        self.cond_emb_num_classes = cond_emb_num_classes
        self.use_self_conditioning = use_self_conditioning
        t_dim = time_emb_dim or hid_chs[0] * 4
        # the blocks take an embedding when there is one to give (the time's,
        # the label's or their sum), as the JAX package's lazily sized layers
        emb_dim = t_dim if use_time_embedder or cond_emb_num_classes is not None else None
        dropout = dropout if dropout else None
        ConvBlock = UnetResBlock if use_res_block else UnetBasicBlock
        n = spatial_dims

        if use_time_embedder:
            self.time_embedder = TimeEmbedding(emb_dim=t_dim)
        if cond_emb_num_classes is not None:
            self.cond_embedder = LabelEmbedder(emb_dim=t_dim, num_classes=cond_emb_num_classes)

        in_conv_ch = 2 * in_ch if use_self_conditioning else in_ch
        # the JAX package gives ``inc`` no dropout
        self.inc = ConvBlock(n, in_conv_ch, hid_chs[0], kernel_sizes[0], strides[0],
                             norm_name, act_name, emb_channels=emb_dim)
        self.encoders = nn.ModuleList([
            DownBlock(n, hid_chs[i - 1], hid_chs[i], kernel_sizes[i], strides[i],
                      kernel_sizes[i], norm_name, act_name, use_res_block, attn[i],
                      emb_dim, dropout, learnable_interpolation)
            for i in range(1, depth)])
        self.decoders = nn.ModuleList([
            UpBlock(n, hid_chs[i + 1], hid_chs[i], kernel_sizes[i + 1], strides[i + 1],
                    strides[i + 1], norm_name, act_name, use_res_block, attn[i], emb_dim,
                    dropout, learnable_interpolation, skip_channels=hid_chs[i])
            for i in range(depth - 1)])
        out_ch_hor = out_ch * 2 if estimate_variance else out_ch
        self.outc = BasicBlock(n, hid_chs[0], out_ch_hor, 1)
        ds = deep_supervision
        if isinstance(ds, bool):
            ds = depth - 1 if ds else 0
        self.outc_ver = nn.ModuleList([BasicBlock(n, hid_chs[i], out_ch, 1)
                                       for i in range(1, ds + 1)])

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

    def forward(self, x_t, t=None, condition=None, cond_mask=None, self_cond=None):
        """(y, deep-supervision outputs, highest resolution first)."""
        emb = self.embed(t, condition, cond_mask)
        if emb is not None:
            emb = emb.to(x_t.dtype)  # keep the activations in the compute dtype
        if self.use_self_conditioning:
            sc = torch.zeros_like(x_t) if self_cond is None else self_cond
            x_t = torch.cat([x_t, sc], dim=1)
        x = [self.inc(x_t, emb)]
        for enc in self.encoders:
            x.append(enc(x[-1], emb))
        for i in range(len(self.decoders), 0, -1):
            x[i - 1] = self.decoders[i - 1](x[i], x[i - 1], emb)
        return self.outc(x[0]), [head(x[i + 1]) for i, head in enumerate(self.outc_ver)]
