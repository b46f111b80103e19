"""Conv/norm/act building blocks, NCHW or NCDHW (port of
``medfusion_tpu/nn/blocks.py``): every block takes ``spatial_dims`` 2 or 3,
as the JAX package's do (``nn.Conv2d``/``nn.Conv3d``,
``nn.BatchNorm2d``/``nn.BatchNorm3d``; the norms, attention and resizes act
on any number of spatial dims).

Submodule names follow the reference's torch modules, which are the keys that
``medfusion_tpu.utils.torch_compat.to_torch_state_dict`` emits, so a JAX
checkpoint loads here with ``strict=True`` (see ``utils/weights.py``).

GROUP norm, with or without its affine parameters, always runs through
:func:`medfusion_tpu_torch.ops.group_norm.group_norm_silu` (the CUDA kernel
on the card), and a BasicBlock whose epilogue is exactly GroupNorm -> SiLU,
with no dropout between, folds the SiLU into the same call, as the JAX
package's BasicBlock does with its fused-GroupNorm switch on. BATCH norm
(the PatchGAN discriminator's) is an ``nn.BatchNorm{2,3}d``; LAYER is a
LayerNorm over the channels and INSTANCE a GroupNorm of one channel a
group (affine off by default), both plain, as the JAX package leaves them
to flax. Dropout (``nn.Dropout``, the global RNG, which
``torch.utils.checkpoint`` replays in a recompute) sits between a
BasicBlock's norm and its activation. The down and up blocks take attention
('linear' or 'spatial', 8 heads of ch/8, depth 1) before their conv block,
as the JAX package's do. With ``learnable_interpolation`` off, the down is
an average pool, the up a resize alone and the up block concatenates its
skip. The space-to-depth tail and the fused 2x up-conv are not ported:
they are exact rewrites of the plain conv used here.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.nn import functional as FN
from medfusion_tpu_torch.ops.group_norm import group_norm_silu

NormName = Union[str, Tuple[str, dict], None]
ActName = Union[str, Tuple[str, dict], None]


def _parse(name):
    if name is None:
        return None, {}
    if isinstance(name, str):
        return name.lower(), {}
    return name[0].lower(), dict(name[1])


def make_act(act_name: ActName):
    """MONAI get_act_layer equivalent, as a function."""
    kind, kw = _parse(act_name)
    if kind is None:
        return None
    if kind in ("swish", "silu"):
        return F.silu
    if kind == "relu":
        return F.relu
    if kind == "leakyrelu":
        slope = kw.get("negative_slope", 0.01)
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if kind == "gelu":
        return F.gelu
    if kind == "tanh":
        return torch.tanh
    raise NotImplementedError(f"activation {act_name!r}")


class Norm(nn.Module):
    """GROUP, LAYER or INSTANCE norm of NCHW ``x`` with torch eps. GROUP
    runs through the GroupNorm(+SiLU) kernel wrapper (``fuse_silu`` applies
    the SiLU in the same call; without ``affine`` the scale is one and the
    bias zero); LAYER normalises each position over its channels, INSTANCE
    each channel over its positions (``affine`` False by default). The
    affine params are ``weight`` and ``bias`` (the reference's names)."""

    def __init__(self, norm_name: NormName, channels: int, fuse_silu: bool = False):
        super().__init__()
        kind, kw = _parse(norm_name)
        if kind not in ("group", "layer", "instance"):
            raise NotImplementedError(f"norm {norm_name!r}")
        self.kind = kind
        self.eps = kw.get("eps", 1e-5)
        self.fuse_silu = fuse_silu
        self.num_groups = {"group": kw.get("num_groups", 32), "layer": 1,
                           "instance": channels}[kind]
        if channels % self.num_groups:
            raise ValueError(
                f"channels {channels} not divisible by num_groups={self.num_groups}")
        if kw.get("affine", kind != "instance"):
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        if self.kind == "layer":
            return F.layer_norm(x.movedim(1, -1), x.shape[1:2], self.weight, self.bias,
                                self.eps).movedim(-1, 1)
        if self.kind == "instance":
            return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        weight, bias = self.weight, self.bias
        if weight is None:
            weight = torch.ones(x.shape[1], dtype=x.dtype, device=x.device)
            bias = torch.zeros_like(weight)
        return group_norm_silu(x, weight, bias, self.num_groups, self.eps,
                               apply_silu=self.fuse_silu)


def make_norm(norm_name: NormName, channels: int, fuse_silu: bool = False,
              spatial_dims: int = 2) -> nn.Module:
    """:class:`Norm` for GROUP, LAYER and INSTANCE; ``nn.BatchNorm2d`` (or
    ``3d``) for BATCH, with flax's momentum 0.9 as torch's 0.1. BatchNorm normalises by
    the batch's statistics in train mode, in which the adversarial trainer
    always runs the discriminators (as Lightning does); torch updates
    ``running_var`` with the unbiased batch variance, flax with the biased
    one."""
    kind, kw = _parse(norm_name)
    if kind == "batch":
        cls = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[spatial_dims]
        return cls(channels, eps=kw.get("eps", 1e-5), momentum=0.1)
    return Norm(norm_name, channels, fuse_silu=fuse_silu)


def make_dropout(dropout: Optional[float]) -> Optional[nn.Module]:
    """``nn.Dropout(dropout)``, or None for None (the JAX package's
    Dropout is skipped only for None; a rate of 0 is the identity)."""
    return None if dropout is None else nn.Dropout(float(dropout))


def conv_nd(in_channels: int, out_channels: int, kernel_size=3, stride=1,
            zero_init: bool = False, spatial_dims: int = 2) -> nn.Module:
    """``nn.Conv2d`` (``nn.Conv3d`` at ``spatial_dims=3``) with MONAI padding
    (k - s + 1) // 2 and torch init."""
    cls = {2: nn.Conv2d, 3: nn.Conv3d}.get(spatial_dims)
    if cls is None:
        raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
    n = spatial_dims
    k = FN.ensure_tuple(kernel_size, n)
    s = FN.ensure_tuple(stride, n)
    conv = cls(in_channels, out_channels, k, s, FN.get_padding(k, s, n))
    if zero_init:
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
    return conv


class BasicBlock(nn.Module):
    """Conv -> Norm -> Dropout -> Act (norm-after-conv, as the reference).
    With dropout the SiLU is not fused into the GroupNorm, as in the JAX
    package."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, norm_name: NormName = None,
                 act_name: ActName = None, zero_conv: bool = False,
                 dropout: Optional[float] = None):
        super().__init__()
        self.conv = conv_nd(in_channels, out_channels, kernel_size, stride,
                            zero_conv, spatial_dims)
        norm_kind, _ = _parse(norm_name)
        act_kind, _ = _parse(act_name)
        fuse = norm_kind == "group" and act_kind in ("swish", "silu") and dropout is None
        if norm_name is not None:
            self.norm = make_norm(norm_name, out_channels, fuse_silu=fuse,
                                  spatial_dims=spatial_dims)
        self.drop = make_dropout(dropout)
        self.act = None if fuse else make_act(act_name)

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "norm"):
            x = self.norm(x)
        if self.drop is not None:
            x = self.drop(x)
        if self.act is not None:
            x = self.act(x)
        return x


class BasicResBlock(nn.Module):
    """BasicBlock + 1x1-conv skip (identity when in == out channels)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, norm_name: NormName = None,
                 act_name: ActName = None, zero_conv: bool = False,
                 dropout: Optional[float] = None):
        super().__init__()
        self.basic_block = BasicBlock(spatial_dims, in_channels, out_channels,
                                      kernel_size, stride, norm_name, act_name,
                                      zero_conv, dropout)
        self.conv_res = (conv_nd(in_channels, out_channels, 1, stride,
                                 spatial_dims=spatial_dims)
                         if in_channels != out_channels else None)

    def forward(self, x):
        res = x if self.conv_res is None else self.conv_res(x)
        return self.basic_block(x) + res


class _UnetBlockBase(nn.Module):
    Block = BasicBlock

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, norm_name: NormName = None,
                 act_name: ActName = None, emb_channels: Optional[int] = None,
                 blocks: int = 2, dropout: Optional[float] = None):
        super().__init__()
        self.block_seq = nn.ModuleList([
            self.Block(spatial_dims, in_channels if i == 0 else out_channels,
                       out_channels, kernel_size, stride, norm_name, act_name,
                       zero_conv=(i == blocks - 1), dropout=dropout)
            for i in range(blocks)
        ])
        self.emb_act = make_act(act_name)
        if emb_channels is not None:
            # index 0 is the reference's activation slot (applied in _embed)
            self.local_embedder = nn.Sequential(
                nn.Identity(), nn.Linear(emb_channels, out_channels))

    def _embed(self, emb, x):
        """Act -> Linear -> broadcast over the spatial dims."""
        e = self.emb_act(emb) if self.emb_act is not None else emb
        e = self.local_embedder[1](e)
        return e.reshape(*e.shape, *([1] * (x.ndim - 2)))


class UnetBasicBlock(_UnetBlockBase):
    """Two BasicBlocks, the last zero-init; emb added after each."""

    def forward(self, x, emb=None):
        e = self._embed(emb, x) if emb is not None else None
        for blk in self.block_seq:
            x = blk(x)
            if e is not None:
                x = x + e
        return x


class UnetResBlock(_UnetBlockBase):
    """Two BasicResBlocks, the last zero-init; emb added after all but the last."""

    Block = BasicResBlock

    def forward(self, x, emb=None):
        e = self._embed(emb, x) if emb is not None else None
        n = len(self.block_seq)
        for i, blk in enumerate(self.block_seq):
            x = blk(x)
            if e is not None and i < n - 1:
                x = x + e
        return x


def pixel_unshuffle(x, r: int = 2):
    """[B, C, H r, W r] -> [B, C r r, H, W], channel order (c r1 r2)."""
    return F.pixel_unshuffle(x, r)


def pixel_shuffle(x, r: int = 2):
    """[B, C r r, H, W] -> [B, C, H r, W r], the inverse of
    :func:`pixel_unshuffle`."""
    return F.pixel_shuffle(x, r)


class BasicDown(nn.Module):
    """Strided conv, or with ``learnable_interpolation`` off an average pool
    with MONAI padding and no parameters. ``use_res`` adds the input's 2x
    pixel-unshuffle to the conv (2-D; out = 4 x in channels)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=2, learnable_interpolation: bool = True,
                 use_res: bool = False):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.use_res = use_res
        if learnable_interpolation:
            self.down_op = conv_nd(in_channels, out_channels, kernel_size, stride,
                                   spatial_dims=spatial_dims)

    def forward(self, x, emb=None):
        if not hasattr(self, "down_op"):
            return FN.avg_pool_same(x, self.kernel_size, self.stride)
        y = self.down_op(x)
        return y + pixel_unshuffle(x) if self.use_res else y


class BasicUp(nn.Module):
    """Nearest-exact resize to the transposed-conv output shape, then 3x3
    conv; with ``learnable_interpolation`` off the resize alone. ``use_res``
    adds the input's 2x pixel-shuffle to the conv (2-D; out = in / 4
    channels)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=2, stride=2, learnable_interpolation: bool = True,
                 use_res: bool = False):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.use_res = use_res
        if learnable_interpolation:
            self.up_op = conv_nd(in_channels, out_channels, 3, 1,
                                 spatial_dims=spatial_dims)

    def forward(self, x, emb=None):
        size = FN.up_output_shape(x.shape[2:], self.kernel_size, self.stride)
        y = FN.interpolate_nearest_exact(x, size)
        if not hasattr(self, "up_op"):
            return y
        y = self.up_op(y)
        return y + pixel_shuffle(x) if self.use_res else y


def _conv_block(use_res_block: bool):
    return UnetResBlock if use_res_block else UnetBasicBlock


def _attention(spatial_dims: int, channels: int, norm_name: NormName,
               use_attention: str, emb_channels: Optional[int],
               dropout: Optional[float] = None):
    """The blocks' attention: 8 heads of ``channels // 8``, depth 1, the
    block's norm; ``None`` for 'none'."""
    from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES, Attention

    if use_attention not in ATTENTION_TYPES:
        raise ValueError(f"unknown attention type {use_attention!r}; "
                         f"expected one of {ATTENTION_TYPES}")
    if use_attention == "none":
        return None
    if channels < 8:
        raise ValueError(f"attention of 8 heads needs at least 8 channels, got {channels}")
    return Attention(spatial_dims, channels, num_heads=8, ch_per_head=channels // 8,
                     norm_name=norm_name, dropout=dropout, emb_dim=emb_channels,
                     depth=1, attention_type=use_attention)


class DownBlock(nn.Module):
    """Down -> Attention -> ConvBlock. Without ``learnable_interpolation``
    the down is an average pool, so attention and the conv block's input
    keep ``in_channels``."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size, stride, downsample_kernel_size, norm_name: NormName,
                 act_name: ActName, use_res_block: bool = False,
                 use_attention: str = "none", emb_channels: Optional[int] = None,
                 dropout: Optional[float] = None, learnable_interpolation: bool = True):
        super().__init__()
        n = spatial_dims
        self.enable_down = FN.ensure_tuple(stride, n) != FN.ensure_tuple(1, n)
        if self.enable_down:
            self.down_op = BasicDown(n, in_channels, out_channels,
                                     downsample_kernel_size, stride,
                                     learnable_interpolation)
        ch = out_channels if self.enable_down and learnable_interpolation else in_channels
        self.attention = _attention(n, ch, norm_name, use_attention, emb_channels,
                                    dropout)
        self.conv_block = _conv_block(use_res_block)(
            n, ch, out_channels, kernel_size, 1, norm_name, act_name,
            emb_channels=emb_channels, dropout=dropout)

    def forward(self, x, emb=None):
        if self.enable_down:
            x = self.down_op(x)
        if self.attention is not None:
            x = self.attention(x, emb)
        return self.conv_block(x, emb)


class UpBlock(nn.Module):
    """Up -> skip join -> Attention -> ConvBlock. The skip is added with
    ``learnable_interpolation``; without it the up is a resize alone and
    the skip of ``skip_channels`` is concatenated after it, so attention
    and the conv block take ``in_channels + skip_channels``."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size, stride, upsample_kernel_size, norm_name: NormName,
                 act_name: ActName, use_res_block: bool = False,
                 use_attention: str = "none", emb_channels: Optional[int] = None,
                 dropout: Optional[float] = None, learnable_interpolation: bool = True,
                 skip_channels: int = 0):
        super().__init__()
        n = spatial_dims
        self.learnable_interpolation = learnable_interpolation
        self.enable_up = FN.ensure_tuple(stride, n) != FN.ensure_tuple(1, n)
        if self.enable_up:
            self.up_op = BasicUp(n, in_channels, out_channels,
                                 upsample_kernel_size, stride, learnable_interpolation)
        ch = out_channels if self.enable_up and learnable_interpolation else in_channels
        if not learnable_interpolation:
            ch += skip_channels
        self.attention = _attention(n, ch, norm_name, use_attention, emb_channels,
                                    dropout)
        self.conv_block = _conv_block(use_res_block)(
            n, ch, out_channels, kernel_size, 1, norm_name, act_name,
            emb_channels=emb_channels, dropout=dropout)

    def forward(self, x_enc, x_skip=None, emb=None):
        x = self.up_op(x_enc) if self.enable_up else x_enc
        if x_skip is not None:
            x = x + x_skip if self.learnable_interpolation else torch.cat([x, x_skip], dim=1)
        if self.attention is not None:
            x = self.attention(x, emb)
        return self.conv_block(x, emb)
