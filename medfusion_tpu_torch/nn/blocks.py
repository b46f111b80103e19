"""Conv/norm/act building blocks, NCHW (port of ``medfusion_tpu/nn/blocks.py``).

Submodule names follow the reference's torch modules, which are the keys that
``medfusion_tpu.utils.torch_compat.to_torch_state_dict`` emits, so a JAX
checkpoint loads here with ``strict=True`` (see ``utils/weights.py``).

GROUP norm always runs through :func:`medfusion_tpu_torch.ops.group_norm.
group_norm_silu` (the CUDA kernel on the card), and a BasicBlock whose
epilogue is exactly GroupNorm -> SiLU folds the SiLU into the same call, as
the JAX package's BasicBlock does with its fused-GroupNorm switch on.
Dropout, the space-to-depth tail and the fused 2x up-conv are not ported:
the last two are exact rewrites of the plain conv used here.
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
    """GROUP norm with torch eps, through the GroupNorm(+SiLU) kernel wrapper.
    ``fuse_silu`` applies the SiLU in the same call. Params ``weight`` and
    ``bias`` (the reference's ``nn.GroupNorm`` names)."""

    def __init__(self, norm_name: NormName, channels: int, fuse_silu: bool = False):
        super().__init__()
        kind, kw = _parse(norm_name)
        if kind != "group":
            raise NotImplementedError(
                f"norm {norm_name!r}: only GROUP is ported")
        self.num_groups = kw.get("num_groups", 32)
        self.eps = kw.get("eps", 1e-5)
        self.fuse_silu = fuse_silu
        if channels % self.num_groups:
            raise ValueError(
                f"channels {channels} not divisible by num_groups={self.num_groups}")
        if not kw.get("affine", True):
            raise NotImplementedError("GROUP norm without affine is not ported")
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps, apply_silu=self.fuse_silu)


def conv_nd(in_channels: int, out_channels: int, kernel_size=3, stride=1,
            zero_init: bool = False, spatial_dims: int = 2) -> nn.Conv2d:
    """``nn.Conv2d`` with MONAI padding (k - s + 1) // 2 and torch init."""
    if spatial_dims != 2:
        raise NotImplementedError("only 2D convs are ported")
    k = FN.ensure_tuple(kernel_size, 2)
    s = FN.ensure_tuple(stride, 2)
    conv = nn.Conv2d(in_channels, out_channels, k, s, FN.get_padding(k, s, 2))
    if zero_init:
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
    return conv


class BasicBlock(nn.Module):
    """Conv -> Norm -> Act (norm-after-conv, as the reference)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, norm_name: NormName = None,
                 act_name: ActName = None, zero_conv: bool = False):
        super().__init__()
        self.conv = conv_nd(in_channels, out_channels, kernel_size, stride,
                            zero_conv, spatial_dims)
        norm_kind, _ = _parse(norm_name)
        act_kind, _ = _parse(act_name)
        fuse = norm_kind == "group" and act_kind in ("swish", "silu")
        if norm_name is not None:
            self.norm = Norm(norm_name, out_channels, fuse_silu=fuse)
        self.act = None if fuse else make_act(act_name)

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "norm"):
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class BasicResBlock(nn.Module):
    """BasicBlock + 1x1-conv skip (identity when in == out channels)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, norm_name: NormName = None,
                 act_name: ActName = None, zero_conv: bool = False):
        super().__init__()
        self.basic_block = BasicBlock(spatial_dims, in_channels, out_channels,
                                      kernel_size, stride, norm_name, act_name,
                                      zero_conv)
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
                 blocks: int = 2):
        super().__init__()
        self.block_seq = nn.ModuleList([
            self.Block(spatial_dims, in_channels if i == 0 else out_channels,
                       out_channels, kernel_size, stride, norm_name, act_name,
                       zero_conv=(i == blocks - 1))
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


class BasicDown(nn.Module):
    """Strided conv (learnable downsample)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=2):
        super().__init__()
        self.down_op = conv_nd(in_channels, out_channels, kernel_size, stride,
                               spatial_dims=spatial_dims)

    def forward(self, x, emb=None):
        return self.down_op(x)


class BasicUp(nn.Module):
    """Nearest-exact resize to the transposed-conv output shape, then 3x3 conv."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=2, stride=2):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.up_op = conv_nd(in_channels, out_channels, 3, 1,
                             spatial_dims=spatial_dims)

    def forward(self, x, emb=None):
        size = FN.up_output_shape(x.shape[2:], self.kernel_size, self.stride)
        return self.up_op(FN.interpolate_nearest_exact(x, size))


def _conv_block(use_res_block: bool):
    return UnetResBlock if use_res_block else UnetBasicBlock


class DownBlock(nn.Module):
    """Down -> ConvBlock (attention 'none')."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size, stride, downsample_kernel_size, norm_name: NormName,
                 act_name: ActName, use_res_block: bool = False,
                 use_attention: str = "none", emb_channels: Optional[int] = None):
        super().__init__()
        _no_attention(use_attention)
        n = spatial_dims
        self.enable_down = FN.ensure_tuple(stride, n) != FN.ensure_tuple(1, n)
        if self.enable_down:
            self.down_op = BasicDown(n, in_channels, out_channels,
                                     downsample_kernel_size, stride)
        ch = out_channels if self.enable_down else in_channels
        self.conv_block = _conv_block(use_res_block)(
            n, ch, out_channels, kernel_size, 1, norm_name, act_name,
            emb_channels=emb_channels)

    def forward(self, x, emb=None):
        if self.enable_down:
            x = self.down_op(x)
        return self.conv_block(x, emb)


class UpBlock(nn.Module):
    """Up -> additive skip -> ConvBlock (attention 'none')."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size, stride, upsample_kernel_size, norm_name: NormName,
                 act_name: ActName, use_res_block: bool = False,
                 use_attention: str = "none", emb_channels: Optional[int] = None):
        super().__init__()
        _no_attention(use_attention)
        n = spatial_dims
        self.enable_up = FN.ensure_tuple(stride, n) != FN.ensure_tuple(1, n)
        if self.enable_up:
            self.up_op = BasicUp(n, in_channels, out_channels,
                                 upsample_kernel_size, stride)
        ch = out_channels if self.enable_up else in_channels
        self.conv_block = _conv_block(use_res_block)(
            n, ch, out_channels, kernel_size, 1, norm_name, act_name,
            emb_channels=emb_channels)

    def forward(self, x_enc, x_skip=None, emb=None):
        x = self.up_op(x_enc) if self.enable_up else x_enc
        if x_skip is not None:
            x = x + x_skip
        return self.conv_block(x, emb)


def _no_attention(use_attention):
    if use_attention != "none":
        raise NotImplementedError(
            f"use_attention={use_attention!r}: the attention modules come with "
            f"the port's second slice; only 'none' is ported")
