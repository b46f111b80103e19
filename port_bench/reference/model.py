"""The plain reference of the latent diffusion model: the label- and
time-conditioned UNet (with or without a SpatialTransformer at every level)
and the KL autoencoder, NCHW, float32.

A frozen copy of the port's plain path, cut to the options the benchmark's
configurations use (res blocks, GroupNorm + SiLU, learnable interpolation,
no dropout, no deep supervision on the UNet), with every kernel replaced by
its plain mathematics: GroupNorm by its two-pass formula, attention by
softmax((q s)(k s)^T) v, the GEGLU MLP by LayerNorm, a Linear, h * gelu(g)
and a Linear. Parameter names are the port's, so one state dict loads into
both with ``strict=True``. Every product goes through the module's
``Precision`` (``precision.py``); :func:`set_precision` switches a model to
the control's float8 operands.

``probe`` collects the shapes that the GroupNorm, attention and GEGLU calls
present, for the work counts (``count/``)."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.precision import F32, Precision


class Probe:
    """Where set on a model (:func:`set_probe`), each kernel-shaped call
    appends (kind, shape dict)."""

    def __init__(self):
        self.calls: List = []


class _Op(nn.Module):
    prec: Precision = F32
    probe: Optional[Probe] = None

    def record(self, kind: str, **shape):
        if self.probe is not None:
            self.probe.calls.append((kind, shape))


class Conv(nn.Conv2d, _Op):
    def forward(self, x):
        return self.prec.conv(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Linear, _Op):
    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Op):
            m.prec = prec
    return model


def set_probe(model: nn.Module, probe: Optional[Probe]) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Op):
            m.probe = probe
    return model


def conv(cin, cout, k=3, stride=1):
    return Conv(cin, cout, k, stride, (k - stride + 1) // 2)


class GroupNorm(_Op):
    """GroupNorm over [B, C, H, W] with torch's eps, SiLU after it where
    ``silu``."""

    def __init__(self, channels: int, groups: int, silu: bool = False):
        super().__init__()
        self.groups, self.silu = groups, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        self.record("group_norm", numel=x.numel(), channels=x.shape[1])
        b = x.shape[0]
        xg = x.reshape(b, self.groups, -1)
        mean = xg.mean(dim=-1, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=-1, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y * torch.sigmoid(y) if self.silu else y


# ---- conv blocks ------------------------------------------------------------


class BasicBlock(nn.Module):
    """conv -> (GroupNorm + SiLU)."""

    def __init__(self, cin, cout, k=3, stride=1, groups: Optional[int] = None):
        super().__init__()
        self.conv = conv(cin, cout, k, stride)
        if groups is not None:
            self.norm = GroupNorm(cout, groups, silu=True)

    def forward(self, x):
        x = self.conv(x)
        return self.norm(x) if hasattr(self, "norm") else x


class BasicResBlock(nn.Module):
    def __init__(self, cin, cout, k, groups):
        super().__init__()
        self.basic_block = BasicBlock(cin, cout, k, 1, groups)
        self.conv_res = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        res = x if self.conv_res is None else self.conv_res(x)
        return self.basic_block(x) + res


class ResBlock(nn.Module):
    """Two BasicResBlocks; the embedding (SiLU -> Linear) added after the
    first."""

    def __init__(self, cin, cout, k, groups, emb_dim: Optional[int] = None):
        super().__init__()
        self.block_seq = nn.ModuleList([BasicResBlock(cin, cout, k, groups),
                                        BasicResBlock(cout, cout, k, groups)])
        if emb_dim is not None:
            self.local_embedder = nn.Sequential(nn.Identity(), Linear(emb_dim, cout))

    def forward(self, x, emb=None):
        x = self.block_seq[0](x)
        if emb is not None:
            x = x + self.local_embedder[1](F.silu(emb))[:, :, None, None]
        return self.block_seq[1](x)


# ---- attention ---------------------------------------------------------------


class CrossAttention(_Op):
    """GroupNorm -> q, k, v -> softmax((q s)(k s)^T) v over ``heads`` heads,
    s = (head width)^-1/4 -> out projection, plus the residual. Against the
    embedding [B, E], one token, every query gets that token's value."""

    def __init__(self, ch: int, heads: int, groups: int, emb_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.norm_x = GroupNorm(ch, groups)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(emb_dim or ch, ch)
        self.to_v = Linear(emb_dim or ch, ch)
        self.to_out = nn.Sequential(Linear(ch, ch))

    def forward(self, x, emb=None):
        b, c, h, w = x.shape
        if emb is not None:
            # one key: its softmax weight is 1, so every query gets its value
            return x + self.to_out(self.to_v(emb))[:, :, None, None]
        xt = self.norm_x(x).flatten(2).transpose(1, 2)
        d = c // self.heads
        split = lambda t: t.unflatten(2, (self.heads, d)).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.to_q(xt)), split(self.to_k(xt)), split(self.to_v(xt))
        s = d ** -0.25
        self.record("attention", b=b, heads=self.heads, n=q.shape[2], m=k.shape[2], d=d)
        p = torch.softmax(self.prec.matmul(q * s, (k * s).transpose(-1, -2)), dim=-1)
        o = self.prec.matmul(p, v).transpose(1, 2).flatten(2)
        return x + self.to_out(o).transpose(1, 2).reshape(b, c, h, w)


class GEGLU(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm = nn.LayerNorm(cin, eps=1e-5)
        self.proj = Linear(cin, cout * 2)


class TransformerBlock(_Op):
    def __init__(self, ch, heads, groups, emb_dim):
        super().__init__()
        self.self_atn = CrossAttention(ch, heads, groups)
        self.cros_atn = CrossAttention(ch, heads, groups, emb_dim)
        self.proj_out = nn.ModuleList([GEGLU(ch, ch * 4), nn.Identity(), Linear(ch * 4, ch)])

    def forward(self, x, emb):
        x = self.cros_atn(self.self_atn(x), emb)
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        geglu, _, down = self.proj_out
        self.record("geglu", rows=b * h * w, c=c, f=down.in_features)
        hg, gate = geglu.proj(geglu.norm(t)).chunk(2, dim=-1)
        out = down(hg * F.gelu(gate))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class SpatialTransformer(nn.Module):
    def __init__(self, ch, heads, groups, emb_dim):
        super().__init__()
        self.norm = GroupNorm(ch, groups)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads, groups, emb_dim)])
        self.proj_out = Linear(ch, ch)

    def forward(self, x, emb):
        b, c, h, w = x.shape
        hx = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        hx = hx.transpose(1, 2).reshape(b, c, h, w)
        hx = self.transformer_blocks[0](hx, emb)
        return x + self.proj_out(hx.flatten(2).transpose(1, 2)).transpose(1, 2).reshape(
            b, c, h, w)


class Attention(nn.Module):
    """'none' (the identity) or 'spatial'."""

    def __init__(self, ch, kind, heads, groups, emb_dim):
        super().__init__()
        self.attention = (SpatialTransformer(ch, heads, groups, emb_dim)
                          if kind == "spatial" else None)

    def forward(self, x, emb):
        return x if self.attention is None else self.attention(x, emb)


class Down(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.down_op = conv(cin, cout, k, stride)

    def forward(self, x):
        return self.down_op(x)


class Up(nn.Module):
    """Nearest-exact resize by ``stride``, then a 3x3 conv."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.up_op = conv(cin, cout, 3, 1)

    def forward(self, x):
        size = tuple(s * self.stride for s in x.shape[2:])
        return self.up_op(F.interpolate(x, size=size, mode="nearest-exact"))


# ---- the UNet ------------------------------------------------------------------


class TimeEmbedding(nn.Module):
    """sin|cos features of t (``emb_dim // 4`` of them, float32) -> Linear
    -> SiLU -> Linear."""

    def __init__(self, emb_dim):
        super().__init__()
        self.pos_dim = emb_dim // 4
        self.time_emb = nn.Sequential(nn.Identity(), Linear(self.pos_dim, emb_dim),
                                      nn.SiLU(), Linear(emb_dim, emb_dim))

    def forward(self, t):
        half = self.pos_dim // 2
        freqs = torch.exp(-math.log(10000) / (half - 1)
                          * torch.arange(half, dtype=torch.float32, device=t.device))
        e = t.float()[:, None] * freqs[None]
        return self.time_emb[1:](torch.cat([torch.sin(e), torch.cos(e)], dim=-1))


class LabelEmbedder(nn.Module):
    def __init__(self, emb_dim, num_classes):
        super().__init__()
        self.embedding = nn.Embedding(num_classes, emb_dim)


class OutBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv", conv(cin, cout, 1))

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """The estimator: in conv; per level above the first, two (res block,
    attention) stages and a strided conv between levels; the middle (res
    block, attention, res block); the decoder's three stages a level, each
    taking one skip by concatenation, with an up block after the first
    stage of each level above the first; a 1x1 out conv. Returns eps."""

    def __init__(self, in_ch, hid_chs: Sequence[int], num_classes: int, attention: str,
                 heads: int, groups: int, strides=(1, 2, 2, 2)):
        super().__init__()
        depth = len(hid_chs)
        e = hid_chs[-1]
        attn = lambda ch, i: Attention(ch, attention if i > 0 else "none",  # noqa: E731
                                       heads, groups, e)
        block = lambda cin, cout: ResBlock(cin, cout, 3, groups, e)  # noqa: E731
        self.time_embedder = TimeEmbedding(e)
        self.cond_embedder = LabelEmbedder(e, num_classes)
        self.in_conv = BasicBlock(in_ch, hid_chs[0], 3, strides[0])
        skips, blocks = [hid_chs[0]], []
        for i in range(1, depth):
            for _ in range(2):
                blocks.append(nn.ModuleList([block(skips[-1], hid_chs[i]),
                                             attn(hid_chs[i], i)]))
                skips.append(hid_chs[i])
            if i < depth - 1:
                blocks.append(Down(hid_chs[i], hid_chs[i], 3, strides[i]))
                skips.append(hid_chs[i])
        self.in_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([block(e, e), attn(e, depth - 1), block(e, e)])
        outs, h = [], e
        for level in range(depth - 1, 0, -1):
            for k in (2, 1, 0):
                co = hid_chs[level - 1 if k == 0 else level]
                stage = [block(h + skips.pop(), co), attn(co, level)]
                if level > 1 and k == 0:
                    stage.append(Up(co, co, strides[level]))
                outs.append(nn.ModuleList(stage))
                h = co
        self.out_blocks = nn.ModuleList(outs[::-1])
        self.outc = OutBlock(hid_chs[0], in_ch)

    def forward(self, x, t, condition, cond_mask):
        emb = self.time_embedder(t) + (self.cond_embedder.embedding(condition)
                                       * cond_mask.to(torch.float32)[:, None])
        hs = [self.in_conv(x)]
        for blk in self.in_blocks:
            hs.append(blk(hs[-1]) if isinstance(blk, Down) else blk[1](blk[0](hs[-1], emb), emb))
        h = self.middle_block[0](hs[-1], emb)
        h = self.middle_block[2](self.middle_block[1](h, emb), emb)
        for stage in reversed(self.out_blocks):
            h = stage[1](stage[0](torch.cat([h, hs.pop()], dim=1), emb), emb)
            if len(stage) > 2:
                h = stage[2](h)
        return self.outc(h)


# ---- the autoencoder ---------------------------------------------------------------


class DownBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.down_op = Down(cin, cout, 3, 2)
        self.conv_block = ResBlock(cout, cout, 3, groups)

    def forward(self, x):
        return self.conv_block(self.down_op(x))


class UpBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.up_op = Up(cin, cout, 2)
        self.conv_block = ResBlock(cout, cout, 3, groups)

    def forward(self, x):
        return self.conv_block(self.up_op(x))


class VAE(nn.Module):
    """Encoder: in res block, a down block a level, the out encoder to
    (mean, logvar); decoder: in res block, an up block a level, a 1x1 out
    conv. ``deep_supervision`` heads are held for the state dict and not
    used by encode or decode."""

    def __init__(self, in_ch, emb_ch, hid_chs: Sequence[int], groups: int,
                 deep_supervision: int):
        super().__init__()
        n = len(hid_chs)
        self.inc = ResBlock(in_ch, hid_chs[0], 3, groups)
        self.encoders = nn.ModuleList([DownBlock(hid_chs[i - 1], hid_chs[i], groups)
                                       for i in range(1, n)])
        self.out_enc = nn.Sequential(BasicBlock(hid_chs[-1], 2 * emb_ch, 3),
                                     BasicBlock(2 * emb_ch, 2 * emb_ch, 1))
        self.inc_dec = ResBlock(emb_ch, hid_chs[-1], 3, groups)
        self.decoders = nn.ModuleList([UpBlock(hid_chs[i + 1], hid_chs[i], groups)
                                       for i in range(n - 1)])
        self.outc = BasicBlock(hid_chs[0], in_ch, 1)
        self.outc_ver = nn.ModuleList([BasicBlock(hid_chs[i], in_ch, 1)
                                       for i in range(1, deep_supervision + 1)])

    def encode(self, x, noise):
        """The posterior's sample mean + exp(logvar / 2) * noise, logvar
        clamped to [-30, 20]."""
        h = self.inc(x)
        for enc in self.encoders:
            h = enc(h)
        mean, logvar = self.out_enc(h).chunk(2, dim=1)
        return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise

    def decode(self, z):
        h = self.inc_dec(z)
        for dec in reversed(self.decoders):
            h = dec(h)
        return self.outc(h)


def build(cfg: dict, which: str) -> nn.Module:
    """The configuration's 'unet' or 'vae' (float32, torch's own init: the
    benchmark loads its seeded state dict over it)."""
    if which == "unet":
        u = cfg["unet"]
        return UNet(cfg["latent_channels"], u["hid_chs"], cfg["num_classes"], u["attention"],
                    u["attn_heads"], u["norm_groups"], tuple(u["strides"]))
    v = cfg["vae"]
    return VAE(cfg["image_channels"], cfg["latent_channels"], v["hid_chs"], v["norm_groups"],
               v["deep_supervision"])
