"""The lucidrains compact DDPM UNet, NCHW
(port of ``medfusion_tpu/models/unet_lucidrains.py``).

Weight-standardised convs (:class:`WSConv`) and GroupNorm blocks with FiLM
time conditioning, linear attention at every level, cosine-similarity full
attention (scale 10) in the middle, the learned-sinusoidal time embedding
option, a learned-variance output and self-conditioning. The estimator
contract is the other families': ``forward(x_t, t, condition, cond_mask,
self_cond) -> (y, [])``; the model has no label conditioning, so
``condition`` and ``cond_mask`` are accepted and ignored, as in the JAX
package.

Quirks kept from the reference, as the JAX package keeps them: WSConv's
eps is 1e-5 for float32 activations and 1e-3 for any other dtype (the
statistics are taken over the weights in float32); ChanLayerNorm has a
scale ``g`` only and the biased variance; the cosine attention normalises
q and k over the token axis; self-conditioning concatenates ``self_cond``
first; the last down and up levels are 3x3 convs, not resamplers.

Everything is plain PyTorch: the JAX package runs none of it in Pallas.
The submodules carry the reference's torch keys (``downs.{i}.{j}``,
``time_mlp.{0,1,3}``, ``ups.{i}.3.1`` for an upsample's conv, ``g`` of
shape [1, C, 1, 1]).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.models.embedders import LearnedSinusoidalPosEmb, SinusoidalPosEmb


def _eps_for(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 1e-3


class WSConv(nn.Conv2d):
    """Conv2d whose weight is standardised per output channel, its mean and
    biased variance taken over the weight in float32."""

    def forward(self, x):
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (w - mean) * torch.rsqrt(var + _eps_for(x.dtype))
        return self._conv_forward(x, w.to(x.dtype), self.bias)


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channels with the biased variance and a scale
    ``g`` [1, C, 1, 1] only."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        var = x.var(dim=1, keepdim=True, unbiased=False)
        mean = x.mean(dim=1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + _eps_for(x.dtype)) * self.g


class LucidBlock(nn.Module):
    """WSConv -> GroupNorm -> FiLM (scale, shift) -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = WSConv(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class LucidResnetBlock(nn.Module):
    """Two blocks, the first FiLM-conditioned on the time embedding, and a
    1x1 residual conv where the width changes."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8):
        super().__init__()
        if time_emb_dim is not None:
            self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
        self.block1 = LucidBlock(dim, dim_out, groups)
        self.block2 = LucidBlock(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb=None):
        scale_shift = None
        if hasattr(self, "mlp") and time_emb is not None:
            scale_shift = self.mlp(time_emb)[:, :, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + self.res_conv(x)


def _heads(t, heads):
    """[B, (h d), H, W] -> [B, h, d, H*W]."""
    return t.unflatten(1, (heads, -1)).flatten(3)


class LucidLinearAttention(nn.Module):
    """Linear attention: softmax of q over the head width, of k over the
    tokens, then (k v^T) q."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.scale = heads, dim_head ** -0.5
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), ChanLayerNorm(dim))

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=1))
        q = q.softmax(dim=-2) * self.scale
        k = k.softmax(dim=-1)
        v = v / (h * w)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, -1, h, w))


class LucidAttention(nn.Module):
    """Cosine-similarity attention at a fixed scale; q and k are
    l2-normalised over the token axis."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, scale: float = 10.0):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.scale = heads, scale
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=1))
        q, k = F.normalize(q, dim=-1, eps=1e-12), F.normalize(k, dim=-1, eps=1e-12)
        attn = (torch.einsum("bhdi,bhdj->bhij", q, k) * self.scale).softmax(dim=-1)
        out = torch.einsum("bhij,bhdj->bhid", attn, v)  # [B, h, N, d]
        return self.to_out(out.transpose(2, 3).reshape(b, -1, h, w))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn, self.norm = fn, ChanLayerNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class _Upsample2x(nn.Module):
    def forward(self, x):
        return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def lucid_upsample(dim: int, dim_out: int) -> nn.Sequential:
    """Nearest 2x, then a 3x3 conv (index 1, the reference's key)."""
    return nn.Sequential(_Upsample2x(), nn.Conv2d(dim, dim_out, 3, padding=1))


class UNetLucidrains(nn.Module):
    def __init__(self, dim: int = 32, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 3, self_condition: bool = False,
                 resnet_block_groups: int = 8, learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False, learned_sinusoidal_dim: int = 16):
        super().__init__()
        self.self_condition = self_condition
        init_dim = init_dim or dim
        self.init_conv = nn.Conv2d(channels * (2 if self_condition else 1), init_dim, 7,
                                   padding=3)
        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim, g = dim * 4, resnet_block_groups
        if learned_sinusoidal_cond:
            # the reference asserts an even width; the shared embedder would pad
            # an odd one, where the JAX UNet's Dense takes the unpadded width
            if learned_sinusoidal_dim % 2:
                raise ValueError(f"learned_sinusoidal_dim must be even, got "
                                 f"{learned_sinusoidal_dim}")
            pos, fourier_dim = LearnedSinusoidalPosEmb(learned_sinusoidal_dim), \
                learned_sinusoidal_dim + 1
        else:
            pos, fourier_dim = SinusoidalPosEmb(dim), dim
        self.time_mlp = nn.Sequential(pos, nn.Linear(fourier_dim, time_dim), nn.GELU(),
                                      nn.Linear(time_dim, time_dim))

        def res(d_in, d_out):
            return LucidResnetBlock(d_in, d_out, time_dim, g)

        def linear_attention(d):
            return Residual(PreNorm(d, LucidLinearAttention(d)))

        self.downs = nn.ModuleList([
            nn.ModuleList([res(d_in, d_in), res(d_in, d_in), linear_attention(d_in),
                           nn.Conv2d(d_in, d_out, 3, padding=1) if i == len(in_out) - 1
                           else nn.Conv2d(d_in, d_out, 4, 2, 1)])
            for i, (d_in, d_out) in enumerate(in_out)])
        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = Residual(PreNorm(mid, LucidAttention(mid)))
        self.mid_block2 = res(mid, mid)
        self.ups = nn.ModuleList([
            nn.ModuleList([res(d_out + d_in, d_out), res(d_out + d_in, d_out),
                           linear_attention(d_out),
                           nn.Conv2d(d_out, d_in, 3, padding=1) if i == len(in_out) - 1
                           else lucid_upsample(d_out, d_in)])
            for i, (d_in, d_out) in enumerate(reversed(in_out))])
        self.final_res_block = res(dim * 2, dim)
        self.final_conv = nn.Conv2d(dim, out_dim or channels * (2 if learned_variance else 1),
                                    1)

    def forward(self, x_t, t=None, condition=None, cond_mask=None, self_cond=None):
        """(y, []); ``condition`` and ``cond_mask`` are ignored."""
        if self.self_condition:
            sc = torch.zeros_like(x_t) if self_cond is None else self_cond
            x_t = torch.cat([sc, x_t], dim=1)
        x = self.init_conv(x_t)
        r = x
        emb = self.time_mlp[0](t).to(self.time_mlp[1].weight.dtype)
        emb = self.time_mlp[1:](emb).to(x.dtype)
        h = []
        for block1, block2, attn, downsample in self.downs:
            x = block1(x, emb)
            h.append(x)
            x = attn(block2(x, emb))
            h.append(x)
            x = downsample(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, emb)), emb)
        for block1, block2, attn, upsample in self.ups:
            x = block1(torch.cat([x, h.pop()], dim=1), emb)
            x = block2(torch.cat([x, h.pop()], dim=1), emb)
            x = upsample(attn(x))
        x = self.final_res_block(torch.cat([x, r], dim=1), emb)
        return self.final_conv(x), []
