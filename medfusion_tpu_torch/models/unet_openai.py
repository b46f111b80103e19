"""The OpenAI / Stable-Diffusion UNet family, NCHW (port of
``medfusion_tpu/models/unet_openai.py``): ``sd_timestep_embedding``,
``SDResBlock``, ``SDUpsample``, ``SDDownsample``, ``SDAttentionBlock``, the
cross-attention transformer (``SDCrossAttention``, ``SDGEGLU``,
``SDFeedForward``, ``SDBasicTransformerBlock``, ``SDSpatialTransformer``),
the ``UNetOpenAI`` noise estimator, and the noisy-image classifier of
classifier guidance (``SDAttentionPool``, ``EncoderUNetOpenAI``).

Modules whose names are the reference ``UNetModel``'s and
``EncoderUNetModel``'s torch keys (``time_embed.0``, ``label_emb``,
``input_blocks.{i}.{j}.in_layers.0``, ``middle_block.{j}``,
``output_blocks.{i}.{j}``, ``out.{k}``), so :func:`openai_key_to_path` (the
port's copy of the JAX package's ``_openai_key_to_path``) maps each to its
flax path and ``utils/weights.py::jax_classifier_to_state_dict`` loads
flax params with ``strict=True``. The reference's 1x1 ``conv1d``
projections (``qkv``, ``proj_out``, ``qkv_proj``, ``c_proj``) are
``nn.Linear`` over the tokens, as the JAX package's ``Dense``.

GroupNorm32 normalises in float32 and returns the input dtype, as the JAX
package's flax ``GroupNorm`` does outside its Pallas kernel (here
``F.group_norm``). ``SDAttentionBlock`` and the attention pool go through
``ops.attention``: the hand-written flash-attention kernels on the card,
their plain versions on the CPU, each differentiable. ``SDCrossAttention``
is a plain matmul softmax, as the JAX package's einsum. Dropout
(``nn.Dropout``) sits in the reference's ``out_layers.2`` slot of a
ResBlock. ``UNetOpenAI(remat=True)`` recomputes each ResBlock and
attention block in the backward (not the spatial transformers), as the JAX
package's ``nn.remat``. ``UNetOpenAI(spatial_dims=3)`` runs on [B, C, D,
H, W] with the JAX package's 3-D rules: the 2x upsampling and the average
pool act on the inner two dims only, and the conv downsample has stride
(1, 2, 2). The classifier follows the same rules in 3-D, but for its
attention pool (2-D only).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch import ops
from medfusion_tpu_torch.nn.functional import checkpointed


def sd_timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal features of a [B] time, cos first (the JAX package's and
    Stable Diffusion's order; the main UNet's embedder is sin first)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm (eps 1e-5 by default) computed in float32, returned in the
    input dtype."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _zero(module: nn.Module) -> nn.Module:
    nn.init.zeros_(module.weight)
    nn.init.zeros_(module.bias)
    return module


def _conv(n: int, *args, **kwargs) -> nn.Module:
    """``nn.Conv2d`` or, at ``n`` = 3, ``nn.Conv3d``."""
    return {2: nn.Conv2d, 3: nn.Conv3d}[n](*args, **kwargs)


def _avg_pool2x(x):
    """Stride-2 average pool; on [B, C, D, H, W] of the inner two dims."""
    return F.avg_pool3d(x, (1, 2, 2)) if x.ndim == 5 else F.avg_pool2d(x, 2)


def _upsample2x(x):
    """Nearest 2x upsample of the last two dims (in 3-D: (D, 2H, 2W))."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class SDUpsample(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv when ``use_conv``."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool,
                 spatial_dims: int = 2):
        super().__init__()
        if use_conv:
            self.conv = _conv(spatial_dims, channels, out_channels, 3, padding=1)
        elif channels != out_channels:
            raise ValueError("an upsample without its conv keeps the width")

    def forward(self, x, emb=None):
        x = _upsample2x(x)
        return self.conv(x) if hasattr(self, "conv") else x


class SDDownsample(nn.Module):
    """Stride-2 3x3 conv (stride (1, 2, 2) in 3-D) or 2x2 average pool."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool,
                 spatial_dims: int = 2):
        super().__init__()
        if use_conv:
            stride = (1, 2, 2) if spatial_dims == 3 else 2
            self.op = _conv(spatial_dims, channels, out_channels, 3, stride=stride, padding=1)
        elif channels != out_channels:
            raise ValueError("an average-pool downsample keeps the width")

    def forward(self, x, emb=None):
        return self.op(x) if hasattr(self, "op") else _avg_pool2x(x)


class SDResBlock(nn.Module):
    """GN -> SiLU -> conv, the time embedding added (or as a FiLM scale and
    shift with ``use_scale_shift_norm``), GN -> SiLU -> zero-init conv, a
    residual (through a 1x1, or 3x3, conv where the width changes);
    ``down`` average-pools and ``up`` nearest-upsamples both paths after the
    first SiLU; a ``dropout`` before the last conv."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float = 0.0, use_conv_shortcut: bool = False,
                 use_scale_shift_norm: bool = False, down: bool = False,
                 norm_groups: int = 32, up: bool = False, spatial_dims: int = 2):
        super().__init__()
        n = spatial_dims
        self.down, self.up = down, up
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(GroupNorm32(channels, norm_groups), nn.SiLU(),
                                       _conv(n, channels, out_channels, 3, padding=1))
        emb_out = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, emb_out))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, norm_groups), nn.SiLU(),
            nn.Dropout(dropout) if dropout else nn.Identity(),
            _zero(_conv(n, out_channels, out_channels, 3, padding=1)))
        if out_channels != channels:
            k = 3 if use_conv_shortcut else 1
            self.skip_connection = _conv(n, channels, out_channels, k, padding=k // 2)
        else:
            self.skip_connection = nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers[:-1](x)
        if self.up:
            h, x = _upsample2x(h), _upsample2x(x)
        elif self.down:
            h, x = _avg_pool2x(h), _avg_pool2x(x)
        h = self.in_layers[-1](h)
        emb_out = self.emb_layers(emb).to(h.dtype)
        emb_out = emb_out.reshape(*emb_out.shape, *(1,) * (h.ndim - 2))
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = self.out_layers[:2](h + emb_out)
        return self.skip_connection(x) + self.out_layers[3](self.out_layers[2](h))


def _split_qkv(qkv, heads: int, new_order: bool):
    """q, k, v [B, N, C] of the [B, N, 3C] projection: channel layout
    [3, H, D] (``new_order``, QKVAttention) or [H, 3, D] (QKVAttentionLegacy)."""
    c = qkv.shape[-1] // 3
    if new_order:
        return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    parts = qkv.unflatten(-1, (heads, 3, c // heads))
    return tuple(parts[..., i, :].flatten(-2) for i in range(3))


def _attend(qkv, heads: int, new_order: bool):
    q, k, v = _split_qkv(qkv, heads, new_order)
    d = q.shape[-1] // heads
    return ops.attention(q, k, v, heads, scale=d ** -0.25)


class SDAttentionBlock(nn.Module):
    """Self-attention over the flattened positions with the double-scaled
    softmax (d^-0.25 on q and on k), zero-init out projection, residual."""

    def __init__(self, channels: int, num_heads: int, new_order: bool = False,
                 norm_groups: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.new_order = new_order
        self.norm = GroupNorm32(channels, norm_groups)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = _zero(nn.Linear(channels, channels))

    def forward(self, x, emb=None):
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # [B, N, C]
        out = self.proj_out(_attend(self.qkv(tokens), self.num_heads, self.new_order))
        return x + out.transpose(1, 2).reshape(x.shape)


class SDCrossAttention(nn.Module):
    """Multi-head attention with bias-free q/k/v projections, the context
    (default: ``x`` itself) as keys and values, a plain softmax of the
    d^-0.5-scaled products, as the JAX package's einsum."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        q, k, v = (t.unflatten(-1, (self.heads, self.dim_head)).transpose(1, 2)
                   for t in (self.to_q(x), self.to_k(ctx), self.to_v(ctx)))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5, dim=-1)
        return self.to_out((attn @ v).transpose(1, 2).flatten(2))


class SDGEGLU(nn.Module):
    """x * gelu(gate) (exact erf) of one projection to twice the width."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class SDFeedForward(nn.Module):
    """GEGLU MLP under the reference's ``net.0.proj`` / ``net.2`` keys."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(SDGEGLU(dim, dim * mult), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class SDBasicTransformerBlock(nn.Module):
    """Pre-LayerNorm self-attention, cross-attention and GEGLU MLP, each
    with a residual, on [B, N, C] tokens."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = SDCrossAttention(dim, None, n_heads, d_head)
        self.ff = SDFeedForward(dim)
        self.attn2 = SDCrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-5) for _ in range(3))

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SDSpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6, float32) -> 1x1 ``proj_in`` -> ``depth``
    transformer blocks over the positions -> zero-init 1x1 ``proj_out`` +
    residual."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, norm_groups: int = 32,
                 spatial_dims: int = 2):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, norm_groups, eps=1e-6)
        self.proj_in = _conv(spatial_dims, in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            SDBasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth)])
        self.proj_out = _zero(_conv(spatial_dims, inner, in_channels, 1))

    def forward(self, x, context=None):
        h = self.proj_in(self.norm(x))
        tokens = h.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            tokens = block(tokens, context=context)
        return self.proj_out(tokens.transpose(1, 2).reshape(h.shape)) + x


class UNetOpenAI(nn.Module):
    """The full SD/ADM UNet: ``channel_mult`` level widths, attention at the
    downsample factors in ``attention_resolutions`` (a
    :class:`SDAttentionBlock`, or with ``use_spatial_transformer`` an
    :class:`SDSpatialTransformer` over ``context``), the FiLM scale-shift
    norm, residual up/downsampling, and a label embedding that a
    per-sample ``cond_mask`` zeroes. ``forward(x_t, t, condition,
    cond_mask, self_cond, context) -> (y, [])``, the estimator contract of
    the ``unet`` family; it has no self-conditioning."""

    def __init__(self, in_channels: int = 4, model_channels: int = 256,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1), dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4), conv_resample: bool = True,
                 spatial_dims: int = 2, num_classes: Optional[int] = None,
                 num_heads: int = 8, num_head_channels: int = -1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, use_new_attention_order: bool = False,
                 use_spatial_transformer: bool = False, transformer_depth: int = 1,
                 context_dim: Optional[int] = None, norm_groups: int = 32,
                 remat: bool = False):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        n = spatial_dims
        mc, ted = model_channels, model_channels * 4
        self.model_channels = mc
        self.num_classes = num_classes
        self.remat = remat

        def heads(ch, upsample=False):
            if num_head_channels == -1:
                return num_heads_upsample if upsample and num_heads_upsample != -1 else num_heads
            if ch % num_head_channels:
                raise ValueError(f"{ch} channels are not a multiple of "
                                 f"num_head_channels={num_head_channels}")
            return ch // num_head_channels

        def res(ch_in, ch_out, **updown):
            return SDResBlock(ch_in, ted, ch_out, dropout,
                              use_scale_shift_norm=use_scale_shift_norm,
                              norm_groups=norm_groups, spatial_dims=n, **updown)

        def attn(ch, upsample=False):
            h = heads(ch, upsample)
            if use_spatial_transformer:
                return SDSpatialTransformer(ch, h, ch // h, transformer_depth, context_dim,
                                            norm_groups, spatial_dims=n)
            return SDAttentionBlock(ch, h, new_order=use_new_attention_order,
                                    norm_groups=norm_groups)

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)
        blocks = [_EmbedSequential(_conv(n, in_channels, mc, 3, padding=1))]
        ch, ds, chans = mc, 1, [mc]
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                blocks.append(_EmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(_EmbedSequential(
                    res(ch, ch, down=True) if resblock_updown
                    else SDDownsample(ch, ch, conv_resample, n)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = _EmbedSequential(res(ch, ch), attn(ch), res(ch, ch))
        out_blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch, upsample=True))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown
                                  else SDUpsample(ch, ch, conv_resample, n))
                    ds //= 2
                out_blocks.append(_EmbedSequential(*layers))
        self.output_blocks = nn.ModuleList(out_blocks)
        self.out = nn.Sequential(GroupNorm32(ch, norm_groups), nn.SiLU(),
                                 _zero(_conv(n, mc, out_channels, 3, padding=1)))

    def _run(self, layers, h, emb, context):
        for layer in layers:
            if isinstance(layer, SDSpatialTransformer):
                h = layer(h, context)
            elif isinstance(layer, (nn.Conv2d, nn.Conv3d)):
                h = layer(h)
            elif (self.remat and torch.is_grad_enabled()
                  and isinstance(layer, (SDResBlock, SDAttentionBlock))):
                h = checkpointed(layer, h, emb)
            else:
                h = layer(h, emb)
        return h

    def forward(self, x_t, t=None, condition=None, cond_mask=None, self_cond=None,
                context=None):
        if self_cond is not None:
            raise ValueError("UNetOpenAI has no self-conditioning (use the unet family)")
        emb = self.time_embed(sd_timestep_embedding(t, self.model_channels).to(
            self.time_embed[0].weight.dtype))
        if condition is not None and self.num_classes is not None:
            lab = self.label_emb(condition.long())
            if cond_mask is not None:
                lab = lab * cond_mask.to(lab.dtype)[:, None]
            emb = emb + lab
        emb = emb.to(x_t.dtype)  # keep the activations in the compute dtype
        hs, h = [], x_t
        for block in self.input_blocks:
            h = self._run(block, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h.to(x_t.dtype)), []


class SDAttentionPool(nn.Module):
    """CLIP-style attention pooling: the mean token prepended, a learned
    positional embedding [C, n + 1] added, one qkv-major attention, the
    first token projected to the logits."""

    def __init__(self, embed_dim: int, num_head_channels: int, output_dim: int,
                 spatial_tokens: int):
        super().__init__()
        self.num_heads = embed_dim // num_head_channels
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spatial_tokens + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x):
        h = x.flatten(2).transpose(1, 2)  # [B, N, C]
        h = torch.cat([h.mean(dim=1, keepdim=True), h], dim=1)
        h = h + self.positional_embedding.T[None].to(h.dtype)
        out = _attend(self.qkv_proj(h), self.num_heads, new_order=True)
        return self.c_proj(out)[:, 0]


class _EmbedSequential(nn.Sequential):
    """Layers applied in turn, the time embedding given to those that take it."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, (SDResBlock, SDAttentionBlock,
                                                    SDDownsample)) else layer(x)
        return x


class EncoderUNetOpenAI(nn.Module):
    """The half UNet classifier: (x [B, C, H, W], or [B, C, D, H, W] at
    ``spatial_dims=3``, t [B]) -> logits [B, K], with the pools 'adaptive'
    (GN -> SiLU -> global mean -> zero-init 1x1 conv), 'attention' (GN ->
    SiLU -> :class:`SDAttentionPool`, 2-D only), 'spatial' and 'spatial_v2'
    (MLPs over the concatenated per-stage spatial means). In 3-D the
    downsamples follow :class:`UNetOpenAI`'s rules (the inner two dims)."""

    def __init__(self, image_size: int = 32, in_channels: int = 4,
                 model_channels: int = 256, out_channels: int = 1000,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, spatial_dims: int = 2, num_heads: int = 1,
                 num_head_channels: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, use_new_attention_order: bool = False,
                 pool: str = "adaptive", norm_groups: int = 32):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        n = spatial_dims
        mc, ted = model_channels, model_channels * 4
        self.model_channels = model_channels
        self.pool = pool
        self.spatial_axes = tuple(range(2, 2 + n))

        def heads(ch):
            return num_heads if num_head_channels == -1 else ch // num_head_channels

        def res(ch_in, ch_out, down=False):
            return SDResBlock(ch_in, ted, ch_out, dropout,
                              use_scale_shift_norm=use_scale_shift_norm, down=down,
                              norm_groups=norm_groups, spatial_dims=n)

        def attn(ch):
            return SDAttentionBlock(ch, heads(ch), new_order=use_new_attention_order,
                                    norm_groups=norm_groups)

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        blocks = [_EmbedSequential(_conv(n, in_channels, mc, 3, padding=1))]
        ch, ds, feature_size = mc, 1, mc
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                blocks.append(_EmbedSequential(*layers))
                feature_size += ch
            if level != len(channel_mult) - 1:
                blocks.append(_EmbedSequential(
                    res(ch, ch, down=True) if resblock_updown
                    else SDDownsample(ch, ch, conv_resample, n)))
                ds *= 2
                feature_size += ch
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = _EmbedSequential(res(ch, ch), attn(ch), res(ch, ch))
        feature_size += ch

        if pool == "adaptive":
            self.out = nn.Sequential(GroupNorm32(ch, norm_groups), nn.SiLU(), nn.Identity(),
                                     _zero(_conv(n, ch, out_channels, 1)))
        elif pool == "attention":
            if num_head_channels == -1:
                raise ValueError("the attention pool needs num_head_channels")
            if n == 3:
                # the JAX package sizes the pool's positional embedding by
                # the 2-D token count and fails with a shape error in 3-D
                raise ValueError("the attention pool is 2-D only: its positional "
                                 "embedding has (image_size // ds) ** 2 tokens")
            self.out = nn.Sequential(GroupNorm32(ch, norm_groups), nn.SiLU(), SDAttentionPool(
                ch, num_head_channels, out_channels, (image_size // ds) ** 2))
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(feature_size, 2048), nn.ReLU(),
                                     nn.Linear(2048, out_channels))
        elif pool == "spatial_v2":
            self.out = nn.Sequential(nn.Linear(feature_size, 2048),
                                     GroupNorm32(2048, norm_groups), nn.SiLU(),
                                     nn.Linear(2048, out_channels))
        else:
            raise NotImplementedError(f"Unexpected {pool} pooling")

    def forward(self, x, t):
        emb = self.time_embed(sd_timestep_embedding(t, self.model_channels).to(
            self.time_embed[0].weight.dtype)).to(x.dtype)
        results = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            if self.pool.startswith("spatial"):
                results.append(h.mean(dim=self.spatial_axes))
        h = self.middle_block(h, emb)
        if self.pool == "adaptive":
            h = self.out[:2](h).mean(dim=self.spatial_axes, keepdim=True)
            return self.out[3](h).flatten(1)
        if self.pool == "attention":
            return self.out(h)
        results.append(h.mean(dim=self.spatial_axes))
        return self.out(torch.cat(results, dim=-1))


_NORM_LEAF = re.compile(r"(^|/)(in_layers_0|out_layers_0|norm|out_0|norm1|norm2|norm3)/weight$")


def openai_key_to_path(key: str, ndim: Optional[int] = None) -> str:
    """A torch key of the OpenAI UNet family -> its flax param path (the
    port's copy of the JAX package's ``_openai_key_to_path``): numeric
    indices join their parent (``in_layers.0`` -> ``in_layers_0``), '.' ->
    '/', a 1-D ``weight`` is a norm's ``scale`` and a wider one a
    ``kernel`` (by name when ``ndim`` is None)."""
    key = re.sub(r"\.(\d+)", r"_\1", key)
    key = key.replace(".", "/")
    if key == "label_emb/weight":
        return "label_emb/embedding"
    if key.endswith("/weight"):
        is_norm = (ndim == 1) if ndim is not None else bool(_NORM_LEAF.search(key))
        return key[: -len("weight")] + ("scale" if is_norm else "kernel")
    return key
