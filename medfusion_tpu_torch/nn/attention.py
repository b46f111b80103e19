"""Attention blocks, NCHW at their boundary
(port of ``medfusion_tpu/nn/attention.py``).

* :func:`compute_attention` — double-scaled softmax((q*s)(k*s)^T) v with
  s = ch_per_head**-0.25: ``ops.attention``, which picks the flash
  kernel's layout (the CUDA kernel on the card, its plain version on the
  CPU).
* :class:`LinearTransformer` — GroupNorm pre-norm, q/k/v projections,
  zero-init out projection, residual; single-layer self- or
  cross-attention.
* :class:`GEGLU`, :class:`BasicTransformerBlock` — self-attention,
  cross-attention against the embedding, and the LayerNorm + GEGLU + down
  projection MLP, which runs through ``ops.geglu.fused_geglu_mlp`` without
  dropout; with dropout it runs LayerNorm -> GEGLU -> Dropout -> down
  projection unfused, as the JAX package's block does.
* :class:`SpatialTransformer` — norm -> proj_in -> blocks -> proj_out +
  residual.
* :class:`Attention` — dispatcher over 'none' | 'linear' | 'spatial'.

Submodule names are the reference's torch keys (``norm_x``, ``to_q``,
``to_out.0``, ``self_atn``, ``cros_atn``, ``proj_out.{0,2}``,
``transformer_blocks.i``), so a JAX checkpoint loads with ``strict=True``.
The 1x1 projections are ``nn.Linear`` over the tokens, as the JAX package
leaves them to XLA outside any Pallas kernel. Every block's input width is
its output width (the UNet's only use), so every residual applies. Dropout
(``nn.Dropout``, in the reference's slots ``to_out.1`` and ``proj_out.1``)
follows each attention's out projection and the GEGLU's product.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from medfusion_tpu_torch import ops
from medfusion_tpu_torch.nn.blocks import Norm, NormName, make_dropout
from medfusion_tpu_torch.ops.geglu import fused_geglu_mlp

ATTENTION_TYPES = ("none", "linear", "spatial")
_GROUP32 = ("GROUP", {"num_groups": 32, "affine": True})


compute_attention = ops.attention  # q [B, N, H*D], k/v [B, M, H*D] -> [B, N, H*D]


def _tokens(x):
    """[B, C, *spatial] -> the [B, N, C] view."""
    return x.flatten(2).transpose(1, 2)


def _spatial(t, spatial):
    """[B, N, C] -> the [B, C, *spatial] view."""
    return t.transpose(1, 2).unflatten(2, tuple(spatial))


class LinearTransformer(nn.Module):
    """Single-layer self/cross attention. ``embedding`` is [B, E] (one
    token) or [B, M, E] tokens; without it the block attends to itself."""

    def __init__(self, spatial_dims: int, out_channels: int, num_heads: int,
                 ch_per_head: int = 32, norm_name: NormName = _GROUP32,
                 dropout: Optional[float] = None, emb_dim: Optional[int] = None):
        super().__init__()
        ch = out_channels
        hid = num_heads * ch_per_head
        self.num_heads = num_heads
        self.scale = ch_per_head ** -0.25
        self.norm_x = Norm(norm_name, ch)
        kv_ch = emb_dim or ch
        self.to_q = nn.Linear(ch, hid)
        self.to_k = nn.Linear(kv_ch, hid)
        self.to_v = nn.Linear(kv_ch, hid)
        drop = make_dropout(dropout)
        self.to_out = nn.Sequential(nn.Linear(hid, ch), *([drop] if drop else []))
        nn.init.zeros_(self.to_out[0].weight)
        nn.init.zeros_(self.to_out[0].bias)

    def forward(self, x, embedding=None):
        b, _, *spatial = x.shape
        if embedding is not None:
            kv = embedding[:, None] if embedding.ndim == 2 else embedding
            if kv.shape[1] == 1:
                # Softmax over one key is 1 for every query, so each token
                # gets to_out(to_v(kv)): norm_x, to_q and to_k are skipped
                # (their parameters stay, so the state dict loads strictly).
                # A dropout draws its mask over every token, as in JAX.
                out = self.to_out[0](self.to_v(kv))
                if len(self.to_out) == 1:
                    return x + out.reshape(b, -1, *[1] * len(spatial))
                n = x[0, 0].numel()
                out = self.to_out[1](out.expand(b, n, out.shape[-1]))
                return x + _spatial(out, spatial)
        xt = _tokens(self.norm_x(x))
        kv = xt if embedding is None else kv
        out = compute_attention(self.to_q(xt), self.to_k(kv), self.to_v(kv),
                                self.num_heads, self.scale)
        return x + _spatial(self.to_out(out), spatial)


class GEGLU(nn.Module):
    """LayerNorm (over channels) -> Linear to 2*out -> h * gelu(gate) (exact
    erf), under the reference's ``norm`` and ``proj`` keys, on [B, N, C]
    tokens. Without dropout the transformer block runs it fused with the
    down projection (:func:`fused_geglu_mlp`) and not through this forward."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_channels, eps=1e-5)
        self.proj = nn.Linear(in_channels, out_channels * 2)

    def forward(self, x):
        h, gate = self.proj(self.norm(x)).chunk(2, dim=-1)
        return h * nn.functional.gelu(gate)


def _whole_weight(linear: nn.Linear):
    """``linear``'s weight, gathered whole where tensor parallelism holds a
    slice of its rows (``parallel/mesh.py::shard_params``): the fused MLP
    kernel reads whole matrices, as GSPMD gathers a sharded operand of the
    JAX package's Pallas call. The gradient comes back sliced."""
    tp = getattr(linear, "tensor_parallel", None)
    if tp is None:
        return linear.weight
    from medfusion_tpu_torch.parallel import comm

    return comm.gather_replicated(linear.weight, 0, tp.value)


class BasicTransformerBlock(nn.Module):
    """self-attn (+ cross-attn against the embedding) + GEGLU MLP, on
    [B, C, *spatial] with C = ``out_channels``."""

    def __init__(self, spatial_dims: int, out_channels: int, num_heads: int,
                 ch_per_head: int = 32, norm_name: NormName = _GROUP32,
                 dropout: Optional[float] = None, emb_dim: Optional[int] = None):
        super().__init__()
        ch = out_channels
        self.self_atn = LinearTransformer(spatial_dims, ch, num_heads,
                                          ch_per_head, norm_name, dropout)
        if emb_dim is not None:
            self.cros_atn = LinearTransformer(spatial_dims, ch, num_heads,
                                              ch_per_head, norm_name, dropout,
                                              emb_dim=emb_dim)
        # reference keys: proj_out.0 = GEGLU, proj_out.1 = dropout slot,
        # proj_out.2 = the down projection
        self.proj_out = nn.ModuleList([GEGLU(ch, ch * 4),
                                       make_dropout(dropout) or nn.Identity(),
                                       nn.Linear(ch * 4, ch)])

    def forward(self, x, embedding=None):
        x = self.self_atn(x)
        if embedding is not None:
            x = self.cros_atn(x, embedding)
        geglu, drop, down = self.proj_out
        if isinstance(drop, nn.Dropout):
            out = down(drop(geglu(_tokens(x))))
        else:
            out = fused_geglu_mlp(_tokens(x), geglu.norm.weight, geglu.norm.bias,
                                  _whole_weight(geglu.proj).t(), geglu.proj.bias,
                                  _whole_weight(down).t(), down.bias)
        return x + _spatial(out, x.shape[2:])


class SpatialTransformer(nn.Module):
    """norm -> proj_in -> ``depth`` transformer blocks -> proj_out +
    residual."""

    def __init__(self, spatial_dims: int, out_channels: int, num_heads: int,
                 ch_per_head: int = 32, norm_name: NormName = _GROUP32,
                 dropout: Optional[float] = None, emb_dim: Optional[int] = None,
                 depth: int = 1):
        super().__init__()
        hid = num_heads * ch_per_head
        self.norm = Norm(norm_name, out_channels)
        self.proj_in = nn.Linear(out_channels, hid)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(spatial_dims, hid, num_heads, ch_per_head,
                                  norm_name, dropout, emb_dim)
            for _ in range(depth)])
        self.proj_out = nn.Linear(hid, out_channels)

    def forward(self, x, embedding=None):
        spatial = x.shape[2:]
        # contiguous NCHW for the blocks' GroupNorm kernel
        h = _spatial(self.proj_in(_tokens(self.norm(x))), spatial).contiguous()
        for block in self.transformer_blocks:
            h = block(h, embedding)
        return x + _spatial(self.proj_out(_tokens(h)), spatial)


class Attention(nn.Module):
    """Dispatcher over ``attention_type`` in 'none' | 'linear' | 'spatial';
    the block is held as ``attention`` (none for 'none')."""

    def __init__(self, spatial_dims: int, out_channels: int, num_heads: int = 8,
                 ch_per_head: int = 32, norm_name: NormName = _GROUP32,
                 dropout: Optional[float] = None, emb_dim: Optional[int] = None,
                 depth: int = 1, attention_type: str = "linear"):
        super().__init__()
        if attention_type not in ATTENTION_TYPES:
            raise ValueError(f"unknown attention type {attention_type!r}; "
                             f"expected one of {ATTENTION_TYPES}")
        self.attention = None
        if attention_type == "spatial":
            self.attention = SpatialTransformer(
                spatial_dims, out_channels, num_heads, ch_per_head, norm_name,
                dropout, emb_dim, depth)
        elif attention_type == "linear":
            self.attention = LinearTransformer(
                spatial_dims, out_channels, num_heads, ch_per_head, norm_name,
                dropout, emb_dim)

    def forward(self, x, emb=None):
        return x if self.attention is None else self.attention(x, emb)
