"""DiT, the Diffusion Transformer noise estimator (port of
``medfusion_tpu/models/dit.py``; Peebles & Xie, arXiv:2212.09748).

NCHW at the boundary, with the port UNet's interface: ``forward(x_t, t,
condition, cond_mask, self_cond=None) -> (pred, [])``; ``with_aux=True``
also returns the summed auxiliary loss of its mixture-of-experts layers (a
float32 scalar, 0 without them), so that no call's aux loss lives in module
state.

* patchify: [B, C, H, W] -> [B, N = (H/p)(W/p), p*p*C] with each token's
  features in the JAX package's (row in patch, column in patch, channel)
  order, then a Linear to ``hidden_size``;
* a fixed 2-D sin-cos position table (:func:`sincos_2d_pos_embed`, float64
  then float32), not a parameter;
* the timestep embedder: 256 frequencies as ``[cos, sin]`` (the UNet's
  embedder is ``[sin, cos]``) -> Linear -> SiLU -> Linear;
* the label table of ``num_classes + 1`` rows, the last the learned null
  (classifier-free) label, blended per sample as ``m * y + (1 - m) * y_null``
  by ``cond_mask`` and used alone when ``condition`` is None;
* blocks with adaLN-Zero: LayerNorm without affine (eps 1e-6) -> modulate
  -> one ``attn_qkv`` Linear split in three -> ``ops.attention`` with the
  double scale d^-0.25 (the token-layout flash kernels on the card) ->
  ``attn_proj``; then LayerNorm -> modulate -> Linear -> GELU (tanh) ->
  Linear, or a routed expert MLP (``parallel/moe.py``) where the block is
  one of every ``moe_every``; each branch scaled by its zero-initialised
  gate;
* the final layer: adaLN modulate -> a zero-initialised Linear to
  p*p*out channels -> unpatchify. ``learn_sigma`` doubles the output
  channels for the pipeline's learned-variance split.

The submodule names are the flax names (``x_embedder``,
``t_embedder.mlp_0``, ``blocks.{i}.attn_qkv``, ``final_layer.linear``, ...),
so ``utils/weights.py::jax_dit_to_state_dict`` loads a JAX DiT's params with
``strict=True``. The initialisation is flax's: xavier-uniform for the 2-D
Linears, N(0, 0.02) for the time MLP and the label table, zeros for both
adaLN layers and the final linear; a fresh DiT therefore outputs zeros.
In a reduced-precision module the float32 sinusoidal features are cast to
the time MLP's dtype, as the port's UNet casts them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch import ops
from medfusion_tpu_torch.parallel.moe import MoEMLP


def sincos_2d_pos_embed(embed_dim: int, h: int, w: int) -> np.ndarray:
    """[h*w, embed_dim] float32 2-D sin-cos table, computed in float64: half
    the channels encode the row, half the column, each as sin then cos of a
    frequency bank (the MAE recipe)."""
    if embed_dim % 4 != 0:
        raise ValueError("sincos_2d_pos_embed needs embed_dim % 4 == 0")

    def one_axis(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000.0 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gy, gx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    emb = np.concatenate([one_axis(embed_dim // 2, gy), one_axis(embed_dim // 2, gx)], axis=1)
    return emb.astype(np.float32)


def _xavier_linear(cin: int, cout: int) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


def _zero_linear(cin: int, cout: int) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


def _normal_linear(cin: int, cout: int) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    nn.init.normal_(lin.weight, std=0.02)
    nn.init.zeros_(lin.bias)
    return lin


def _layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTTimestepEmbedder(nn.Module):
    """256 frequencies ``[cos, sin]`` -> Linear -> SiLU -> Linear."""

    def __init__(self, hidden_size: int, freq_embed_size: int = 256):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.mlp_0 = _normal_linear(freq_embed_size, hidden_size)
        self.mlp_2 = _normal_linear(hidden_size, hidden_size)

    def forward(self, t):
        half = self.freq_embed_size // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.mlp_2(F.silu(self.mlp_0(emb.to(self.mlp_0.weight.dtype))))


class DiTBlock(nn.Module):
    """Attention and MLP (or expert MLP) with adaLN-Zero conditioning on
    tokens [B, N, hidden]; returns (tokens, the expert MLP's aux loss or
    None)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 moe_experts: Optional[int] = None, moe_num_selected: int = 2,
                 moe_capacity_factor: float = 1.25, moe_expert_axis=None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (hidden_size // num_heads) ** -0.25
        mlp_dim = int(hidden_size * mlp_ratio)
        self.adaLN_modulation = _zero_linear(hidden_size, 6 * hidden_size)
        self.attn_qkv = _xavier_linear(hidden_size, 3 * hidden_size)
        self.attn_proj = _xavier_linear(hidden_size, hidden_size)
        if moe_experts is not None:
            self.moe_mlp = MoEMLP(hidden_size, mlp_dim, moe_experts,
                                  num_selected=moe_num_selected,
                                  capacity_factor=moe_capacity_factor,
                                  expert_axis=moe_expert_axis)
        else:
            self.moe_mlp = None
            self.mlp_fc1 = _xavier_linear(hidden_size, mlp_dim)
            self.mlp_fc2 = _xavier_linear(mlp_dim, hidden_size)

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(F.silu(c)).chunk(6, dim=-1)
        h = _modulate(_layer_norm(x), shift_msa, scale_msa)
        # q, k and v are column slices of one [B, N, 3C] tensor: row stride 3C
        q, k, v = self.attn_qkv(h).chunk(3, dim=-1)
        a = self.attn_proj(ops.attention(q, k, v, self.num_heads, self.scale))
        x = x + gate_msa[:, None, :] * a
        h2 = _modulate(_layer_norm(x), shift_mlp, scale_mlp)
        aux = None
        if self.moe_mlp is not None:
            h2, aux = self.moe_mlp(h2)
        else:
            h2 = self.mlp_fc2(F.gelu(self.mlp_fc1(h2), approximate="tanh"))
        return x + gate_mlp[:, None, :] * h2, aux


class DiTFinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = _zero_linear(hidden_size, 2 * hidden_size)
        self.linear = _zero_linear(hidden_size, patch_size * patch_size * out_channels)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(F.silu(c)).chunk(2, dim=-1)
        return self.linear(_modulate(_layer_norm(x), shift, scale))


class DiT(nn.Module):
    """Class-conditional latent Diffusion Transformer on [B, in_ch, H, W]
    with H and W divisible by ``patch_size``. ``moe_experts`` makes block i
    an expert-MLP block where ``i % moe_every == moe_every - 1``;
    ``moe_expert_axis`` (a process group or a 1-D DeviceMesh) splits the
    experts of every expert-MLP block over its ranks, which hold their own
    rows of the batch (``parallel/moe.py``)."""

    # the pipelines ask for the aux loss of a training forward
    returns_aux = True

    def __init__(self, in_ch: int, patch_size: int = 2, hidden_size: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 cond_emb_num_classes: Optional[int] = None, learn_sigma: bool = False,
                 use_self_conditioning: bool = False, moe_experts: Optional[int] = None,
                 moe_every: int = 2, moe_num_selected: int = 2,
                 moe_capacity_factor: float = 1.25, moe_expert_axis=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} must be divisible by "
                             f"num_heads {num_heads}")
        if hidden_size % 4:
            raise ValueError("hidden_size must be divisible by 4 (the 2-D sin-cos "
                             "pos-embed splits it in quarters)")
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.cond_emb_num_classes = cond_emb_num_classes
        self.use_self_conditioning = use_self_conditioning
        self.out_ch = in_ch * (2 if learn_sigma else 1)
        x_in = patch_size * patch_size * in_ch * (2 if use_self_conditioning else 1)
        self.x_embedder = _xavier_linear(x_in, hidden_size)
        self.t_embedder = DiTTimestepEmbedder(hidden_size)
        if cond_emb_num_classes is not None:
            # +1: the last row is the learned null (CFG) label
            self.y_embedder = nn.Embedding(cond_emb_num_classes + 1, hidden_size)
            nn.init.normal_(self.y_embedder.weight, std=0.02)
        self.blocks = nn.ModuleList([
            DiTBlock(hidden_size, num_heads, mlp_ratio,
                     moe_experts=(moe_experts if moe_experts is not None
                                  and i % moe_every == moe_every - 1 else None),
                     moe_num_selected=moe_num_selected,
                     moe_capacity_factor=moe_capacity_factor,
                     moe_expert_axis=moe_expert_axis)
            for i in range(depth)])
        self.final_layer = DiTFinalLayer(hidden_size, patch_size, self.out_ch)
        self._pos = {}

    def _pos_embed(self, gh: int, gw: int, device) -> torch.Tensor:
        key = (gh, gw, str(device))
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(
                sincos_2d_pos_embed(self.hidden_size, gh, gw)).to(device)
        return self._pos[key]

    def _patchify(self, x):
        b, c, hh, ww = x.shape
        p = self.patch_size
        if hh % p or ww % p:
            raise ValueError(f"input {hh}x{ww} not divisible by patch {p}")
        gh, gw = hh // p, ww // p
        x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)  # [B, gh, gw, p, p, C]
        return x.reshape(b, gh * gw, p * p * c), gh, gw

    def _unpatchify(self, x, gh, gw):
        b, p = x.shape[0], self.patch_size
        x = x.reshape(b, gh, gw, p, p, self.out_ch).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, self.out_ch, gh * p, gw * p)

    def forward(self, x_t, t=None, condition=None, cond_mask=None, self_cond=None,
                with_aux: bool = False):
        if self.use_self_conditioning:
            sc = torch.zeros_like(x_t) if self_cond is None else self_cond
            x_t = torch.cat([x_t, sc], dim=1)
        tokens, gh, gw = self._patchify(x_t)
        x = self.x_embedder(tokens)
        x = x + self._pos_embed(gh, gw, x.device)[None].to(x.dtype)

        b = x.shape[0]
        if t is None:
            t = torch.zeros((b,), dtype=torch.long, device=x.device)
        c = self.t_embedder(t)
        if self.cond_emb_num_classes is not None:
            null_row = torch.full((b,), self.cond_emb_num_classes, dtype=torch.long,
                                  device=x.device)
            y = self.y_embedder(null_row)
            if condition is not None:
                y_cond = self.y_embedder(condition.long())
                if cond_mask is not None:
                    m = cond_mask.to(y_cond.dtype)[:, None]
                    y = m * y_cond + (1.0 - m) * y
                else:
                    y = y_cond
            c = c + y
        c = c.to(x.dtype)  # keep the activations in the compute dtype

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, block_aux = block(x, c)
            if block_aux is not None:
                aux = aux + block_aux
        out = self._unpatchify(self.final_layer(x, c), gh, gw)
        return (out, [], aux) if with_aux else (out, [])
