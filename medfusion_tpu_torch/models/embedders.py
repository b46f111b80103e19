"""Time and label embedders (port of ``medfusion_tpu/models/embedders.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from medfusion_tpu_torch.nn.blocks import make_act


class SinusoidalPosEmb(nn.Module):
    """sin|cos features of a [B] time, computed in float32: frequencies
    exp(-log(max_period) i / (emb_dim // 2 - downscale_freq_shift)), cos
    first with ``flip_sin_to_cos``, an odd ``emb_dim`` padded with a zero
    column."""

    def __init__(self, emb_dim: int = 16, downscale_freq_shift: float = 1.0,
                 max_period: int = 10000, flip_sin_to_cos: bool = False):
        super().__init__()
        self.emb_dim = emb_dim
        self.downscale_freq_shift = downscale_freq_shift
        self.max_period = max_period
        self.flip_sin_to_cos = flip_sin_to_cos

    @property
    def out_dim(self) -> int:
        return self.emb_dim

    def forward(self, x):
        half_dim = self.emb_dim // 2
        exponent = math.log(self.max_period) / (half_dim - self.downscale_freq_shift)
        freqs = torch.exp(-exponent * torch.arange(half_dim, dtype=torch.float32,
                                                   device=x.device))
        emb = x.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        if self.flip_sin_to_cos:
            emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
        if self.emb_dim % 2 == 1:
            emb = nn.functional.pad(emb, (0, 1))
        return emb


class LearnedSinusoidalPosEmb(nn.Module):
    """[t | sin(2 pi t w) | cos(2 pi t w)] with learned frequencies ``weights``
    [emb_dim // 2] (N(0, 1) at init), float32; an odd ``emb_dim`` pads a zero
    column, so the width is ``emb_dim + 1`` either way."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.emb_dim = emb_dim
        self.weights = nn.Parameter(torch.randn(emb_dim // 2))

    @property
    def out_dim(self) -> int:
        return self.emb_dim + 1

    def forward(self, x):
        x = x.float()[:, None]
        freqs = x * self.weights.float()[None, :] * 2 * math.pi
        out = torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)
        if self.emb_dim % 2 == 1:
            out = nn.functional.pad(out, (0, 1))
        return out


class _Act(nn.Module):
    """An activation function as a module (a slot of the Sequential)."""

    def __init__(self, act_name):
        super().__init__()
        self.fn = make_act(act_name)

    def forward(self, x):
        return self.fn(x)


class TimeEmbedding(nn.Module):
    """pos_emb(pos_emb_dim, emb_dim // 4 by default) -> Linear(emb_dim) ->
    act -> Linear(emb_dim); ``pos_embedder`` is :class:`SinusoidalPosEmb` or
    :class:`LearnedSinusoidalPosEmb` (or any module class taking the width
    and giving ``out_dim`` features).

    Held in ``time_emb`` (a Sequential) so the keys are the reference's
    ``time_emb.0`` (a learned embedder's ``weights``), ``time_emb.1`` and
    ``time_emb.3``."""

    def __init__(self, emb_dim: int = 64, pos_embedder: type = SinusoidalPosEmb,
                 pos_emb_dim: Optional[int] = None, act_name=("SWISH", {})):
        super().__init__()
        pos = pos_embedder(pos_emb_dim if pos_emb_dim is not None else emb_dim // 4)
        self.time_emb = nn.Sequential(
            pos, nn.Linear(pos.out_dim, emb_dim), _Act(act_name),
            nn.Linear(emb_dim, emb_dim))

    def forward(self, time):
        # the positional features are float32; the layers may be bf16
        h = self.time_emb[0](time).to(self.time_emb[1].weight.dtype)
        return self.time_emb[1:](h)


class LabelEmbedder(nn.Module):
    """Integer label -> learned embedding [B, emb_dim]."""

    def __init__(self, emb_dim: int = 32, num_classes: int = 2):
        super().__init__()
        self.embedding = nn.Embedding(num_classes, emb_dim)

    def forward(self, condition):
        return self.embedding(condition.long())
