"""Time and label embedders (port of ``medfusion_tpu/models/embedders.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class SinusoidalPosEmb(nn.Module):
    """sin|cos features of a [B] time, computed in float32."""

    def __init__(self, emb_dim: int = 16):
        super().__init__()
        self.emb_dim = emb_dim

    def forward(self, x):
        half_dim = self.emb_dim // 2
        exponent = math.log(10000) / (half_dim - 1.0)
        freqs = torch.exp(-exponent * torch.arange(half_dim, dtype=torch.float32,
                                                   device=x.device))
        emb = x.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        if self.emb_dim % 2 == 1:
            emb = nn.functional.pad(emb, (0, 1))
        return emb


class TimeEmbedding(nn.Module):
    """pos_emb(emb_dim//4) -> Linear(emb_dim) -> SiLU -> Linear(emb_dim).

    Held in ``time_emb`` (a Sequential) so the keys are the reference's
    ``time_emb.1`` / ``time_emb.3``."""

    def __init__(self, emb_dim: int = 64):
        super().__init__()
        pos_dim = emb_dim // 4
        self.time_emb = nn.Sequential(
            SinusoidalPosEmb(pos_dim), nn.Linear(pos_dim, emb_dim),
            nn.SiLU(), nn.Linear(emb_dim, emb_dim))

    def forward(self, time):
        # the sinusoidal features are float32; the layers may be bf16
        h = self.time_emb[0](time).to(self.time_emb[1].weight.dtype)
        return self.time_emb[1:](h)


class LabelEmbedder(nn.Module):
    """Integer label -> learned embedding [B, emb_dim]."""

    def __init__(self, emb_dim: int = 32, num_classes: int = 2):
        super().__init__()
        self.embedding = nn.Embedding(num_classes, emb_dim)

    def forward(self, condition):
        return self.embedding(condition.long())
