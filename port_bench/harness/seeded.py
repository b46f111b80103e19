"""Weights and inputs made from ``--seed`` on the device, in a few large
calls: the same seed gives the same tensors, and the reference makes them
again from the seed rather than taking them from the program.

Every stream is a ``torch.Generator`` seeded by a ``SeedSequence`` of the
run's seed and the stream's own key, so seeds of any size (beyond 32 bits)
and streams never collide."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from port_bench.reference import model as R

_KEYS = {"unet": 1, "vae": 2, "chunk": 3, "batch": 4, "drop": 5, "sample": 6}


def generator(device, seed: int, key: str, *index: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), _KEYS[key], *map(int, index)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def rng(seed: int, key: str, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), _KEYS[key], *map(int, index)])


def weights(model: nn.Module, seed: int, key: str, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict for the reference ``model``'s parameters
    (``model`` may live on the meta device), every tensor drawn,
    zero-initialised layers included: a norm's scale 1 + 0.1 z and shift
    0.1 z, an embedding table z, a conv or linear weight z / sqrt(fan_in)
    and its bias z / (2 sqrt(fan_in)). One draw for the whole model, cut
    into the leaves."""
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    norms = {n for n, m in modules.items() if isinstance(m, (nn.LayerNorm, R.GroupNorm))}
    flat = torch.randn(sum(p.numel() for p in params.values()),
                       generator=generator(device, seed, key), device=device)
    leaves = list(flat.split([p.numel() for p in params.values()]))
    scales, shifts = [], []
    for (name, p), leaf in zip(params.items(), leaves):
        owner, _, kind = name.rpartition(".")
        if owner in norms:
            scales.append(0.1)
            shifts.append(1.0 if kind == "weight" else 0.0)
        elif isinstance(modules.get(owner), nn.Embedding):
            scales.append(1.0)
            shifts.append(0.0)
        else:
            w = params[f"{owner}.weight"]
            fan_in = w.numel() // w.shape[0]
            scales.append((1.0 if kind == "weight" else 0.5) / math.sqrt(fan_in))
            shifts.append(0.0)
    torch._foreach_mul_(leaves, scales)
    torch._foreach_add_(leaves, shifts)
    return {name: leaf.view(p.shape) for (name, p), leaf in zip(params.items(), leaves)}


def chunk(cfg: dict, seed: int, index: int, rows: int, steps: int,
          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk ``index``'s draws, channels-last: x_T [rows, h, w, c] and the
    DDIM loop's noise [steps, 2, rows, h, w, c]."""
    g = generator(device, seed, "chunk", index)
    lat = (cfg["latent_size"], cfg["latent_size"], cfg["latent_channels"])
    x_T = torch.randn((rows, *lat), generator=g, device=device)
    noise = torch.randn((steps, 2, rows, *lat), generator=g, device=device)
    return x_T, noise


def chunk_label(index: int, num_classes: int) -> int:
    """One label a chunk, in turn."""
    return index % num_classes


def batch(cfg: dict, seed: int, index: int, block: int, rows: int, device) -> Tuple[dict, dict]:
    """Block ``block`` (a rank's rows) of training batch ``index``: the batch
    {source [rows, H, W, C] in [-1, 1], target [rows]} and the draws
    {enc_noise, t, x_T, drop}, drop one boolean for the whole batch."""
    g = generator(device, seed, "batch", index, block)
    s, c = cfg["image_size"], cfg["image_channels"]
    lat = (cfg["latent_size"], cfg["latent_size"], cfg["latent_channels"])
    source = torch.rand((rows, s, s, c), generator=g, device=device) * 2 - 1
    target = torch.randint(0, cfg["num_classes"], (rows,), generator=g, device=device)
    draws = {"enc_noise": torch.randn((rows, *lat), generator=g, device=device),
             "t": torch.randint(0, cfg["timesteps"], (rows,), generator=g, device=device),
             "x_T": torch.randn((rows, *lat), generator=g, device=device)}
    gd = generator(device, seed, "drop", index)
    draws["drop"] = torch.rand((), generator=gd, device=device) < cfg["cfg_dropout"]
    return {"source": source, "target": target}, draws
