"""The reference's PyTorch Lightning checkpoints (port of the reading half of
``medfusion_tpu/utils/torch_compat.py``: ``load_torch_checkpoint`` and
``convert_state_dict``).

A reference ``DiffusionPipeline`` checkpoint (``.ckpt``) holds one
``state_dict`` with the noise estimator under ``noise_estimator.`` and the
latent embedder, where the file has one, under ``latent_embedder.``; a
reference autoencoder's holds the autoencoder's keys bare. The port's
modules carry the reference's torch key names, so loading is a strict
``load_state_dict`` after the prefix is stripped, not a conversion. The one
layout difference: the reference's 1x1 convolutions used as projections
(``to_q``, ``proj_in``, ...) have trailing unit kernel dims, where the port
has ``nn.Linear`` weights; :func:`fit_layout` drops those dims.

The file is read with ``torch.load(weights_only=True)``, which unpickles
tensors and plain containers and nothing else. The JAX package reads with
``weights_only=False``; a file whose ``hyper_parameters`` need arbitrary
unpickling (classes, functions) is refused here with a message, so no
pickled code runs without the user asking for it.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict

import torch

def is_lightning_checkpoint(path) -> bool:
    """A ``.ckpt`` file (the reference's Lightning format)."""
    return path is not None and str(path).endswith(".ckpt") and Path(path).is_file()


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    """The tensors of a Lightning checkpoint's ``state_dict`` (or of a bare
    state dict), on the CPU. Raises ValueError for a file that needs more
    than tensors and plain containers to unpickle."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: this checkpoint needs arbitrary unpickling (its hyper_parameters "
            f"hold Python objects), which can run code; refusing to load it. From a "
            f"source you trust, keep its weights alone: torch.save({{'state_dict': "
            f"torch.load(path, weights_only=False)['state_dict']}}, new_path)\n{e}") from e
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def strip_prefix(state_dict: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The keys under ``prefix``, without it, and without BatchNorm's
    ``num_batches_tracked`` and the schedule's ``timesteps*`` buffers (the
    JAX ``convert_state_dict``'s rule)."""
    out = {}
    for key, val in state_dict.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        if key.endswith("num_batches_tracked") or key.startswith("timesteps"):
            continue
        out[key] = val
    return out


def fit_layout(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor]):
    """``state_dict`` with two reference-layout fixes for ``module``: a
    weight whose extra trailing dims are all 1 (a 1x1 conv) takes the shape
    of the module's ``nn.Linear`` weight, and a ``num_batches_tracked`` the
    file does not hold is the module's."""
    own = module.state_dict()
    sd = dict(state_dict)
    for key, ref in own.items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = ref
        val = sd.get(key)
        if (val is not None and val.ndim > ref.ndim and val.shape[:ref.ndim] == ref.shape
                and all(d == 1 for d in val.shape[ref.ndim:])):
            sd[key] = val.reshape(ref.shape)
    return sd


def load_strict(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """``module.load_state_dict(fit_layout(module, state_dict), strict=True)``."""
    module.load_state_dict(fit_layout(module, state_dict), strict=True)
    return module


def pipeline_states(path):
    """(estimator state, latent-embedder state or None) of a reference
    ``DiffusionPipeline`` checkpoint."""
    sd = read_state_dict(path)
    unet = strip_prefix(sd, "noise_estimator.")
    if not unet:
        raise ValueError(f"{path}: no 'noise_estimator.' keys; not a DiffusionPipeline "
                         f"checkpoint")
    return unet, strip_prefix(sd, "latent_embedder.") or None


def autoencoder_state(path) -> Dict[str, torch.Tensor]:
    """The autoencoder's state of a reference checkpoint: its bare keys (a
    reference VAE or VQVAE), or a pipeline checkpoint's ``latent_embedder.``
    part."""
    sd = read_state_dict(path)
    if any(k.startswith("latent_embedder.") for k in sd):
        return strip_prefix(sd, "latent_embedder.")
    return strip_prefix(sd)
