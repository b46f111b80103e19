"""The system under test, built through its own entry points
(``medfusion_tpu_torch.cli.presets``) at a configuration's sizes, on the meta
device first and then on the card with the benchmark's seeded weights
(``load_state_dict(strict=True)``), so that no time goes to an
initialisation that the seed overwrites."""

from __future__ import annotations

import dataclasses

import torch

from port_bench.harness import seeded
from port_bench.reference import model as R

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def preset(cfg: dict):
    from medfusion_tpu_torch.cli.presets import Preset

    lat = cfg["latent_size"]
    return Preset(name=cfg["name"], image_size=cfg["image_size"],
                  in_channels=cfg["image_channels"],
                  latent_shape=(lat, lat, cfg["latent_channels"]),
                  emb_channels=cfg["vae"]["emb_channels"], num_classes=cfg["num_classes"],
                  vae_hid_chs=tuple(cfg["vae"]["hid_chs"]),
                  unet_hid_chs=tuple(cfg["unet"]["hid_chs"]), timesteps=cfg["timesteps"],
                  schedule=cfg["schedule"], beta_start=cfg["beta_start"],
                  beta_end=cfg["beta_end"], cfg_dropout=cfg["cfg_dropout"],
                  diffusion_lr=cfg["optimizer"]["lr"],
                  ae_deep_supervision=cfg["vae"]["deep_supervision"])


def seeded_weights(cfg: dict, seed: int, device):
    """(UNet, VAE) float32 state dicts drawn from ``seed``, named by the
    reference's parameters (built on the meta device)."""
    with torch.device("meta"):
        unet, vae = R.build(cfg, "unet"), R.build(cfg, "vae")
    return (seeded.weights(unet, seed, "unet", device),
            seeded.weights(vae, seed, "vae", device))


def _materialise(pipe, p, sd_unet, sd_vae, device):
    from medfusion_tpu_torch.cli.presets import build_scheduler

    for module, sd in ((pipe.noise_estimator, sd_unet), (pipe.latent_embedder, sd_vae)):
        module.to_empty(device=device)
        dtype = next(module.parameters()).dtype
        module.load_state_dict({k: v.to(dtype) for k, v in sd.items()}, strict=True)
    return dataclasses.replace(pipe, scheduler=build_scheduler(p, device))


def sampling_pipeline(cfg: dict, sd_unet, sd_vae, device):
    """``cli/presets.py::build_pipeline`` at the configuration, in its
    compute dtype, holding the seeded weights (rounded to that dtype)."""
    from medfusion_tpu_torch.cli.presets import build_pipeline

    p = preset(cfg)
    pipe = build_pipeline(p, device="meta", compute_dtype=DTYPES[cfg["compute_dtype"]],
                          attention=cfg["unet"]["attention"],
                          attn_heads=cfg["unet"]["attn_heads"])
    return _materialise(pipe, p, sd_unet, sd_vae, device)


def training_pipeline(cfg: dict, sd_unet, sd_vae, device):
    """``cli/presets.py::build_train_pipeline`` at the configuration: float32
    masters, the frozen VAE, holding the seeded weights."""
    from medfusion_tpu_torch.cli.presets import build_train_pipeline

    p = preset(cfg)
    pipe = build_train_pipeline(p, device="meta", attention=cfg["unet"]["attention"],
                                attn_heads=cfg["unet"]["attn_heads"],
                                compute_dtype=DTYPES[cfg["compute_dtype"]])
    return _materialise(pipe, p, sd_unet, sd_vae, device)


def reference_models(cfg: dict, sd_unet, sd_vae, device, served=None):
    """The plain reference's (UNet, VAE) on ``device`` in float32 holding the
    seeded weights, rounded first to ``served`` where the program holds
    them in that dtype."""
    with torch.device("meta"):
        unet, vae = R.build(cfg, "unet"), R.build(cfg, "vae")
    for module, sd in ((unet, sd_unet), (vae, sd_vae)):
        module.to_empty(device=device)
        module.load_state_dict({k: (v if served is None else v.to(served)).float()
                                for k, v in sd.items()}, strict=True)
    return unet, vae
