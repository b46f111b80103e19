"""Named presets (port of ``medfusion_tpu/cli/presets.py``) and
:func:`build_pipeline`, which makes a seeded sampling pipeline on a device.

chest  — CheXpert 256x256, latent 8x32x32
eye    — AIROGS 256x256, latent 4x32x32
colon  — MSIvsMSS 512x512, latent 4x64x64
smoke  — tiny everything, for tests
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from medfusion_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    image_size: int
    in_channels: int
    latent_shape: Tuple[int, int, int]  # (H, W, C) channels-last
    emb_channels: int
    num_classes: Optional[int]
    vae_hid_chs: Tuple[int, ...] = (64, 128, 256, 512)
    unet_hid_chs: Tuple[int, ...] = (256, 256, 512, 1024)
    timesteps: int = 1000
    schedule: str = "scaled_linear"
    beta_start: float = 0.002
    beta_end: float = 0.02
    ae_deep_supervision: int = 1


PRESETS = {
    "chest": Preset(name="chest", image_size=256, in_channels=3,
                    latent_shape=(32, 32, 8), emb_channels=8, num_classes=2),
    "eye": Preset(name="eye", image_size=256, in_channels=3,
                  latent_shape=(32, 32, 4), emb_channels=4, num_classes=2),
    "colon": Preset(name="colon", image_size=512, in_channels=3,
                    latent_shape=(64, 64, 4), emb_channels=4, num_classes=2),
    "smoke": Preset(name="smoke", image_size=32, in_channels=3,
                    latent_shape=(8, 8, 2), emb_channels=2, num_classes=2,
                    vae_hid_chs=(8, 16, 32), unet_hid_chs=(16, 32),
                    timesteps=20, ae_deep_supervision=0),
}


def build_vae(p: Preset):
    """The in-house KL autoencoder ('vae' kind)."""
    from medfusion_tpu_torch.models.latent_embedders import VAE

    n_groups = 8 if min(p.vae_hid_chs) >= 8 else min(p.vae_hid_chs)
    n = len(p.vae_hid_chs)
    return VAE(in_channels=p.in_channels, out_channels=p.in_channels,
               emb_channels=p.emb_channels, hid_chs=p.vae_hid_chs,
               kernel_sizes=(3,) * n, strides=(1,) + (2,) * (n - 1),
               deep_supervision=p.ae_deep_supervision,
               norm_name=("GROUP", {"num_groups": n_groups, "affine": True}))


def build_unet(p: Preset, attention: str = "none", attn_heads: int = 8):
    """The reference 'unet2' estimator ('unet' family). ``attention`` is the
    reference's ``use_attention`` ('none' | 'linear' | 'spatial'; 'spatial'
    is the eye/colon attention config) and ``attn_heads`` its head count."""
    from medfusion_tpu_torch.models.unet import UNet

    n = len(p.unet_hid_chs)
    n_groups = 32 if min(p.unet_hid_chs) >= 32 else min(p.unet_hid_chs) // 2
    return UNet(in_ch=p.emb_channels, out_ch=p.emb_channels,
                hid_chs=p.unet_hid_chs, kernel_sizes=(3,) * n,
                strides=(1,) + (2,) * (n - 1), time_emb_dim=p.unet_hid_chs[-1],
                cond_emb_num_classes=p.num_classes, deep_supervision=0,
                use_attention=attention, attn_heads=attn_heads,
                use_res_block=True,
                norm_name=("GROUP", {"num_groups": n_groups, "affine": True}))


def build_scheduler(p: Preset, device="cpu"):
    from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule

    return GaussianDiffusionSchedule.create(
        timesteps=p.timesteps, schedule_strategy=p.schedule,
        beta_start=p.beta_start, beta_end=p.beta_end, device=device)


def build_pipeline(p: Preset, device=None, compute_dtype=None, seed: int = 0,
                   unet_params=None, vae_params=None, attention: str = "none",
                   attn_heads: int = 8):
    """Sampling pipeline as ``medfusion_tpu/cli/sample.py`` builds it (eps
    objective, no x0 clipping), on ``device`` (default ``cuda``; raises
    without CUDA). Weights are a seeded torch initialisation, or the JAX
    package's flax params (nested numpy dicts) when given. ``attention`` and
    ``attn_heads`` configure the UNet (:func:`build_unet`)."""
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from medfusion_tpu_torch.utils.weights import load_jax_params

    dev = resolve_device(device)
    fork = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=fork), torch.device(dev):
        torch.manual_seed(seed)
        unet = build_unet(p, attention=attention, attn_heads=attn_heads)
        vae = build_vae(p)
    if unet_params is not None:
        load_jax_params(unet, unet_params, kind="unet")
    if vae_params is not None:
        load_jax_params(vae, vae_params, kind="vae")
    unet.eval()
    vae.eval()
    return DiffusionPipeline(scheduler=build_scheduler(p, dev),
                             noise_estimator=unet, latent_embedder=vae,
                             clip_x0=False, compute_dtype=compute_dtype)
