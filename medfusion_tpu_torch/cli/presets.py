"""Named presets (port of ``medfusion_tpu/cli/presets.py``),
:func:`build_pipeline`, which makes a seeded sampling pipeline on a device,
:func:`build_train_pipeline`, which makes the training pipeline of the
JAX package's training CLI, and :func:`build_dataset`, the preset's dataset.

chest  — CheXpert 256x256, latent 8x32x32
eye    — AIROGS 256x256, latent 4x32x32
colon  — MSIvsMSS 512x512, latent 4x64x64
smoke  — tiny everything, for tests
"""

from __future__ import annotations

import contextlib
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
    cfg_dropout: float = 0.5
    diffusion_batch_size: int = 32
    diffusion_lr: float = 1e-4
    ae_batch_size: int = 8
    ae_lr: float = 1e-4
    ae_loss: str = "l2"  # the reference trains the chest VAE with MSE
    ae_embedding_loss_weight: float = 1e-6
    ae_deep_supervision: int = 1
    dataset: str = "chexpert_2"


PRESETS = {
    "chest": Preset(name="chest", image_size=256, in_channels=3,
                    latent_shape=(32, 32, 8), emb_channels=8, num_classes=2,
                    dataset="chexpert_2"),
    "eye": Preset(name="eye", image_size=256, in_channels=3,
                  latent_shape=(32, 32, 4), emb_channels=4, num_classes=2,
                  dataset="airogs"),
    "colon": Preset(name="colon", image_size=512, in_channels=3,
                    latent_shape=(64, 64, 4), emb_channels=4, num_classes=2,
                    dataset="msivsmss_2"),
    "smoke": Preset(name="smoke", image_size=32, in_channels=3,
                    latent_shape=(8, 8, 2), emb_channels=2, num_classes=2,
                    vae_hid_chs=(8, 16, 32), unet_hid_chs=(16, 32),
                    timesteps=20, diffusion_batch_size=4, ae_batch_size=4,
                    dataset="synthetic", ae_deep_supervision=0),
}


AE_KINDS = ("vae", "vqvae")


def build_vae(p: Preset, kind: str = "vae"):
    """The in-house latent embedder by kind: 'vae' (KL) or 'vqvae' (a
    codebook of 8,192, beta 0.25), at the preset's widths. The diffusers
    family ('diffusers_kl', 'diffusers_vq') is not ported (ROADMAP Queue 1)."""
    from medfusion_tpu_torch.models.latent_embedders import VAE, VQVAE

    if kind not in AE_KINDS:
        raise ValueError(f"latent embedder {kind!r} is not ported; expected one of "
                         f"{AE_KINDS}")
    n_groups = 8 if min(p.vae_hid_chs) >= 8 else min(p.vae_hid_chs)
    n = len(p.vae_hid_chs)
    common = dict(in_channels=p.in_channels, out_channels=p.in_channels,
                  emb_channels=p.emb_channels, hid_chs=p.vae_hid_chs,
                  kernel_sizes=(3,) * n, strides=(1,) + (2,) * (n - 1),
                  deep_supervision=p.ae_deep_supervision,
                  norm_name=("GROUP", {"num_groups": n_groups, "affine": True}))
    if kind == "vqvae":
        return VQVAE(num_embeddings=8192, beta=0.25, **common)
    return VAE(**common)


@contextlib.contextmanager
def seeded(dev: torch.device, seed: int):
    """Modules built inside are on ``dev`` with torch's initialisation seeded
    by ``seed``; the caller's generators are left as they were."""
    fork = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=fork), torch.device(dev):
        torch.manual_seed(seed)
        yield


def load_vae(p: Preset, dev: torch.device, seed: int, vae_ckpt=None):
    """The preset's VAE on ``dev`` in eval mode: restored from ``vae_ckpt``
    (``utils/checkpoint.py::restore_ae_params``), else as seeded by ``seed``."""
    from medfusion_tpu_torch.utils.checkpoint import restore_ae_params

    with seeded(dev, seed):
        vae = build_vae(p)
    if vae_ckpt:
        restore_ae_params(vae_ckpt, vae)
    return vae.eval()


def build_discriminators(p: Preset, disc: str = "conv"):
    """One discriminator for each pyramid level of the preset's autoencoder
    (``ae_deep_supervision + 1``), in an ``nn.ModuleList``: 'conv', the
    reference's ``Discriminator``, or 'patch', its ``NLayerDiscriminator``,
    each at its own default widths."""
    import torch.nn as nn

    from medfusion_tpu_torch.models.latent_embedders import (
        Discriminator,
        NLayerDiscriminator,
    )

    cls = {"conv": Discriminator, "patch": NLayerDiscriminator}[disc]
    return nn.ModuleList([cls(in_channels=p.in_channels, spatial_dims=2)
                          for _ in range(p.ae_deep_supervision + 1)])


def build_unet(p: Preset, attention: str = "none", attn_heads: int = 8, **options):
    """The reference 'unet2' estimator ('unet' family). ``attention`` is the
    reference's ``use_attention`` ('none' | 'linear' | 'spatial'; 'spatial'
    is the eye/colon attention config) and ``attn_heads`` its head count;
    ``options`` override the UNet's other arguments (``deep_supervision``,
    ``estimate_variance``, ``use_self_conditioning``), which the CLIs leave
    at the preset's."""
    from medfusion_tpu_torch.models.unet import UNet

    n = len(p.unet_hid_chs)
    n_groups = 32 if min(p.unet_hid_chs) >= 32 else min(p.unet_hid_chs) // 2
    kw = dict(in_ch=p.emb_channels, out_ch=p.emb_channels,
              hid_chs=p.unet_hid_chs, kernel_sizes=(3,) * n,
              strides=(1,) + (2,) * (n - 1), time_emb_dim=p.unet_hid_chs[-1],
              cond_emb_num_classes=p.num_classes, deep_supervision=0,
              use_attention=attention, attn_heads=attn_heads,
              use_res_block=True,
              norm_name=("GROUP", {"num_groups": n_groups, "affine": True}))
    return UNet(**{**kw, **options})


def build_scheduler(p: Preset, device="cpu", zero_terminal_snr: bool = False):
    """The preset's schedule; ``zero_terminal_snr`` rescales it to abar_T = 0."""
    from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule

    return GaussianDiffusionSchedule.create(
        timesteps=p.timesteps, schedule_strategy=p.schedule,
        beta_start=p.beta_start, beta_end=p.beta_end, device=device,
        zero_terminal_snr=zero_terminal_snr)


def _build_modules(p: Preset, device, seed, attention, attn_heads, unet_params=None,
                   vae_params=None, unet_state=None, vae_ckpt=None):
    """(UNet, VAE, device): the modules on ``device``, with a seeded torch
    initialisation, then the JAX package's flax params (nested numpy dicts)
    or a port state dict of the UNet, and a VAE checkpoint
    (``utils/checkpoint.py::restore_ae_params``) where given, each loaded
    with ``strict=True``."""
    from medfusion_tpu_torch.utils.checkpoint import restore_ae_params
    from medfusion_tpu_torch.utils.weights import load_jax_params

    dev = resolve_device(device)
    with seeded(dev, seed):
        unet = build_unet(p, attention=attention, attn_heads=attn_heads)
        vae = build_vae(p)
    if unet_params is not None:
        load_jax_params(unet, unet_params, kind="unet")
    if vae_params is not None:
        load_jax_params(vae, vae_params, kind="vae")
    if unet_state is not None:
        unet.load_state_dict(unet_state, strict=True)
    if vae_ckpt is not None:
        restore_ae_params(vae_ckpt, vae)
    return unet, vae, dev


def build_pipeline(p: Preset, device=None, compute_dtype=None, seed: int = 0,
                   unet_params=None, vae_params=None, attention: str = "none",
                   attn_heads: int = 8, unet_state=None, vae_ckpt=None,
                   objective: str = "x_T", latent_scale: float = 1.0,
                   latent_shift: float = 0.0, zero_terminal_snr: bool = False):
    """Sampling pipeline as ``medfusion_tpu/cli/sample.py`` builds it (no
    x0 clipping; ``objective`` the estimator's, eps by default; a
    zero-terminal-SNR schedule with ``zero_terminal_snr``), on
    ``device`` (default ``cuda``; raises without CUDA), with both modules
    cast to ``compute_dtype``. Weights are a seeded torch initialisation,
    or what :func:`_build_modules` loads. ``attention`` and ``attn_heads``
    configure the UNet (:func:`build_unet`); the diffusion runs on (z -
    ``latent_shift``) * ``latent_scale``."""
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline

    unet, vae, dev = _build_modules(p, device, seed, attention, attn_heads,
                                    unet_params, vae_params, unet_state, vae_ckpt)
    if compute_dtype is not None:
        unet.to(compute_dtype)
        vae.to(compute_dtype)
    return DiffusionPipeline(scheduler=build_scheduler(p, dev, zero_terminal_snr),
                             noise_estimator=unet.eval(), latent_embedder=vae.eval(),
                             estimator_objective=objective, clip_x0=False,
                             compute_dtype=compute_dtype, latent_scale=latent_scale,
                             latent_shift=latent_shift)


def build_train_pipeline(p: Preset, device=None, attention: str = "none",
                         attn_heads: int = 8, objective: str = "x_T",
                         compute_dtype=None, seed: int = 0, vae_ckpt=None,
                         latent_scale: float = 1.0, latent_shift: float = 0.0,
                         zero_terminal_snr: bool = False,
                         min_snr_gamma: Optional[float] = None):
    """Training pipeline as ``medfusion_tpu/cli/train_diffusion.py`` builds
    it: CFG dropout ``p.cfg_dropout``, no input centering, no x0 clipping,
    L1 loss, ``objective`` ('x_T', 'x_0' or 'v'), no learned variance and no
    self-conditioning, a zero-terminal-SNR schedule with
    ``zero_terminal_snr``, Min-SNR weighting with ``min_snr_gamma``. Both
    modules stay float32
    (the estimator holds the master weights; the train step casts both to
    ``compute_dtype``); the VAE is frozen, loaded from ``vae_ckpt`` where
    given. The diffusion runs on (z - ``latent_shift``) * ``latent_scale``."""
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline

    unet, vae, dev = _build_modules(p, device, seed, attention, attn_heads,
                                    vae_ckpt=vae_ckpt)
    return DiffusionPipeline(
        scheduler=build_scheduler(p, dev, zero_terminal_snr),
        noise_estimator=unet, latent_embedder=vae.eval().requires_grad_(False),
        estimator_objective=objective, classifier_free_guidance_dropout=p.cfg_dropout,
        do_input_centering=False, clip_x0=False, loss="l1", compute_dtype=compute_dtype,
        min_snr_gamma=min_snr_gamma, latent_scale=latent_scale, latent_shift=latent_shift)


def build_dataset(p: Preset, data_root: Optional[str], n_synthetic: int = 64, seed: int = 0):
    """The preset's training set under ``data_root`` (resized and centre
    cropped to the preset's size, with horizontal flips), or the synthetic
    set when there is no ``data_root`` or the preset has no dataset."""
    from medfusion_tpu_torch.data import (
        AIROGSDataset,
        CheXpert_2_Dataset,
        MSIvsMSS_2_Dataset,
        SyntheticDataset2D,
    )

    if p.dataset == "synthetic" or data_root is None:
        return SyntheticDataset2D(n=n_synthetic, image_size=p.image_size,
                                  channels=p.in_channels, num_classes=p.num_classes,
                                  seed=seed)
    common = dict(image_resize=p.image_size, image_crop=p.image_size,
                  augment_horizontal_flip=True)
    if p.dataset == "chexpert_2":
        return CheXpert_2_Dataset(data_root, **common)
    if p.dataset == "airogs":
        return AIROGSDataset(data_root, crawler_ext="jpg", **common)
    if p.dataset == "msivsmss_2":
        return MSIvsMSS_2_Dataset(data_root, crawler_ext="jpg", **common)
    raise ValueError(f"unknown dataset {p.dataset!r}")
