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


AE_KINDS = ("vae", "vqvae", "diffusers_kl", "diffusers_vq")


def build_vae(p: Preset, kind: str = "vae", **options):
    """The latent embedder by kind at the preset's widths: 'vae' (KL) or
    'vqvae' (a codebook of 8,192, beta 0.25) of the in-house family, or
    'diffusers_kl' / 'diffusers_vq' (the vendored AutoencoderKL / VQModel:
    ``block_out_channels`` the preset's VAE widths, one resnet a level,
    GroupNorms of 32 groups or half the narrowest width, 8,192 codes), as
    the JAX package's ``build_vae``; ``options`` override the in-house
    family's other arguments (``learnable_interpolation``, ``dropout``),
    which no CLI sets."""
    if kind not in AE_KINDS:
        raise ValueError(f"unknown latent embedder {kind!r}; expected one of {AE_KINDS}")
    if kind.startswith("diffusers"):
        from medfusion_tpu_torch.models.latent_embedders_diffusers import (
            AutoencoderKLDiffusers,
            VQModelDiffusers,
        )

        groups = 32 if min(p.vae_hid_chs) >= 32 else min(p.vae_hid_chs) // 2
        common = dict(in_channels=p.in_channels, out_channels=p.in_channels,
                      emb_channels=p.emb_channels, block_out_channels=p.vae_hid_chs,
                      layers_per_block=1, norm_num_groups=groups)
        if options:
            raise ValueError(f"{kind} takes no options, got {sorted(options)}")
        if kind == "diffusers_vq":
            return VQModelDiffusers(num_embeddings=8192, **common)
        return AutoencoderKLDiffusers(**common)
    from medfusion_tpu_torch.models.latent_embedders import VAE, VQVAE

    n_groups = 8 if min(p.vae_hid_chs) >= 8 else min(p.vae_hid_chs)
    n = len(p.vae_hid_chs)
    common = dict(in_channels=p.in_channels, out_channels=p.in_channels,
                  emb_channels=p.emb_channels, hid_chs=p.vae_hid_chs,
                  kernel_sizes=(3,) * n, strides=(1,) + (2,) * (n - 1),
                  deep_supervision=p.ae_deep_supervision,
                  norm_name=("GROUP", {"num_groups": n_groups, "affine": True}), **options)
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


def build_discriminators(p: Preset, disc: str = "conv", levels: Optional[int] = None):
    """One discriminator for each pyramid level of the preset's autoencoder
    (``ae_deep_supervision + 1``, or ``levels``), in an ``nn.ModuleList``:
    'conv', the reference's ``Discriminator``, or 'patch', its
    ``NLayerDiscriminator``, each at its own default widths."""
    import torch.nn as nn

    from medfusion_tpu_torch.models.latent_embedders import (
        Discriminator,
        NLayerDiscriminator,
    )

    cls = {"conv": Discriminator, "patch": NLayerDiscriminator}[disc]
    n = p.ae_deep_supervision + 1 if levels is None else levels
    return nn.ModuleList([cls(in_channels=p.in_channels, spatial_dims=2) for _ in range(n)])


ESTIMATORS = ("unet", "unet_legacy", "openai", "lucidrains", "dit")
PORTED_ESTIMATORS = ESTIMATORS
# the families with a ``remat`` option (cli.train_diffusion --remat)
REMAT_ESTIMATORS = ("unet", "openai")


def estimator_refusal(estimator: str, attention: str = "none",
                      attn_heads: int = 8) -> Optional[str]:
    """Why ``estimator`` with these attention options cannot be built, or
    None: the JAX package's own refusals (``attention`` configures the
    unet and unet_legacy families only, ``attn_heads`` the 'unet' family
    only)."""
    if estimator not in ESTIMATORS:
        return f"unknown estimator {estimator!r}; expected one of {ESTIMATORS}"
    if attention != "none" and estimator not in ("unet", "unet_legacy"):
        return (f"attention={attention!r} only configures the unet/unet_legacy "
                f"families; estimator {estimator!r} fixes its own attention")
    if attn_heads != 8 and estimator != "unet":
        return (f"attn_heads={attn_heads} is a unet-family option; {estimator!r} pins "
                f"the reference head geometry")
    return None


def dit_sizing(p: Preset) -> dict:
    """The JAX CLI's DiT for a preset: hidden sized off the top UNet width
    (a multiple of 16, at least 64), heads of width 64 (at least 4, and
    dividing hidden), depth 3 per UNet level, patch 2. Chest: hidden 1,024,
    16 heads, depth 12."""
    hidden = max(64, (p.unet_hid_chs[-1] // 16) * 16)
    heads = max(4, hidden // 64)
    while hidden % heads:
        heads -= 1
    return dict(in_ch=p.emb_channels, patch_size=2, hidden_size=hidden,
                depth=max(2, len(p.unet_hid_chs) * 3), num_heads=heads,
                cond_emb_num_classes=p.num_classes)


def _width_multiples(p: Preset, estimator: str) -> int:
    mc = p.unet_hid_chs[0]
    if any(c % mc for c in p.unet_hid_chs):
        raise ValueError(f"the {estimator} estimator needs hid_chs that are multiples of "
                         f"hid_chs[0], got {p.unet_hid_chs}")
    return mc


def build_unet(p: Preset, estimator: str = "unet", attention: str = "none",
               attn_heads: int = 8, **options):
    """The noise estimator by family, sized as the JAX package's
    ``build_unet``: 'unet' (the reference 'unet2'), 'unet_legacy' (the
    reference's estimators/unet.py, with the unet family's widths),
    'openai' (the SD/ADM UNet: model channels hid_chs[0], channel_mult
    hid_chs / hid_chs[0], 2 res blocks, no attention resolutions, 8 heads,
    scale-shift norm, resblock up/down, 32 GroupNorm groups or half the
    narrowest width), 'lucidrains' (dim hid_chs[0], dim_mults as openai's,
    8 groups, unconditional), or 'dit', the Diffusion Transformer at
    :func:`dit_sizing`. ``attention`` is the unet and unet_legacy families'
    ``use_attention`` ('none' | 'linear' | 'spatial'; 'spatial' is the
    eye/colon attention config) and ``attn_heads`` the unet family's head
    count (:func:`estimator_refusal`); ``options`` override the estimator's
    other arguments (the UNets' ``deep_supervision``,
    ``estimate_variance``, ``use_self_conditioning``, ``dropout``,
    ``remat``; the DiT's ``learn_sigma``, ``use_self_conditioning`` and
    ``moe_*``), which the CLIs leave at the preset's."""
    why = estimator_refusal(estimator, attention, attn_heads)
    if why is not None:
        raise ValueError(why)
    if estimator == "dit":
        from medfusion_tpu_torch.models.dit import DiT

        return DiT(**{**dit_sizing(p), **options})
    if estimator == "openai":
        from medfusion_tpu_torch.models.unet_openai import UNetOpenAI

        mc = _width_multiples(p, estimator)
        groups = 32 if min(p.unet_hid_chs) >= 32 else min(p.unet_hid_chs) // 2
        kw = dict(in_channels=p.emb_channels, model_channels=mc,
                  out_channels=p.emb_channels,
                  channel_mult=tuple(c // mc for c in p.unet_hid_chs), num_res_blocks=2,
                  attention_resolutions=(), num_classes=p.num_classes, num_heads=8,
                  use_scale_shift_norm=True, resblock_updown=True, norm_groups=groups)
        return UNetOpenAI(**{**kw, **options})
    if estimator == "lucidrains":
        from medfusion_tpu_torch.models.unet_lucidrains import UNetLucidrains

        mc = _width_multiples(p, estimator)
        kw = dict(dim=mc, dim_mults=tuple(c // mc for c in p.unet_hid_chs),
                  channels=p.emb_channels, resnet_block_groups=8 if mc >= 8 else mc // 2)
        return UNetLucidrains(**{**kw, **options})

    n = len(p.unet_hid_chs)
    n_groups = 32 if min(p.unet_hid_chs) >= 32 else min(p.unet_hid_chs) // 2
    kw = dict(in_ch=p.emb_channels, out_ch=p.emb_channels,
              hid_chs=p.unet_hid_chs, kernel_sizes=(3,) * n,
              strides=(1,) + (2,) * (n - 1), time_emb_dim=p.unet_hid_chs[-1],
              cond_emb_num_classes=p.num_classes, deep_supervision=0,
              use_attention=attention,
              norm_name=("GROUP", {"num_groups": n_groups, "affine": True}))
    if estimator == "unet_legacy":
        from medfusion_tpu_torch.models.unet_legacy import UNetLegacy

        return UNetLegacy(**{**kw, **options})
    from medfusion_tpu_torch.models.unet import UNet

    return UNet(**{**kw, "attn_heads": attn_heads, "use_res_block": True, **options})


def build_scheduler(p: Preset, device="cpu", zero_terminal_snr: bool = False):
    """The preset's schedule; ``zero_terminal_snr`` rescales it to abar_T = 0."""
    from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule

    return GaussianDiffusionSchedule.create(
        timesteps=p.timesteps, schedule_strategy=p.schedule,
        beta_start=p.beta_start, beta_end=p.beta_end, device=device,
        zero_terminal_snr=zero_terminal_snr)


def _build_modules(p: Preset, device, seed, attention, attn_heads, unet_params=None,
                   vae_params=None, unet_state=None, vae_ckpt=None, estimator="unet",
                   **options):
    """(estimator, VAE, device): the modules on ``device``, with a seeded
    torch initialisation, then the JAX package's flax params (nested numpy
    dicts) or a state dict of the estimator (the port's, or a reference
    checkpoint's, ``utils/torch_compat.py::load_strict``), and a VAE
    checkpoint (``utils/checkpoint.py::restore_ae_params``) where given,
    each loaded with ``strict=True``."""
    from medfusion_tpu_torch.utils.checkpoint import restore_ae_params
    from medfusion_tpu_torch.utils.torch_compat import load_strict
    from medfusion_tpu_torch.utils.weights import load_jax_params

    dev = resolve_device(device)
    with seeded(dev, seed):
        unet = build_unet(p, estimator, attention=attention, attn_heads=attn_heads,
                          **options)
        vae = build_vae(p)
    if unet_params is not None:
        load_jax_params(unet, unet_params, kind=estimator)  # each family's converter
    if vae_params is not None:
        load_jax_params(vae, vae_params, kind="vae")
    if unet_state is not None:
        load_strict(unet, unet_state)
    if vae_ckpt is not None:
        restore_ae_params(vae_ckpt, vae)
    return unet, vae, dev


def build_pipeline(p: Preset, device=None, compute_dtype=None, seed: int = 0,
                   unet_params=None, vae_params=None, attention: str = "none",
                   attn_heads: int = 8, unet_state=None, vae_ckpt=None,
                   objective: str = "x_T", latent_scale: float = 1.0,
                   latent_shift: float = 0.0, zero_terminal_snr: bool = False,
                   family: str = "diffusion", flow_shift: float = 1.0,
                   estimator: str = "unet"):
    """Sampling pipeline as ``medfusion_tpu/cli/sample.py`` builds it (no
    x0 clipping; ``objective`` the estimator's, eps by default; a
    zero-terminal-SNR schedule with ``zero_terminal_snr``; with ``family``
    'flow' a flow-matching pipeline whose grid is shifted by
    ``flow_shift``), on ``device`` (default ``cuda``; raises without CUDA),
    with both modules cast to ``compute_dtype``. Weights are a seeded torch
    initialisation, or what :func:`_build_modules` loads. ``estimator``,
    ``attention`` and ``attn_heads`` choose the estimator
    (:func:`build_unet`); the model runs on (z - ``latent_shift``) *
    ``latent_scale``."""
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline

    unet, vae, dev = _build_modules(p, device, seed, attention, attn_heads,
                                    unet_params, vae_params, unet_state, vae_ckpt,
                                    estimator)
    if compute_dtype is not None:
        unet.to(compute_dtype)
        vae.to(compute_dtype)
    if family == "flow":
        return FlowMatchingPipeline(noise_estimator=unet.eval(), latent_embedder=vae.eval(),
                                    do_input_centering=False, shift=flow_shift,
                                    compute_dtype=compute_dtype, latent_scale=latent_scale,
                                    latent_shift=latent_shift)
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
                         min_snr_gamma: Optional[float] = None,
                         family: str = "diffusion", flow_shift: float = 1.0,
                         time_sampling: str = "logit_normal", estimator: str = "unet",
                         remat: bool = False):
    """Training pipeline as ``medfusion_tpu/cli/train_diffusion.py`` builds
    it: CFG dropout ``p.cfg_dropout``, no input centering, no x0 clipping,
    L1 loss, ``objective`` ('x_T', 'x_0' or 'v'), no learned variance and no
    self-conditioning, a zero-terminal-SNR schedule with
    ``zero_terminal_snr``, Min-SNR weighting with ``min_snr_gamma``; with
    ``family`` 'flow' the flow-matching pipeline (L2 on the velocity, time
    drawn by ``time_sampling`` and shifted by ``flow_shift``); ``estimator``
    any family of :func:`build_unet`, with ``remat`` (gradient
    checkpointing) where the family has it (``REMAT_ESTIMATORS``; ignored
    elsewhere, as the JAX CLI ignores it). Both modules stay float32
    (the estimator holds the master weights; the train step casts both to
    ``compute_dtype``); the VAE is frozen, loaded from ``vae_ckpt`` where
    given. The model runs on (z - ``latent_shift``) * ``latent_scale``."""
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline

    options = {"remat": True} if remat and estimator in REMAT_ESTIMATORS else {}
    unet, vae, dev = _build_modules(p, device, seed, attention, attn_heads,
                                    vae_ckpt=vae_ckpt, estimator=estimator, **options)
    if family == "flow":
        return FlowMatchingPipeline(
            noise_estimator=unet, latent_embedder=vae.eval().requires_grad_(False),
            classifier_free_guidance_dropout=p.cfg_dropout, do_input_centering=False,
            compute_dtype=compute_dtype, timestep_sampling=time_sampling, shift=flow_shift,
            latent_scale=latent_scale, latent_shift=latent_shift)
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
