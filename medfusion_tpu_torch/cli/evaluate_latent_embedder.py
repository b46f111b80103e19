"""Autoencoder reconstruction quality: 1-LPIPS, MS-SSIM and MSE (port of
``medfusion_tpu/cli/evaluate_latent_embedder.py``).

The reference's script: the preset's images (``--data-root``, or synthetic
data) in batches of ``--batch-size`` through the VAE's encode and decode
(:func:`roundtrip`), per image LPIPS against the input, MS-SSIM of
clip((pred + 1) / 2) against (x + 1) / 2, and MSE; reported as mean and
std (LPIPS as 1 - mean), with JAX's result keys. Each batch's encoder draw
comes from one generator seeded by ``--seed``.

The VAE is a port autoencoder run (``--vae-ckpt``, as ``cli.train_diffusion``
loads it: plain or adversarial, or an ``.npz`` of the JAX VAE's params), or
a seeded random one. VGG16: ``--vgg-weights`` (an ``.npz``, torchvision or
the JAX package's converted keys), else the ingested artifact
(``cli.ingest_weights vgg16``), else a random backbone, with a warning.

Usage:
  python -m medfusion_tpu_torch.cli.evaluate_latent_embedder --preset chest \\
      --data-root /data/CheXpert --vae-ckpt runs/ae [--vgg-weights w.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.helpers import latent_roundtrip
from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset, load_vae, seeded
from medfusion_tpu_torch.data import SimpleDataModule
from medfusion_tpu_torch.losses import ms_ssim
from medfusion_tpu_torch.losses.lpips import LPIPS, frozen_lpips, load_vgg16_npz
from medfusion_tpu_torch.utils import pretrained as P

WARNING = ("WARNING: no pretrained VGG16 — LPIPS uses a random backbone (valid metric, "
           "NOT comparable to published numbers; ingest via cli.ingest_weights vgg16)")


@torch.no_grad()
def roundtrip(vae, lpips: LPIPS, x: torch.Tensor, noise: torch.Tensor):
    """(LPIPS, MS-SSIM, MSE), each [B], of NCHW images ``x`` in [-1, 1] and
    their reconstruction through ``vae`` with the encoder draw ``noise``."""
    _, pred = latent_roundtrip(vae, x, noise)
    lp = lpips(pred, x).reshape(-1)
    ms = ms_ssim(torch.clamp((pred + 1) / 2, 0, 1), (x + 1) / 2, size_average=False)
    mse = ((pred - x) ** 2).mean(dim=tuple(range(1, x.ndim)))
    return lp, ms, mse


def load_vgg_state(vgg_weights: Optional[str] = None):
    """The VGG16 state dict to use (``--vgg-weights``, else the ingested
    artifact), or None with the warning printed."""
    if vgg_weights:
        return load_vgg16_npz(vgg_weights)
    ingested = P.load_pretrained(P.VGG16)
    if ingested is not None:
        print(f"using ingested VGG16 weights from {P.artifact_path(P.VGG16)}")
    else:
        print(WARNING)
    return ingested


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--vae-ckpt", default=None)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--max-batches", type=int, default=0, help="0 = all")
    ap.add_argument("--vgg-weights", default=None, help=".npz of VGG16 weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    dev = resolve_device(args.device)
    vae = load_vae(p, dev, args.seed, args.vae_ckpt)
    with seeded(dev, args.seed):
        lpips = frozen_lpips(load_vgg_state(args.vgg_weights), dev)
    ds = build_dataset(p, args.data_root, n_synthetic=max(args.batch_size, 16), seed=args.seed)
    dm = SimpleDataModule(ds, ds_test=ds, batch_size=args.batch_size, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    lps, mss, mses = [], [], []
    for i, batch in enumerate(dm.test_dataloader()):
        x = torch.from_numpy(batch["source"]).to(dev).movedim(-1, 1).contiguous()
        noise = torch.randn((x.shape[0], p.emb_channels, *p.latent_shape[:2]), generator=gen,
                            device=dev)
        for acc, v in zip((lps, mss, mses), roundtrip(vae, lpips, x, noise)):
            acc.append(v.cpu().numpy())
        if args.max_batches and i + 1 >= args.max_batches:
            break
    lp, ms, mse = (np.concatenate(a) for a in (lps, mss, mses))
    result = {"1-LPIPS_mean": float(1 - lp.mean()), "LPIPS_std": float(lp.std()),
              "MS-SSIM_mean": float(ms.mean()), "MS-SSIM_std": float(ms.std()),
              "MSE_mean": float(mse.mean()), "MSE_std": float(mse.std()),
              "n": int(lp.shape[0])}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
