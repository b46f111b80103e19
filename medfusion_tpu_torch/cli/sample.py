"""Sample images per condition with the PyTorch port.

For each condition in {0, 1} (and unconditioned), sample ``--n`` images with
150-step DDIM and classifier-free guidance 8, as ``medfusion_tpu.cli.sample``
does, and write them as ``.npy`` arrays ([n, H, W, C] float32) plus a PNG
grid written with the standard library's zlib.

Usage:
  python -m medfusion_tpu_torch.cli.sample --preset chest --n 8 \
      [--params weights.npz] [--dtype bf16] [--device cuda] --out results/samples

``--params`` is an ``.npz`` of the JAX package's flax params, keyed by the
flax paths joined by '/', with ``noise_estimator/`` and ``latent_embedder/``
prefixes. Without it the weights are a seeded random initialisation.
"""

from __future__ import annotations

import argparse
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

DTYPES = {"bf16": torch.bfloat16, "f32": None}


def write_png(path: Path, img: np.ndarray) -> None:
    """[H, W, 3] uint8 -> RGB PNG, written with zlib only."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, 6))
                     + chunk(b"IEND", b""))


def image_grid(imgs: np.ndarray) -> np.ndarray:
    """[n, H, W, 3] in [-1, 1] -> one uint8 row-major grid image."""
    n, h, w, c = imgs.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i, im in enumerate(imgs):
        r, q = divmod(i, cols)
        grid[r * h:(r + 1) * h, q * w:(q + 1) * w] = im
    return np.clip((grid + 1.0) * 127.5, 0, 255).astype(np.uint8)


def load_npz_params(path):
    from medfusion_tpu_torch.utils.weights import unflatten_npz

    with np.load(path) as f:
        tree = unflatten_npz({k: f[k] for k in f.files})
    return tree["noise_estimator"], tree["latent_embedder"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--guidance", type=float, default=8.0)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--params", default=None, help="flax params .npz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/samples")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    unet_params = vae_params = None
    if args.params:
        unet_params, vae_params = load_npz_params(args.params)
    pipe = build_pipeline(p, device=args.device, compute_dtype=DTYPES[args.dtype],
                          seed=args.seed, unet_params=unet_params,
                          vae_params=vae_params)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    steps = min(args.steps, p.timesteps)
    results = {}
    for cond_val in ([0, 1, None] if p.num_classes else [None]):
        cond = (None if cond_val is None else
                torch.full((args.n,), cond_val, dtype=torch.long, device=pipe.device))
        # the same noise for every condition
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
        gs = args.guidance if cond_val is not None else 1.0
        imgs = pipe.sample(args.n, p.latent_shape, condition=cond, generator=gen,
                           steps=steps, guidance_scale=gs, eta=args.eta)
        results[cond_val] = imgs.float().cpu().numpy()
        np.save(out / f"sample_cond_{cond_val}.npy", results[cond_val])
        write_png(out / f"sample_cond_{cond_val}.png", image_grid(results[cond_val]))
        print(f"condition={cond_val}: wrote {out}/sample_cond_{cond_val}.npy/.png")
    if 0 in results and 1 in results:
        diff = np.abs(results[0] - results[1]) - 1.0
        write_png(out / "sample_diff.png", image_grid(diff))
    return results


if __name__ == "__main__":
    main()
