"""Sample images per condition with the PyTorch port.

For each condition in {0, 1} (and unconditioned), sample ``--n`` images with
150-step DDIM and classifier-free guidance 8, as ``medfusion_tpu.cli.sample``
does, and write them as ``.npy`` arrays ([n, H, W, C] float32) plus a PNG
grid written by ``data/png.py``.

Usage:
  python -m medfusion_tpu_torch.cli.sample --preset chest --n 8 \
      --ckpt runs/diffusion --ema --vae-ckpt runs/ae --out results/samples
  python -m medfusion_tpu_torch.cli.sample --preset chest --n 8 \
      [--attention spatial] [--attention-heads 8] \
      [--params weights.npz] [--dtype bf16] [--device cuda] --out results/samples

``--ckpt`` is a port diffusion run (or its ``checkpoints`` directory): the
UNet of its latest step, or with ``--ema`` that step's EMA copy. It must
have been trained with the ``--attention``, ``--attention-heads``,
``--objective``, ``--latent-scale`` and ``--latent-shift`` given here (its
``config.json`` is checked). ``--vae-ckpt`` is a port autoencoder run or an
``.npz`` of the JAX VAE's flax params.

``--attention`` is the UNet's ``use_attention`` config ('spatial' is the
reference's eye/colon attention config); on the card every attention and
transformer MLP runs through the hand-written kernels.

``--params`` is an ``.npz`` of the JAX package's flax params, keyed by the
flax paths joined by '/', with ``noise_estimator/`` and ``latent_embedder/``
prefixes. Without it the weights are a seeded random initialisation.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
from medfusion_tpu_torch.data.png import write_png
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.utils import checkpoint as C

DTYPES = {"bf16": torch.bfloat16, "f32": None}


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


def load_unet_state(path, ema: bool, flags: dict):
    """The UNet state dict of a port diffusion run's latest step (its EMA
    copy with ``ema``), after checking the run's config against ``flags``."""
    ckpt_dir = C.ckpt_dir_of(Path(path))
    C.check_config(ckpt_dir, flags, f"--ckpt {path}")
    state = C.load_payload(ckpt_dir)["state"]
    if ema and state["ema"] is None:
        raise SystemExit(f"--ema: the run under {path} was trained without --use-ema")
    return state["ema"] if ema else state["model"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--guidance", type=float, default=8.0)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--attention", choices=ATTENTION_TYPES, default="none",
                    help="UNet attention per the reference's use_attention "
                         "config: 'linear' = single-layer transformer, "
                         "'spatial' = SpatialTransformer")
    ap.add_argument("--attention-heads", type=int, default=8,
                    help="attention heads (reference geometry: 8); must "
                         "divide every attended level's width")
    ap.add_argument("--params", default=None, help="flax params .npz")
    ap.add_argument("--ckpt", default=None, help="a port diffusion run")
    ap.add_argument("--ema", action="store_true", help="--ckpt's EMA copy")
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run, or an .npz of the JAX VAE's params")
    ap.add_argument("--objective", choices=("x_T", "x_0", "v"), default="x_T")
    ap.add_argument("--latent-scale", type=float, default=1.0)
    ap.add_argument("--latent-shift", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/samples")
    args = ap.parse_args(argv)
    if args.attention_heads != 8 and args.attention == "none":
        ap.error("--attention-heads has no effect without attention layers; "
                 "add --attention spatial|linear")

    if args.ema and not args.ckpt:
        ap.error("--ema needs --ckpt")
    if args.params and (args.ckpt or args.vae_ckpt):
        ap.error("--params holds both networks; give it alone or --ckpt/--vae-ckpt")

    p = PRESETS[args.preset]
    unet_params = vae_params = unet_state = None
    if args.params:
        unet_params, vae_params = load_npz_params(args.params)
    if args.ckpt:
        unet_state = load_unet_state(args.ckpt, args.ema, {
            "attention": args.attention, "attention_heads": args.attention_heads,
            "objective": args.objective, "latent_scale": args.latent_scale,
            "latent_shift": args.latent_shift})
    pipe = build_pipeline(p, device=args.device, compute_dtype=DTYPES[args.dtype],
                          seed=args.seed, unet_params=unet_params,
                          vae_params=vae_params, attention=args.attention,
                          attn_heads=args.attention_heads, unet_state=unet_state,
                          vae_ckpt=args.vae_ckpt, objective=args.objective,
                          latent_scale=args.latent_scale, latent_shift=args.latent_shift)
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
