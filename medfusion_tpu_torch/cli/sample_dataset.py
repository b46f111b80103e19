"""Bulk sampling of evaluation sets with the PyTorch port.

The counterpart of ``medfusion_tpu/cli/sample_dataset.py``: for each step
count of ``--steps-list`` and each label (0 .. num_classes-1, or None for an
unconditional preset), sample ``--n-samples`` images in chunks of
``--chunk`` (guidance ``--guidance``, 1 by default, with
``un_cond = 1 - label``) and write ``<out>/steps_{s}/label_{l}/fake_{i}.png``
as uint8 ``(clip(x, -1, 1) + 1) * 127.5`` (grey for one channel), with the
port's own PNG writer. Every sampler of ``cli.sample`` is accepted
but the consistency sampler, as in the JAX CLI (``--sampler ddim|dpmpp|edm``,
``--encoder-key-every``, ``--zero-terminal-snr``, ``--timestep-spacing``,
``--guidance-rescale``); ``--estimator`` as in ``cli.sample``; DDIM and the fast sampler
run at eta 1, as the JAX package's bulk sampler does. ``--family flow
--flow-shift`` bulk-samples a flow-matching checkpoint with the Heun ODE
(its step counts not capped at T), and ``--classifier-ckpt`` guides DDIM
or DPM++ toward each chunk's label, as in ``cli.sample``; the refusals,
the kernel switches and the reference ``.ckpt`` files (``--ckpt``,
``--vae-ckpt``) are ``cli.sample``'s.

Seeding: the JAX CLI folds (steps, label, chunk) into its key; torch has no
``fold_in``, so each chunk draws from a ``torch.Generator`` seeded by
``np.random.SeedSequence([seed, steps, label_id, chunk_idx])``, with
``label_id = num_classes`` for the unconditional case, as in the JAX CLI.
The streams therefore differ from the JAX CLI's, and are as independent.

Each chunk is sampled over the ranks of a ('data', 'model') mesh with
``parallel/sampling.py::make_sharded_sampler``, as in the JAX CLI: it is
rounded down to a multiple of the world size (at least one row a rank),
each rank samples its rows with the whole chunk's noise (so the images do
not depend on the world size) and writes only those, under their global
indices ``fake_{written + row}.png``; nothing is gathered and no file is
written twice. Under ``torchrun`` there is one process a card (``--device
cuda``, NCCL) or a CPU process a rank (``--device cpu``, gloo); run alone it
is a world of one, whose group the CLI makes and destroys.

Usage:
  python -m medfusion_tpu_torch.cli.sample_dataset --preset chest --ckpt runs/diffusion \\
      --ema --vae-ckpt runs/ae --n-samples 7869 --chunk 200 --steps-list 50 100 150
  python -m torch.distributed.run --standalone --nproc_per_node 8 \\
      -m medfusion_tpu_torch.cli.sample_dataset --preset chest --chunk 256 ...
  python -m medfusion_tpu_torch.cli.sample_dataset --preset chest --sampler dpmpp \\
      --steps-list 25 --n-samples 8 --chunk 8
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
from medfusion_tpu_torch.cli.sample import (
    DTYPES,
    add_estimator_args,
    add_sampler_args,
    check_args,
    load_classifier_arg,
    load_unet_state,
    run_flags,
    sampling_steps,
    vae_source,
)
from medfusion_tpu_torch.data.png import write_png
from medfusion_tpu_torch.parallel import make_mesh, make_sharded_sampler
from medfusion_tpu_torch.parallel.mesh import axis_rank, axis_size


def to_uint8(imgs: np.ndarray) -> np.ndarray:
    """[-1, 1] images -> uint8, as the JAX bulk sampler converts them."""
    return ((np.clip(imgs, -1, 1) + 1) * 127.5).astype(np.uint8)


def chunk_generator(device, seed: int, steps: int, label_id: int, chunk_idx: int):
    state = np.random.SeedSequence([seed, steps, label_id, chunk_idx]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--ckpt", default=None,
                    help="a port diffusion run, or a reference Lightning .ckpt")
    ap.add_argument("--ema", action="store_true", help="--ckpt's EMA copy")
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run, an .npz of the JAX VAE's params, or a "
                         "reference Lightning .ckpt")
    ap.add_argument("--out", default="results/fake")
    ap.add_argument("--n-samples", type=int, default=7869)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--steps-list", type=int, nargs="+", default=[50, 100, 150, 200, 250])
    ap.add_argument("--guidance", type=float, default=1.0)
    ap.add_argument("--objective", choices=("x_T", "x_0", "v"), default="x_T")
    add_estimator_args(ap)
    ap.add_argument("--latent-scale", type=float, default=1.0)
    ap.add_argument("--latent-shift", type=float, default=0.0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_sampler_args(ap, consistency=False)
    args = ap.parse_args(argv)
    check_args(ap, args)
    if args.n_samples < 1 or args.chunk < 1:
        ap.error("--n-samples and --chunk must be >= 1")

    p = PRESETS[args.preset]
    if args.classifier_ckpt and not p.num_classes:
        # guiding everything toward class 0 would bias the set undetectably
        ap.error("classifier guidance needs a condition (the per-sample guidance "
                 "labels); the preset is unconditional")
    owns_group = not dist.is_initialized()
    try:
        return sample_dataset(args, p)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def sample_dataset(args, p):
    # the group first: under torchrun it picks this process's card
    mesh = make_mesh(n_model=1, device=args.device)
    n_data, rank = axis_size(mesh, "data"), axis_rank(mesh, "data")
    unet_state = None
    if args.ckpt:
        unet_state = load_unet_state(args.ckpt, args.ema, run_flags(args))
    pipe = build_pipeline(p, device=args.device, compute_dtype=DTYPES[args.dtype],
                          seed=args.seed, attention=args.attention,
                          attn_heads=args.attention_heads, unet_state=unet_state,
                          vae_ckpt=vae_source(args), objective=args.objective,
                          latent_scale=args.latent_scale, latent_shift=args.latent_shift,
                          zero_terminal_snr=args.zero_terminal_snr, family=args.family,
                          flow_shift=args.flow_shift, estimator=args.estimator)
    dev = pipe.device
    classifier = load_classifier_arg(args, p, dev)
    labels = list(range(p.num_classes)) if p.num_classes else [None]
    written_dirs = {}
    for steps in args.steps_list:
        steps = sampling_steps(args, p, steps)
        sampler = make_sharded_sampler(
            pipe, mesh, p.latent_shape, steps=steps, guidance_scale=args.guidance, eta=1.0,
            encoder_key_every=args.encoder_key_every,
            sampler="flow" if args.family == "flow" else args.sampler,
            flow_shift=args.flow_shift, classifier_apply=classifier,
            classifier_scale=args.classifier_scale, guidance_rescale=args.guidance_rescale,
            timestep_spacing=args.timestep_spacing, edm_churn=args.edm_churn,
            edm_rho=args.edm_rho)
        for label in labels:
            out_dir = Path(args.out) / f"steps_{steps}" / f"label_{label}"
            out_dir.mkdir(parents=True, exist_ok=True)
            label_id = label if label is not None else (p.num_classes or 0)
            written, chunk_idx, t0 = 0, 0, time.perf_counter()
            while written < args.n_samples:
                n = min(args.chunk, args.n_samples - written)
                n = max(n_data, (n // n_data) * n_data)  # divisible by the mesh
                cond = un_cond = None
                if label is not None:
                    cond = torch.full((n,), label, dtype=torch.long, device=dev)
                    un_cond = torch.full((n,), 1 - label, dtype=torch.long, device=dev)
                gen = chunk_generator(dev, args.seed, steps, label_id, chunk_idx)
                imgs = to_uint8(sampler(gen, n, cond, un_cond).float().cpu().numpy())
                first = written + rank * imgs.shape[0]
                for i, img in enumerate(imgs):
                    write_png(out_dir / f"fake_{first + i}.png",
                              img[..., 0] if img.shape[-1] == 1 else img)
                written += n
                chunk_idx += 1
            seconds = time.perf_counter() - t0
            if rank == 0:
                print(f"steps={steps} label={label}: {written} samples -> {out_dir} "
                      f"in {seconds:.3f} s ({n_data} rank{'s' if n_data > 1 else ''})")
            written_dirs[(steps, label)] = out_dir
    return written_dirs


if __name__ == "__main__":
    main()
