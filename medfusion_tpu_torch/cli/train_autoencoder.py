"""Train the latent embedder (the KL or VQ autoencoder), optionally
adversarially (VAEGAN / VQGAN), with the PyTorch port.

The counterpart of ``medfusion_tpu/cli/train_autoencoder.py``: the preset's
autoencoder (``--model vae``, or ``vqvae`` with a codebook of 8,192), the
pixel loss of the preset (MSE for chest) + (1 - SSIM) per image, the
deep-supervision heads, and 1e-6 x the KL (the VQVAE: its pyramid-weighted
means and 1 x the commitment loss); batch 8 for the chest preset. Without
``--gan``: Adam at the preset's lr, no weight decay. With ``--gan``: one
discriminator per pyramid level (``--disc conv``, the reference's
``Discriminator``, or ``patch``, its BatchNorm PatchGAN), the adaptive
lambda, both players on Adam at lr 1e-6, and the adversarial terms on after
``--start-gan-step`` optimizer steps (two a batch). ``--lr-schedule`` and
``--warmup-steps`` shape the lr of every optimizer. A checkpoint every
``--ckpt-every`` steps and at the end (the latest 5 kept, the best on the
batch's L1 pointed to and kept), the metrics in ``<out>/logs/metrics.jsonl``,
and every ``--sample-every`` steps a grid of sources above their
reconstructions in ``<out>/images``. Without ``--out`` nothing is written.

Step s draws its reparameterisation noise from a generator seeded by
(``--seed``, s), and ``--resume`` continues the data stream where the run
stopped (``train/loop.py``), so a resumed run equals an uninterrupted one.

Usage:
  python -m medfusion_tpu_torch.cli.train_autoencoder --preset chest \\
      --data-root /data/CheXpert --out runs/ae [--max-steps N] [--resume]
  python -m medfusion_tpu_torch.cli.train_autoencoder --preset chest \\
      --data-root /data/CheXpert --out runs/vaegan --gan [--disc patch]
  python -m medfusion_tpu_torch.cli.train_autoencoder --preset smoke \\
      --device cpu --max-steps 2 [--model vqvae] [--gan]

``--lpips`` adds the reference's LPIPS term (weight 1, pyramid depths below
2) with the VGG16 that ``cli.ingest_weights vgg16`` stored; without an
ingested VGG16 it is refused, not trained against a random backbone.

``--model diffusers_kl|diffusers_vq`` trains the vendored diffusers
AutoencoderKL / VQModel (``models/latent_embedders_diffusers.py``) with
their wrappers' losses, as the JAX CLI does: the L2 pixel loss without SSIM
and 1 x the KL or commitment loss; with ``--gan`` always one PatchGAN
(``--disc`` is ignored), the lambda taken at ``decoder.conv_out.weight``,
and the discriminator's terms on from half of ``--start-gan-step``.

Without ``--device cpu`` it runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.presets import (
    AE_KINDS,
    PRESETS,
    build_dataset,
    build_discriminators,
    build_vae,
    seeded,
)
from medfusion_tpu_torch.data import SimpleDataModule
from medfusion_tpu_torch.losses.lpips import frozen_lpips
from medfusion_tpu_torch.train import GANTrainState, TrainState, make_lr_schedule
from medfusion_tpu_torch.train.adversarial import (
    AdversarialTrainer,
    make_adversarial_train_step,
)
from medfusion_tpu_torch.train.autoencoder import (
    AutoencoderTrainer,
    make_autoencoder_train_step,
)
from medfusion_tpu_torch.train.loop import (
    SAMPLE_KEY,
    batch_stream,
    data_state,
    restore_data_state,
    step_generator,
)
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils import pretrained as P
from medfusion_tpu_torch.utils.logging import MetricsWriter, save_image_grid
from medfusion_tpu_torch.utils.resilience import run_with_auto_restore


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--data-root", default=None,
                    help="the preset's dataset root (default: synthetic data)")
    ap.add_argument("--out", default=None,
                    help="run directory (checkpoints, logs, images); none: write nothing")
    ap.add_argument("--model", choices=AE_KINDS, default="vae",
                    help="latent-embedder family: the in-house KL or VQ autoencoder, or "
                         "the diffusers AutoencoderKL / VQModel")
    ap.add_argument("--gan", action="store_true", help="adversarial (VAEGAN/VQGAN) training")
    ap.add_argument("--disc", choices=("conv", "patch"), default="conv",
                    help="discriminator: the conv stack (GroupNorm) or the PatchGAN "
                         "(BatchNorm); the diffusers models always take the PatchGAN")
    ap.add_argument("--start-gan-step", type=int, default=50000,
                    help="optimizer steps (two a batch) before the adversarial terms")
    ap.add_argument("--lpips", action="store_true",
                    help="the LPIPS perceptual term (needs ingested VGG16 weights)")
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--sample-every", type=int, default=1000, help="0 = off")
    ap.add_argument("--lr-schedule", choices=("const", "cosine", "lambda_linear"),
                    default="const")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--num-workers", type=int, default=0,
                    help="worker processes that read and transform the images "
                         "(0: in this process, in the JAX package's order)")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted for the JAX CLI's command lines, where it turns off "
                         "buffer donation; the port donates no buffers, so it changes "
                         "nothing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--auto-restart", type=int, default=0, metavar="N",
                    help="on a crash, restart up to N times from the latest checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.lpips and not P.artifact_path(P.VGG16).exists():
        ap.error(f"--lpips needs ingested VGG16 weights (none under {P.weights_dir()}); "
                 "run python -m medfusion_tpu_torch.cli.ingest_weights vgg16 --src "
                 "vgg16-397923af.pth first — training against a random backbone is "
                 "refused, not warned")
    if (args.resume or args.auto_restart) and args.out is None:
        ap.error("--resume and --auto-restart need --out")
    if args.auto_restart:
        return run_with_auto_restore(lambda resume: _train(args, args.resume or resume),
                                     max_restarts=args.auto_restart)
    return _train(args, args.resume)


def _train(args, resume: bool):
    p = PRESETS[args.preset]
    dev = resolve_device(args.device)
    batch_size = args.batch_size or p.ae_batch_size
    diffusers = args.model.startswith("diffusers")
    # the vendored diffusers VQGAN / VAEWrapper: one PatchGAN, no pyramid
    disc = "patch" if diffusers else args.disc
    with seeded(dev, args.seed):
        vae = build_vae(p, args.model)
        discs = (build_discriminators(p, disc, levels=1 if diffusers else None)
                 if args.gan else None)
    quantized = args.model in ("vqvae", "diffusers_vq")
    perceiver = None
    if args.lpips:
        perceiver = frozen_lpips(P.load_pretrained(P.VGG16), dev)
        print(f"LPIPS perceptual loss on (ingested weights, {P.artifact_path(P.VGG16)})")
    trainer = AutoencoderTrainer(
        vae, flavor="vqvae" if quantized else "vae",
        pixel_loss="l2" if diffusers else p.ae_loss, perceiver=perceiver,
        embedding_loss_weight=1.0 if quantized or diffusers else p.ae_embedding_loss_weight,
        use_ssim=not diffusers)
    schedule = make_lr_schedule(args.lr_schedule, args.warmup_steps, args.max_steps)
    if args.gan:
        # the reference's VAEGAN: lr 1e-6 for both players
        state = GANTrainState(vae, discs, lr=1e-6, lr_schedule=schedule)
        step_fn = make_adversarial_train_step(AdversarialTrainer(
            trainer, discs, start_gan_train_step=args.start_gan_step,
            start_disc_train_step=args.start_gan_step // 2 if diffusers else None))
    else:
        state = TrainState(vae, lr=p.ae_lr, weight_decay=0.0, lr_schedule=schedule)
        step_fn = make_autoencoder_train_step(trainer)
    ds = build_dataset(p, args.data_root, n_synthetic=max(batch_size * 4, 16), seed=args.seed)
    dm = SimpleDataModule(ds, batch_size=batch_size, seed=args.seed,
                          weights=ds.get_weights(), num_workers=args.num_workers)

    out = None if args.out is None else Path(args.out)
    ckpt_dir = None if out is None else out / "checkpoints"
    run_config = {"model": args.model, "gan": args.gan, "lpips": args.lpips,
                  "disc": disc if args.gan else None}
    if resume and C.latest_step(ckpt_dir) is not None:
        C.check_config(ckpt_dir, run_config, "--resume")
        restore_data_state(ds, C.restore_checkpoint(ckpt_dir, state))
        print(f"resumed from step {C.latest_step(ckpt_dir)}")
    writer = None if out is None else MetricsWriter(out / "logs")

    losses = []
    step, t0 = (state.gen if args.gan else state).step, time.time()
    stream = batch_stream(dm, step)
    try:
        while step < args.max_steps:
            batch = next(stream)
            source = torch.from_numpy(batch["source"]).to(dev)
            noise = None if quantized else torch.randn(
                (batch_size, *p.latent_shape), generator=step_generator(dev, args.seed, step),
                device=dev)
            metrics = step_fn(state, {"source": source}, noise)
            losses.append(metrics["loss"])
            step += 1
            if step % 50 == 0 or step == 1:
                if writer is not None:
                    writer.log_scalars(step, metrics)
                print(f"step {step} loss {float(metrics['loss']):.4f} "
                      f"({time.time() - t0:.1f}s)")
            if ckpt_dir is not None and (step % args.ckpt_every == 0 or step == args.max_steps):
                C.save_checkpoint(ckpt_dir, state, step,
                                  config={**dataclasses.asdict(p), **run_config},
                                  keep_top_k=5, extra=data_state(ds))
                C.save_best_checkpoint(ckpt_dir, step, float(metrics["L1"]), state=state)
            if out is not None and args.sample_every and step % args.sample_every == 0:
                save_reconstructions(trainer, source, p, args.seed, step,
                                     out / "images" / f"sample_{step}.png")
    finally:
        stream.close()
        if writer is not None:
            writer.close()
    print(f"done: {step} steps" + ("" if ckpt_dir is None else f" -> {ckpt_dir}"))
    return state, [float(v) for v in losses]


@torch.no_grad()
def save_reconstructions(trainer, source, p, seed: int, step: int, path) -> None:
    """Up to 8 sources above their reconstructions by ``trainer``'s
    autoencoder (the generator of a GAN run), as one PNG grid."""
    dev = source.device
    x = source[:8].movedim(-1, 1).contiguous()
    noise = None if trainer.flavor == "vqvae" else torch.randn(
        (x.shape[0], p.latent_shape[2], *p.latent_shape[:2]),
        generator=step_generator(dev, seed, SAMPLE_KEY, step), device=dev)
    pred, _, _ = trainer.forward(x, noise)
    grid = torch.cat([x, pred]).movedim(1, -1).float().cpu().numpy()
    save_image_grid(np.asarray(grid), path, nrow=x.shape[0])


if __name__ == "__main__":
    main()
