"""Train the latent diffusion model with the PyTorch port.

The counterpart of ``medfusion_tpu/cli/train_diffusion.py``: the preset's
dataset under ``--data-root`` (weighted as the JAX package weights it) or
synthetic data, a frozen VAE (``--vae-ckpt``: a port autoencoder run, an
``.npz`` of the JAX VAE's flax params, or a reference Lightning ``.ckpt``;
else a seeded random VAE), the UNet,
T=1000 scaled-linear schedule, CFG dropout 0.5, L1 loss, AdamW (lr 1e-4,
weight decay 0.01) over the UNet only, optional EMA, batch 32 for the chest
preset. ``--bf16`` trains with bf16 compute and float32 master weights,
optimizer state and loss. A checkpoint every ``--ckpt-every`` steps and at
the end (the latest 2 kept, the best on the loss pointed to and kept), the
metrics in ``<out>/logs/metrics.jsonl``, and every ``--sample-every``
steps 4 images of a 50-step DDIM sample from the EMA (or the model) in
``<out>/images``. Without ``--out`` nothing is written.

``--estimator`` picks the noise estimator, sized off the preset as the JAX
CLI sizes it (``cli/presets.py::build_unet``), in either family: ``unet``
(the reference's unet2), ``unet_legacy`` (one down and up block a level;
takes ``--attention`` too), ``openai`` (the SD/ADM UNet, scale-shift norm
and resblock up/down; its middle block attends through the token-layout
flash kernels), ``lucidrains`` (the compact DDPM UNet, unconditional: the
labels are ignored) or ``dit`` (the Diffusion Transformer: hidden 1,024, 16
heads, depth 12, patch 2 for the chest preset; its attention runs the
token-layout flash kernels forward and backward). ``--attention`` is
refused but for unet and unet_legacy, ``--attention-heads`` but for unet,
as the JAX package does. ``--remat`` recomputes the estimator's blocks in
the backward (gradient checkpointing: the unet family's conv blocks, the
openai family's res and attention blocks) to save activation memory; the
other families have no such option and ignore it, as the JAX CLI does.

Step s draws from a generator seeded by (``--seed``, s), and ``--resume``
continues the data stream where the run stopped (``train/loop.py``), so a
resumed run equals an uninterrupted one. ``--resume`` refuses a run saved
with another ``--use-ema``, ``--objective``, ``--estimator``, ``--attention``,
``--attention-heads``, ``--zero-terminal-snr``, ``--min-snr-gamma``,
``--family`` or ``--grain``. A batch label outside the preset's classes
raises on the host.

``--zero-terminal-snr`` rescales the schedule to abar_T = 0
(arXiv:2305.08891; needs ``--objective v`` or ``x_0``; sample with
``cli.sample --zero-terminal-snr``, trailing spacing by default);
``--min-snr-gamma`` weights each sample's loss by Min-SNR-gamma
(arXiv:2303.09556). Self-conditioning, a learned variance and
deep-supervision terms are options of ``DiffusionPipeline`` and the UNet,
as in the JAX package, which gives them no flags either.

``--family flow`` trains the flow-matching family on the same UNet and VAE
(``pipelines/flow.py``: L2 on the velocity, time drawn by
``--time-sampling``, logit-normal by default, and shifted by
``--flow-shift``); its ``--sample-every`` grids are 25-step Heun samples.
It refuses ``--zero-terminal-snr``, ``--min-snr-gamma`` and an
``--objective`` other than ``x_T``, as the JAX CLI does. Sample it with
``cli.sample --family flow``.

Usage:
  python -m medfusion_tpu_torch.cli.train_diffusion --preset chest \\
      --data-root /data/CheXpert --vae-ckpt runs/ae --out runs/diffusion \\
      --bf16 --use-ema
  python -m medfusion_tpu_torch.cli.train_diffusion --preset smoke \\
      --device cpu --max-steps 2

Without ``--device cpu`` it runs on the card and raises when there is none.
On the card every self-attention runs its forward and backward through the
hand-written kernels. The kernel switches (``--flash``, ``--fused-geglu``,
``--fused-up``, ``--s2d-tail``) follow the JAX CLI's rules
(``cli/kernels.py``); ``--no-flash`` and ``--no-fused-geglu`` are refused
on the card.

``--grain`` reads the data in the order of the JAX CLI's grain loader
(``data/grain_loader.py``): epoch e a permutation seeded by ``--seed`` +
e, the dataset's weights ignored, full batches only; a resumed run
continues the epoch. ``--no-donate`` is accepted for the JAX CLI's command
lines and changes nothing: the port donates no buffers.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from medfusion_tpu_torch.cli.kernels import add_kernel_args, resolve_kernel_flags
from medfusion_tpu_torch.cli.presets import (
    ESTIMATORS,
    PRESETS,
    build_dataset,
    build_train_pipeline,
    estimator_refusal,
)
from medfusion_tpu_torch.data import GrainDataModule, SimpleDataModule
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step, make_lr_schedule
from medfusion_tpu_torch.train.loop import (
    SAMPLE_KEY,
    batch_stream,
    check_labels,
    data_state,
    restore_data_state,
    step_generator,
)
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.logging import MetricsWriter, save_image_grid
from medfusion_tpu_torch.utils.resilience import run_with_auto_restore

# what --resume must find unchanged in the saved config
RESUME_KEYS = ("use_ema", "objective", "estimator", "attention", "attention_heads",
               "zero_terminal_snr", "min_snr_gamma", "family", "grain")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--data-root", default=None,
                    help="the preset's dataset root (default: synthetic data)")
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run (or its checkpoints directory), an "
                         ".npz of the JAX VAE's flax params, or a reference Lightning "
                         ".ckpt")
    ap.add_argument("--out", default=None,
                    help="run directory (checkpoints, logs, images); none: write nothing")
    ap.add_argument("--estimator", choices=ESTIMATORS, default="unet",
                    help="noise-estimator family: unet (the reference's unet2), "
                         "unet_legacy, openai (the SD/ADM UNet), lucidrains (the compact "
                         "DDPM UNet, unconditional) or dit (Diffusion Transformer, "
                         "arXiv:2212.09748)")
    ap.add_argument("--remat", action="store_true",
                    help="gradient checkpointing: recompute the unet family's conv blocks "
                         "or the openai family's res and attention blocks in the "
                         "backward; ignored by the other families, which have no such "
                         "option")
    ap.add_argument("--attention", choices=ATTENTION_TYPES, default="none")
    ap.add_argument("--attention-heads", type=int, default=8)
    add_kernel_args(ap, attention=False)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=200000)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--sample-every", type=int, default=0, help="0 = off")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 estimator forward/backward, float32 master "
                         "weights, optimizer state and loss")
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--objective", choices=("x_T", "x_0", "v"), default="x_T")
    ap.add_argument("--family", choices=("diffusion", "flow"), default="diffusion",
                    help="flow = rectified-flow / flow-matching training, sampled "
                         "with the Heun probability-flow ODE (cli.sample --family flow)")
    ap.add_argument("--flow-shift", type=float, default=1.0,
                    help="SD3 timestep shift of the training draw and the default "
                         "sampling grid (flow family only)")
    ap.add_argument("--time-sampling", choices=("uniform", "logit_normal"),
                    default="logit_normal",
                    help="flow-family training time distribution")
    ap.add_argument("--zero-terminal-snr", action="store_true",
                    help="rescale the schedule so that abar_T = 0 exactly "
                         "(arXiv:2305.08891); needs --objective v or x_0")
    ap.add_argument("--min-snr-gamma", type=float, default=None,
                    help="Min-SNR-gamma loss weighting (arXiv:2303.09556; the "
                         "paper's default is 5); off when unset")
    ap.add_argument("--latent-scale", type=float, default=1.0,
                    help="the diffusion runs on (z - shift) * scale")
    ap.add_argument("--latent-shift", type=float, default=0.0)
    ap.add_argument("--lr-schedule", choices=("const", "cosine", "lambda_linear"),
                    default="const")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--num-workers", type=int, default=0,
                    help="worker processes that read and transform the images "
                         "(0: in this process, in the JAX package's order)")
    ap.add_argument("--grain", action="store_true",
                    help="the JAX CLI's grain order: epoch e a uniform permutation "
                         "seeded by --seed + e (the dataset's weights ignored)")
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
    why = estimator_refusal(args.estimator, args.attention, args.attention_heads)
    if why is not None:
        ap.error(why)
    resolve_kernel_flags(args, ap)
    if args.family == "flow":
        if args.zero_terminal_snr or args.min_snr_gamma is not None:
            ap.error("--zero-terminal-snr/--min-snr-gamma are diffusion-schedule "
                     "options; the flow family has no schedule")
        if args.objective != "x_T":
            ap.error("--objective selects a diffusion parameterization; the flow "
                     "family always trains the velocity objective")
    if args.zero_terminal_snr and args.objective == "x_T":
        ap.error("--zero-terminal-snr cannot train the eps ('x_T') objective: x_0 "
                 "is unrecoverable from eps at abar_T = 0; use --objective v or x_0")
    if (args.resume or args.auto_restart) and args.out is None:
        ap.error("--resume and --auto-restart need --out")
    if args.auto_restart:
        return run_with_auto_restore(lambda resume: _train(args, args.resume or resume),
                                     max_restarts=args.auto_restart)
    return _train(args, args.resume)


def run_config(p, args) -> dict:
    return {**dataclasses.asdict(p), "use_ema": args.use_ema, "objective": args.objective,
            "estimator": args.estimator, "attention": args.attention, "attention_heads": args.attention_heads,
            "zero_terminal_snr": args.zero_terminal_snr,
            "min_snr_gamma": args.min_snr_gamma,
            "latent_scale": args.latent_scale, "latent_shift": args.latent_shift,
            "family": args.family, "flow_shift": args.flow_shift,
            "time_sampling": args.time_sampling, "remat": args.remat, "grain": args.grain}


def _train(args, resume: bool):
    """Returns (state, losses, pipeline)."""
    p = PRESETS[args.preset]
    batch_size = args.batch_size or p.diffusion_batch_size
    pipe = build_train_pipeline(p, device=args.device, attention=args.attention,
                                attn_heads=args.attention_heads, objective=args.objective,
                                seed=args.seed, vae_ckpt=args.vae_ckpt,
                                latent_scale=args.latent_scale,
                                latent_shift=args.latent_shift,
                                zero_terminal_snr=args.zero_terminal_snr,
                                min_snr_gamma=args.min_snr_gamma, family=args.family,
                                flow_shift=args.flow_shift,
                                time_sampling=args.time_sampling,
                                estimator=args.estimator, remat=args.remat)
    dev = pipe.device
    state = TrainState(pipe.noise_estimator, lr=p.diffusion_lr, weight_decay=1e-2,
                       use_ema=args.use_ema,
                       lr_schedule=make_lr_schedule(args.lr_schedule, args.warmup_steps,
                                                    args.max_steps))
    step_fn = make_diffusion_train_step(
        pipe, compute_dtype=torch.bfloat16 if args.bf16 else None)
    ds = build_dataset(p, args.data_root, n_synthetic=max(batch_size * 4, 16), seed=args.seed)
    if args.grain:
        dm = GrainDataModule(ds, batch_size=batch_size, seed=args.seed,
                             num_workers=args.num_workers)
    else:
        dm = SimpleDataModule(ds, batch_size=batch_size, seed=args.seed,
                              weights=ds.get_weights(), num_workers=args.num_workers)

    out = None if args.out is None else Path(args.out)
    ckpt_dir = None if out is None else out / "checkpoints"
    config = run_config(p, args)
    if resume and C.latest_step(ckpt_dir) is not None:
        C.check_config(ckpt_dir, {k: config[k] for k in RESUME_KEYS},
                       "--resume config mismatch")
        restore_data_state(ds, C.restore_checkpoint(ckpt_dir, state))
        print(f"resumed from step {state.step}")
    writer = None if out is None else MetricsWriter(out / "logs")

    losses = []
    step, t_start = state.step, time.time()
    stream = batch_stream(dm, step)
    try:
        while step < args.max_steps:
            batch = next(stream)
            dev_batch = {"source": torch.from_numpy(batch["source"]).to(dev)}
            if "target" in batch and p.num_classes:
                check_labels(batch["target"], p.num_classes)
                dev_batch["target"] = torch.from_numpy(batch["target"]).long().to(dev)
            draws = pipe.train_draws(batch_size, p.latent_shape,
                                     generator=step_generator(dev, args.seed, step))
            metrics = step_fn(state, dev_batch, draws)
            losses.append(metrics["loss"])
            step += 1
            if step % 50 == 0 or step == 1:
                if writer is not None:
                    writer.log_scalars(step, metrics)
                print(f"step {step} loss {float(metrics['loss']):.4f} "
                      f"({time.time() - t_start:.1f}s)")
            if ckpt_dir is not None and (step % args.ckpt_every == 0 or step == args.max_steps):
                C.save_checkpoint(ckpt_dir, state, step, config=config, keep_top_k=2,
                                  extra=data_state(ds))
                C.save_best_checkpoint(ckpt_dir, step, float(metrics["loss"]), state=state)
            if out is not None and args.sample_every and step % args.sample_every == 0:
                save_samples(pipe, state, p, args.seed, step,
                             out / "images" / f"sample_{step}.png")
    finally:
        stream.close()
        if writer is not None:
            writer.close()
    print(f"done: {step} steps" + ("" if ckpt_dir is None else f" -> {ckpt_dir}"))
    return state, [float(v) for v in losses], pipe


def save_samples(pipe, state, p, seed: int, step: int, path) -> None:
    """4 images (labels 0, 1, 0, 1) of a 50-step DDIM sample, or a 25-step
    Heun sample of the flow family, from the EMA copy, or the model without
    one, as one PNG grid."""
    sampler = dataclasses.replace(pipe, noise_estimator=state.inference_model)
    dev = pipe.device
    cond = (torch.arange(4, device=dev) % p.num_classes) if p.num_classes else None
    steps = (dict(steps=25) if isinstance(pipe, FlowMatchingPipeline)
             else dict(steps=min(50, p.timesteps), use_ddim=True))
    imgs = sampler.sample(4, p.latent_shape, condition=cond,
                          generator=step_generator(dev, seed, SAMPLE_KEY, step), **steps)
    save_image_grid(imgs.float().cpu().numpy(), path)


if __name__ == "__main__":
    main()
