"""Train the latent diffusion model with the PyTorch port.

The counterpart of ``medfusion_tpu/cli/train_diffusion.py`` on synthetic
data: a seeded random VAE (frozen) and UNet, T=1000 scaled-linear schedule,
CFG dropout 0.5, L1 loss, AdamW (lr 1e-4, weight decay 0.01) over the UNet
only, optional EMA, batch 32 for the chest preset. ``--bf16`` trains with
bf16 compute and float32 master weights, optimizer state and loss. The
random draws of each step come from one ``torch.Generator`` seeded by
``--seed``.

Usage:
  python -m medfusion_tpu_torch.cli.train_diffusion --preset chest \\
      --attention spatial --bf16 --max-steps 5
  python -m medfusion_tpu_torch.cli.train_diffusion --preset smoke \\
      --device cpu --max-steps 2

Without ``--device cpu`` it runs on the card and raises when there is none.
On the card every self-attention runs its forward and backward through the
hand-written kernels. Not ported: ``--data-root`` (real datasets),
checkpoint save and resume, ``--sample-every``, ``--family flow``, the
grain loader and ``--auto-restart``.
"""

from __future__ import annotations

import argparse
import time

import torch

from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline
from medfusion_tpu_torch.data import SimpleDataModule, SyntheticDataset2D
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step, make_lr_schedule


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--attention", choices=ATTENTION_TYPES, default="none")
    ap.add_argument("--attention-heads", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=200000)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 estimator forward/backward, float32 master "
                         "weights, optimizer state and loss")
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--objective", choices=("x_T", "x_0", "v"), default="x_T")
    ap.add_argument("--lr-schedule", choices=("const", "cosine", "lambda_linear"),
                    default="const")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.attention_heads != 8 and args.attention == "none":
        ap.error("--attention-heads has no effect without attention layers; "
                 "add --attention spatial|linear")

    p = PRESETS[args.preset]
    batch_size = args.batch_size or p.diffusion_batch_size
    pipe = build_train_pipeline(p, device=args.device, attention=args.attention,
                                attn_heads=args.attention_heads,
                                objective=args.objective, seed=args.seed)
    dev = pipe.device
    state = TrainState(pipe.noise_estimator, lr=p.diffusion_lr, weight_decay=1e-2,
                       use_ema=args.use_ema,
                       lr_schedule=make_lr_schedule(args.lr_schedule, args.warmup_steps,
                                                    args.max_steps))
    step_fn = make_diffusion_train_step(
        pipe, compute_dtype=torch.bfloat16 if args.bf16 else None)
    ds = SyntheticDataset2D(n=max(batch_size * 4, 16), image_size=p.image_size,
                            channels=p.in_channels, num_classes=p.num_classes,
                            seed=args.seed)
    dm = SimpleDataModule(ds, batch_size=batch_size, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    losses = []
    step, epoch, t_start = 0, 0, time.time()
    while step < args.max_steps:
        for batch in dm.train_dataloader(epoch=epoch):
            dev_batch = {"source": torch.from_numpy(batch["source"]).to(dev)}
            if "target" in batch and p.num_classes:
                dev_batch["target"] = torch.from_numpy(batch["target"]).long().to(dev)
            draws = pipe.train_draws(batch_size, p.latent_shape, generator=gen)
            metrics = step_fn(state, dev_batch, draws)
            losses.append(metrics["loss"])
            step += 1
            if step % 50 == 0 or step == 1:
                print(f"step {step} loss {float(metrics['loss']):.4f} "
                      f"({time.time() - t_start:.1f}s)")
            if step >= args.max_steps:
                break
        epoch += 1
    print(f"done: {step} steps")
    return state, [float(v) for v in losses]


if __name__ == "__main__":
    main()
