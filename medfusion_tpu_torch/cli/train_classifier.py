"""Train the noisy-latent classifier of classifier-guided sampling with the
PyTorch port (the counterpart of ``medfusion_tpu/cli/train_classifier.py``).

``EncoderUNetOpenAI`` (``--model-channels``, channel multipliers 1 and 2,
two residual blocks a level, ``--pool``) learns the preset's labels from the
frozen VAE's latents q-sampled to uniform timesteps (``train/classifier.py``),
with AdamW at ``--lr`` (optax's default weight decay 1e-4, as the JAX CLI),
on the preset's dataset under ``--data-root`` (weighted as the diffusion
CLI weights it) or synthetic data; ``--vae-ckpt`` is a port autoencoder run
or an ``.npz`` of the JAX VAE's flax params (else a seeded random VAE).
Checkpoints are ``<out>/checkpoints/step_<n>.pt`` every ``--ckpt-every``
steps and at the end (the latest 2 kept, the best on the loss pointed to);
``--resume`` continues a run exactly (step s draws from a generator seeded
by (``--seed``, s); the data stream continues where it stopped) and refuses
one saved with another ``--model-channels`` or ``--pool``. The classifier
trains in float32; on the card its attentions run the hand-written kernels
forward and backward.

``cli.sample --classifier-ckpt`` and ``cli.sample_dataset --classifier-ckpt``
read the run (or an ``.npz`` of the JAX classifier's flax params) through
:func:`load_classifier`.

Usage:
  python -m medfusion_tpu_torch.cli.train_classifier --preset chest \\
      --data-root /data/CheXpert --vae-ckpt runs/ae --out runs/classifier
  python -m medfusion_tpu_torch.cli.train_classifier --preset smoke --device cpu \\
      --max-steps 4 --out /tmp/clf
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset, build_scheduler, load_vae, seeded
from medfusion_tpu_torch.data import SimpleDataModule
from medfusion_tpu_torch.models.unet_openai import EncoderUNetOpenAI
from medfusion_tpu_torch.train import ClassifierTrainer, TrainState, make_classifier_train_step
from medfusion_tpu_torch.train.loop import (
    batch_stream,
    check_labels,
    data_state,
    restore_data_state,
    step_generator,
)
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.logging import MetricsWriter

POOLS = ("adaptive", "attention", "spatial", "spatial_v2")
RESUME_KEYS = ("model_channels", "pool")


def build_classifier(p, model_channels: int = 64, pool: str = "adaptive",
                     num_head_channels: int = -1) -> EncoderUNetOpenAI:
    """The preset's classifier; the attention pool needs a head size, which
    defaults to min(32, model_channels)."""
    h, _, c = p.latent_shape
    if pool == "attention" and num_head_channels == -1:
        num_head_channels = min(32, model_channels)
    return EncoderUNetOpenAI(
        image_size=h, in_channels=c, model_channels=model_channels,
        out_channels=p.num_classes, num_res_blocks=2, attention_resolutions=(),
        channel_mult=(1, 2), pool=pool, num_head_channels=num_head_channels)


def load_classifier(p, ckpt, model_channels: int = 64, pool: str = "adaptive",
                    device=None) -> EncoderUNetOpenAI:
    """The classifier of a port run (its directory or its ``checkpoints``
    directory; the latest step; its config checked against
    ``model_channels`` and ``pool``) or of an ``.npz`` of the JAX
    classifier's flax params (paths joined by '/', bare or under
    ``params/``), loaded with ``strict=True``, float32, in eval mode and
    without gradients of its own."""
    from medfusion_tpu_torch.utils.weights import jax_classifier_to_state_dict, unflatten_npz

    dev = resolve_device(device)
    with torch.device(dev):
        clf = build_classifier(p, model_channels, pool)
    path = Path(ckpt)
    if path.suffix == ".npz":
        with np.load(path) as f:
            tree = unflatten_npz({k: f[k] for k in f.files})
        sd = jax_classifier_to_state_dict(tree.get("params", tree), clf)
    else:
        ckpt_dir = C.ckpt_dir_of(path)
        C.check_config(ckpt_dir, {"model_channels": model_channels, "pool": pool},
                       f"--classifier-ckpt {ckpt}")
        sd = C.load_payload(ckpt_dir)["state"]["model"]
    clf.load_state_dict(sd, strict=True)
    return clf.eval().requires_grad_(False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run, an .npz of the JAX VAE's params, or a "
                         "reference Lightning .ckpt")
    ap.add_argument("--out", default="runs/classifier")
    ap.add_argument("--max-steps", type=int, default=20000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--model-channels", type=int, default=64)
    ap.add_argument("--pool", default="adaptive", choices=POOLS)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--num-workers", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    if not p.num_classes:
        ap.error("classifier training needs a labelled preset")
    dev = resolve_device(args.device)
    batch_size = args.batch_size or p.diffusion_batch_size
    vae = load_vae(p, dev, args.seed, args.vae_ckpt).requires_grad_(False)
    with seeded(dev, args.seed):
        clf = build_classifier(p, args.model_channels, args.pool)
    trainer = ClassifierTrainer(classifier=clf, scheduler=build_scheduler(p, dev),
                                latent_embedder=vae)
    state = TrainState(clf, lr=args.lr, weight_decay=1e-4)
    step_fn = make_classifier_train_step(trainer)
    ds = build_dataset(p, args.data_root, n_synthetic=max(batch_size * 4, 16), seed=args.seed)
    dm = SimpleDataModule(ds, batch_size=batch_size, seed=args.seed,
                          weights=ds.get_weights(), num_workers=args.num_workers)

    out = Path(args.out)
    ckpt_dir = out / "checkpoints"
    config = {**dataclasses.asdict(p), "model_channels": args.model_channels,
              "pool": args.pool}
    if args.resume and C.latest_step(ckpt_dir) is not None:
        C.check_config(ckpt_dir, {k: config[k] for k in RESUME_KEYS},
                       "--resume config mismatch")
        restore_data_state(ds, C.restore_checkpoint(ckpt_dir, state))
        print(f"resumed from step {state.step}")
    writer = MetricsWriter(out / "logs")

    losses = []
    step, t_start = state.step, time.time()
    stream = batch_stream(dm, step)
    try:
        while step < args.max_steps:
            batch = next(stream)
            check_labels(batch["target"], p.num_classes)
            dev_batch = {"source": torch.from_numpy(batch["source"]).to(dev),
                         "target": torch.from_numpy(batch["target"]).long().to(dev)}
            draws = trainer.draws(batch_size, p.latent_shape,
                                  generator=step_generator(dev, args.seed, step))
            metrics = step_fn(state, dev_batch, draws)
            losses.append(metrics["loss"])
            step += 1
            if step % 50 == 0 or step == 1:
                writer.log_scalars(step, metrics)
                print(f"step {step} loss {float(metrics['loss']):.4f} "
                      f"acc {float(metrics['acc']):.3f} ({time.time() - t_start:.1f}s)")
            if step % args.ckpt_every == 0 or step == args.max_steps:
                C.save_checkpoint(ckpt_dir, state, step, config=config, keep_top_k=2,
                                  extra=data_state(ds))
                C.save_best_checkpoint(ckpt_dir, step, float(metrics["loss"]), state=state)
    finally:
        stream.close()
        writer.close()
    print(f"done: {step} steps -> {ckpt_dir}")
    return state, [float(v) for v in losses]


if __name__ == "__main__":
    main()
