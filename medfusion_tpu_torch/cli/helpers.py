"""Helper commands of the reference's ``scripts/helpers`` (port of
``medfusion_tpu/cli/helpers.py``).

* ``latent-stats``: one batch through the VAE's encode (an explicit draw
  from a generator seeded by ``--seed``) and decode; prints the latents'
  mean and std and the ``--latent-shift``/``--latent-scale`` they suggest
  for ``cli.train_diffusion`` and ``cli.sample``, and writes
  ``latent_hist.png`` (a 100-bin histogram, drawn with numpy) and
  ``roundtrip.png`` (the images above their reconstructions).
* ``extract-vae``: the generator of an adversarial run (``--ckpt``, a
  ``GANTrainState`` checkpoint) as a plain autoencoder checkpoint at the same
  step, which ``cli.train_diffusion --vae-ckpt`` takes.
* ``export-images``: a grid of random dataset images.
* ``export-gif``: a DDIM (eta 0) trajectory as a GIF, one decoded frame a
  step; needs PIL.
* ``interpolate``: two dataset images' latents noised once to step
  ``--steps``, mixed at ``--n`` lambdas and denoised by the ancestral sampler
  from t = steps - 1 (the reference's DDIM path queries t ~ T-1 on a latent
  noised only to ``steps``, which the JAX package leaves out on purpose, and
  so does the port); with ``--ddim-invert`` both latents are inverted by
  DDIM, slerped and denoised by DDIM at eta 0.
* ``inpaint``: regenerate ``--box`` (fractions x0,y0,x1,y1 of the image,
  widened to whole latent cells) of a dataset image by DDIM with the
  known-region projection, RePaint with ``--resample-steps``/``--jump-length``.
* ``img2img``: SDEdit of a dataset image at ``--strength``, DDIM eta 0,
  optionally toward ``--label`` under ``--guidance-scale``.

The diffusion model is a port diffusion run (``--ckpt``, its EMA copy with
``--ema``) or seeded random weights; the VAE is ``--vae-ckpt`` or seeded
random weights. All draws come from one generator seeded by ``--seed``.
Refused, naming ROADMAP Queue 1: ``--family flow`` (item 3), an
``--estimator`` other than ``unet`` (item 7), and the kernel switches
``--flash``, ``--fused-geglu`` and ``--fused-up`` (item 10): the port runs
its hand-written kernels always.

Usage:
  python -m medfusion_tpu_torch.cli.helpers latent-stats --preset chest \\
      --data-root /data/CheXpert --vae-ckpt runs/ae --out results/latents
  python -m medfusion_tpu_torch.cli.helpers interpolate --preset chest \\
      --ckpt runs/diffusion --ema --vae-ckpt runs/ae [--ddim-invert]
  python -m medfusion_tpu_torch.cli.helpers inpaint --preset smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.presets import (PRESETS, build_dataset, build_pipeline, build_vae,
                                             load_vae)
from medfusion_tpu_torch.cli.sample import load_unet_state
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.data.png import write_png
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.logging import save_image_grid, to_uint8

def _generator(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _images(ds, indices, dev) -> torch.Tensor:
    """Dataset items as one channels-last batch on ``dev``."""
    return torch.from_numpy(np.stack([ds[int(i) % len(ds)]["source"] for i in indices])).to(dev)


@torch.no_grad()
def latent_roundtrip(vae, x: torch.Tensor, noise: torch.Tensor):
    """(z, reconstruction) of NCHW images ``x`` with the encoder draw ``noise``."""
    z = vae.encode(x, noise)
    return z, vae.decode(z)


def latent_suggestion(z: torch.Tensor):
    """(mean, std) of the latents, the population std as ``jnp.std``: the
    suggested ``--latent-shift`` is the mean, ``--latent-scale`` 1 / std."""
    return float(z.mean()), float(z.std(unbiased=False))


def histogram_png(values: np.ndarray, path) -> None:
    """A bar chart of ``values``' histogram (100 bars of 4 pixels on a white
    ground, the tallest 240 pixels), written as a grey PNG."""
    bins, height = 100, 240
    counts, _ = np.histogram(values, bins=bins)
    bars = np.round(counts / max(counts.max(), 1) * height).astype(int)
    img = np.full((height + 8, bins * 4 + 8), 255, np.uint8)
    rows = np.arange(height)[:, None]
    cols = (height - rows <= bars[None, :]).repeat(4, axis=1)  # [height, bins * 4]
    img[4:4 + height, 4:4 + bins * 4][cols] = 40
    write_png(path, img)


def latent_stats(args, dev):
    p = PRESETS[args.preset]
    vae = load_vae(p, dev, args.seed, args.vae_ckpt)
    ds = build_dataset(p, args.data_root, n_synthetic=args.n, seed=args.seed)
    x = _to_nchw(_images(ds, range(min(args.n, len(ds))), dev))
    noise = torch.randn((x.shape[0], p.emb_channels, *p.latent_shape[:2]),
                        generator=_generator(dev, args.seed), device=dev)
    z, dec = latent_roundtrip(vae, x, noise)
    mean, std = latent_suggestion(z)
    scale = 1.0 / max(std, 1e-8)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    histogram_png(z.cpu().numpy().ravel(), out / "latent_hist.png")
    save_image_grid(_to_nhwc(torch.cat([x, dec])).cpu().numpy(), out / "roundtrip.png",
                    nrow=x.shape[0])
    print(f"latent shape {tuple(_to_nhwc(z).shape)}, mean {mean:.4f}, std {std:.4f}")
    print(f"latent histogram (mean {mean:.3f}, std {std:.3f})")
    print(f"suggested: train_diffusion/sample --latent-shift {mean:.4f} "
          f"--latent-scale {scale:.4f}")
    print(f"wrote {out}/latent_hist.png and {out}/roundtrip.png")
    return {"mean": mean, "std": std, "latent_shift": mean, "latent_scale": scale}


def extract_vae(args, dev):
    """An adversarial run's generator -> a plain autoencoder checkpoint."""
    from medfusion_tpu_torch.train import TrainState

    if not args.ckpt:
        raise SystemExit("extract-vae needs --ckpt (an adversarial autoencoder run)")
    p = PRESETS[args.preset]
    ckpt_dir = C.ckpt_dir_of(Path(args.ckpt))
    state = C.load_payload(ckpt_dir)["state"]
    if "gen" not in state:
        raise SystemExit(f"--ckpt {args.ckpt}: not an adversarial (--gan) run")
    cfg_file = ckpt_dir / C.CONFIG_FILE
    config = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    with torch.device(dev):
        model = build_vae(p, config.get("model", "vae"))
    model.load_state_dict(state["gen"]["model"], strict=True)
    out_state = TrainState(model, lr=p.ae_lr, weight_decay=0.0)
    out_state.step = int(state["step"])
    C.save_checkpoint(args.out, out_state, out_state.step,
                      config={**config, "gan": False, "disc": None})
    print(f"extracted VAE (step {out_state.step}) -> {args.out}")
    return out_state


def export_images(args, dev):
    p = PRESETS[args.preset]
    ds = build_dataset(p, args.data_root, n_synthetic=args.n, seed=args.seed)
    idx = np.random.default_rng(args.seed).choice(len(ds), size=min(args.n, len(ds)),
                                                  replace=False)
    imgs = np.stack([ds[int(i)]["source"] for i in idx])
    save_image_grid(imgs, Path(args.out) / "random_images.png")
    print(f"wrote {args.out}/random_images.png")


def load_pipeline(args, p, dev):
    """The helpers' pipeline: no input centering and no x0 clipping, as the
    JAX CLI's ``load_pipeline``; float32."""
    unet_state = None
    if args.ckpt:
        unet_state = load_unet_state(args.ckpt, args.ema, {
            "attention": args.attention, "attention_heads": args.attention_heads,
            "objective": "x_T", "latent_scale": 1.0, "latent_shift": 0.0,
            "zero_terminal_snr": False})
    pipe = build_pipeline(p, device=dev, seed=args.seed, attention=args.attention,
                          attn_heads=args.attention_heads, unet_state=unet_state,
                          vae_ckpt=args.vae_ckpt)
    return dataclasses.replace(pipe, do_input_centering=False)


def export_gif(args, dev):
    """The DDIM (eta 0) trajectory from one seeded latent, a decoded frame a
    step."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("export-gif writes its GIF with PIL (Pillow), which is not "
                         "installed here; the port's own writer makes PNG only") from e
    p = PRESETS[args.preset]
    pipe = load_pipeline(args, p, dev)
    sched = pipe.scheduler
    steps = min(args.steps, p.timesteps)
    ts = [int(t) for t in sched.ddim_timesteps_host(steps)[::-1]]
    gen = _generator(dev, args.seed)
    x = torch.randn((1, p.emb_channels, *p.latent_shape[:2]), generator=gen, device=dev)
    frames = []
    with torch.no_grad():
        for i, t in enumerate(ts):
            tb = torch.full((1,), t, dtype=torch.long, device=dev)
            noise = torch.randn(x.shape, generator=gen, device=dev)
            x_prior, x_0, x_T, _ = pipe.estimate(x, tb, noise=noise)
            if i < steps - 1:
                x = S.ddim_step(sched, x_0, x_T, t, ts[i + 1], torch.zeros_like(x), eta=0.0)
            else:
                x = x_prior
            img = _to_nhwc(pipe.decode_latent(x)).cpu().numpy()[0]
            frames.append(Image.fromarray(to_uint8(img)))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    frames[0].save(out, save_all=True, append_images=frames[1:], duration=80, loop=0)
    print(f"wrote {out} ({len(frames)} frames)")


def slerp(z1: torch.Tensor, z2: torch.Tensor, lams: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of two noise tensors at a column of lambdas
    [n, 1, 1, 1], a lerp where the ends are near parallel."""
    f1, f2 = z1.reshape(-1), z2.reshape(-1)
    cos = torch.dot(f1, f2) / (torch.linalg.vector_norm(f1) * torch.linalg.vector_norm(f2))
    omega = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    so = torch.sin(omega)
    if so > 1e-6:
        w1, w2 = torch.sin((1.0 - lams) * omega) / so, torch.sin(lams * omega) / so
    else:
        w1, w2 = 1.0 - lams, lams
    return w1 * z1 + w2 * z2


def _save_row(args, name, rows, detail):
    out = Path(args.out)
    save_image_grid(np.stack(rows), out / name, nrow=len(rows))
    print(f"wrote {out}/{name} ({detail})")


def interpolate(args, dev):
    p = PRESETS[args.preset]
    pipe = load_pipeline(args, p, dev)
    ds = build_dataset(p, args.data_root, n_synthetic=max(args.n, 4), seed=args.seed)
    x1, x2 = _images(ds, [args.i1], dev), _images(ds, [args.i2], dev)
    gen = _generator(dev, args.seed)
    enc_shape = (1, p.emb_channels, *p.latent_shape[:2])
    z1 = _to_nhwc(pipe.encode_latent(_to_nchw(x1), torch.randn(enc_shape, generator=gen,
                                                                device=dev)))
    z2 = _to_nhwc(pipe.encode_latent(_to_nchw(x2), torch.randn(enc_shape, generator=gen,
                                                                device=dev)))
    i_step = min(args.steps, p.timesteps - 1)
    lams = torch.linspace(0.0, 1.0, args.n, device=dev).reshape(-1, 1, 1, 1)
    with torch.no_grad():
        if args.ddim_invert:
            x = slerp(pipe.invert(z1, steps=i_step), pipe.invert(z2, steps=i_step), lams)
            out = pipe.denoise(x, steps=i_step, use_ddim=True, eta=0.0, generator=gen)
            detail = f"ddim-invert, {i_step} steps"
        else:
            t = torch.full((1,), i_step, dtype=torch.long, device=dev)
            z1t = S.q_sample(pipe.scheduler, z1, t, torch.randn(z1.shape, generator=gen,
                                                                device=dev))
            z2t = S.q_sample(pipe.scheduler, z2, t, torch.randn(z2.shape, generator=gen,
                                                                device=dev))
            # ancestral over t = i_step - 1 .. 0: the level the latents were noised to
            out = pipe.denoise((1.0 - lams) * z1t + lams * z2t, steps=i_step,
                               use_ddim=False, generator=gen)
            detail = f"i={i_step}"
    rows = [x1[0].cpu().numpy(), *out.cpu().numpy(), x2[0].cpu().numpy()]
    _save_row(args, "interpolation.png", rows, f"{args.n} lambdas, {detail}")
    return out


def inpaint(args, dev):
    p = PRESETS[args.preset]
    pipe = load_pipeline(args, p, dev)
    ds = build_dataset(p, args.data_root, n_synthetic=max(args.i1 + 1, 4), seed=args.seed)
    x = _images(ds, [args.i1], dev)
    gen = _generator(dev, args.seed)
    z = pipe.encode_latent(_to_nchw(x), torch.randn((1, p.emb_channels, *p.latent_shape[:2]),
                                                    generator=gen, device=dev))
    z = _to_nhwc(z)
    fx0, fy0, fx1, fy1 = (float(v) for v in args.box.split(","))
    lh, lw = z.shape[1], z.shape[2]
    y0, y1 = int(math.floor(fy0 * lh)), int(math.ceil(fy1 * lh))
    x0, x1 = int(math.floor(fx0 * lw)), int(math.ceil(fx1 * lw))
    mask = torch.ones((1, lh, lw, 1), device=dev)  # 1 = keep
    mask[:, y0:y1, x0:x1, :] = 0.0  # 0 = generate
    out = pipe.sample_inpaint(z, mask, steps=args.steps, use_ddim=True, eta=1.0,
                              resample_steps=args.resample_steps,
                              jump_length=args.jump_length, generator=gen)
    ih, iw = x.shape[1], x.shape[2]
    img_mask = np.ones((ih, iw, 1), np.float32)
    img_mask[int(fy0 * ih):int(fy1 * ih), int(fx0 * iw):int(fx1 * iw)] = 0.0
    src = x[0].cpu().numpy()
    rows = [src, src * img_mask - (1.0 - img_mask), out[0].cpu().numpy()]
    _save_row(args, "inpaint.png", rows,
              f"box {args.box} -> latent [{y0}:{y1},{x0}:{x1}] of {lh}x{lw}")
    return out


def img2img(args, dev):
    p = PRESETS[args.preset]
    pipe = load_pipeline(args, p, dev)
    ds = build_dataset(p, args.data_root, n_synthetic=max(args.i1 + 1, 4), seed=args.seed)
    x = _images(ds, [args.i1], dev)
    cond = None
    if args.label is not None and p.num_classes:
        cond = torch.tensor([args.label], dtype=torch.long, device=dev)
    # at most T steps, as cli.sample: a longer grid repeats timesteps
    out = pipe.img2img(x, strength=args.strength, condition=cond,
                       steps=min(args.steps, p.timesteps), use_ddim=True, eta=0.0,
                       guidance_scale=args.guidance_scale, generator=_generator(dev, args.seed))
    _save_row(args, "img2img.png", [x[0].cpu().numpy(), out[0].cpu().numpy()],
              f"strength {args.strength}, {args.steps} steps")
    return out


COMMANDS = {"latent-stats": latent_stats, "extract-vae": extract_vae,
            "export-gif": export_gif, "export-images": export_images,
            "interpolate": interpolate, "inpaint": inpaint, "img2img": img2img}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        s = sub.add_parser(name)
        s.add_argument("--preset", choices=sorted(PRESETS), default="smoke")
        s.add_argument("--data-root", default=None)
        s.add_argument("--vae-ckpt", default=None)
        s.add_argument("--ckpt", default=None)
        s.add_argument("--ema", action="store_true")
        s.add_argument("--out", default="results/helpers")
        s.add_argument("--n", type=int, default=8)
        s.add_argument("--steps", type=int, default=25)
        s.add_argument("--seed", type=int, default=0)
        s.add_argument("--device", default="cuda")
        if name in ("export-gif", "interpolate", "inpaint", "img2img"):
            s.add_argument("--estimator", default="unet",
                           choices=("unet", "unet_legacy", "openai", "lucidrains", "dit"),
                           help="only 'unet' is ported")
            s.add_argument("--attention", choices=ATTENTION_TYPES, default="none")
            s.add_argument("--attention-heads", type=int, default=8)
            for flag in ("--flash", "--fused-geglu", "--fused-up"):
                s.add_argument(flag, action=argparse.BooleanOptionalAction, default=None,
                               help="not ported: the port runs its kernels always")
        if name in ("interpolate", "inpaint", "img2img"):
            s.add_argument("--family", choices=("diffusion", "flow"), default="diffusion",
                           help="flow is not ported")
        if name == "interpolate":
            s.add_argument("--i1", type=int, default=0)
            s.add_argument("--i2", type=int, default=1)
            s.add_argument("--ddim-invert", action="store_true",
                           help="interpolate in DDIM-inverted noise space (slerp)")
        if name == "img2img":
            s.add_argument("--i1", type=int, default=0,
                           help="dataset index of the image to edit")
            s.add_argument("--strength", type=float, default=0.6)
            s.add_argument("--label", type=int, default=None)
            s.add_argument("--guidance-scale", type=float, default=1.0)
        if name == "inpaint":
            s.add_argument("--i1", type=int, default=0,
                           help="dataset index of the image to inpaint")
            s.add_argument("--box", default="0.25,0.25,0.75,0.75",
                           help="fractional x0,y0,x1,y1 region to regenerate")
            s.add_argument("--resample-steps", type=int, default=1)
            s.add_argument("--jump-length", type=int, default=1)
    args = ap.parse_args(argv)
    if getattr(args, "family", "diffusion") == "flow":
        ap.error("--family flow is not ported yet (ROADMAP Queue 1, item 3)")
    if getattr(args, "estimator", "unet") != "unet":
        ap.error(f"--estimator {args.estimator}: only the 'unet' family is ported "
                 f"(ROADMAP Queue 1, item 7)")
    switches = [f for f in ("flash", "fused_geglu", "fused_up") if getattr(args, f, None)
                is not None]
    if switches:
        ap.error(f"--{switches[0].replace('_', '-')}: the kernel switches are not ported; "
                 f"the port runs its hand-written kernels always (ROADMAP Queue 1, item 10)")
    if args.cmd == "export-gif" and args.out == "results/helpers":
        args.out = "results/helpers/trajectory.gif"
    return COMMANDS[args.cmd](args, resolve_device(args.device))


if __name__ == "__main__":
    main()
