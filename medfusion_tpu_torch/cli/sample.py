"""Sample images per condition with the PyTorch port.

For each condition in {0, 1} (and unconditioned), sample ``--n`` images with
150-step DDIM and classifier-free guidance 8, as ``medfusion_tpu.cli.sample``
does, and write them as ``.npy`` arrays ([n, H, W, C] float32) plus PNG
grids ``sample_cond_{0,1,None}.png`` and ``sample_diff.png`` written by
``data/png.py``.

``--sampler dpmpp`` is DPM-Solver++(2M) (deterministic; 25-50 steps),
``--sampler edm`` the Karras Heun sampler (``--edm-churn``, ``--edm-rho``),
``--encoder-key-every k > 1`` the encoder-propagation DDIM sampler
(approximate; deterministic, eta 0, as in the JAX CLI, so ``--eta`` is
refused with it). ``--zero-terminal-snr`` is for a checkpoint trained with it
(trailing spacing by default); ``--timestep-spacing`` and
``--guidance-rescale`` are as in the JAX CLI. The same draws come from one
generator seeded by ``--seed`` for every condition. ``--sampler
consistency`` samples a consistency model (``cli.distill --method cd|ct``,
whose run directory ``--ckpt`` takes) in ``min(--steps, 8)`` rounds of
f and renoise, at ``--cd-sigma-data``, one conditional forward a round (no
CFG); it refuses ``--classifier-ckpt``, as the JAX CLI does.

``--estimator unet_legacy|openai|lucidrains|dit`` samples a checkpoint of
that family (``cli.train_diffusion --estimator``); without ``--estimator``
the family is the ``--ckpt`` run's (its ``config.json``), else the UNet.
``--attention`` is refused but for the unet and unet_legacy families and
``--attention-heads`` but for the unet family, as in the JAX package.

``--family flow`` samples a flow-matching checkpoint (``cli.train_diffusion
--family flow``) with the Heun probability-flow ODE on a grid shifted by
``--flow-shift``; its ``--steps`` is not capped at T. It refuses the
diffusion-schedule flags (``--zero-terminal-snr``, ``--guidance-rescale``,
``--timestep-spacing``, ``--objective``), ``--sampler``,
``--encoder-key-every`` and ``--classifier-ckpt``, as the JAX CLI does.

``--classifier-ckpt`` guides DDIM or DPM++ with a noisy-latent classifier
(``cli.train_classifier``: a port run, or an ``.npz`` of the JAX
classifier's flax params) built with ``--classifier-model-channels`` and
``--classifier-pool``: the eps prediction moves by ``--classifier-scale``
x sqrt(1 - abar_t) x the gradient of log p(label | x_t), on the labelled
conditions only. The classifier runs in float32, its attention through the
hand-written kernels forward and backward on the card. EDM and the fast
sampler refuse it, as in the JAX CLI.

Usage:
  python -m medfusion_tpu_torch.cli.sample --preset chest --n 8 \
      --ckpt runs/diffusion --ema --vae-ckpt runs/ae --out results/samples
  python -m medfusion_tpu_torch.cli.sample --preset chest --n 8 \
      [--attention spatial] [--attention-heads 8] \
      [--params weights.npz] [--dtype bf16] [--device cuda] --out results/samples
  python -m medfusion_tpu_torch.cli.sample --preset chest --sampler dpmpp --steps 25

``--ckpt`` is a port diffusion run (or its ``checkpoints`` directory): the
UNet of its latest step, or with ``--ema`` that step's EMA copy. It must
have been trained with the ``--estimator``, ``--attention``,
``--attention-heads``, ``--objective``, ``--latent-scale`` and
``--latent-shift`` given here (its
``config.json`` is checked). ``--vae-ckpt`` is a port autoencoder run or an
``.npz`` of the JAX VAE's flax params. Either may instead be a reference
Lightning ``.ckpt`` (``utils/torch_compat.py``): ``--ckpt`` takes its
``noise_estimator.`` weights, and its ``latent_embedder.`` weights where it
has them (over ``--vae-ckpt``, as in the JAX CLI); ``--vae-ckpt`` takes a
reference autoencoder's file.

``--attention`` is the UNet's ``use_attention`` config ('spatial' is the
reference's eye/colon attention config); on the card every attention and
transformer MLP runs through the hand-written kernels. The kernel switches
(``--flash``, ``--fused-geglu``, ``--fused-up``, ``--s2d-tail``) are the JAX
CLI's, with its rules (``cli/kernels.py``); ``--no-flash`` and
``--no-fused-geglu`` are refused on the card.

``--params`` is an ``.npz`` of the JAX package's flax params, keyed by the
flax paths joined by '/', with ``noise_estimator/`` and ``latent_embedder/``
prefixes. Without it the weights are a seeded random initialisation.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch.cli.kernels import add_kernel_args, resolve_kernel_flags
from medfusion_tpu_torch.cli.presets import (
    ESTIMATORS,
    PRESETS,
    build_pipeline,
    estimator_refusal,
)
from medfusion_tpu_torch.cli.train_classifier import POOLS, load_classifier
from medfusion_tpu_torch.data.png import write_png
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.pipelines.diffusion import make_classifier_grad
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.train.consistency import consistency_sample
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.torch_compat import is_lightning_checkpoint, pipeline_states

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


def run_flags(args) -> dict:
    """What a ``--ckpt`` run's config must agree with."""
    return {"estimator": args.estimator, "attention": args.attention,
            "attention_heads": args.attention_heads, "objective": args.objective, "latent_scale": args.latent_scale,
            "latent_shift": args.latent_shift, "zero_terminal_snr": args.zero_terminal_snr,
            "family": args.family}


def load_classifier_arg(args, p, dev):
    """The ``--classifier-ckpt`` classifier on ``dev`` (float32), or None."""
    if not args.classifier_ckpt:
        return None
    return load_classifier(p, args.classifier_ckpt, args.classifier_model_channels,
                           args.classifier_pool, device=dev)


def load_unet_state(path, ema: bool, flags: dict):
    """The UNet state dict of a port diffusion run's latest step (its EMA
    copy with ``ema``), after checking the run's config against ``flags``;
    or the ``noise_estimator.`` part of a reference Lightning ``.ckpt``
    (which has no port config and no EMA copy that the port reads)."""
    if is_lightning_checkpoint(path):
        if ema:
            raise SystemExit(f"--ema: {path} is a reference Lightning checkpoint; its "
                             f"estimator weights are the only ones read")
        return pipeline_states(path)[0]
    ckpt_dir = C.ckpt_dir_of(Path(path))
    C.check_config(ckpt_dir, flags, f"--ckpt {path}")
    state = C.load_payload(ckpt_dir)["state"]
    if ema and state["ema"] is None:
        raise SystemExit(f"--ema: the run under {path} was trained without --use-ema")
    return state["ema"] if ema else state["model"]


def vae_source(args):
    """Where the pipeline's VAE comes from: a reference ``--ckpt`` file that
    holds a latent embedder (as the JAX CLI, it wins over ``--vae-ckpt``),
    else ``--vae-ckpt``."""
    if is_lightning_checkpoint(args.ckpt) and pipeline_states(args.ckpt)[1] is not None:
        return args.ckpt
    return args.vae_ckpt


def run_estimator(ckpt) -> str:
    """The estimator family a port run was trained with (its config's
    ``estimator``; 'unet' for a run without one, or without ``ckpt``)."""
    if not ckpt or is_lightning_checkpoint(ckpt):
        return "unet"
    cfg = C.ckpt_dir_of(Path(ckpt)) / C.CONFIG_FILE
    return json.loads(cfg.read_text()).get("estimator", "unet") if cfg.exists() else "unet"


def check_args(ap, args) -> None:
    """The refusals shared with ``cli.sample_dataset``: the JAX sample CLI's
    (a superset of its bulk sampler's), and what the port does not have
    yet; the default spacing and, without ``--estimator``, the ``--ckpt``
    run's estimator family."""
    if args.estimator is None:
        args.estimator = run_estimator(args.ckpt)
    why = estimator_refusal(args.estimator, args.attention, args.attention_heads)
    if why is not None:
        ap.error(why)
    resolve_kernel_flags(args, ap)
    if args.ema and not args.ckpt:
        ap.error("--ema needs --ckpt")
    if args.family == "flow":
        if args.zero_terminal_snr or args.guidance_rescale > 0:
            ap.error("--zero-terminal-snr/--guidance-rescale are diffusion-schedule "
                     "options; the flow family has no schedule")
        if args.timestep_spacing is not None:
            ap.error("--timestep-spacing is a diffusion DDIM-grid option; the flow "
                     "ODE grid is set by --flow-shift")
        if args.objective != "x_T":
            ap.error("--objective selects a diffusion parameterization; flow "
                     "checkpoints are velocity models")
        if args.sampler != "ddim":
            ap.error("--family flow has its own ODE sampler; drop --sampler")
        if args.classifier_ckpt:
            ap.error("classifier guidance is not wired into the flow family")
        if args.encoder_key_every > 1:
            ap.error("--encoder-key-every is a diffusion-family fast path")
    if args.sampler == "consistency" and args.classifier_ckpt:
        ap.error("--classifier-ckpt guidance is not wired into consistency sampling; "
                 "use ddim/dpmpp")
    if args.classifier_ckpt and args.encoder_key_every > 1:
        ap.error("--classifier-ckpt guidance is not wired into the "
                 "encoder-propagation fast sampler; drop --encoder-key-every")
    if args.classifier_ckpt and args.sampler == "edm":
        ap.error("--classifier-ckpt guidance is not wired into the EDM sampler "
                 "(fractional-t queries); use ddim/dpmpp")
    if args.guidance_rescale > 0 and args.encoder_key_every > 1:
        ap.error("--guidance-rescale is not wired into the encoder-"
                 "propagation fast sampler; drop --encoder-key-every")
    if args.timestep_spacing is None:
        args.timestep_spacing = "trailing" if args.zero_terminal_snr else "linspace"


def add_estimator_args(ap) -> None:
    """The estimator flags shared with ``cli.sample_dataset``, the kernel
    switches (``cli/kernels.py``) among them."""
    ap.add_argument("--estimator", choices=ESTIMATORS, default=None,
                    help="the noise-estimator family the checkpoint was trained with "
                         "(default: the --ckpt run's, else unet)")
    ap.add_argument("--attention", choices=ATTENTION_TYPES, default="none",
                    help="UNet attention per the reference's use_attention "
                         "config: 'linear' = single-layer transformer, "
                         "'spatial' = SpatialTransformer")
    ap.add_argument("--attention-heads", type=int, default=8,
                    help="attention heads (reference geometry: 8); must "
                         "divide every attended level's width")
    add_kernel_args(ap, attention=False)


def add_sampler_args(ap, consistency: bool = True) -> None:
    """The sampler flags shared with ``cli.sample_dataset``, which has no
    consistency sampler (``consistency`` False), as in the JAX package."""
    ap.add_argument("--sampler", choices=("ddim", "dpmpp", "edm")
                    + (("consistency",) if consistency else ()), default="ddim",
                    help="dpmpp = DPM-Solver++(2M) (arXiv:2211.01095), 25-50 steps; "
                         "edm = Karras Heun (arXiv:2206.00364)"
                         + ("; consistency = a one- or few-step consistency model "
                            "(cli.distill --method cd|ct; --steps is the number of "
                            "f/renoise rounds, at most 8)" if consistency else ""))
    if consistency:
        ap.add_argument("--cd-sigma-data", type=float, default=0.5,
                        help="sigma_data the consistency model was trained with")
    ap.add_argument("--edm-churn", type=float, default=0.0,
                    help="EDM S_churn (> 0 adds stochastic churn)")
    ap.add_argument("--edm-rho", type=float, default=7.0,
                    help="EDM sigma-grid warp exponent (the paper's 7)")
    ap.add_argument("--encoder-key-every", type=int, default=1,
                    help="> 1: the encoder-propagation fast sampler (approximate)")
    ap.add_argument("--zero-terminal-snr", action="store_true",
                    help="the checkpoint was trained with --zero-terminal-snr")
    ap.add_argument("--timestep-spacing", choices=("linspace", "trailing"), default=None,
                    help="grid spacing; trailing by default with --zero-terminal-snr")
    ap.add_argument("--guidance-rescale", type=float, default=0.0,
                    help="CFG rescale phi (arXiv:2305.08891 §3.4; 0 = off)")
    ap.add_argument("--family", choices=("diffusion", "flow"), default="diffusion",
                    help="flow = a flow-matching checkpoint, sampled with the Heun "
                         "probability-flow ODE")
    ap.add_argument("--flow-shift", type=float, default=1.0,
                    help="SD3 resolution shift of the flow sampling grid (1 = uniform)")
    ap.add_argument("--classifier-ckpt", default=None,
                    help="a noisy-latent classifier (cli.train_classifier run or .npz) "
                         "for classifier-guided DDIM/DPM++ (arXiv:2105.05233)")
    ap.add_argument("--classifier-scale", type=float, default=1.0)
    ap.add_argument("--classifier-model-channels", type=int, default=64)
    ap.add_argument("--classifier-pool", default="adaptive", choices=POOLS)


def sampling_steps(args, p, steps: int) -> int:
    """The step count of a sampling: a diffusion grid is capped at T, the
    flow ODE's is not."""
    return steps if args.family == "flow" else min(steps, p.timesteps)


def run_sampler(pipe, args, p, n, steps, condition, gs, gen, un_cond=None, eta=1.0,
                classifier=None):
    """Channels-last images of one sampler call; every draw from ``gen``,
    the initial latent first; ``eta`` for DDIM and the fast sampler; a flow
    pipeline integrates its ODE (Heun); ``classifier`` guides DDIM and
    DPM++ on a labelled ``condition`` at ``args.classifier_scale``."""
    x_T = torch.randn((n, *p.latent_shape), generator=gen, device=pipe.device)
    common = dict(condition=condition, steps=steps, guidance_scale=gs, un_cond=un_cond)
    if isinstance(pipe, FlowMatchingPipeline):
        return pipe.denoise(x_T, generator=gen, **common)
    if args.sampler == "consistency":  # the student's one conditional forward: no CFG
        return consistency_sample(pipe, x_T, steps=min(steps, 8), condition=condition,
                                  sigma_data=args.cd_sigma_data, generator=gen)
    guided = {}
    if classifier is not None and condition is not None:
        guided = dict(classifier_grad=make_classifier_grad(classifier, condition),
                      classifier_scale=args.classifier_scale)
    if args.sampler == "edm":
        return pipe.denoise_edm(x_T, s_churn=args.edm_churn, rho=args.edm_rho,
                                guidance_rescale=args.guidance_rescale, generator=gen,
                                **common)
    spacing = dict(timestep_spacing=args.timestep_spacing)
    if args.sampler == "dpmpp":
        return pipe.denoise_dpmpp(x_T, guidance_rescale=args.guidance_rescale,
                                  **spacing, **common, **guided)
    if args.encoder_key_every > 1:
        return pipe.denoise_fast(x_T, eta=eta, generator=gen,
                                 encoder_key_every=args.encoder_key_every,
                                 **spacing, **common)
    return pipe.denoise(x_T, use_ddim=True, eta=eta, generator=gen,
                        guidance_rescale=args.guidance_rescale, **spacing, **common,
                        **guided)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--guidance", type=float, default=8.0)
    ap.add_argument("--eta", type=float, default=None,
                    help="DDIM eta (default 1); the fast sampler runs at 0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    add_estimator_args(ap)
    ap.add_argument("--params", default=None, help="flax params .npz")
    ap.add_argument("--ckpt", default=None,
                    help="a port diffusion run, or a reference Lightning .ckpt")
    ap.add_argument("--ema", action="store_true", help="--ckpt's EMA copy")
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run, an .npz of the JAX VAE's params, or a "
                         "reference Lightning .ckpt")
    ap.add_argument("--objective", choices=("x_T", "x_0", "v"), default="x_T")
    ap.add_argument("--latent-scale", type=float, default=1.0)
    ap.add_argument("--latent-shift", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/samples")
    add_sampler_args(ap)
    args = ap.parse_args(argv)
    check_args(ap, args)
    if args.params and (args.ckpt or args.vae_ckpt):
        ap.error("--params holds both networks; give it alone or --ckpt/--vae-ckpt")
    if args.eta is not None and args.encoder_key_every > 1:
        ap.error("--eta does not apply to --encoder-key-every: the fast sampler "
                 "runs deterministic DDIM (eta 0), as the JAX CLI does")
    eta = 0.0 if args.encoder_key_every > 1 else (1.0 if args.eta is None else args.eta)

    p = PRESETS[args.preset]
    unet_params = vae_params = unet_state = None
    if args.params:
        unet_params, vae_params = load_npz_params(args.params)
    if args.ckpt:
        unet_state = load_unet_state(args.ckpt, args.ema, run_flags(args))
    pipe = build_pipeline(p, device=args.device, compute_dtype=DTYPES[args.dtype],
                          seed=args.seed, unet_params=unet_params,
                          vae_params=vae_params, attention=args.attention,
                          attn_heads=args.attention_heads, unet_state=unet_state,
                          vae_ckpt=vae_source(args), objective=args.objective,
                          latent_scale=args.latent_scale, latent_shift=args.latent_shift,
                          zero_terminal_snr=args.zero_terminal_snr, family=args.family,
                          flow_shift=args.flow_shift, estimator=args.estimator)
    classifier = load_classifier_arg(args, p, pipe.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    steps = sampling_steps(args, p, args.steps)
    results = {}
    for cond_val in ([0, 1, None] if p.num_classes else [None]):
        cond = (None if cond_val is None else
                torch.full((args.n,), cond_val, dtype=torch.long, device=pipe.device))
        # the same noise for every condition
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
        gs = args.guidance if cond_val is not None else 1.0
        imgs = run_sampler(pipe, args, p, args.n, steps, cond, gs, gen, eta=eta,
                           classifier=classifier)
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
