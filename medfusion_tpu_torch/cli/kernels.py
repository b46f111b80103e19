"""Attention config and the kernel switches of every sampling and training
CLI (port of ``medfusion_tpu/cli/kernels.py``).

:func:`add_kernel_args` registers the JAX package's flags with its choices
and defaults (``--attention``, ``--attention-heads``, ``--flash``,
``--fused-geglu``, ``--fused-up``, ``--s2d-tail``), and
:func:`resolve_kernel_flags` resolves their auto defaults against the
requested model with the JAX package's rules and refusals, returning the
same ``(flash, fused_geglu, fused_up, s2d_tail)``.

What the switches mean here:

* ``--flash`` and ``--fused-geglu``: on the card the hand-written kernels
  are the only route for attention and the transformer MLP; their plain
  PyTorch versions are the kernels' oracles, not a path on the card. So an
  explicit ``--no-flash`` or ``--no-fused-geglu`` with a CUDA ``--device``
  is refused. On ``--device cpu`` the plain versions run whatever the
  flags say.
* ``--fused-up`` and ``--s2d-tail``: on the TPU these are exact rewrites
  of a plain conv (a 2x upsample fused into the next 3x3 conv; the last
  decoder level in space-to-depth layout). The port computes that conv
  itself either way, so both values are accepted and change nothing.

Nothing here flips a global switch: the device of the tensors picks the
route (``ops``).
"""

from __future__ import annotations

import argparse

import torch

from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES as ATTENTION_CHOICES

# families whose architecture takes the reference's per-level use_attention
# config; the others fix their own attention
ATTENTION_CONFIGURABLE = ("unet", "unet_legacy")


def add_kernel_args(ap: argparse.ArgumentParser, attention: bool = True) -> None:
    """The JAX CLIs' kernel flags; ``attention`` False leaves out
    ``--attention``/``--attention-heads`` for a CLI that registers them
    itself."""
    if attention:
        ap.add_argument(
            "--attention", choices=ATTENTION_CHOICES, default="none",
            help="UNet attention per the reference's use_attention config: "
                 "'linear' = single-layer transformer, 'spatial' = "
                 "SpatialTransformer (the eye/colon attention configs); "
                 "unet/unet_legacy families only")
        ap.add_argument(
            "--attention-heads", type=int, default=8,
            help="attention heads on the unet family (reference geometry: 8 "
                 "heads of ch/8); must divide every attended level's width")
    ap.add_argument(
        "--flash", action=argparse.BooleanOptionalAction, default=None,
        help="attention through the hand-written flash kernels. Default: on "
             "whenever the model has attention layers; --no-flash is refused "
             "on the card, where the kernels are the only route")
    ap.add_argument(
        "--fused-geglu", action=argparse.BooleanOptionalAction, default=None,
        help="the SpatialTransformer MLP through the fused LN+GEGLU+proj "
             "kernel. Default: on with --attention spatial; --no-fused-geglu "
             "is refused on the card")
    ap.add_argument(
        "--fused-up", action=argparse.BooleanOptionalAction, default=None,
        help="the TPU's exact 4-phase rewrite of a 2x upsample + 3x3 conv; "
             "accepted for compatibility, it changes nothing here (the plain "
             "conv computes the same map). Default: on")
    ap.add_argument(
        "--s2d-tail", action=argparse.BooleanOptionalAction, default=None,
        help="the TPU's exact space-to-depth layout of the last decoder "
             "level; accepted for compatibility, it changes nothing here. "
             "Default: on")


def resolve_kernel_flags(args, parser: argparse.ArgumentParser | None = None):
    """Resolve the auto defaults against the requested model, as the JAX
    package does, and return ``(flash, fused_geglu, fused_up, s2d_tail)``.
    Raises the JAX package's refusals (through ``parser.error`` when given,
    else as ``ValueError``), and refuses an explicit ``--no-flash`` or
    ``--no-fused-geglu`` on a CUDA ``args.device`` (``cuda`` when absent)."""
    def _err(msg):
        if parser is not None:
            parser.error(msg)
        raise ValueError(msg)

    attention = getattr(args, "attention", "none") or "none"
    estimator = getattr(args, "estimator", "unet")
    if attention != "none" and estimator not in ATTENTION_CONFIGURABLE:
        _err(f"--attention {attention} only configures the "
             f"{'/'.join(ATTENTION_CONFIGURABLE)} families; "
             f"--estimator {estimator} fixes its own attention")
    has_attention = attention != "none" or estimator == "dit"

    heads = getattr(args, "attention_heads", 8)
    if heads != 8:
        if estimator != "unet":
            _err(f"--attention-heads is a unet-family option; "
                 f"--estimator {estimator} pins its own head geometry")
        if attention == "none":
            _err("--attention-heads has no effect without attention layers; "
                 "add --attention spatial|linear")

    asked_flash = getattr(args, "flash", None)
    flash = has_attention if asked_flash is None else bool(asked_flash)
    if flash and not has_attention:
        _err("--flash has no effect without attention layers; add "
             "--attention spatial|linear (or --estimator dit)")

    asked_geglu = getattr(args, "fused_geglu", None)
    fused = (attention == "spatial") if asked_geglu is None else bool(asked_geglu)
    if fused and attention != "spatial":
        # the GEGLU MLP lives only in the SpatialTransformer blocks
        _err("--fused-geglu has no effect without --attention spatial "
             "(DiT's MLP is GELU, not GEGLU)")

    if torch.device(getattr(args, "device", None) or "cuda").type == "cuda":
        for flag, asked in (("--no-flash", asked_flash), ("--no-fused-geglu", asked_geglu)):
            if asked is False:
                _err(f"{flag}: on the card the hand-written kernels are the only route; "
                     f"their plain versions are the kernels' oracles (run them with "
                     f"--device cpu)")

    fused_up = getattr(args, "fused_up", None)
    fused_up = True if fused_up is None else bool(fused_up)
    s2d_tail = getattr(args, "s2d_tail", None)
    s2d_tail = True if s2d_tail is None else bool(s2d_tail)
    return flash, fused, fused_up, s2d_tail
