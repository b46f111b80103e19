#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 19 (the constructor options no CLI reaches) alone
on one CUDA card.

Builds the kernels, then runs the phase's parts in order: (a) the chest UNet
and VAE without learnable interpolation, DDIM 25 with CFG and the decode;
(b) one bf16 train step of that UNet and of the legacy UNet whose decoders
concatenate their skips, with kernels 1, 3-6 held at their shapes; (c) the
3-D classifier, f32 forward and backward; (d) small widths on the card
against the CPU. Prints each part's report and the worst error by kernel.
Needs no earlier phase's files. Run from the repository root:

    python3 tools/surface_phase.py [a] [b] [c] [d]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(parts):
    import torch

    import chip_smoke as cs
    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.ops import build
    from medfusion_tpu_torch.ops import flash_attention as FA
    from medfusion_tpu_torch.ops import geglu as GL
    from medfusion_tpu_torch.ops import group_norm as G

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    worst = {}
    t0 = time.perf_counter()
    if "a" in parts:
        print(cs.phase_surface_sampling(ops, G, worst), flush=True)
    if "b" in parts:
        print(cs.phase_surface_training(ops, FA, G, GL, worst), flush=True)
    if "c" in parts:
        print(cs.phase_surface_classifier_3d(ops, FA, worst), flush=True)
    if "d" in parts:
        print(cs.phase_surface_vs_cpu(), flush=True)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s; worst {worst}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["a", "b", "c", "d"])
