"""Learning-rate schedules (port of ``medfusion_tpu/train/lr_schedules.py``)
as per-step multipliers of the base learning rate, for
``torch.optim.lr_scheduler.LambdaLR``: update ``i`` (counted from 0) runs
at ``base_lr * schedule(i)``, as optax evaluates its schedule at the count
of updates made before.

* ``const``: 1, with an optional linear warmup from 0.
* ``cosine``: linear warmup from 0, then cosine decay to 0 at
  ``total_steps`` (warmup included).
* ``lambda_linear``: the reference's vendored ``LambdaLinearScheduler`` with
  its defaults: linear warmup from 1e-6 to 1 over ``warmup_steps`` (default
  10000), then flat at 1.
"""

from __future__ import annotations

import math
from typing import Callable


def make_lr_schedule(name: str, warmup_steps: int = 0,
                     total_steps: int = 100_000) -> Callable[[int], float]:
    if name == "const":
        if warmup_steps > 0:
            return lambda step: min(step, warmup_steps) / warmup_steps
        return lambda step: 1.0
    if name == "cosine":
        warm = max(warmup_steps, 1)
        decay = max(total_steps, warm + 1) - warm

        def cosine(step):
            if step < warm:
                return step / warm
            return 0.5 * (1.0 + math.cos(math.pi * min(step - warm, decay) / decay))

        return cosine
    if name == "lambda_linear":
        warm, f_start = warmup_steps or 10000, 1.0e-6
        return lambda step: (1.0 - f_start) / warm * step + f_start if step < warm else 1.0
    raise ValueError(f"unknown lr schedule {name!r}")
