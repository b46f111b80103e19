"""Learning-rate schedules (port of ``medfusion_tpu/train/lr_schedules.py``)
as per-step multipliers of the base learning rate, for
``torch.optim.lr_scheduler.LambdaLR``: update ``i`` (counted from 0) runs
at ``base_lr * schedule(i)``, as optax evaluates its schedule at the count
of updates made before.

* ``const``: 1, with an optional linear warmup from 0.
* ``cosine``: linear warmup from 0, then cosine decay to 0 at
  ``total_steps`` (warmup included).
* ``lambda_linear``: the reference's vendored ``LambdaLinearScheduler``
  (:func:`lambda_linear_schedule`) with its defaults: linear warmup from
  1e-6 to 1 over ``warmup_steps`` (default 10000), then flat at 1.
"""

from __future__ import annotations

import bisect
import itertools
import math
from typing import Callable, Sequence


def lambda_linear_schedule(warm_up_steps: Sequence[int] = (10000,),
                           f_min: Sequence[float] = (1.0,), f_max: Sequence[float] = (1.0,),
                           f_start: Sequence[float] = (1.0e-6,),
                           cycle_lengths: Sequence[int] = (10_000_000_000_000,)
                           ) -> Callable[[int], float]:
    """The reference's ``LambdaLinearScheduler`` as ``step -> multiplier``:
    in each cycle (a step at a cycle's end still belongs to it) a linear
    warmup from ``f_start`` to ``f_max`` over ``warm_up_steps``, then a
    linear decay from ``f_max`` toward ``f_min`` over the cycle's length;
    every argument has one entry a cycle."""
    n_cycles = len(cycle_lengths)
    if not len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start) == n_cycles:
        raise ValueError("lambda_linear_schedule takes one entry a cycle in every argument")
    ends = list(itertools.accumulate(cycle_lengths))

    def schedule(step):
        cycle = min(bisect.bisect_left(ends, step), n_cycles - 1)
        n = step - (ends[cycle - 1] if cycle else 0)
        warm, cl = warm_up_steps[cycle], cycle_lengths[cycle]
        if n < warm:
            return (f_max[cycle] - f_start[cycle]) / warm * n + f_start[cycle]
        return f_min[cycle] + (f_max[cycle] - f_min[cycle]) * (cl - n) / cl

    return schedule


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
        return lambda_linear_schedule(warm_up_steps=(warmup_steps or 10000,))
    raise ValueError(f"unknown lr schedule {name!r}")
