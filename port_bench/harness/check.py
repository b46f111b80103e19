"""The numbers that decide ``correct``, each beside its limit.

* Training: the worst step's loss gap |l - l_ref| / |l_ref| over the three
  checked steps; and by the worst leaf, the gap between the program's norm
  and the reference's of the first gradient ('grad'), of the parameters'
  change after three steps ('change') and of the EMA's change ('ema'),
  each measured against the reference's norm of that leaf or of the median
  leaf, whichever is larger. Leaves whose reference gradient is under a
  thousandth of the median leaf's (nought to rounding) are left out of the
  changes: AdamW moves them by round-off alone. And one number steady
  from seed to seed: over the leaves whose first gradient is not nought,
  the median of ||g - g_ref|| / ||g_ref||, the first gradient's relative
  gap element by element ('grad_diff_median_leaf').
* Sampling: by the worst image of the sample, the relative L2 gap
  ||x - x_ref|| / ||x_ref||."""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is nought


def leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).cpu().double()


def worst_leaf_gap(prog: torch.Tensor, ref: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> float:
    """max over leaves of | |p| - |r| | / max(|r|, median |r|)."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    scale = torch.clamp(ref, min=float(ref.median()))
    gap = ((prog - ref).abs() / scale).max()
    return float(gap)


def median_leaf_gap(prog: torch.Tensor, ref: torch.Tensor,
                    keep: Optional[torch.Tensor] = None) -> float:
    """The median over leaves of | |p| - |r| | / |r|."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    return float(((prog - ref).abs() / ref.clamp(min=1e-30)).median())


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog``/``ref``: {'losses' [3], 'grad', 'change', 'ema' (leaf norms,
    in the same leaf order)}; ``ref`` may hold 'grad_diff', the leaf norms
    of the difference of the two first gradients."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    keep = ref["grad"] >= NOUGHT * float(ref["grad"].median())
    numbers = {"loss": max(losses),
               "grad": worst_leaf_gap(prog["grad"], ref["grad"]),
               "change": worst_leaf_gap(prog["change"], ref["change"], keep),
               "ema": worst_leaf_gap(prog["ema"], ref["ema"], keep),
               "grad_median_leaf": median_leaf_gap(prog["grad"], ref["grad"]),
               "change_median_leaf": median_leaf_gap(prog["change"], ref["change"], keep)}
    if "grad_diff" in ref:
        numbers["grad_diff_median_leaf"] = float(
            (ref["grad_diff"][keep] / ref["grad"][keep]).median())
    return numbers


def image_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max over images [B, ...] of ||x - x_ref|| / ||x_ref||."""
    d = (prog.float() - ref.float()).flatten(1).norm(dim=1)
    return float((d / ref.float().flatten(1).norm(dim=1)).max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{'correct', 'checks': {name: {'value', 'limit'}}} over the numbers that
    have a limit; a number that is missing or not finite fails."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return {"correct": ok, "checks": checks}


def print_checks(checks: Dict) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
