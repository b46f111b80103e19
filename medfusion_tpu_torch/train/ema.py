"""EMA of model weights with the warmup decay of ``medfusion_tpu/train/ema.py``:
decay = 1 - (1 + step / inv_gamma)^-power clamped to [min_value,
max_value], and 0 while step <= 0, with step = optimization_step -
update_after_step - 1."""

from __future__ import annotations

import torch


def ema_decay(optimization_step: int, update_after_step: int = 0,
              inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
              min_value: float = 0.0, max_value: float = 0.9999) -> float:
    step = max(0, optimization_step - update_after_step - 1)
    if step <= 0:
        return 0.0
    value = 1.0 - (1.0 + step / inv_gamma) ** (-power)
    return min(max(value, min_value), max_value)


@torch.no_grad()
def ema_update(ema_model: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * new, parameter by parameter, in
    place (the JAX package returns a new tree)."""
    ema = dict(ema_model.named_parameters())
    names = list(ema)
    new = dict(model.named_parameters())
    if set(new) != set(names):
        raise ValueError("the EMA model and the model have different parameters")
    targets = [ema[n] for n in names]
    torch._foreach_mul_(targets, decay)
    torch._foreach_add_(targets, [new[n].detach().to(ema[n].dtype) for n in names],
                        alpha=1.0 - decay)
