"""Train state (port of ``medfusion_tpu/train/state.py``): the step count,
the float32 estimator, its AdamW optimizer and an optional EMA copy.

The JAX package keeps these in one immutable pytree; here the module, the
optimizer and the EMA copy are updated in place. ``torch.optim.AdamW`` gives
optax ``adamw``'s update: decoupled weight decay on the parameters before
the step, and bias-corrected m / (sqrt(v) + eps)."""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from medfusion_tpu_torch.train.ema import ema_decay, ema_update


class TrainState:
    def __init__(self, model: torch.nn.Module, lr: float = 1e-4,
                 weight_decay: float = 1e-2, use_ema: bool = False,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        self.step = 0
        self.model = model
        self.optimizer = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay)
        self.lr_scheduler = (torch.optim.lr_scheduler.LambdaLR(self.optimizer, lr_schedule)
                             if lr_schedule is not None else None)
        # a deep copy: the EMA must not alias the live parameters
        self.ema = copy.deepcopy(model).requires_grad_(False) if use_ema else None

    def apply_gradients(self) -> None:
        """One AdamW step on the gradients held in the parameters' ``.grad``;
        then the EMA, with the decay of the step count BEFORE the increment
        (as the JAX package's ``apply_gradients``); then step += 1."""
        self.optimizer.step()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.ema is not None:
            ema_update(self.ema, self.model, ema_decay(self.step))
        self.step += 1
