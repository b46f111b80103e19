"""Train state (port of ``medfusion_tpu/train/state.py``): the step count,
the float32 model, its AdamW optimizer, an optional learning-rate schedule
and an optional EMA copy.

The JAX package keeps these in one immutable pytree; here the module, the
optimizer and the EMA copy are updated in place. ``torch.optim.AdamW`` gives
optax ``adamw``'s update: decoupled weight decay on the parameters before
the step, and bias-corrected m / (sqrt(v) + eps); with ``weight_decay=0``
it is optax ``adam``, which the autoencoder trains with.
:meth:`TrainState.state_dict` holds all of it in tensors, numbers and
strings, for ``torch.load(weights_only=True)``. :class:`GANTrainState` holds
two of them, the autoencoder's and the discriminators'."""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch

from medfusion_tpu_torch.train.ema import ema_decay, ema_update
from medfusion_tpu_torch.utils.profiling import annotate


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
        with annotate("train.optimizer"):
            self.optimizer.step()
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        if self.ema is not None:
            with annotate("train.ema"):
                ema_update(self.ema, self.model, ema_decay(self.step))
        self.step += 1

    @property
    def inference_model(self) -> torch.nn.Module:
        """The EMA copy where there is one, else the model."""
        return self.ema if self.ema is not None else self.model

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "lr_scheduler": (None if self.lr_scheduler is None
                                 else self.lr_scheduler.state_dict()),
                "ema": None if self.ema is None else self.ema.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore :meth:`state_dict`'s content in place; raises when the
        checkpoint and this state disagree on the EMA or the schedule."""
        if (sd["ema"] is None) != (self.ema is None):
            raise ValueError(f"the checkpoint {'has' if sd['ema'] is not None else 'has no'} "
                             f"EMA, this state {'has' if self.ema is not None else 'has none'}")
        if (sd["lr_scheduler"] is None) != (self.lr_scheduler is None):
            raise ValueError("the checkpoint and this state disagree on the lr schedule")
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(sd["lr_scheduler"])
        if self.ema is not None:
            self.ema.load_state_dict(sd["ema"], strict=True)
        self.step = int(sd["step"])


class GANTrainState:
    """The two-player state of adversarial autoencoder training (port of
    ``medfusion_tpu/train/adversarial.py::GANTrainState``): ``step`` counts
    optimizer steps, two a batch (the reference's "step increases with each
    optimizer"); ``gen`` is the autoencoder's :class:`TrainState`, ``disc``
    the discriminators' (one ``nn.ModuleList``, one per pyramid level), each
    on Adam (``weight_decay=0``) at ``lr`` under ``lr_schedule``. The
    BatchNorm buffers of a PatchGAN discriminator are in ``disc``'s module
    state."""

    def __init__(self, generator: torch.nn.Module, discriminators: torch.nn.ModuleList,
                 lr: float = 1e-6, lr_schedule: Optional[Callable[[int], float]] = None):
        self.step = 0
        self.gen = TrainState(generator, lr=lr, weight_decay=0.0, lr_schedule=lr_schedule)
        self.disc = TrainState(discriminators, lr=lr, weight_decay=0.0,
                               lr_schedule=lr_schedule)

    def state_dict(self) -> Dict:
        return {"step": self.step, "gen": self.gen.state_dict(),
                "disc": self.disc.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        if "gen" not in sd:
            raise ValueError("the checkpoint holds no two-player (--gan) state")
        self.gen.load_state_dict(sd["gen"])
        self.disc.load_state_dict(sd["disc"])
        self.step = int(sd["step"])
