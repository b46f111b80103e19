"""The plain reference of what the cells run around the models: the
scaled-linear schedule, the DDIM sampler at eta 1 with the eps objective
and no clipping, the L1 training loss on eps with classifier-free-guidance
dropout, AdamW and the EMA with its warm-up decay. Float32 throughout;
channels-last at the boundary, as the port's public calls are."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


class Schedule:
    """Float32 tables of the schedule, built in float64."""

    def __init__(self, cfg: dict, device):
        T = cfg["timesteps"]
        if cfg["schedule"] != "scaled_linear":
            raise ValueError(f"no reference for schedule {cfg['schedule']!r}")
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, T) ** 2
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        t32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        self.T = T
        self.ac = t32(ac)
        self.sqrt_ac = t32(np.sqrt(ac))
        self.sqrt_1m_ac = t32(np.sqrt(1.0 - ac))
        self.sqrt_recip_ac = t32(np.sqrt(1.0 / ac))
        self.sqrt_recipm1_ac = t32(np.sqrt(1.0 / ac - 1.0))
        self.coef1 = t32(betas * np.sqrt(ac_prev) / (1.0 - ac))
        self.coef2 = t32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac))

    def grid(self, steps: int) -> List[int]:
        """The DDIM grid, descending (linspace spacing)."""
        asc = np.linspace(0.0, float(self.T - 1), steps).astype(np.int64)
        return [int(v) for v in asc[::-1]]


def _nchw(x):
    return x.movedim(-1, 1)


@torch.no_grad()
def sample(unet, vae, sched: Schedule, x_T, noise, labels, steps: int, eta: float = 1.0):
    """Images [B, H, W, C] from x_T [B, h, w, c] and the loop's draws
    [steps, 2, B, h, w, c] (column 1 the DDIM draw of each step)."""
    x = _nchw(x_T).float()
    b = x.shape[0]
    ones = torch.ones(b, device=x.device)
    ts = sched.grid(steps)
    for i, t in enumerate(ts):
        eps = unet(x, torch.full((b,), t, device=x.device, dtype=torch.long), labels, ones)
        x0 = sched.sqrt_recip_ac[t] * x - sched.sqrt_recipm1_ac[t] * eps
        if i + 1 < len(ts):
            a, an = sched.ac[t], sched.ac[ts[i + 1]]
            sigma = eta * torch.sqrt((1 - a / an) * (1 - an) / (1 - a))
            c = torch.sqrt(torch.clamp(1 - an - sigma ** 2, min=0.0))
            x = x0 * torch.sqrt(an) + c * eps + sigma * _nchw(noise[i, 1]).float()
        else:  # t = 0: the posterior mean, with no noise
            x = sched.coef1[t] * x0 + sched.coef2[t] * x
    return vae.decode(x).movedim(1, -1)


def loss(unet, vae, sched: Schedule, batch: Dict, draws: Dict):
    """The L1 loss on eps of one block of rows (a mean over the block)."""
    x = _nchw(batch["source"]).float()
    with torch.no_grad():
        z = vae.encode(x, _nchw(draws["enc_noise"]).float())
    t = draws["t"]
    x_T = _nchw(draws["x_T"]).float()
    x_t = sched.sqrt_ac[t][:, None, None, None] * z + sched.sqrt_1m_ac[t][:, None, None, None] * x_T
    mask = torch.where(torch.as_tensor(draws["drop"], device=x.device), 0.0, 1.0).expand(
        x.shape[0])
    return (unet(x_t, t, batch["target"], mask) - x_T).abs().mean()


def ema_decay(step: int, cfg: dict) -> float:
    """The EMA's decay at optimisation step ``step`` (before its increment)."""
    e = cfg["ema"]
    s = max(0, step - e["update_after_step"] - 1)
    if s <= 0:
        return 0.0
    value = 1.0 - (1.0 + s / e["inv_gamma"]) ** (-e["power"])
    return min(max(value, e["min_value"]), e["max_value"])


class AdamW:
    """Decoupled weight decay, then Adam with bias correction; a parameter
    without a gradient is decayed all the same (its gradient is zero)."""

    def __init__(self, params: Sequence[torch.Tensor], cfg: dict):
        o = cfg["optimizer"]
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps, self.wd = (o["lr"], o["betas"], o["eps"],
                                                          o["weight_decay"])
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
