"""Mixture-of-experts MLP with capacity-based top-k routing (port of
``medfusion_tpu/parallel/moe.py::MoEMLP``; GShard, arXiv:2006.16668, and
Switch, arXiv:2101.03961).

Routing is dense one-hot work over static shapes, as in the JAX package:
float32 router probabilities, an iterative top-k argmax (the gates
renormalised over the k chosen for k > 1; k = 1 keeps the raw probability,
so the router still reaches the task gradient), each expert's buffer
capped at ``moe_capacity`` tokens with the overflow dropped, later
selection slots queued behind earlier ones, and ``(combine > 0)`` as the
dispatch mask. The dispatch, the two expert matmuls and the combine are
``torch.einsum`` calls: the JAX package computes them outside any Pallas
kernel. The forward returns ``(y, aux)``: aux is the load-balance loss on
the first selection slot plus the router z-loss, each weighted, a float32
scalar; returning it keeps one call's aux loss out of another's (the JAX
package sows it into flax intermediates).

The experts' weights are local to one card: expert parallelism
(``expert_axis``, ``moe_partition_spec``) is ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def moe_capacity(capacity_factor: float, k: int, n: int, e: int) -> int:
    """Each expert's token buffer: max(1, ceil(cf * k * N / E))."""
    return max(1, int(math.ceil(capacity_factor * k * n / e)))


def _fan_avg_uniform_(w: torch.Tensor) -> torch.Tensor:
    """flax ``variance_scaling(1, 'fan_avg', 'uniform')`` on [E, d_in, d_out]:
    fan_in = d_in * E and fan_out = d_out * E (the leading axis is a
    receptive field), so the bound is sqrt(6 / (E * (d_in + d_out)))."""
    e, d_in, d_out = w.shape
    bound = math.sqrt(6.0 / (e * (d_in + d_out)))
    return nn.init.uniform_(w, -bound, bound)


class MoEMLP(nn.Module):
    """Top-k routed expert MLP, [B, N, d] -> ([B, N, d], aux)."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 1e-2, router_z_weight: float = 1e-3,
                 expert_axis=None):
        super().__init__()
        if expert_axis is not None:
            raise NotImplementedError("expert_axis (expert parallelism) is not ported "
                                      "(ROADMAP Queue 1, item 9)")
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_z_weight = router_z_weight
        self.router = nn.Linear(hidden_size, num_experts, bias=False)
        nn.init.normal_(self.router.weight, std=0.02)
        self.w1 = nn.Parameter(_fan_avg_uniform_(torch.empty(num_experts, hidden_size,
                                                             mlp_dim)))
        self.b1 = nn.Parameter(torch.zeros(num_experts, mlp_dim))
        self.w2 = nn.Parameter(_fan_avg_uniform_(torch.empty(num_experts, mlp_dim,
                                                             hidden_size)))
        self.b2 = nn.Parameter(torch.zeros(num_experts, hidden_size))

    def route(self, logits):
        """float32 router logits [B, N, E] -> (probs, combine [B, N, E, cap]
        float32, the first slot's one-hot selection [B, N, E])."""
        b, n, e = logits.shape
        k = min(self.num_selected, e)
        cap = moe_capacity(self.capacity_factor, k, n, e)
        probs = torch.softmax(logits, dim=-1)
        masked = probs
        sel_masks, sel_gates = [], []
        for _ in range(k):
            onehot = F.one_hot(masked.argmax(dim=-1), e).to(probs.dtype)
            sel_masks.append(onehot)
            sel_gates.append((probs * onehot).sum(dim=-1))
            masked = masked * (1.0 - onehot)
        if k > 1:
            denom = sum(sel_gates) + 1e-9
            sel_gates = [g / denom for g in sel_gates]
        slots = torch.arange(cap, device=logits.device)
        combine = torch.zeros((b, n, e, cap), dtype=probs.dtype, device=logits.device)
        used = torch.zeros((b, 1, e), dtype=probs.dtype, device=logits.device)
        for mask, gate in zip(sel_masks, sel_gates):
            pos = torch.cumsum(mask, dim=1) - mask + used  # place in the expert's buffer
            fits = (pos < cap).to(probs.dtype) * mask
            used = used + fits.sum(dim=1, keepdim=True)
            # a place at or past cap matches no slot: a zero row, as jax.nn.one_hot
            pos_oh = (pos.long()[..., None] == slots).to(probs.dtype)
            combine = combine + gate[..., None, None] * fits[..., None] * pos_oh
        return probs, combine, sel_masks[0]

    def forward(self, x):
        e = self.num_experts
        logits = self.router(x).float()
        probs, combine, first = self.route(logits)
        # load balance on the first slot (Switch eq. 4) and the router z-loss
        # (ST-MoE, arXiv:2202.08906 eq. 5)
        aux = self.aux_loss_weight * e * (probs.mean(dim=(0, 1)) * first.mean(dim=(0, 1))).sum()
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + self.router_z_weight * (z * z).mean()

        dispatch = (combine > 0).to(x.dtype)
        xin = torch.einsum("bnec,bnd->ebcd", dispatch, x)
        h = torch.einsum("ebcd,edm->ebcm", xin, self.w1) + self.b1[:, None, None, :]
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ebcm,emd->ebcd", h, self.w2) + self.b2[:, None, None, :]
        y = torch.einsum("bnec,ebcd->bnd", combine.to(x.dtype), out)
        return y, aux
