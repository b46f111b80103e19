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

Expert parallelism (``expert_axis``, a process group or a 1-D
``DeviceMesh``, n ranks): each rank holds E/n of the experts (experts
[r E/n, (r + 1) E/n) on rank r) and its own rows of the batch, the group
being the one the batch rows are split over. Routing and capacity stay per
sample, so splitting the batch changes no routing. The dispatched buffer
[E, b, cap, d] goes through a differentiable all-to-all to the experts'
ranks, each rank runs its experts on every rank's tokens, and a second
all-to-all brings the results back before the combine. The load-balance
statistics (the router's mean probability and the first slot's share, per
expert) are means over the group's batch, as the JAX layer takes them over
the whole batch. :func:`moe_partition_spec` gives the JAX package's
placements for a whole layer's parameters.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.parallel import comm


def moe_capacity(capacity_factor: float, k: int, n: int, e: int) -> int:
    """Each expert's token buffer: max(1, ceil(cf * k * N / E))."""
    return max(1, int(math.ceil(capacity_factor * k * n / e)))


def _fan_avg_uniform_(w: torch.Tensor, e: int) -> torch.Tensor:
    """flax ``variance_scaling(1, 'fan_avg', 'uniform')`` on [E, d_in, d_out]
    (``w`` holds some of the E experts): fan_in = d_in * E and fan_out =
    d_out * E (the leading axis is a receptive field), so the bound is
    sqrt(6 / (E * (d_in + d_out)))."""
    _, d_in, d_out = w.shape
    bound = math.sqrt(6.0 / (e * (d_in + d_out)))
    return nn.init.uniform_(w, -bound, bound)


def _as_group(expert_axis):
    """The process group of ``expert_axis``: a group, or a 1-D DeviceMesh."""
    if expert_axis is None or isinstance(expert_axis, dist.ProcessGroup):
        return expert_axis
    if hasattr(expert_axis, "get_group"):
        return expert_axis.get_group()
    raise TypeError(f"expert_axis must be a process group or a 1-D DeviceMesh, got "
                    f"{type(expert_axis).__name__}")


class MoEMLP(nn.Module):
    """Top-k routed expert MLP, [B, N, d] -> ([B, N, d], aux)."""

    expert_parameter_names = ("w1", "b1", "w2", "b2")

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 1e-2, router_z_weight: float = 1e-3,
                 expert_axis=None):
        super().__init__()
        # a deep copy (the EMA copy) shares the group
        self._expert_group = comm.Shared(_as_group(expert_axis))
        n = 1 if self.expert_group is None else dist.get_world_size(self.expert_group)
        if num_experts % n:
            raise ValueError(f"{num_experts} experts do not split over {n} ranks")
        local = num_experts // n
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_z_weight = router_z_weight
        self.router = nn.Linear(hidden_size, num_experts, bias=False)
        nn.init.normal_(self.router.weight, std=0.02)
        self.w1 = nn.Parameter(_fan_avg_uniform_(torch.empty(local, hidden_size, mlp_dim),
                                                 num_experts))
        self.b1 = nn.Parameter(torch.zeros(local, mlp_dim))
        self.w2 = nn.Parameter(_fan_avg_uniform_(torch.empty(local, mlp_dim, hidden_size),
                                                 num_experts))
        self.b2 = nn.Parameter(torch.zeros(local, hidden_size))

    @property
    def expert_group(self):
        return self._expert_group.value

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
        me, ce = probs.mean(dim=(0, 1)), first.mean(dim=(0, 1))
        if self.expert_group is not None:
            me, ce = comm.mean_over(me, self.expert_group), comm.mean_over(ce, self.expert_group)
        aux = self.aux_loss_weight * e * (me * ce).sum()
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + self.router_z_weight * (z * z).mean()

        dispatch = (combine > 0).to(x.dtype)
        xin = torch.einsum("bnec,bnd->ebcd", dispatch, x).contiguous()
        out = self._experts(xin)
        y = torch.einsum("bnec,ebcd->bnd", combine.to(x.dtype), out)
        return y, aux

    def _experts(self, xin):
        """The experts' MLP on the dispatched buffer [E, b, cap, d]; under
        expert parallelism each rank's experts run on every rank's tokens,
        between two all-to-alls."""
        g = self.expert_group
        if g is not None:
            n = dist.get_world_size(g)
            e, b = xin.shape[:2]
            # [E, b] -> n chunks of E/n experts, one to each rank; back come
            # [n (source rank), E/n, b] of this rank's experts
            xin = comm.all_to_all(xin, g)
            xin = xin.unflatten(0, (n, e // n)).transpose(0, 1).flatten(1, 2).contiguous()
        h = torch.einsum("ebcd,edm->ebcm", xin, self.w1) + self.b1[:, None, None, :]
        h = F.gelu(h, approximate="tanh")
        out = (torch.einsum("ebcm,emd->ebcd", h, self.w2)
               + self.b2[:, None, None, :]).contiguous()
        if g is not None:
            out = out.unflatten(1, (n, b)).transpose(0, 1).flatten(0, 1).contiguous()
            out = comm.all_to_all(out, g)
        return out


def moe_partition_spec(module: nn.Module, mesh, axis: str = "model"):
    """Expert-parallel placements of a mixture-of-experts layer's parameters
    (name -> one placement a mesh dim): the leading (expert) dim of every
    parameter of rank >= 2 that divides by the ``axis`` size is sharded over
    ``axis``; the rest is replicated. The router is excluded by name (its
    [E, hidden] weight would otherwise match the rule)."""
    from medfusion_tpu_torch.parallel.mesh import Shard, _dim, axis_size, replicated

    n = axis_size(mesh, axis)
    out = {}
    for name, p in module.named_parameters():
        place = list(replicated(mesh))
        if ("router" not in name.split(".") and n > 1 and p.ndim >= 2
                and p.shape[0] % n == 0):
            place[_dim(mesh, axis)] = Shard(0)
        out[name] = tuple(place)
    return out


def moe_aux_loss(auxes) -> torch.Tensor:
    """The sum of every aux loss in a (nested) list, tuple or dict of the
    values mixture-of-experts layers return; add it to the training loss."""
    if isinstance(auxes, dict):
        auxes = list(auxes.values())
    if isinstance(auxes, (list, tuple)):
        return sum((moe_aux_loss(a) for a in auxes), torch.zeros(()))
    return torch.as_tensor(auxes, dtype=torch.float32).sum()
