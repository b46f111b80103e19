"""Sequence-parallel exact attention over a mesh dim (port of
``medfusion_tpu/parallel/ring_attention.py``).

Tokens are split over the ranks of a mesh dim: each rank holds one block of
q, k and v. It attends to its own K/V block, then passes the K/V block it
holds to the next rank of the ring and takes the previous rank's
(``batch_isend_irecv``), n - 1 times, so every q block meets every K/V block
with (n - 1) neighbour exchanges. Each block's attention is the port's
flash-attention forward in the head layout (``ops/flash_attention.py``: the
CUDA kernel for a CUDA tensor, its plain version for a CPU tensor), which
returns the block's o and its row logsumexp lse; the partial results merge
exactly by lse: o = sum_i exp(lse_i - L) o_i with L = logsumexp_i(lse_i).
The double-scale convention holds: (q s)(k s)^T.

Forward only, as the JAX package's ring attention is only ever run: the
kernel's lse carries no gradient, so under autograd with q, k or v requiring
grad it raises (ROADMAP names the follow-up).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from medfusion_tpu_torch.ops.flash_attention import flash_attention
from medfusion_tpu_torch.parallel import comm
from medfusion_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


def merge_attention_blocks(outs, lses):
    """Exact attention from the attention of one q block against each of
    several K/V blocks: ``outs`` [B, H, N, D] and ``lses`` [B, H, N] f32,
    one pair a K/V block. Returns o in ``outs[0]``'s dtype."""
    if len(outs) == 1:
        return outs[0]
    lse = torch.stack(lses)
    total = torch.logsumexp(lse, dim=0)
    o = sum(torch.exp(l - total)[..., None] * o.float() for o, l in zip(outs, lse))
    return o.to(outs[0].dtype)


def shard_tokens(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's block of the tokens (dim 2) of a full [B, H, N, D]."""
    n = axis_size(mesh, axis)
    if x.shape[2] % n:
        raise ValueError(f"{x.shape[2]} tokens do not split over {n} ranks")
    return x.chunk(n, dim=2)[axis_rank(mesh, axis)]


def ring_attention(q, k, v, mesh, scale: float, axis: str = "data"):
    """Exact attention of this rank's token block against every rank's.

    q, k, v: this rank's [B, H, n_loc, D] blocks of tokens split over
    ``mesh[axis]`` (:func:`shard_tokens`). ``scale`` is applied to both q
    and k. Returns this rank's [B, H, n_loc, D] block of the output."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "ring_attention is forward only: its gradient (kernels 3-4 with dK/dV "
            "rotated back around the ring) is a ROADMAP follow-up")
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    outs, lses = [], []
    o, lse = flash_attention(q, k, v, scale)
    outs.append(o)
    lses.append(lse)
    # the held block first, then n - 1 rotations: a rotation inside every
    # turn would move one K/V block that nothing reads
    for _ in range(n - 1):
        k, v = comm.rotate((k, v), group)
        o, lse = flash_attention(q, k, v, scale)
        outs.append(o)
        lses.append(lse)
    return merge_attention_blocks(outs, lses)
