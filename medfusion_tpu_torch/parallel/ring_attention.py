"""Sequence-parallel exact attention over a mesh dim, differentiable in q, k
and v (port of ``medfusion_tpu/parallel/ring_attention.py``).

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

The backward is a ring too. With the merged o and L, p = exp(s - L) is the
globally normalised probability and D = rowsum(dO o) the global D, so the
flash-attention backward of one (q block, K/V block) pair (the dQ and dK/dV
kernels on the card, their plain version on the CPU) gives exact partial
sums: this rank's dQ is the sum of its pairs' dQ, and a K/V block's dK/dV
the sum over the ranks' q blocks. Each rank walks the ring again, carrying
with the K/V block it holds that block's dK/dV accumulators (f32), adds its
pair's share and passes all four on; after the last block one more rotation
of the accumulators alone brings each block's dK/dV home to its owner (n
rotations of the accumulators, n - 1 of k and v). The rotated blocks are
received again rather than saved in the forward, so memory stays O(n_loc)
per rank, the point of ring attention.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from medfusion_tpu_torch.ops.flash_attention import (
    _on_card,
    flash_attention,
    flash_attention_backward_cuda,
    flash_attention_backward_reference,
)
from medfusion_tpu_torch.parallel import comm
from medfusion_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


def merge_attention_blocks(outs, lses):
    """Exact attention from the attention of one q block against each of
    several K/V blocks: ``outs`` [B, H, N, D] and ``lses`` [B, H, N] f32,
    one pair a K/V block. Returns (o in ``outs[0]``'s dtype, the merged row
    logsumexp L [B, H, N] f32); one block's pair is returned as it is."""
    if len(outs) == 1:
        return outs[0], lses[0]
    lse = torch.stack(lses)
    total = torch.logsumexp(lse, dim=0)
    o = sum(torch.exp(l - total)[..., None] * o.float() for o, l in zip(outs, lse))
    return o.to(outs[0].dtype), total


def _pair_backward(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) of one (q block, K/V block) pair in the input dtype:
    the dQ and dK/dV kernels for a CUDA tensor, their plain version for a
    CPU tensor."""
    bwd = flash_attention_backward_cuda if _on_card(q) else flash_attention_backward_reference
    return bwd(q, k, v, o, lse, do, scale)


def attention_blocks_backward(q, kv_blocks, o, lse, do, scale: float):
    """The backward of one q block against K/V blocks held on this rank:
    ``kv_blocks`` a list of (k, v) [B, H, M_i, D], ``o`` and ``lse`` the
    merged output and row logsumexp over all of them (``merge_attention_blocks``),
    ``do`` the gradient of o. Returns (dq f32, [(dk, dv) in the input dtype,
    one pair a block]); the ring's backward is this function spread over
    ranks."""
    dq, dkv = None, []
    for k, v in kv_blocks:
        dq_i, dk, dv = _pair_backward(q, k, v, o, lse, do, scale)
        dq = dq_i.float() if dq is None else dq.add_(dq_i)
        dkv.append((dk, dv))
    return dq, dkv


def _ring_forward(q, k, v, scale, group):
    """This rank's (o, L): the held block first, then n - 1 rotations (a
    rotation inside every turn would move one K/V block that nothing
    reads)."""
    blocks = [flash_attention(q, k, v, scale)]
    for _ in range(dist.get_world_size(group) - 1):
        k, v = comm.rotate((k, v), group)
        blocks.append(flash_attention(q, k, v, scale))
    return merge_attention_blocks(*zip(*blocks))


class _RingAttention(torch.autograd.Function):
    """o of ring attention; its backward walks the ring again with dK/dV
    carried beside the K/V blocks. Every rank of the group must run the
    backward (a rank whose dO is zero too): it sends and receives."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group):
        o, lse = _ring_forward(q, k, v, scale, group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (scale, group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, group = ctx.cfg
        n = dist.get_world_size(group)
        dtype = q.dtype
        grads = _pair_backward(q, k, v, o, lse, do, scale)
        if n > 1:  # f32 sums; a world of one returns the pair's gradients as they are
            dq, dk, dv = (g.float() for g in grads)
            for _ in range(n - 1):
                # at step t rank r holds rank (r - t) mod n's K/V block and its sums
                k, v, dk, dv = comm.rotate((k, v, dk, dv), group)
                for acc, g in zip((dq, dk, dv), _pair_backward(q, k, v, o, lse, do, scale)):
                    acc.add_(g)
            # rank r now holds block r + 1's sums: one step on brings each home
            dk, dv = comm.rotate((dk, dv), group)
            grads = (dq, dk, dv)
        return (*(g.to(dtype) if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None, None)


def shard_tokens(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's block of the tokens (dim 2) of a full [B, H, N, D]."""
    n = axis_size(mesh, axis)
    if x.shape[2] % n:
        raise ValueError(f"{x.shape[2]} tokens do not split over {n} ranks")
    return x.chunk(n, dim=2)[axis_rank(mesh, axis)]


def ring_attention(q, k, v, mesh, scale: float, axis: str = "data"):
    """Exact attention of this rank's token block against every rank's,
    differentiable in q, k and v.

    q, k, v: this rank's [B, H, n_loc, D] blocks of tokens split over
    ``mesh[axis]`` (:func:`shard_tokens`). ``scale`` is applied to both q
    and k. Returns this rank's [B, H, n_loc, D] block of the output."""
    return _RingAttention.apply(q, k, v, scale, axis_group(mesh, axis))
