"""The collectives of the parallel layer, each an autograd function whose
backward is the collective the gradient needs (the port's counterpart of
what GSPMD inserts into the JAX package's compiled step).

The group's backend follows its device: gloo for CPU tensors, NCCL for CUDA
tensors. gloo has no reduce-scatter, so there a reduce-scatter is an
all-reduce and this rank's slice of it (the same sum).

* :func:`all_gather` — concatenate every rank's piece along ``dim``;
  backward: reduce-scatter (sum). For a parameter sharded over the ranks
  that each compute a different loss (FSDP over the data ranks).
* :func:`gather_replicated` — the same forward; backward: this rank's slice
  of the gradient, for an output that every rank of the group goes on to
  use identically (tensor parallelism's output, Megatron's "gather from
  the model-parallel region").
* :func:`copy_to_group` — identity; backward: all-reduce (sum), for the
  input of a layer whose ranks each compute a slice of its output
  (Megatron's "copy to the model-parallel region").
* :func:`rows_of` — this rank's block of rows of a tensor every rank holds;
  backward: all-gather of the blocks' gradients.
* :func:`mean_over` — the mean over the ranks; backward: the mean of the
  gradients, the rule that keeps a per-rank loss summed into a
  data-parallel mean exact.
* :func:`broadcast_replicated` — the sum over the ranks of tensors that are
  zero on all ranks but one (the pipeline's last stage); backward: the
  identity, since every rank goes on to use the sum identically.
* :func:`all_to_all` — dim 0 split into one equal chunk per rank, chunk j
  sent to rank j; backward: the same exchange of the gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Shared:
    """A handle (a group) that a deep copy of its holder shares."""

    def __init__(self, value):
        self.value = value

    def __deepcopy__(self, memo):
        return self


def global_rank(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank``."""
    return dist.get_global_rank(group, rank)


def _gather(x, dim, group):
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, dim, group):
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _slice(x, dim, group):
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.cfg = (dim, group)
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.cfg
        return _reduce_scatter(g, dim, group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.cfg = (dim, group)
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.cfg
        return _slice(g, dim, group), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _RowsOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.cfg = (dim, group)
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.cfg
        return _gather(g, dim, group), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group) / dist.get_world_size(ctx.group), None


class _BroadcastReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_gather(x, dim: int, group):
    return _AllGather.apply(x, dim, group)


def gather_replicated(x, dim: int, group):
    return _GatherReplicated.apply(x, dim, group)


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def rows_of(x, dim: int, group):
    return _RowsOf.apply(x, dim, group)


def mean_over(x, group):
    return _MeanOver.apply(x, group)


def broadcast_replicated(x, group):
    return _BroadcastReplicated.apply(x, group)


def all_to_all(x, group):
    return _AllToAll.apply(x, group)


# ---- point to point -----------------------------------------------------------


def send(x, dst: int, group) -> None:
    """Blocking send of ``x`` to ``group``'s rank ``dst``."""
    dist.send(x.contiguous(), dst=global_rank(group, dst), group=group)


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """Blocking receive of a ``shape`` tensor from ``group``'s rank ``src``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, src=global_rank(group, src), group=group)
    return out


class _Send(torch.autograd.Function):
    """Send ``x`` forward; the backward receives its gradient from the same
    peer. Returns a zero scalar that the caller adds to its result, so the
    backward reaches this node."""

    @staticmethod
    def forward(ctx, x, dst, group):
        ctx.cfg = (dst, group, x.shape, x.dtype, x.device)
        send(x, dst, group)
        return torch.zeros((), dtype=x.dtype, device=x.device)

    @staticmethod
    def backward(ctx, _g):
        dst, group, shape, dtype, device = ctx.cfg
        return recv(shape, dtype, device, dst, group), None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor shaped and typed as ``like`` forward; the backward
    sends its gradient back to the peer. ``anchor``, a tensor that requires
    grad where the caller's result will, puts the node into the graph; it
    takes no gradient."""

    @staticmethod
    def forward(ctx, like, anchor, src, group):
        ctx.cfg = (src, group)
        return recv(like.shape, like.dtype, like.device, src, group)

    @staticmethod
    def backward(ctx, g):
        src, group = ctx.cfg
        send(g, src, group)
        return None, None, None, None


def send_diff(x, dst: int, group):
    return _Send.apply(x, dst, group)


def recv_diff(like, anchor, src: int, group):
    return _Recv.apply(like, anchor, src, group)


def rotate(tensors, group):
    """Each rank sends ``tensors`` to the next rank of ``group`` (ring
    order) and receives the previous rank's, in one batch of
    ``batch_isend_irecv``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = global_rank(group, (r + 1) % n), global_rank(group, (r - 1) % n)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs
