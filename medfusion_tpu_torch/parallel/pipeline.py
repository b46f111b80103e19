"""Pipeline parallelism, GPipe fill-drain over a mesh dim (port of
``medfusion_tpu/parallel/pipeline.py``).

Rank s of the mesh's ``axis`` holds stage s's parameters. The batch is cut
into microbatches; stage 0 reads them from ``x``, every other stage
receives each from the stage before, and every stage but the last sends
its result on (point-to-point, blocking, in microbatch order on every rank,
so each send meets its receive). Only real microbatches compute: no fill
or drain tick runs a stage on a stand-in activation. The last stage's
results come back to every rank of ``axis``, as the JAX package's psum
returns them.

Differentiable end to end: each send and receive is an autograd function
whose backward moves the gradient the other way. Autograd runs a rank's
backward in the reverse order of its forward, the last microbatch first,
which is the order the neighbouring stages' backward sends and receives in,
so the blocking pairs meet again. With ``data_axis`` each microbatch's rows
are split over that mesh dim; with ``zero_axis`` a stage's parameters are
stored sliced over it (:func:`shard_stage_params`) and all-gathered just in
time. A stage's parameter gradient comes back on the rank that holds the
stage, summed over the data ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from medfusion_tpu_torch.data.prefetch import _map, _tensors
from medfusion_tpu_torch.parallel import comm
from medfusion_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


def stack_stage_params(params_list: Sequence[Any]):
    """Stack per-stage parameter trees (dicts, lists) along a new leading
    stage dim."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in params_list]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in params_list])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(p) for p in params_list])


def pipeline_partition_spec(stacked_params, axis: str = "model"):
    """The spec of each leaf, one entry a dim from the first: the stage dim
    on ``axis`` (the JAX package's ``P(axis)``)."""
    return _map(lambda _: (axis,), stacked_params)


def _zero_sharded(v, zero_axis) -> bool:
    """Whether a stacked leaf has a post-stage dim that ``zero_axis``
    slices: rank-1 stacked leaves (a scalar a stage) have none."""
    return zero_axis is not None and v.ndim >= 2


def shard_stage_params(stacked_params, mesh, axis: str = "model", zero_axis: str = None):
    """This rank's stage of the stacked parameters, each leaf [1, ...]; with
    ``zero_axis`` the first post-stage dim of every leaf of rank >= 2 is
    also cut to this rank's slice over that mesh dim (ZeRO-3, gathered in
    :func:`pipeline_apply`; it must divide by the dim's size)."""
    s = axis_rank(mesh, axis)

    def one(v):
        v = v[s:s + 1]
        if _zero_sharded(v, zero_axis):
            n, r = axis_size(mesh, zero_axis), axis_rank(mesh, zero_axis)
            if v.shape[1] % n:
                raise ValueError(f"dim 1 of a stage leaf {tuple(v.shape)} does not split "
                                 f"over {n} ranks of {zero_axis!r}")
            v = v.chunk(n, dim=1)[r]
        return v.detach().clone().requires_grad_(v.requires_grad)

    return _map(one, stacked_params)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params, x: torch.Tensor, *, mesh, axis: str = "model",
                   n_microbatches: int = None, data_axis: str = None,
                   zero_axis: str = None) -> torch.Tensor:
    """``stage_{S-1}(... stage_0(x))`` with ``S = mesh[axis]`` stages.

    ``stage_fn(stage_params, activation) -> activation`` is one
    shape-preserving stage; ``stacked_params`` is the stacked tree
    (:func:`stack_stage_params`, leaves [S, ...]) or this rank's stage of it
    (:func:`shard_stage_params`, leaves [1, ...]; required with
    ``zero_axis``). ``x`` is the whole batch [B, ...] on every rank; B must
    divide into ``n_microbatches`` (default S) equal microbatches, and each
    of those over ``data_axis`` where given. Returns the whole result on
    every rank."""
    n_stages = axis_size(mesh, axis)
    s = axis_rank(mesh, axis)
    group = axis_group(mesh, axis)
    n_micro = n_microbatches or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    x_mb = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    dgroup = axis_group(mesh, data_axis) if data_axis else None
    zgroup = axis_group(mesh, zero_axis) if zero_axis else None

    def stage_leaf(v):
        if v.shape[0] == n_stages and not (zero_axis and n_stages > 1):
            p = v[s]
        elif v.shape[0] == 1:
            p = v[0]
        else:
            raise ValueError(f"a stacked leaf {tuple(v.shape)} has neither {n_stages} "
                             f"stages nor one (with zero_axis, pass shard_stage_params' "
                             f"pieces)")
        gathered_over_data = False
        if _zero_sharded(v, zero_axis):
            # the ranks of zero_axis that compute different rows sum their
            # gradients in the gather's backward; ranks that compute the same
            # rows each keep their slice
            if zero_axis == data_axis:
                p = comm.all_gather(p, 0, zgroup)
                gathered_over_data = True
            else:
                p = comm.gather_replicated(p, 0, zgroup)
        if dgroup is not None and not gathered_over_data:
            p = comm.copy_to_group(p, dgroup)
        return p

    p_local = _map(stage_leaf, stacked_params)
    x_local = comm.rows_of(x_mb, 1, dgroup) if dgroup is not None else x_mb
    anchor = next((t for t in _tensors(p_local) if t.requires_grad), x_local)

    results, sends = [], []
    for i in range(n_micro):
        inp = x_local[i] if s == 0 else comm.recv_diff(x_local[i], anchor, s - 1, group)
        y = stage_fn(p_local, inp)
        if s < n_stages - 1:
            sends.append(comm.send_diff(y, s + 1, group))
        else:
            results.append(y)
    if results:
        out = torch.stack(results)
    else:
        out = torch.zeros_like(x_local) + sum(sends)
    out = comm.broadcast_replicated(out, group)
    if dgroup is not None:
        out = comm.gather_replicated(out, 1, dgroup)
    return out.reshape(x.shape)
