"""The ('data', 'model') mesh and the placement of parameters on it (port of
``medfusion_tpu/parallel/mesh.py``).

The JAX package states every sharding as a ``PartitionSpec`` and lets GSPMD
compile the collectives into its step. Here a rank holds its own pieces and
the collectives are explicit (``parallel/comm.py``):

* **data**: each rank takes its rows of the batch (:func:`shard_batch`);
  the train step (``train/diffusion.py::train_on``) all-reduces the
  replicated parameters' gradients and its metrics to their means over the
  data ranks, so the loss is the global batch's mean, as JAX's is.
* **FSDP** (ZeRO-3): a parameter is stored as this rank's slice along one
  dim; ``estimator_params`` all-gathers it where the parameter dict of the
  step is built (before the bf16 cast), with a differentiable all-gather
  whose backward is a reduce-scatter, so the gradient arrives sliced.
* **model** (tensor parallelism): a Conv, Linear or Embedding weight sharded
  on its output channels computes this rank's slice of the output, and a
  differentiable all-gather joins the slices along the channels (Megatron's
  column-parallel layer: its input's gradient is all-reduced over the model
  ranks, its output's gradient sliced); its bias stays whole and is added
  after the gather.

The placement rules (:func:`model_partition_spec`,
:func:`fsdp_partition_spec`) make the JAX package's decisions leaf for
leaf: each rule is evaluated on the parameter's shape in the JAX layout
(conv kernels [*k, I, O], Dense kernels [I, O]) and the chosen dim is mapped
through the permutation that ``utils/weights.py`` applies to that leaf. A
placement is a tuple with one entry per mesh dim, ``Replicate()`` or
``Shard(dim)`` (dim a torch dim of the parameter).
"""

from __future__ import annotations

import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from medfusion_tpu_torch.data.prefetch import _map
from medfusion_tpu_torch.parallel import comm
from medfusion_tpu_torch.parallel.multihost import initialize_multihost
from medfusion_tpu_torch.utils.profiling import annotate

try:
    from torch.distributed.tensor import Replicate, Shard
except ImportError:  # torch < 2.4
    from torch.distributed._tensor import Replicate, Shard

MESH_DIMS = ("data", "model")
_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device="cuda"):
    """A ``DeviceMesh`` of dims ('data', 'model') over the default group's
    ranks; without a group, one is made (``initialize_multihost``)."""
    from torch.distributed.device_mesh import init_device_mesh

    initialize_multihost(device=device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, f"mesh {n_data}x{n_model} != {world} devices"
    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=MESH_DIMS)


def _dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def replicated(mesh) -> Tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def batch_sharding(mesh, ndim: int = 1) -> Tuple:
    """Dim 0 over 'data', replicated over the rest of the mesh."""
    place = list(replicated(mesh))
    place[_dim(mesh, "data")] = Shard(0)
    return tuple(place)


def rows(x, index: int, parts: int):
    """Block ``index`` of ``parts`` equal blocks of ``x``'s rows (a view)."""
    b = x.shape[0]
    if b % parts:
        raise ValueError(f"batch of {b} rows does not split over {parts} ranks")
    n = b // parts
    return x[index * n:(index + 1) * n]


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's rows (over 'data') of every tensor or array of rank >= 1
    in a batch (dicts, lists, tuples); anything else, a scalar among them,
    as it is."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")

    def one(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
            return rows(x, r, n)
        return x

    return _map(one, batch)


# ---- the JAX layout and the placement rules -------------------------------------


def jax_layout(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> perm, torch dim i being the JAX layout's dim
    perm[i]: a conv weight [O, I, *k] is the kernel [*k, I, O] and a Linear
    weight [O, I] the kernel [I, O] (``utils/weights.py::_to_torch_leaf``);
    every other parameter keeps its layout."""
    owner = {}
    for mod_name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mod_name}.{pname}" if mod_name else pname] = (mod, pname)
    perms = {}
    for name, p in model.named_parameters():
        mod, pname = owner[name]
        n = p.ndim
        if pname == "weight" and isinstance(mod, _CONVS):
            k = n - 2
            perms[name] = (k + 1, k, *range(k))
        elif pname == "weight" and isinstance(mod, nn.Linear):
            perms[name] = (1, 0)
        else:
            perms[name] = tuple(range(n))
    return perms


def _jax_shape(p, perm):
    shape = [0] * p.ndim
    for i, j in enumerate(perm):
        shape[j] = p.shape[i]
    return shape


def model_partition_spec(model: nn.Module, mesh, min_shard_dim: int = 256) -> Dict[str, Tuple]:
    """Tensor-parallel placements: a parameter of rank >= 2 whose JAX-layout
    last dim (output channels) is at least ``min_shard_dim`` and divides by
    the 'model' size is sharded there over 'model'; everything else is
    replicated."""
    n = axis_size(mesh, "model")
    md = _dim(mesh, "model")
    perms = jax_layout(model)
    out = {}
    for name, p in model.named_parameters():
        place = list(replicated(mesh))
        if n > 1 and p.ndim >= 2:
            out_ch = _jax_shape(p, perms[name])[-1]
            if out_ch >= min_shard_dim and out_ch % n == 0:
                place[md] = Shard(perms[name].index(p.ndim - 1))
        out[name] = tuple(place)
    return out


def fsdp_partition_spec(model: nn.Module, mesh, axis: str = "data", min_size: int = 2 ** 14,
                        tp_specs: Optional[Dict[str, Tuple]] = None) -> Dict[str, Tuple]:
    """ZeRO-3 placements: a parameter of at least ``min_size`` elements is
    sharded over ``axis`` on its largest JAX-layout dim that divides by the
    axis size (ties to the later dim), skipping a dim ``tp_specs`` shards."""
    n = axis_size(mesh, axis)
    ad = _dim(mesh, axis)
    perms = jax_layout(model)
    out = {}
    for name, p in model.named_parameters():
        place = list(tp_specs[name] if tp_specs is not None else replicated(mesh))
        if n > 1 and p.numel() >= min_size:
            perm = perms[name]
            taken = {perm[pl.dim] for pl in place if isinstance(pl, Shard)}
            best, best_size = None, 0
            for i, d in enumerate(_jax_shape(p, perm)):
                if i not in taken and d % n == 0 and d >= best_size and d > 1:
                    best, best_size = i, d
            if best is not None:
                place[ad] = Shard(perm.index(best))
        out[name] = tuple(place)
    return out


# ---- placed parameters ------------------------------------------------------------


class ParallelPlan:
    """Where each parameter of a model lives on the mesh (``specs``: name ->
    placements), with the groups of its dims. A deep copy of the model (the
    EMA copy) shares the plan."""

    def __init__(self, mesh, specs: Dict[str, Tuple]):
        self.mesh = mesh
        self.specs = specs
        self.groups = {axis: axis_group(mesh, axis) for axis in mesh.mesh_dim_names}
        self.data_group = self.groups["data"]

    def __deepcopy__(self, memo):
        return self

    def shards(self, name: str) -> List[Tuple[int, Any]]:
        """[(torch dim, group)] of ``name``, data first."""
        out = []
        for axis, pl in zip(self.mesh.mesh_dim_names, self.specs.get(name, ())):
            if isinstance(pl, Shard):
                out.append((pl.dim, self.groups[axis]))
        return out

    def fsdp_dim(self, name: str) -> Optional[int]:
        pl = self.specs.get(name)
        if pl is None:
            return None
        pl = pl[_dim(self.mesh, "data")]
        return pl.dim if isinstance(pl, Shard) else None

    def tp_dim(self, name: str) -> Optional[int]:
        pl = self.specs.get(name)
        if pl is None:
            return None
        pl = pl[_dim(self.mesh, "model")]
        return pl.dim if isinstance(pl, Shard) else None

    def gather_fsdp(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """``p`` all-gathered along its FSDP dim (differentiable: the
        gradient comes back reduce-scattered); ``p`` itself without one."""
        d = self.fsdp_dim(name)
        return p if d is None else comm.all_gather(p, d, self.data_group)


def _tp_conv_forward(self, x):
    g = self.tensor_parallel.value
    y = comm.gather_replicated(self._conv_forward(comm.copy_to_group(x, g), self.weight, None),
                               1, g)
    if self.bias is None:
        return y
    return y + self.bias.view(1, -1, *([1] * (y.ndim - 2)))


def _tp_linear_forward(self, x):
    g = self.tensor_parallel.value
    y = comm.gather_replicated(F.linear(comm.copy_to_group(x, g), self.weight), -1, g)
    return y if self.bias is None else y + self.bias


def _tp_embedding_forward(self, idx):
    y = F.embedding(idx, self.weight, self.padding_idx, self.max_norm, self.norm_type,
                    self.scale_grad_by_freq, self.sparse)
    return comm.gather_replicated(y, -1, self.tensor_parallel.value)


def _tensor_parallel_forward(mod, pname: str, dim: int, name: str):
    """The forward that computes ``mod``'s output-channel slice, or raise
    where ``name`` is not such a weight."""
    if pname == "weight" and isinstance(mod, _CONVS) and dim == 0:
        return _tp_conv_forward
    if pname == "weight" and isinstance(mod, nn.Linear) and dim == 0:
        return _tp_linear_forward
    if pname == "weight" and isinstance(mod, nn.Embedding) and dim == 1:
        return _tp_embedding_forward
    raise NotImplementedError(
        f"tensor parallelism shards {name} (a {type(mod).__name__}'s {pname} on dim "
        f"{dim}); only the output channels of Conv, Linear and Embedding weights "
        f"compute sliced")


def shard_params(model: nn.Module, mesh, tensor_parallel: bool = False, fsdp: bool = False,
                 min_shard_dim: int = 256, fsdp_min_size: int = 2 ** 14) -> nn.Module:
    """Place ``model``'s parameters in place: replicated by default;
    'model'-sharded by :func:`model_partition_spec` with
    ``tensor_parallel``; also 'data'-sharded by :func:`fsdp_partition_spec`
    with ``fsdp``. Each parameter keeps this rank's piece, and the model
    holds the plan (``model.parallel_plan``) by which the train step gathers
    and reduces. Build the optimizer (``TrainState``) after this call.
    Returns ``model``."""
    specs = (model_partition_spec(model, mesh, min_shard_dim=min_shard_dim)
             if tensor_parallel else {n: replicated(mesh) for n, _ in model.named_parameters()})
    if fsdp:
        specs = fsdp_partition_spec(model, mesh, min_size=fsdp_min_size, tp_specs=specs)
    plan = ParallelPlan(mesh, specs)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if plan.shards(name):
                p.data = local_piece(plan.shards(name), p.data).clone()
    for name, _ in model.named_parameters():
        d = plan.tp_dim(name)
        if d is None:
            continue
        mod_name, _, pname = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        fwd = _tensor_parallel_forward(mod, pname, d, name)
        mod.tensor_parallel = comm.Shared(plan.groups["model"])  # the model group
        mod.forward = types.MethodType(fwd, mod)
    model.parallel_plan = plan
    return model


# ---- what the step and the checkpoints need -----------------------------------------


def local_piece(shards, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of ``full`` under ``shards`` [(dim, group)]."""
    for d, g in shards:
        full = full.chunk(dist.get_world_size(g), dim=d)[dist.get_rank(g)]
    return full


def whole(shards, piece: torch.Tensor) -> torch.Tensor:
    """The whole tensor of this rank's ``piece`` (a collective on every
    group of ``shards``)."""
    with torch.no_grad():
        for d, g in reversed(shards):
            piece = comm._gather(piece, d, g)
    return piece


def layout(model: nn.Module) -> Dict[str, List[Tuple[int, Any]]]:
    """Parameter name -> [(dim, group)] for every parameter that a rank
    holds a piece of: by the model's plan, and the experts of each
    expert-parallel mixture-of-experts layer (dim 0 over its group)."""
    plan = getattr(model, "parallel_plan", None)
    out = {}
    if plan is not None:
        out = {name: plan.shards(name) for name, _ in model.named_parameters()
               if plan.shards(name)}
    for mod_name, mod in model.named_modules():
        if getattr(mod, "expert_group", None) is not None:
            prefix = f"{mod_name}." if mod_name else ""
            for pname in mod.expert_parameter_names:
                out[prefix + pname] = [(0, mod.expert_group)]
    return out


def data_parallel_group(model: nn.Module):
    """The group over whose ranks the batch rows are split for ``model``:
    its plan's 'data' group, else the group of its expert-parallel layers;
    None for a model that is not placed."""
    plan = getattr(model, "parallel_plan", None)
    group = plan.data_group if plan is not None else None
    for mod in model.modules():
        eg = getattr(mod, "expert_group", None)
        if eg is None:
            continue
        if group is None:
            group = eg
        elif dist.get_process_group_ranks(eg) != dist.get_process_group_ranks(group):
            raise ValueError("an expert-parallel layer's group must be the group the "
                             "batch rows are split over (the mesh's 'data' group)")
    return group


def _expert_param_ids(model):
    return {id(p) for mod in model.modules() if getattr(mod, "expert_group", None) is not None
            for pname in mod.expert_parameter_names for p in [getattr(mod, pname)]}


def sync_gradients(model: nn.Module, group) -> None:
    """Gradients of the data-parallel mean over ``group``'s ranks: the
    replicated parameters' all-reduced (one flat buffer a dtype) and
    divided by the size; an FSDP slice's (reduce-scattered already by the
    gather's backward) and an expert's (summed over the ranks' tokens by the
    all-to-all's backward) divided by it. Its span counts the bytes
    all-reduced (``allreduce_bytes``) and the all-reduces (``collectives``)."""
    with annotate("parallel.sync_gradients") as span:
        n = dist.get_world_size(group)
        plan = getattr(model, "parallel_plan", None)
        experts = _expert_param_ids(model)
        flat: Dict[torch.dtype, List[torch.Tensor]] = {}
        for name, p in model.named_parameters():
            if p.grad is None:
                continue
            if id(p) in experts or (plan is not None and plan.fsdp_dim(name) is not None):
                p.grad.div_(n)
            else:
                flat.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in flat.values():
            buf = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(buf, group=group)
            span.count(allreduce_bytes=buf.numel() * buf.element_size(), collectives=1)
            buf.div_(n)
            offset = 0
            for g in grads:
                g.copy_(buf[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def mean_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over ``group``'s ranks."""
    keys = list(metrics)
    if not keys:
        return metrics
    buf = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(buf, group=group)
    buf.div_(dist.get_world_size(group))
    return {k: buf[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def _map_state(state, sd: Dict, fn) -> Dict:
    """``sd`` (a ``TrainState``'s or ``GANTrainState``'s state dict) with
    ``fn(shards, tensor)`` applied to every placed parameter's tensors: the
    model's, the EMA copy's and the optimizer's moments."""
    if "gen" in sd:
        return {**sd, "gen": _map_state(state.gen, sd["gen"], fn),
                "disc": _map_state(state.disc, sd["disc"], fn)}
    if not isinstance(getattr(state, "model", None), nn.Module):
        return sd
    lay = layout(state.model)
    if not lay:
        return sd
    names = [n for n, _ in state.model.named_parameters()]

    def module(msd):
        return None if msd is None else {k: fn(lay[k], v) if k in lay else v
                                         for k, v in msd.items()}

    opt = sd["optimizer"]
    moments = {i: {k: fn(lay[names[i]], v) if (names[i] in lay and torch.is_tensor(v)
                                               and v.ndim > 0) else v
                   for k, v in st.items()}
               for i, st in opt["state"].items()}
    return {**sd, "model": module(sd["model"]), "ema": module(sd["ema"]),
            "optimizer": {**opt, "state": moments}}


def whole_state_dict(state, sd: Dict) -> Dict:
    """``state.state_dict()`` with every placed tensor made whole (a
    collective: every rank calls it)."""
    return _map_state(state, sd, whole)


def local_state_dict(state, sd: Dict) -> Dict:
    """A whole state dict cut to this rank's pieces, for ``state``."""
    return _map_state(state, sd, lambda shards, t: local_piece(shards, t).clone())
