"""GroupNorm (+ SiLU): the hand-written Hopper kernel, its plain version, and
the wrapper that chooses between them by the tensor's device.

Port of ``medfusion_tpu/ops/group_norm.py`` (the Pallas kernel ``_kernel``,
its reference ``group_norm_silu_reference`` and the differentiable wrapper
``fused_group_norm_silu``). Layout here is contiguous NCHW ([B, C, *spatial]).

* A CPU tensor goes through :func:`group_norm_silu_reference`.
* A CUDA tensor launches ``csrc/group_norm_silu.cu`` or raises: there is no
  fallback. Every launch adds one to :data:`LAUNCHES`. One launch a call,
  by the plan :func:`launch_plan` picks from the shape: a group in the
  registers of one block (every UNet shape), or in the shared memory of a
  thread-block cluster (every VAE shape).
* The gradient recomputes through the plain version with autograd, as the
  JAX custom VJP recomputes through its reference.
"""

from __future__ import annotations

import ctypes
import math

import torch

from medfusion_tpu_torch.ops.build import LAUNCH_LOCK

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

# The launch plan's limits (csrc/group_norm_silu.cu). The block route holds
# a group in registers, at most BLOCK_MAX_VALUES_PER_THREAD values a thread
# and BLOCK_MAX_GROUP_THREADS threads a group: up to 16,384 elements. A
# larger group takes a thread-block cluster, each block a slice in shared
# memory. The defaults below are the fastest of the variants measured on an
# H100 with tools/compare_attn_builds.py --kernel gn (PERF.md §6).
VEC_BYTES = 16  # one vector load or store: 8 bf16 or 4 f32
BLOCK_VALUES_PER_THREAD = 16  # the plan's aim; up to the maximum where threads run out
BLOCK_MAX_VALUES_PER_THREAD = 32  # 4 bf16 or 8 f32 vectors, the kernel's instantiations
BLOCK_MAX_GROUP_THREADS = 512
BLOCK_BUDGET = BLOCK_MAX_VALUES_PER_THREAD * BLOCK_MAX_GROUP_THREADS
BLOCK_THREADS = 256  # a block of the block route: several groups where a group takes fewer
BLOCK_MAX_THREADS = 512  # the block kernel's launch bound
CLUSTER_THREADS = 512
CLUSTER_SLICE_BYTES = 64 * 1024  # a block's slice: three blocks share an SM
MAX_CLUSTER = 16  # clusters above 8 blocks are the card's non-portable sizes
SMEM_PER_BLOCK = 232448  # 227 KB: dynamic plus static shared memory a block may take
CLUSTER_STATIC_SMEM = 1024  # the cluster kernel's own: mbarriers and partial sums
MAX_GRID = 2**31 - 1

_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_float] + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_ROUTES = {"block": 0, "cluster": 1}
_PLANS = {}  # (B, C, S, G, dtype, aligned) -> the plan the card can launch
_MAX_CLUSTERS = {}  # (dtype, vector, threads, cluster, smem_bytes) -> occupancy


def launch_plan(B: int, C: int, S: int, G: int, dtype, *, aligned: bool = True,
                max_cluster: int = MAX_CLUSTER,
                values_per_thread: int = BLOCK_VALUES_PER_THREAD,
                block_threads: int = BLOCK_THREADS,
                cluster_threads: int = CLUSTER_THREADS,
                slice_bytes: int = CLUSTER_SLICE_BYTES) -> dict:
    """How the kernel takes GroupNorm over x [B, C, S] with G groups.

    Each (batch, group) is a run of n = (C/G)*S contiguous elements.
    ``route`` "block" (n <= BLOCK_BUDGET): ``group_threads`` threads hold a
    run in registers, ``units`` 16-byte vectors each (the fewest threads,
    up to BLOCK_MAX_GROUP_THREADS, that hold n at ``values_per_thread``
    values a thread, then the smallest power of two of vectors that covers
    n); ``groups_per_block`` runs share a block of ``threads``. ``route``
    "cluster": a cluster of ``cluster`` blocks of ``threads`` takes a run,
    block r the positions [r*slice, (r+1)*slice) (the last one cut at n),
    the first ``resident`` of them in ``smem_bytes`` of shared memory. The
    cluster is the smallest power of two from 2 whose slice fits
    ``slice_bytes``, at most ``max_cluster``; a slice past a block's shared
    memory keeps what fits resident and reads the rest again on each pass.
    ``vector``: 16-byte accesses (n a multiple of the vector and x
    ``aligned`` to 16 bytes); else element by element. The other arguments
    let a comparison of builds try other plans."""
    es = torch.finfo(dtype).bits // 8
    vec = VEC_BYTES // es
    n = (C // G) * S
    groups = B * G
    vector = bool(aligned and n % vec == 0)
    plan = dict(n=n, groups=groups, vector=vector, units=0, group_threads=0,
                groups_per_block=1, cluster=1, slice=n, resident=0, smem_bytes=0)
    if n <= BLOCK_BUDGET:
        gt = 32
        while gt * values_per_thread < n and gt < BLOCK_MAX_GROUP_THREADS:
            gt *= 2
        units = 1
        while gt * units * vec < n:
            units *= 2
        per_block = max(1, min(block_threads, BLOCK_MAX_THREADS) // gt)
        plan.update(route="block", threads=gt * per_block, group_threads=gt,
                    groups_per_block=per_block, units=units,
                    blocks=-(-groups // per_block))
    else:
        cap = (SMEM_PER_BLOCK - CLUSTER_STATIC_SMEM) // VEC_BYTES * vec
        cs = min(2, max_cluster)
        while cs < max_cluster and -(-n // cs) * es > slice_bytes:
            cs *= 2
        per_block = -(-n // cs)
        slice_ = -(-per_block // vec) * vec  # whole vectors
        resident = min(slice_, cap)
        plan.update(route="cluster", threads=cluster_threads, cluster=cs, slice=slice_,
                    resident=resident, smem_bytes=resident * es, blocks=groups * cs)
    if plan["blocks"] > MAX_GRID:
        raise ValueError(f"{plan['blocks']} blocks exceed the grid's limit")
    return plan


def max_active_clusters(plan: dict, dtype) -> int:
    """``cudaOccupancyMaxActiveClusters`` for a cluster plan on the current
    card: how many of its clusters can be resident at once (0: none can be
    launched)."""
    from medfusion_tpu_torch.ops.build import function

    key = (dtype, plan["vector"], plan["threads"], plan["cluster"], plan["smem_bytes"])
    if key not in _MAX_CLUSTERS:
        fn = function("group_norm_silu", "mf_group_norm_silu_max_clusters",
                      [ctypes.c_int] * 5)
        got = fn(_IS_BF16[dtype], int(plan["vector"]), plan["threads"], plan["cluster"],
                 plan["smem_bytes"])
        if got < 0:
            raise RuntimeError(f"group_norm_silu occupancy query failed: CUDA error {-got}")
        _MAX_CLUSTERS[key] = got
    return _MAX_CLUSTERS[key]


def _plan_for(b, c, s, g, dtype, aligned):
    """:func:`launch_plan` for the card: a cluster that the occupancy query
    says cannot be resident is halved until one can."""
    key = (b, c, s, g, dtype, aligned)
    plan = _PLANS.get(key)
    if plan is None:
        plan = launch_plan(b, c, s, g, dtype, aligned=aligned)
        while plan["route"] == "cluster" and max_active_clusters(plan, dtype) == 0:
            if plan["cluster"] == 1:
                raise RuntimeError(f"no group_norm_silu cluster plan fits the card: {plan}")
            plan = launch_plan(b, c, s, g, dtype, aligned=aligned,
                               max_cluster=plan["cluster"] // 2)
        _PLANS[key] = plan
    return plan


def group_norm_silu_reference(x, scale, bias, num_groups: int,
                              eps: float = 1e-5, apply_silu: bool = True):
    """Plain PyTorch version: f32 two-pass statistics, output in x's dtype."""
    b, c = x.shape[0], x.shape[1]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.ndim - 2)
    xn = xn * scale.reshape(bshape) + bias.reshape(bshape)
    if apply_silu:
        xn = xn * torch.sigmoid(xn)
    return xn.to(x.dtype)


def _check(x, scale, bias, num_groups):
    if x.ndim < 3:
        raise ValueError(f"expected [B, C, *spatial], got shape {tuple(x.shape)}")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups={num_groups}")
    if x.dtype not in _IS_BF16:
        raise TypeError(f"group_norm_silu kernel takes float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu kernel takes contiguous NCHW input")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device:
            raise ValueError(
                f"{name} must be [{c}] {x.dtype} on {x.device}, got "
                f"{tuple(p.shape)} {p.dtype} on {p.device}")
    s = math.prod(x.shape[2:])
    if (c // num_groups) * s >= 2**31:
        raise ValueError("one group holds 2^31 or more elements")


def launch(fn, x, scale, bias, num_groups, eps, apply_silu, plan):
    """Allocate y and launch ``csrc/group_norm_silu.cu``'s entry ``fn`` on
    the checked operands with ``plan`` (:func:`launch_plan`)."""
    b, c = x.shape[0], x.shape[1]
    s = math.prod(x.shape[2:])
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_IS_BF16[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), b * num_groups, plan["n"], s, c // num_groups, num_groups,
                 float(eps), int(apply_silu), _ROUTES[plan["route"]], int(plan["vector"]),
                 plan["threads"], plan["group_threads"], plan["units"], plan["cluster"],
                 plan["slice"], plan["resident"], plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"group_norm_silu launch failed: CUDA error {err}")
    return y


def group_norm_silu_cuda(x, scale, bias, num_groups: int, eps: float = 1e-5,
                         apply_silu: bool = True, plan=None):
    """Launch the CUDA kernel on the current stream (no autograd): one
    launch, with :func:`launch_plan`'s plan for x's shape (or ``plan``)."""
    global LAUNCHES
    from medfusion_tpu_torch.ops.build import function

    _check(x, scale, bias, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_cuda takes a CUDA tensor, got {x.device}")
    if plan is None:
        plan = _plan_for(x.shape[0], x.shape[1], math.prod(x.shape[2:]), num_groups,
                         x.dtype, x.data_ptr() % VEC_BYTES == 0)
    y = launch(function("group_norm_silu", "mf_group_norm_silu", _ARGTYPES), x,
               scale.contiguous(), bias.contiguous(), num_groups, eps, apply_silu, plan)
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return y


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, apply_silu)
        return group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ss, bs = (t.detach().requires_grad_(True) for t in (x, scale, bias))
            out = group_norm_silu_reference(xs, ss, bs, *ctx.cfg)
            gx, gs, gb = torch.autograd.grad(out, (xs, ss, bs), grad)
        return gx, gs, gb, None, None, None


def group_norm_silu(x, scale, bias, num_groups: int, eps: float = 1e-5,
                    apply_silu: bool = True):
    """GroupNorm(+SiLU) of NCHW ``x``: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor. A CUDA ``x`` in another memory
    layout is copied to contiguous NCHW first: cuDNN answers a conv whose
    input has one channel (a grey image or a volume, whose strides also read
    as channels-last) in the channels-last layout."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"no group_norm_silu for device {x.device}")
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
    return group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)
