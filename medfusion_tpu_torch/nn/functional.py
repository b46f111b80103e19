"""Small functional helpers with PyTorch/MONAI semantics
(port of ``medfusion_tpu/nn/functional.py``; NCHW or NCDHW here)."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOrSeq = Union[int, Sequence[int]]


def ensure_tuple(x: IntOrSeq, n: int) -> Tuple[int, ...]:
    if isinstance(x, (tuple, list)):
        if len(x) != n:
            raise ValueError(f"expected length {n}, got {x}")
        return tuple(int(v) for v in x)
    return (int(x),) * n


def get_padding(kernel_size: IntOrSeq, stride: IntOrSeq, n: int) -> Tuple[int, ...]:
    """MONAI get_padding: (k - s + 1) // 2 per dim (must be >= 0)."""
    k = ensure_tuple(kernel_size, n)
    s = ensure_tuple(stride, n)
    pad = tuple((ki - si + 1) // 2 for ki, si in zip(k, s))
    if min(pad) < 0:
        raise ValueError(f"padding < 0 for kernel {k} stride {s}")
    return pad


def up_output_shape(in_shape: Sequence[int], kernel_size: IntOrSeq,
                    stride: IntOrSeq) -> Tuple[int, ...]:
    """(size-1)*stride + kernel - 2*get_padding(kernel, stride) per dim."""
    n = len(in_shape)
    k = ensure_tuple(kernel_size, n)
    s = ensure_tuple(stride, n)
    p = get_padding(k, s, n)
    return tuple((sz - 1) * si + ki - 2 * pi
                 for sz, ki, si, pi in zip(in_shape, k, s, p))


def interpolate_nearest_exact(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest-exact')`` on [B, C, *spatial]."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def interpolate_area(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='area')`` on [B, C, H, W] or [B, C, D, H,
    W]: the mean over bin [floor(b*in/out), ceil((b+1)*in/out)) of each
    axis."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    pool = {2: F.adaptive_avg_pool2d, 3: F.adaptive_avg_pool3d}[x.ndim - 2]
    return pool(x, tuple(size))


def avg_pool_same(x: torch.Tensor, kernel_size: IntOrSeq, stride: IntOrSeq) -> torch.Tensor:
    """torch AvgPool on [B, C, *spatial] (2 or 3 spatial dims) with MONAI
    padding (k - s + 1) // 2 of zeros, counted in each window's mean
    (``count_include_pad=True``, torch's default)."""
    n = x.ndim - 2
    k = ensure_tuple(kernel_size, n)
    s = ensure_tuple(stride, n)
    pad = [p for pi in reversed(get_padding(k, s, n)) for p in (pi, pi)]
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[n]
    return pool(F.pad(x, pad), k, s)


def save_add(*args):
    """None-tolerant sum."""
    args = [a for a in args if a is not None]
    return sum(args[1:], args[0]) if args else None


def checkpointed(module: torch.nn.Module, *args):
    """``module(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward. The parameters the
    module holds at the call (the cast ones that ``functional_call`` swaps
    in, which are restored before the backward runs) are passed to the
    recompute, so both forwards read the same tensors; the global RNG is
    replayed, so a dropout draws the same mask."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    params = dict(module.named_parameters())
    return checkpoint(lambda p, *a: functional_call(module, p, a), params, *args,
                      use_reentrant=False)
