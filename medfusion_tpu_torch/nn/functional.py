"""Small functional helpers with PyTorch/MONAI semantics
(port of ``medfusion_tpu/nn/functional.py``; NCHW here)."""

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


def save_add(*args):
    """None-tolerant sum."""
    args = [a for a in args if a is not None]
    return sum(args[1:], args[0]) if args else None
