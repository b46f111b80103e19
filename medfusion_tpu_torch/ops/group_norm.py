"""GroupNorm (+ SiLU): the hand-written Hopper kernel, its plain version, and
the wrapper that chooses between them by the tensor's device.

Port of ``medfusion_tpu/ops/group_norm.py`` (the Pallas kernel ``_kernel``,
its reference ``group_norm_silu_reference`` and the differentiable wrapper
``fused_group_norm_silu``). Layout here is contiguous NCHW ([B, C, *spatial]).

* A CPU tensor goes through :func:`group_norm_silu_reference`.
* A CUDA tensor launches ``csrc/group_norm_silu.cu`` or raises: there is no
  fallback. Every launch adds one to :data:`LAUNCHES`.
* The gradient recomputes through the plain version with autograd, as the
  JAX custom VJP recomputes through its reference.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

# Elements of one (batch, group) run that one thread block reduces and
# normalises: 16384 bf16 values are 32 KB, so a block's second statistics
# pass re-reads its chunk from L2.
CHUNK = 16384

_SYMBOLS = {torch.float32: "mf_group_norm_silu_f32",
            torch.bfloat16: "mf_group_norm_silu_bf16"}


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
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"group_norm_silu kernel takes float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu kernel takes contiguous NCHW input")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device:
            raise ValueError(
                f"{name} must be [{c}] {x.dtype} on {x.device}, got "
                f"{tuple(p.shape)} {p.dtype} on {p.device}")
    b, s = x.shape[0], math.prod(x.shape[2:])
    if b * num_groups > 65535:
        raise ValueError(f"B*G = {b * num_groups} exceeds the grid's y limit")
    if (c // num_groups) * s >= 2**31:
        raise ValueError("one group holds 2^31 or more elements")


def group_norm_silu_cuda(x, scale, bias, num_groups: int, eps: float = 1e-5,
                         apply_silu: bool = True):
    """Launch the CUDA kernel on the current stream (no autograd)."""
    global LAUNCHES
    from medfusion_tpu_torch.ops.build import library

    _check(x, scale, bias, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_cuda takes a CUDA tensor, got {x.device}")
    scale, bias = scale.contiguous(), bias.contiguous()
    b, c = x.shape[0], x.shape[1]
    s = math.prod(x.shape[2:])
    n = (c // num_groups) * s
    nchunk = -(-n // CHUNK)
    y = torch.empty_like(x)
    stats = torch.empty((b * num_groups * nchunk, 2), dtype=torch.float32,
                        device=x.device)
    fn = getattr(library("group_norm_silu"), _SYMBOLS[x.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 stats.data_ptr(), b, c, s, num_groups, float(eps),
                 int(apply_silu), CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"group_norm_silu launch failed: CUDA error {err}")
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
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"no group_norm_silu for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
    return group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)
