"""Fused LayerNorm + GEGLU + down-projection transformer MLP: the
hand-written Hopper kernel, its plain version, and the wrapper that chooses
between them by the tensor's device.

Port of ``medfusion_tpu/ops/geglu.py`` (the Pallas kernel ``_kernel``, its
reference ``geglu_mlp_reference`` and the differentiable wrapper
``fused_geglu_mlp``), with the JAX argument layout: x [..., C], w1 [C, 2F]
with h in columns [:F] and the gate in [F:], w2 [F, C].

* A CPU tensor goes through :func:`geglu_mlp_reference`.
* A CUDA tensor launches ``csrc/geglu_mlp.cu`` or raises: there is no
  fallback. The kernel takes float32/bfloat16, any M, and C, F multiples of
  16 with C <= 1024. Every launch adds one to :data:`LAUNCHES`; where F is
  split over blocks (:func:`launch_shape`), the launch is two kernels, the
  second adding the f32 partial sums.
* The gradient recomputes through the plain version with autograd, as the
  JAX custom VJP ``_fused_bwd`` recomputes through its reference.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

MAX_CHANNELS = 1024  # the [BM, C] accumulator lives in registers
F_CHUNK = 64  # F columns per step of the bf16 kernel
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


def launch_shape(m: int, c: int, f: int, dtype, sms: int):
    """(rows per block, F splits) of a launch. bf16: 64, 32 or 16 rows as C
    is <= 256, <= 512 or <= 1024 (the block's [rows, C] f32 accumulator
    stays within 64 registers a thread); F is split over blocks only when
    the row blocks fill at most half the SMs (measured on an H100: a split
    of 128 row blocks lost to the partial sums' round trip), into enough
    parts for two blocks per SM. float32: min(64, 8192 / C) rows, no
    split."""
    if dtype == torch.float32:
        return min(64, 8192 // c), 1
    rows = 64 if c <= 256 else (32 if c <= 512 else 16)
    blocks = -(-m // rows)
    if 2 * blocks > sms:
        return rows, 1
    return rows, min(-(-f // F_CHUNK), -(-2 * sms // blocks))


def layer_norm_f32(x, scale, bias, eps: float = 1e-5):
    """flax ``nn.LayerNorm`` (fast variance) in f32: E[x^2] - mean^2
    clamped at 0; the result is f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def gelu_exact(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def geglu_reference(x, ln_scale, ln_bias, w1, b1):
    """LayerNorm -> x W1 + b1 -> h * gelu(gate), at the module path's
    rounding points (each step's result in x's dtype)."""
    dt = x.dtype
    f = w1.shape[1] // 2
    xn = layer_norm_f32(x, ln_scale, ln_bias).to(dt)
    proj = (xn @ w1 + b1).to(dt)
    h, gate = proj[..., :f], proj[..., f:]
    return (h.float() * gelu_exact(gate.float())).to(dt)


def geglu_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Plain PyTorch version: GEGLU, then g W2 + b2 in x's dtype."""
    return (geglu_reference(x, ln_scale, ln_bias, w1, b1) @ w2 + b2).to(x.dtype)


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2):
    c = x.shape[-1]
    f = w2.shape[0]
    if w1.shape != (c, 2 * f) or w2.shape != (f, c):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not "
                         f"match C={c}")
    for name, t, n in (("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c),
                       ("b1", b1, 2 * f), ("b2", b2, c)):
        if t.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if c % 16 or f % 16 or not 16 <= c <= MAX_CHANNELS:
        raise ValueError(f"geglu_mlp kernel takes C and F multiples of 16 with "
                         f"C <= {MAX_CHANNELS}, got C={c}, F={f}")
    ts = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.dtype not in _IS_BF16 or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"geglu_mlp kernel takes one dtype, float32/bfloat16; "
                        f"got {sorted({str(t.dtype) for t in ts})}")
    if any(t.device != x.device for t in ts):
        raise ValueError("geglu_mlp operands are on different devices")
    if x.numel() == 0:
        raise ValueError("geglu_mlp needs at least one row")


def geglu_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Launch the CUDA kernel on the current stream (no autograd)."""
    global LAUNCHES
    from medfusion_tpu_torch.ops.build import function

    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_mlp_cuda takes a CUDA tensor, got {x.device}")
    c = x.shape[-1]
    f = w2.shape[0]
    x2 = x.reshape(-1, c).contiguous()
    # nn.Linear layout: a no-op for w1 = linear.weight.t()
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    ln_scale, ln_bias, b1, b2 = (t.contiguous() for t in (ln_scale, ln_bias, b1, b2))
    m = x2.shape[0]
    out = torch.empty_like(x2)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, splits = launch_shape(m, c, f, x.dtype, sms)
    partial = (torch.empty((splits, m, c), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    fn = function("geglu_mlp", "mf_geglu_mlp", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_IS_BF16[x.dtype], x2.data_ptr(), ln_scale.data_ptr(),
                 ln_bias.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                 w2t.data_ptr(), b2.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), m, c, f,
                 rows, splits, 1e-5, stream)
    if err != 0:
        raise RuntimeError(f"geglu_mlp launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out.reshape(x.shape)


class _GegluMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return geglu_mlp_cuda(*args)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = geglu_mlp_reference(*leaves)
            return torch.autograd.grad(out, leaves, grad)


def fused_geglu_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """LayerNorm -> GEGLU -> down projection of x [..., C]: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return geglu_mlp_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"no geglu_mlp for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GegluMLP.apply(*args)
    return geglu_mlp_cuda(*args)
