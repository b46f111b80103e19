"""Fused LayerNorm + GEGLU + down-projection transformer MLP: the
hand-written Hopper kernel, its plain version, and the wrapper that chooses
between them by the tensor's device.

Port of ``medfusion_tpu/ops/geglu.py`` (the Pallas kernel ``_kernel``, its
reference ``geglu_mlp_reference`` and the differentiable wrapper
``fused_geglu_mlp``), with the JAX argument layout: x [..., C], w1 [C, 2F]
with h in columns [:F] and the gate in [F:], w2 [F, C].

* A CPU tensor goes through :func:`geglu_mlp_reference`.
* A CUDA tensor launches ``csrc/geglu_mlp.cu`` or raises: there is no
  fallback. The kernels take float32/bfloat16, any M, and C, F multiples of
  16 with C <= 1024 (bfloat16 keeps the LayerNormed [rows, C] tile in
  shared memory: 128 KB at C = 1,024). In bfloat16 a call is two kernels,
  the LayerNorm + up-projection + gate writing g [M, F] to a workspace and
  the down-projection reading it (:func:`launch_shape`); in float32 one.
  Each call of :func:`geglu_mlp_cuda` adds one to :data:`LAUNCHES`, however
  many CUDA kernels it runs.
* The gradient recomputes through the plain version with autograd, as the
  JAX custom VJP ``_fused_bwd`` recomputes through its reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from medfusion_tpu_torch.ops.build import LAUNCH_LOCK

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

MAX_CHANNELS = 1024  # the bf16 kernel's LayerNormed [rows, C] tile: 128 KB
N_TILE = 128  # F columns of an up-projection n-tile (and C columns of a down tile)
DOWN_ROWS = 128  # rows of a down-projection tile
_PROLOGUE_TILES = 0.5  # a block's LayerNorm prologue, in n-tiles of work
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ENCODE_ERROR = 10000  # the entry returns this plus the CUresult of a failed encode
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


class LaunchShape(NamedTuple):
    """How ``csrc/geglu_mlp.cu`` is launched for one call."""

    block_rows: int  # rows of an up-projection block (f32: of the one kernel)
    tiles_per_block: int  # 128-column n-tiles of F per up-projection block
    up_grid: Tuple[int, int]  # (runs of n-tiles, row tiles); f32: (row tiles, 1)
    down_grid: Optional[Tuple[int, int]]  # (C tiles, 128-row tiles); f32: None
    workspace: Optional[Tuple[int, int]]  # g [M, F] in bf16; f32: None


def launch_shape(m: int, c: int, f: int, dtype, sms: int) -> LaunchShape:
    """The launch of one call on a card with ``sms`` SMs. bf16: the
    up-projection's blocks take 128 rows for 256 < C <= 512 and 64 else
    (their LayerNormed rows stay in shared memory; at C <= 256 two blocks
    share an SM, above one), and each takes a run of 128-column n-tiles of
    F. The run is all of F unless the row tiles alone cannot fill the card;
    then the run is the one that minimises waves x (run + the LayerNorm
    prologue, about half an n-tile), the larger run on a tie. The
    down-projection takes 128 x 128 output tiles; g [M, F] bf16 passes
    between the two. float32: one kernel, min(64, 8192 / C) rows a block."""
    if dtype == torch.float32:
        rows = min(64, 8192 // c)
        return LaunchShape(rows, 1, (-(-m // rows), 1), None, None)
    rows = 128 if 256 < c <= 512 else 64
    slots = sms * (2 if c <= 256 else 1)  # blocks the card holds at once
    row_tiles = -(-m // rows)
    n_tiles = -(-f // N_TILE)
    run = n_tiles
    if row_tiles < slots:
        def cost(t):
            return -(-row_tiles * -(-n_tiles // t) // slots) * (t + _PROLOGUE_TILES)

        run = min(range(n_tiles, 0, -1), key=cost)
    return LaunchShape(rows, run, (-(-n_tiles // run), row_tiles),
                       (-(-c // N_TILE), -(-m // DOWN_ROWS)), (m, f))


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


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernels read rows
    in 16-byte chunks and through TMA), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def geglu_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Launch the CUDA kernels on the current stream (no autograd): in
    bfloat16 the up-projection and the down-projection with g [M, F] in a
    workspace between them, in float32 one kernel. One call counts as one
    launch in :data:`LAUNCHES`."""
    global LAUNCHES
    from medfusion_tpu_torch.ops.build import function

    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_mlp_cuda takes a CUDA tensor, got {x.device}")
    out = launch(function("geglu_mlp", "mf_geglu_mlp", _ARGTYPES),
                 x, ln_scale, ln_bias, w1, b1, w2, b2)
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return out


def launch(fn, x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Lay the checked CUDA operands out as ``csrc/geglu_mlp.cu``'s entry
    ``fn`` takes them, allocate the output and the workspace, and launch."""
    c = x.shape[-1]
    f = w2.shape[0]
    x2 = _aligned(x.reshape(-1, c))
    # nn.Linear layout: a no-op for w1 = linear.weight.t()
    w1t, w2t = _aligned(w1.t()), _aligned(w2.t())
    ln_scale, ln_bias, b1, b2 = (_aligned(t) for t in (ln_scale, ln_bias, b1, b2))
    m = x2.shape[0]
    out = torch.empty_like(x2)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = launch_shape(m, c, f, x.dtype, sms)
    g = (torch.empty(plan.workspace, dtype=x.dtype, device=x.device)
         if plan.workspace else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_IS_BF16[x.dtype], x2.data_ptr(), ln_scale.data_ptr(),
                 ln_bias.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                 w2t.data_ptr(), b2.data_ptr(), out.data_ptr(),
                 None if g is None else g.data_ptr(), m, c, f,
                 plan.block_rows, plan.tiles_per_block, 1e-5, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"geglu_mlp: a TMA tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"geglu_mlp launch failed: CUDA error {err}")
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
