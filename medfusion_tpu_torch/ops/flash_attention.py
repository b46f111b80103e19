"""Flash-attention forward: the hand-written Hopper kernel, its plain
version, and the wrappers that choose between them by the tensor's device.

Port of the forward kernels of ``medfusion_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (head layout, q/k/v [B, H, N, D]) and ``_fwd_mha_kernel``
(token layout, q/k/v [B, N, H*D]). On Hopper both are ONE CUDA kernel
(``csrc/flash_attention.cu``) addressed by strides, so the token layout
needs no transposes; each entry has its own launch count, so a run shows
which layout ran.

Both entries return ``(o, lse)``: o in the input dtype, lse the f32 row
logsumexp ([B, H, N] for the head layout, [B, N, H] for the token layout),
which the training slice's backward will need.

* A CPU tensor goes through :func:`naive_attention_reference`.
* A CUDA tensor launches the kernel or raises: there is no fallback. The
  kernel takes head dims 16, 32, 64 and 128, float32 and bfloat16, and any
  N, M >= 1. The backward kernels are not ported yet, so a CUDA call that
  needs a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel through each entry since import (or since a
# caller reset them).
LAUNCHES = 0  # head layout, flash_attention
TOKEN_LAUNCHES = 0  # token layout, flash_attention_tokens

HEAD_DIMS = (16, 32, 64, 128)
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])


def naive_attention_reference(q, k, v, scale: float):
    """Plain PyTorch version on [B, H, N, D] / [B, H, M, D]: q*s and k*s
    rounded to the input dtype (s itself rounded to it first), f32 logits
    and softmax statistics, p rounded to the input dtype for p.v with f32
    accumulation. Returns (o [B, H, N, D] in q's dtype, lse [B, H, N] f32)."""
    dt = q.dtype
    s = torch.tensor(scale, dtype=dt)
    logits = (q * s).float() @ (k * s).float().transpose(-1, -2)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(dt).float() @ v.float()) / l
    return o.to(dt), (m + torch.log(l)).squeeze(-1)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected q, k, v of shape [B, H, N|M, D]")
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _IS_BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if n < 1 or m < 1:
        raise ValueError("flash attention needs N, M >= 1")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte rows: the kernel moves the head dim in 16-byte chunks
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have a unit-stride head dim and "
                             f"16-byte aligned rows, got strides {t.stride()}")


def _launch(q, k, v, o, lse, scale):
    """Launch on [B, H, N|M, D] views (any strides, unit head stride) and
    an lse view [B, H, N]."""
    from medfusion_tpu_torch.ops.build import function

    b, h, n, d = q.shape
    strides = [*q.stride()[:3], *o.stride()[:3], *k.stride()[:3],
               *v.stride()[:3], *lse.stride()]
    fn = function("flash_attention", "mf_flash_attention_fwd", _ARGTYPES)
    arr = (ctypes.c_longlong * 15)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_IS_BF16[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, h, n, k.shape[2], d,
                 ctypes.cast(arr, ctypes.c_void_p), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {err}")


def _on_card(*ts):
    """True for CUDA tensors (raises if a gradient is asked for); False for
    CPU tensors; raises for any other device."""
    dev = ts[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"no flash attention for device {ts[0].device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "flash attention backward kernels are not ported yet (ROADMAP "
            "Queue 2, kernels 3-4); run the CUDA forward under no_grad")
    return True


def flash_attention_cuda(q, k, v, scale: float):
    """Head layout on the card: q [B, H, N, D], k/v [B, H, M, D] (any
    strides with a unit head stride) -> (o like q, lse [B, H, N] f32)."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes a CUDA tensor, got {q.device}")
    b, h, n, _ = q.shape
    o = torch.empty_like(q)  # keeps q's strides
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch(q, k, v, o, lse, scale)
    LAUNCHES += 1
    return o, lse


def flash_attention_tokens_cuda(q, k, v, num_heads: int, scale: float):
    """Token layout on the card: q [B, N, H*D], k/v [B, M, H*D] ->
    (o [B, N, H*D], lse [B, N, H] f32), through the same kernel."""
    global TOKEN_LAUNCHES
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    _check(qh, kh, vh)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_tokens_cuda takes a CUDA tensor, "
                         f"got {q.device}")
    b, n, _ = q.shape
    o = torch.empty((b, n, q.shape[2]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, num_heads), dtype=torch.float32, device=q.device)
    _launch(qh, kh, vh, _heads(o, num_heads), lse.transpose(1, 2), scale)
    TOKEN_LAUNCHES += 1
    return o, lse


def _heads(x, num_heads):
    """[B, N, H*D] -> the [B, H, N, D] view (no copy)."""
    if x.ndim != 3 or x.shape[2] % num_heads:
        raise ValueError(f"feature dim of {tuple(x.shape)} is not divisible "
                         f"by num_heads={num_heads}")
    return x.unflatten(2, (num_heads, -1)).transpose(1, 2)


def flash_attention(q, k, v, scale: float):
    """[B, H, N, D] attention with the double scale s on q and k:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    Returns (o, lse [B, H, N])."""
    if _on_card(q, k, v):
        return flash_attention_cuda(q, k, v, scale)
    return naive_attention_reference(q, k, v, scale)


def flash_attention_tokens(q, k, v, num_heads: int, scale: float):
    """[B, N, H*D] attention (the layout the transformer blocks hold): the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    Returns (o [B, N, H*D], lse [B, N, H])."""
    if _on_card(q, k, v):
        return flash_attention_tokens_cuda(q, k, v, num_heads, scale)
    o, lse = naive_attention_reference(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads), scale)
    return o.transpose(1, 2).flatten(2), lse.transpose(1, 2)
