"""Flash attention, forward and backward: the hand-written Hopper kernels,
their plain versions, and the wrappers that choose between them by the
tensor's device.

Port of ``medfusion_tpu/ops/flash_attention.py``: the forward kernels
``_fwd_kernel`` (head layout, q/k/v [B, H, N, D]) and ``_fwd_mha_kernel``
(token layout, q/k/v [B, N, H*D]) are ONE CUDA kernel
(``csrc/flash_attention.cu``) addressed by strides, so the token layout
needs no transposes; the backward kernels ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` are two CUDA kernels (``csrc/flash_attention_bwd.cu``),
addressed by strides the same way. Each entry and each backward kernel has
its own launch count, so a run shows which ran.

Both entries return ``(o, lse)``: o in the input dtype, lse the f32 row
logsumexp ([B, H, N] for the head layout, [B, N, H] for the token layout).
Both are differentiable in o (lse is not) through one
``torch.autograd.Function``, which saves q, k, v, o and lse, as the JAX
custom VJPs ``_flash`` and ``_flash_mha`` do.

* A CPU tensor goes through :func:`naive_attention_reference` and, for the
  gradient, :func:`flash_attention_backward_reference`.
* A CUDA tensor launches the kernels or raises: there is no fallback. The
  kernels take every head dim that is a multiple of 8 up to 1,024
  (:data:`MAX_HEAD_DIM`), float32 and bfloat16, and any N, M >= 1. In
  bfloat16 a head dim under 128 runs the kernel compiled for the next of
  16, 32, 64 and 128 on zero-filled columns, and a wider one splits the
  output's columns into 128-wide chunks over blocks (``csrc/*.cu``); so do
  the float32 forward and backward, whose products run on the tensor cores
  in split-TF32 (three tf32 products for each f32 one, f32-accurate; the
  forward's key loop split over a block's warps, each with its own online
  softmax, merged in warp order). A head
  dim that is not a multiple of 8 would break the kernels' 16-byte rows and
  TMA's 16-byte strides, so the entries run the kernels on zero-padded
  copies (:func:`pad_head_dim`) and return the first d columns: zero
  columns add nothing to q k^T and give only zero columns of o and of the
  gradients, so the function is the same.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from medfusion_tpu_torch.ops.build import LAUNCH_LOCK

# Launches of the CUDA kernel through each entry since import (or since a
# caller reset them).
LAUNCHES = 0  # head layout, flash_attention
TOKEN_LAUNCHES = 0  # token layout, flash_attention_tokens
BWD_DQ_LAUNCHES = 0  # backward, the dQ kernel (either layout)
BWD_DKV_LAUNCHES = 0  # backward, the dK/dV kernel (either layout)

HEAD_DIM_MULTIPLE = 8  # 16-byte rows in bf16
MAX_HEAD_DIM = 1024
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
_ENCODE_ERROR = 10000  # an entry returns this plus the CUresult of a failed encode


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


def _bwd_p_ds(q, k, v, lse, do, delta, sc2):
    """p and ds in f32 (the backward's rounding points)."""
    p = torch.exp(sc2 * (q.float() @ k.float().transpose(-1, -2)) - lse.float()[..., None])
    return p, p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])


def flash_attention_bwd_dq_reference(q, k, v, o, lse, do, scale: float):
    """Plain version of the dQ kernel: (dq, delta = rowsum(do * o) [B, H, N]
    f32). See :func:`flash_attention_backward_reference`."""
    sc2 = scale * scale
    delta = (do.float() * o.float()).sum(dim=-1)
    _, ds = _bwd_p_ds(q, k, v, lse, do, delta, sc2)
    return (sc2 * (ds.to(q.dtype).float() @ k.float())).to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, lse, do, delta, scale: float):
    """Plain version of the dK/dV kernel: (dk, dv). See
    :func:`flash_attention_backward_reference`."""
    sc2 = scale * scale
    p, ds = _bwd_p_ds(q, k, v, lse, do, delta, sc2)
    dk = (sc2 * (ds.to(q.dtype).float().transpose(-1, -2) @ q.float())).to(q.dtype)
    dv = (p.to(q.dtype).float().transpose(-1, -2) @ do.float()).to(q.dtype)
    return dk, dv


def flash_attention_backward_reference(q, k, v, o, lse, do, scale: float):
    """Plain PyTorch backward on [B, H, N, D] / [B, H, M, D] with lse
    [B, H, N], at the JAX backward kernels' rounding points, which are not
    the forward's: s = sc2 * (q k^T) with the UNSCALED q and k in the input
    dtype and f32 accumulation (sc2 = scale**2, taken in double and rounded
    to f32 once); p = exp(s - lse); dp = do v^T and D = rowsum(do * o) in
    f32; ds = p * (dp - D); ds and p rounded to the input dtype only as
    operands of ds k, ds^T q and p^T do (f32 accumulation); dq = sc2 * acc
    and dk = sc2 * acc, each rounded once; dv = acc. Returns (dq, dk, dv) in
    the input dtype. Split as the kernels are: the dQ part, then the dK/dV
    part, which recomputes p and ds."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, o, lse, do, scale)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, lse, do, delta, scale))


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected q, k, v of shape [B, H, N|M, D]")
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if d % HEAD_DIM_MULTIPLE:
        raise ValueError(f"flash attention kernel operands take head dims that are "
                         f"multiples of {HEAD_DIM_MULTIPLE} (pad_head_dim), got {d}")
    if q.dtype not in _IS_BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if n < 1 or m < 1:
        raise ValueError("flash attention needs N, M >= 1")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_aligned(t):
            raise ValueError(f"{name} must have a unit-stride head dim and "
                             f"16-byte aligned rows, got strides {t.stride()}")


def _rows_aligned(t):
    """16-byte rows: the kernels move the head dim in 16-byte chunks."""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _no_zero_stride(t):
    """No dim longer than 1 has stride 0: a TMA tensor map takes no such
    stride (an expanded tensor is copied for the bfloat16 kernels)."""
    return all(s != 0 or n == 1 for s, n in zip(t.stride(), t.shape))


def _launch(q, k, v, o, lse, scale):
    """Launch on [B, H, N|M, D] views (any strides, unit head stride) and
    an lse view [B, H, N], as :func:`flash_attention_forward_operands`
    gives them."""
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
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash attention: a TMA tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {err}")


def pad_head_dim(*ts):
    """[B, H, N|M, d] tensors as the kernels take them: each one whose d is
    not a multiple of 8 (and at most :data:`MAX_HEAD_DIM`) becomes a fresh
    contiguous [B, H, N|M, d'] copy, d' the next multiple of 8, the added
    columns zero; the others are returned as they are."""
    def pad(t):
        d = t.shape[-1]
        if d % HEAD_DIM_MULTIPLE == 0 or d > MAX_HEAD_DIM:
            return t
        return F.pad(t, (0, -d % HEAD_DIM_MULTIPLE))
    return tuple(pad(t) for t in ts)


def flash_attention_forward_operands(q, k, v, num_heads=None):
    """Check the forward's inputs and allocate its outputs: returns (q, k,
    v, o, lse) as the kernel takes them, [B, H, N|M, D] views and an lse
    view [B, H, N]. ``num_heads`` None is the head layout (q [B, H, N, D];
    o takes q's strides where q is dense, else packed ones; lse [B, H, N]);
    else the token layout (q [B, N, H*D]; o the view of a new [B, N, H*D]
    tensor, lse the view of a new [B, N, H] one). In bfloat16 a q, k or v
    with a zero stride is copied (:func:`_no_zero_stride`: the kernel reads
    them through TMA)."""
    tokens = q.shape
    if num_heads is not None:
        q, k, v = (_heads(t, num_heads) for t in (q, k, v))
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _no_zero_stride(t) else t.contiguous() for t in (q, k, v))
    if num_heads is None:
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    else:
        o = _heads(torch.empty(tokens, dtype=q.dtype, device=q.device), num_heads)
        lse = torch.empty((*tokens[:2], num_heads), dtype=torch.float32,
                          device=q.device).transpose(1, 2)
    return q, k, v, o, lse


def _on_card(t):
    """True for a CUDA tensor, False for a CPU tensor; raises for any other
    device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {t.device}")
    return t.device.type == "cuda"


def _launch_bwd(kernel: str, ops, scale):
    """One backward kernel on [B, H, N|M, D] views ``ops`` = (q, k, v, o,
    do, dq, dk, dv) plus [B, H, N] views (lse, delta)."""
    from medfusion_tpu_torch.ops.build import function

    q, k = ops[0], ops[1]
    b, h, n, d = q.shape
    fn = function("flash_attention_bwd", f"mf_flash_attention_bwd_{kernel}",
                  _BWD_ARGTYPES)
    ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in ops])
    strides = (ctypes.c_longlong * 30)(*[s for t in ops for s in t.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_IS_BF16[q.dtype], ctypes.cast(ptrs, ctypes.c_void_p), b, h, n,
                 k.shape[2], d, ctypes.cast(strides, ctypes.c_void_p),
                 float(scale * scale), stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash attention backward ({kernel}): a TMA tensor map "
                           f"could not be encoded (CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash attention backward ({kernel}) launch failed: "
                           f"CUDA error {err}")


def flash_attention_backward_operands(q, k, v, o, lse, do):
    """Check the backward's inputs on [B, H, N|M, D] views (lse [B, H, N])
    and allocate its outputs: returns the ten operands (q, k, v, o, do, dq,
    dk, dv, lse, delta) of the two kernels. dq, dk and dv take q's, k's and
    v's strides; ``do`` is copied to a contiguous tensor only where its rows
    break the kernels' 16-byte rule (autograd hands it over in whatever
    strides the next op gave it) and, in bfloat16, q, k, v and do where
    they have a zero stride (:func:`_no_zero_stride`)."""
    _check(q, k, v)
    for name, t in (("o", o), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if o.shape != q.shape or o.dtype != q.dtype or not _rows_aligned(o):
        raise ValueError(f"o must be q's shape and dtype with 16-byte rows, got "
                         f"{tuple(o.shape)} {o.dtype} strides {o.stride()}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, N] float32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} on {do.device} does not "
                         f"match q {tuple(q.shape)} {q.dtype} on {q.device}")
    if not _rows_aligned(do):
        do = do.contiguous()
    if q.dtype == torch.bfloat16:  # q, k, v and do are read through TMA
        q, k, v, do = (t if _no_zero_stride(t) else t.contiguous() for t in (q, k, v, do))
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return (q, k, v, o, do, torch.empty_like(q), torch.empty_like(k),
            torch.empty_like(v), lse, delta)


def flash_attention_bwd_dq(ops, scale: float):
    """The dQ kernel on :func:`flash_attention_backward_operands`' operands:
    writes dq and delta = rowsum(do * o)."""
    global BWD_DQ_LAUNCHES
    _launch_bwd("dq", ops, scale)
    with LAUNCH_LOCK:
        BWD_DQ_LAUNCHES += 1


def flash_attention_bwd_dkv(ops, scale: float):
    """The dK/dV kernel: reads delta (written by the dQ kernel, which runs
    before it on the same stream) and writes dk and dv."""
    global BWD_DKV_LAUNCHES
    _launch_bwd("dkv", ops, scale)
    with LAUNCH_LOCK:
        BWD_DKV_LAUNCHES += 1


def flash_attention_backward_cuda(q, k, v, o, lse, do, scale: float):
    """The backward on the card, on [B, H, N|M, D] views (any strides with
    a unit head stride) and lse [B, H, N]: the dQ kernel, then the dK/dV
    kernel. Returns (dq, dk, dv) with q's, k's and v's strides (at a D that
    is not a multiple of 8: the first D columns of the padded kernels'
    outputs)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward_cuda takes CUDA tensors, "
                         f"got {q.device}")
    d = q.shape[3]
    q, k, v, o, do = pad_head_dim(q, k, v, o, do)
    ops = flash_attention_backward_operands(q, k, v, o, lse, do)
    flash_attention_bwd_dq(ops, scale)
    flash_attention_bwd_dkv(ops, scale)
    return tuple(g[..., :d] for g in ops[5:8])


def flash_attention_cuda(q, k, v, scale: float):
    """Head layout on the card: q [B, H, N, D], k/v [B, H, M, D] (any
    strides with a unit head stride) -> (o like q, lse [B, H, N] f32); a D
    that is not a multiple of 8 runs on zero-padded copies
    (:func:`pad_head_dim`) and o is the first D columns of their output."""
    global LAUNCHES
    d = q.shape[-1]
    ops = flash_attention_forward_operands(*pad_head_dim(q, k, v))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes a CUDA tensor, got {q.device}")
    _launch(*ops, scale)
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return ops[3][..., :d], ops[4]


def flash_attention_tokens_cuda(q, k, v, num_heads: int, scale: float):
    """Token layout on the card: q [B, N, H*D], k/v [B, M, H*D] ->
    (o [B, N, H*D], lse [B, N, H] f32), through the same kernel."""
    global TOKEN_LAUNCHES
    qh = _heads(q, num_heads)
    d = qh.shape[3]
    if d % HEAD_DIM_MULTIPLE:  # zero-padded [B, H, N|M, d'] copies
        ops = flash_attention_forward_operands(
            *pad_head_dim(qh, *(_heads(t, num_heads) for t in (k, v))))
    else:
        ops = flash_attention_forward_operands(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_tokens_cuda takes a CUDA tensor, "
                         f"got {q.device}")
    _launch(*ops, scale)
    with LAUNCH_LOCK:
        TOKEN_LAUNCHES += 1
    return ops[3][..., :d].transpose(1, 2).flatten(2), ops[4].transpose(1, 2)


def _heads(x, num_heads):
    """[B, N, H*D] -> the [B, H, N, D] view (no copy)."""
    if x.ndim != 3 or x.shape[2] % num_heads:
        raise ValueError(f"feature dim of {tuple(x.shape)} is not divisible "
                         f"by num_heads={num_heads}")
    return x.unflatten(2, (num_heads, -1)).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """o and lse of both layouts, differentiable in o: the forward and
    backward kernels for CUDA tensors, the plain versions for CPU tensors.
    ``num_heads`` None is the head layout, else the token layout."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        o, lse = _forward(q, k, v, scale, num_heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (scale, num_heads)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, num_heads = ctx.cfg
        if num_heads is not None:  # the [B, H, N|M, D] views of the tokens
            q, k, v, o, do = (_heads(t, num_heads) for t in (q, k, v, o, do))
            lse = lse.transpose(1, 2)
        bwd = (flash_attention_backward_cuda if _on_card(q)
               else flash_attention_backward_reference)
        grads = bwd(q, k, v, o, lse, do, scale)
        if num_heads is not None:
            grads = tuple(g.transpose(1, 2).flatten(2) for g in grads)
        return (*grads, None, None)


def _forward(q, k, v, scale, num_heads):
    if num_heads is None:
        if _on_card(q):
            return flash_attention_cuda(q, k, v, scale)
        return naive_attention_reference(q, k, v, scale)
    if _on_card(q):
        return flash_attention_tokens_cuda(q, k, v, num_heads, scale)
    o, lse = naive_attention_reference(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads), scale)
    return o.transpose(1, 2).flatten(2), lse.transpose(1, 2)


def flash_attention(q, k, v, scale: float):
    """[B, H, N, D] attention with the double scale s on q and k:
    the CUDA kernels for a CUDA tensor, the plain versions for a CPU tensor.
    Returns (o, lse [B, H, N])."""
    return _FlashAttention.apply(q, k, v, scale, None)


def flash_attention_tokens(q, k, v, num_heads: int, scale: float):
    """[B, N, H*D] attention (the layout the transformer blocks hold): the
    CUDA kernels for a CUDA tensor, the plain versions for a CPU tensor.
    Returns (o [B, N, H*D], lse [B, N, H])."""
    return _FlashAttention.apply(q, k, v, scale, num_heads)
