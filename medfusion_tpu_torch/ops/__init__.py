"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* :mod:`medfusion_tpu_torch.ops.group_norm` — GroupNorm(+SiLU), replacing the
  Pallas kernel ``medfusion_tpu/ops/group_norm.py::_kernel``.
* :mod:`medfusion_tpu_torch.ops.flash_attention` — flash attention in
  head and token layout, replacing ``_fwd_kernel`` and ``_fwd_mha_kernel``
  (forward) and ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (backward) of
  ``medfusion_tpu/ops/flash_attention.py``.
* :mod:`medfusion_tpu_torch.ops.geglu` — the fused LayerNorm + GEGLU +
  down-projection MLP, replacing ``medfusion_tpu/ops/geglu.py::_kernel``.
* :mod:`medfusion_tpu_torch.ops.build` — builds ``csrc/*.cu`` at first use.

Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

from medfusion_tpu_torch.ops import flash_attention as _fa
from medfusion_tpu_torch.ops import geglu, group_norm
from medfusion_tpu_torch.ops.build import LAUNCH_LOCK

# KV length from which attention takes the head-layout entry; shorter KV
# takes the token-layout entry. This is the JAX package's split
# (medfusion_tpu/ops/flash_attention.py HEAD_LAYOUT_MIN_TOKENS), measured on
# a TPU, where the head layout costs HBM transposes. On Hopper both entries
# launch the same strided kernel without copies; the split awaits an H100
# measurement. The JAX package's MIN_KV_TOKENS (XLA's softmax below 256
# tokens) is not carried over: on the card that would be the plain version.
HEAD_LAYOUT_MIN_TOKENS = 1024


def attention(q, k, v, num_heads: int, scale: float):
    """Double-scaled softmax attention on the transformer blocks' layout:
    q [B, N, H*D], k/v [B, M, H*D] -> o [B, N, H*D]."""
    if k.shape[1] >= HEAD_LAYOUT_MIN_TOKENS:
        qh, kh, vh = (_fa._heads(t, num_heads) for t in (q, k, v))
        o, _ = _fa.flash_attention(qh, kh, vh, scale)
        return o.transpose(1, 2).flatten(2)  # a view when o has q's strides
    o, _ = _fa.flash_attention_tokens(q, k, v, num_heads, scale)
    return o


def launch_counts() -> dict:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    with LAUNCH_LOCK:
        return {"group_norm_silu": group_norm.LAUNCHES,
                "flash_attention": _fa.LAUNCHES,
                "flash_attention_tokens": _fa.TOKEN_LAUNCHES,
                "flash_attention_bwd_dq": _fa.BWD_DQ_LAUNCHES,
                "flash_attention_bwd_dkv": _fa.BWD_DKV_LAUNCHES,
                "geglu_mlp": geglu.LAUNCHES}


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        group_norm.LAUNCHES = 0
        _fa.LAUNCHES = 0
        _fa.TOKEN_LAUNCHES = 0
        _fa.BWD_DQ_LAUNCHES = 0
        _fa.BWD_DKV_LAUNCHES = 0
        geglu.LAUNCHES = 0
