"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* :mod:`medfusion_tpu_torch.ops.group_norm` — GroupNorm(+SiLU), replacing the
  Pallas kernel ``medfusion_tpu/ops/group_norm.py::_kernel``.
* :mod:`medfusion_tpu_torch.ops.build` — builds ``csrc/*.cu`` at first use.

Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

from medfusion_tpu_torch.ops import group_norm


def launch_counts() -> dict:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    return {"group_norm_silu": group_norm.LAUNCHES}


def reset_launch_counts() -> None:
    group_norm.LAUNCHES = 0
