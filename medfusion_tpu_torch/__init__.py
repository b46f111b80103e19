"""PyTorch / CUDA port of medfusion-tpu for NVIDIA Hopper (H100).

The JAX package ``medfusion_tpu`` is the reference; this package mirrors its
module layout (``core``, ``nn``, ``ops``, ``models``, ``parallel``, ``pipelines``,
``data``, ``losses``, ``train``, ``utils``, ``cli``) with NCHW ``nn.Module``s and
hand-written CUDA kernels under ``csrc/``.

Entry points run on the card unless the caller asks for the CPU: a device of
``None`` resolves to ``cuda`` and raises when CUDA is absent. Nothing falls
back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given.

    An explicit ``"cuda"`` also raises without CUDA, so a caller never lands
    on the CPU without asking for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
