"""Supervised restarts around checkpointed training (port of
``medfusion_tpu/utils/resilience.py``).

:func:`run_with_auto_restore` calls ``attempt(resume)``; on an exception it
calls it again with ``resume=True``, so that the training restores its
latest checkpoint and continues, up to ``max_restarts`` times. A CUDA error
that poisons the context (a device-side assert, an illegal memory access)
is raised at once: every later CUDA call in the process would fail too.
"""

from __future__ import annotations

from typing import Callable

# messages of the CUDA errors after which the process's context is unusable
STICKY_CUDA_ERRORS = ("device-side assert", "illegal memory access",
                      "an illegal instruction", "misaligned address",
                      "unspecified launch failure")


def run_with_auto_restore(attempt: Callable[[bool], object], max_restarts: int = 3):
    """Run ``attempt(resume)`` until it returns; restart on an exception.

    ``attempt`` is called with ``resume=False`` first and ``resume=True``
    after every failure. Returns what ``attempt`` returns. A sticky CUDA
    error, the failure after the last restart, and what is not an
    ``Exception`` (an interrupt) propagate."""
    restarts = 0
    resume = False
    while True:
        try:
            return attempt(resume)
        except Exception as e:
            restarts += 1
            if restarts > max_restarts or any(m in str(e) for m in STICKY_CUDA_ERRORS):
                raise
            print(f"[auto-restart {restarts}/{max_restarts}] {type(e).__name__}: {e} "
                  f"— restoring from the latest checkpoint")
            resume = True
