"""Tracing and step timing (port of ``medfusion_tpu/utils/profiling.py``).

* :func:`trace` profiles the block it wraps with ``torch.profiler``: the
  host's operators, and the card's kernels and copies when CUDA is there,
  written on exit into ``log_dir`` as a Chrome-trace JSON file
  (``*.pt.trace.json``) that Perfetto and TensorBoard's profiler plugin
  read.
* :func:`annotate` names a region of a trace
  (``torch.profiler.record_function``); the trace holds it on the host's
  timeline, and on the card's where kernels ran inside it.
* :class:`StepTimer`: the wall-clock time a step, smoothed by an
  exponential moving average, with the JAX package's arithmetic.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block, the card's activity too where CUDA is available.
    Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


def annotate(name: str):
    """A named region inside a traced block."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with EMA smoothing; call ``tick`` once a step
    (after a ``synchronize`` to time the card's work)."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self._last: Optional[float] = None
        self.ema_step_s: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema_step_s = (
                dt if self.ema_step_s is None
                else self.smoothing * self.ema_step_s + (1 - self.smoothing) * dt
            )
        self._last = now
        return self.ema_step_s

    def stats(self) -> Dict[str, float]:
        if self.ema_step_s is None:
            return {}
        return {"step_seconds": self.ema_step_s, "steps_per_sec": 1.0 / self.ema_step_s}
