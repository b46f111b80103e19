"""Spans, counters and traces (port of ``medfusion_tpu/utils/profiling.py``).

* :func:`annotate` opens a named span where the program does a phase of its
  work (a sampling chunk, a denoising step, the estimator's call, a train
  step's forward, backward and update, the gradient all-reduce), with
  counters. With recording off, the default, it returns one shared no-op
  context manager: no clock is read and no ``record_function`` entered.
* :func:`recording` switches recording on for the block it wraps and
  yields the :class:`Recording` that holds the spans of the thread that
  entered it, complete when the block ends. Nothing else switches it on.
* :func:`trace` profiles the block with ``torch.profiler`` and records its
  spans: the host's operators, the card's kernels and copies when CUDA is
  there, and each span as a ``user_annotation``, written on exit into
  ``log_dir`` as a Chrome-trace JSON file (``*.pt.trace.json``) that
  Perfetto and TensorBoard's profiler plugin read.
* :func:`device_intervals` reads a finished profile's kernels and copies
  on the spans' clock.

Spans are stamped with ``time.time_ns()``, the clock of ``torch.profiler``'s
Kineto events, so that a span and the device work it enqueued compare
directly, and the processes of one machine order against each other.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_recording: Optional["Recording"] = None  # the module-level flag: None when off


class _NoSpan:
    """What :func:`annotate` returns with recording off (one instance)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, **counters):
        """Counters are not kept with recording off."""


NO_SPAN = _NoSpan()


class Span:
    """One recorded span: ``parent`` is the index in :attr:`Recording.spans`
    of the span it lies in (None at a root), ``round`` the index of its root
    among the recording's roots (a chunk, a step), ``start_ns`` and
    ``end_ns`` its ends on ``time.time_ns()``'s clock, ``counters`` its
    counters (summed where counted more than once)."""

    __slots__ = ("name", "parent", "round", "start_ns", "end_ns", "counters", "_rec", "_fn")

    def __init__(self, rec: "Recording", name: str, counters: Dict[str, int]):
        self.name, self.counters, self._rec, self._fn = name, counters, rec, None
        self.parent = self.round = self.start_ns = self.end_ns = None

    def __enter__(self):
        rec = self._rec
        if rec._open:
            self.parent = rec._open[-1]
            self.round = rec.spans[self.parent].round
        else:
            self.round = rec.rounds
            rec.rounds += 1
        rec._open.append(len(rec.spans))
        rec.spans.append(self)
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
        self._rec._open.pop()
        return None

    def count(self, **counters):
        """Add to the span's counters."""
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0) + v

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, round={self.round}, "
                f"start_ns={self.start_ns}, end_ns={self.end_ns}, counters={self.counters})")


class Recording:
    """The spans of one :func:`recording` block, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self.rounds = 0
        self.thread = threading.get_ident()
        self._open: List[int] = []


def annotate(name: str, **counters) -> "Span | _NoSpan":
    """A span named ``name`` with ``counters`` (name -> int), to be used as
    a context manager; ``.count(**counters)`` adds to them inside it. With
    recording off, or on another thread than the one recording, the shared
    no-op :data:`NO_SPAN`. Inside a ``torch.profiler`` a recorded span also
    enters ``record_function``, so that the trace holds it."""
    rec = _recording
    if rec is None or rec.thread != threading.get_ident():
        return NO_SPAN
    return Span(rec, name, counters)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the spans that this thread opens inside the block. Yields the
    :class:`Recording`; a block inside another shares the outer one's."""
    global _recording
    if _recording is not None:
        yield _recording
        return
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block, the card's activity too where CUDA is available,
    with its spans recorded. Yields the ``torch.profiler.profile``; the
    trace file is written when the block ends.

    A span's kernels lie within its host interval where it ends after a
    ``synchronize``. The card's side of a span (``gpu_user_annotation``) is
    drawn per stream, from the kernels launched in it and not in a span
    inside it: a region holding a side stream's copies has one on that
    stream too, which holds no kernel."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        with recording():
            yield prof


def device_intervals(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of each kernel and copy of the finished
    profile ``prof``, on the spans' clock, in the order they started."""
    from torch.autograd import DeviceType

    origin = prof.profiler.kineto_results.trace_start_ns()
    out = [(e.name, origin + round(e.time_range.start * 1e3),
            origin + round(e.time_range.end * 1e3))
           for e in prof.events()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sorted(out, key=lambda t: t[1])
