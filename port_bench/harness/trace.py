"""The traced run's reading: ``torch.profiler`` of the device alone over a
bounded steady stretch of whole rounds (chunks or steps), with CUDA events
in public ``nn.Module`` forward hooks, for the per-layer metrics
(``TraceRun``); then one more round profiled on the host too, whose
longest idle gaps are labelled by the host operation running in them."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from port_bench.count.kernels import kind_of


@dataclasses.dataclass
class TraceRun:
    """What a per-layer reader reads (``metrics/<name>.py``)."""

    chips: int
    rounds: int  # whole chunks or steps in the traced stretch
    window_s: float  # the stretch's length on the host clock, synchronised
    busy_s: float  # union of each card's kernel and copy intervals, averaged over the cards
    kernels: List[Tuple[str, str, float]]  # (name, kind, seconds) of each kernel
    hooks: Dict[str, List[float]]  # name -> ms of each call
    flops_per_round: float  # model FLOPs of one round on one rank
    bounds_per_round: Dict[str, float]  # kernel kind -> bound seconds a round, one rank

    def kernel_seconds(self, *kinds: str) -> float:
        return sum(s for _, k, s in self.kernels if k in kinds)

    def has(self, *kinds: str) -> bool:
        return any(k in kinds for _, k, _ in self.kernels)


class Hooks:
    """CUDA events at entry to ``first`` and exit from ``last`` of each
    registered pair; ``ms()`` after a synchronise."""

    def __init__(self):
        self.pairs: Dict[str, List] = {}
        self.handles = []

    def add(self, name: str, first: torch.nn.Module, last: Optional[torch.nn.Module] = None):
        """Time each call from ``first``'s entry to ``last``'s exit (no
        hooks without a card: there is no device time to read)."""
        if not torch.cuda.is_available():
            return
        last = first if last is None else last
        events = self.pairs.setdefault(name, [])

        def pre(_m, _args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append([ev, None])

        def post(_m, _args, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[-1][1] = ev

        self.handles += [first.register_forward_pre_hook(pre),
                         last.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def ms(self) -> Dict[str, List[float]]:
        return {k: [a.elapsed_time(b) for a, b in v if b is not None]
                for k, v in self.pairs.items()}


def profiled(fn, sync, host: bool):
    """Run ``fn()`` under ``torch.profiler``, synchronised by ``sync`` at
    both ends: the device's activity where there is a card, and the host's
    operations with ``host`` (which slows a host-bound loop down, so the
    device-side readings come from a stretch without it). Returns
    (profile, host seconds)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        seconds = time.perf_counter() - t0
    return prof, seconds


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered stretches), in the
    intervals' unit."""
    intervals.sort()
    covered, gaps, end = 0.0, [], None
    for a, b in intervals:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            covered += b - a
            end = b
        elif b > end:
            covered += b - end
            end = b
    return covered, gaps


def read_profile(prof) -> Dict:
    """{'kernels' [(name, kind, s)], 'busy_s', 'breakdown'}: the device's
    kernels, the union of its intervals, its top operations and its longest
    idle gaps labelled by the host operation that was running in them."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            dev.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU and e.cpu_parent is None:
            host.append((e.time_range.start, e.time_range.end, e.name))
    busy_us, gaps = _union([(a, b) for _, a, b in dev])
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host.sort()
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        what = next((n for s, e, n in host if s <= mid <= e), "host idle")
        labelled.append([what, (b - a) * 1e-6])
    return {"kernels": [(n, kind_of(n), (b - a) * 1e-6) for n, a, b in dev],
            "busy_s": busy_us * 1e-6,
            "breakdown": {"device_ops": [[n, s] for n, s in top], "idle_gaps": labelled}}
