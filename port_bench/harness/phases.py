"""The device's idle time by the program phase that the host was in, from
the port's spans (``medfusion_tpu_torch/utils/profiling.py``) and a
device-only ``torch.profiler`` stretch on the spans' clock.

Each idle interval of the card within the stretch is divided among the
innermost spans open on the host across it, by intersecting intervals;
each innermost span counts for the nearest span around it (itself
included) that names a phase of the cell's kind (``PHASES``), and the time
with no such span open goes to 'other'. The parts add up to the idle time.

On a world of several cards, the gradient all-reduce's skew: the step's
first ``collectives`` NCCL kernels in launch order are its all-reduce, and
the skew of a step is the latest rank's device start of it minus the
earliest rank's."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

OTHER = "other"

# the span names that name a phase, by traffic kind; a span counts for the
# nearest of them around it
PHASES = {
    "sample": {"estimator": "estimator", "sample.chunk": "sampler"},
    "train": {"train.forward": "forward", "train.backward": "backward",
              "train.optimizer": "optimizer", "train.ema": "optimizer"},
}

# what a span needs here: profiling.Span has these fields, and so has this
# plain tuple, which crosses between processes
SpanRecord = collections.namedtuple("SpanRecord", "name parent round start_ns end_ns counters")


def records(spans) -> List[SpanRecord]:
    return [SpanRecord(s.name, s.parent, s.round, s.start_ns, s.end_ns, dict(s.counters))
            for s in spans]


def idle_intervals(busy: Sequence[Tuple[int, int]], start: int, end: int
                   ) -> List[Tuple[int, int]]:
    """The stretches of [start, end] that no interval of ``busy`` covers."""
    idle, at = [], start
    for a, b in sorted(busy):
        a, b = max(a, start), min(b, end)
        if b <= at:
            continue
        if a > at:
            idle.append((at, a))
        at = b
    if at < end:
        idle.append((at, end))
    return idle


def innermost(spans: Sequence[SpanRecord]) -> List[Tuple[int, int, int]]:
    """(start, end, index) of the stretches in which span ``index`` is the
    innermost span open, in time order. Spans nest (one thread's)."""
    children: Dict[Optional[int], List[int]] = collections.defaultdict(list)
    for i, s in enumerate(spans):
        children[s.parent].append(i)
    out: List[Tuple[int, int, int]] = []

    def walk(i):
        at = spans[i].start_ns
        for c in children[i]:
            if spans[c].start_ns > at:
                out.append((at, spans[c].start_ns, i))
            walk(c)
            at = max(at, spans[c].end_ns)
        if spans[i].end_ns > at:
            out.append((at, spans[i].end_ns, i))

    for root in children[None]:
        walk(root)
    return out


def phase_of(spans: Sequence[SpanRecord], i: Optional[int], names: Dict[str, str]) -> str:
    """The phase of span ``i``: that of the nearest span around it, itself
    included, whose name ``names`` maps; else 'other'."""
    while i is not None:
        if spans[i].name in names:
            return names[spans[i].name]
        i = spans[i].parent
    return OTHER


def idle_split(idle: Sequence[Tuple[int, int]], spans: Sequence[SpanRecord],
               names: Dict[str, str]) -> Dict[str, int]:
    """{phase: ns} of the ``idle`` intervals (sorted, disjoint), each part
    of them given to the phase of the innermost span open across it;
    'other' holds the rest. The parts add up to the idle time."""
    segs = innermost(spans)
    out = {p: 0 for p in set(names.values()) | {OTHER}}
    j = 0
    for a, b in idle:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[phase_of(spans, segs[k][2], names)] += hi - lo
                covered += hi - lo
            k += 1
        out[OTHER] += (b - a) - covered
    return out


def allreduce_kernels(nccl: Sequence[Tuple[int, int]], rounds: int, collectives: int
                      ) -> List[Tuple[int, int]]:
    """(start, end) of each round's gradient all-reduce: the first of the
    round's ``collectives`` NCCL kernels, each round launching the same
    number of NCCL kernels, in launch order (one stream)."""
    nccl = sorted(nccl)
    if rounds <= 0 or not nccl or len(nccl) % rounds or collectives < 1:
        raise ValueError(f"{len(nccl)} NCCL kernels do not split into {rounds} rounds "
                         f"of {collectives} or more")
    each = len(nccl) // rounds
    if each < collectives:
        raise ValueError(f"{each} NCCL kernels a round, fewer than {collectives}")
    return nccl[::each]


def skews_ms(per_rank: Sequence[Sequence[int]]) -> List[float]:
    """Each round's latest rank's start minus the earliest rank's, ms."""
    return [(max(r) - min(r)) * 1e-6 for r in zip(*per_rank)]


def last_arrivals_ms(per_rank: Sequence[Sequence[Tuple[int, int]]]) -> List[float]:
    """Each round's kernel duration on the rank that started it last, ms:
    the others were waiting for it, so this is the transfer alone."""
    return [(b - a) * 1e-6 for a, b in (max(r) for r in zip(*per_rank))]
