"""The device's idle time split by program phase (``harness/phases.py``)
on synthetic intervals, and ``phases.py``'s traced run of the smoke cells
on the CPU, where the card is idle throughout and the whole stretch is
split."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import phases as tool
from port_bench.harness import phases, spec
from port_bench.tests import smoke

SAMPLE = phases.PHASES["sample"]
TRAIN = phases.PHASES["train"]


def _spans(*rows):
    """(name, parent, start, end) rows as the recorder's fields."""
    return [phases.SpanRecord(n, p, 0, a, b, {}) for n, p, a, b in rows]


# a chunk [0, 100] with two steps, each with an estimator call
CHUNK = _spans(("sample.chunk", None, 0, 100),
               ("sample.step", 0, 10, 50), ("estimator", 1, 20, 40),
               ("sample.step", 0, 60, 90), ("estimator", 3, 65, 85))


def test_idle_intervals_are_the_windows_uncovered_stretches():
    busy = [(5, 10), (8, 20), (30, 40), (-5, 2), (95, 130)]
    assert phases.idle_intervals(busy, 0, 100) == [(2, 5), (20, 30), (40, 95)]
    assert phases.idle_intervals([], 0, 10) == [(0, 10)]
    assert phases.idle_intervals([(0, 10)], 0, 10) == []


def test_innermost_segments_tile_the_roots():
    assert phases.innermost(CHUNK) == [(0, 10, 0), (10, 20, 1), (20, 40, 2), (40, 50, 1),
                                       (50, 60, 0), (60, 65, 3), (65, 85, 4), (85, 90, 3),
                                       (90, 100, 0)]


def test_nested_spans_a_gap_across_spans_and_none_open():
    idle = [(0, 5), (15, 25), (38, 62), (95, 110)]
    got = phases.idle_split(idle, CHUNK, SAMPLE)
    # (15, 25): 5 in a step, 5 in the estimator; (38, 62): 2 in the
    # estimator, 22 in the steps and the chunk; (95, 110): 5 in the chunk,
    # 10 with no span open
    assert got == {"estimator": 7, "sampler": 5 + 5 + 22 + 5, "other": 10}
    assert sum(got.values()) == sum(b - a for a, b in idle)


def test_no_span_open_is_other_and_parts_sum_to_the_whole():
    assert phases.idle_split([(0, 7)], [], SAMPLE) == {"estimator": 0, "sampler": 0,
                                                       "other": 7}
    step = _spans(("train.step", None, 0, 100), ("train.forward", 0, 5, 40),
                  ("train.encode", 1, 5, 15), ("estimator", 1, 15, 40),
                  ("train.backward", 0, 40, 70), ("parallel.sync_gradients", 0, 70, 80),
                  ("train.optimizer", 0, 80, 90), ("train.ema", 0, 90, 98))
    idle = [(0, 10), (12, 45), (60, 85), (97, 120)]
    got = phases.idle_split(idle, step, TRAIN)
    assert got == {"forward": 5 + 28, "backward": 5 + 10, "optimizer": 5 + 1,
                   "other": 5 + 10 + 2 + 20}
    assert sum(got.values()) == sum(b - a for a, b in idle)


def test_the_gradient_allreduce_is_each_rounds_first_nccl_kernel():
    # two rounds, each the gradient all-reduce then the metrics' mean
    nccl = [(300, 320), (100, 130), (150, 160), (340, 345)]
    assert phases.allreduce_kernels(nccl, rounds=2, collectives=1) == [(100, 130), (300, 320)]
    assert phases.skews_ms([[100, 300], [40_000_100, 300], [100, 5_000_300]]) == [40.0, 5.0]
    # the rank that starts last waits for no one: its kernel is the transfer
    ranks = [[(0, 9_000_000)], [(8_000_000, 10_000_000)]]
    assert phases.last_arrivals_ms(ranks) == [2.0]
    with pytest.raises(ValueError):
        phases.allreduce_kernels([(1, 2), (2, 3), (3, 4)], rounds=2, collectives=1)


def _cell(kind, chips=1):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cell = smoke.cell(kind, chips=chips)
    cell.per_layer = [m for m in bench["per_layer"] if m["name"] == f"device_idle_pct.{kind}"]
    return cell


@pytest.mark.parametrize("kind", ["sample", "train"])
def test_a_traced_smoke_run_splits_the_whole_idle_share(kind):
    torch.set_num_threads(2)
    result = tool.run_rank(_cell(kind), 5, device=torch.device("cpu"))
    got = result["phases"]
    idle = result["metrics"][f"device_idle_pct.{kind}"]["value"]
    assert got[f"idle_sum_pct.{kind}"] == pytest.approx(idle, abs=1.0)
    if kind == "sample":
        # a chunk, each step and its estimator call, the decode
        assert got["spans_per_round"] == 2 + 2 * smoke.TRAFFIC["sample"]["steps"]
        assert got["estimator_host_ms.sample"] == got["span_ms"]["estimator"] > 0
    else:
        assert got["spans_per_round"] == 7
        assert got["train_host_ms.train"] > 0
        assert "allreduce_mb.train" not in got


def _rank(queue, cell, rank, port):
    """One rank of the two-rank run in a fresh process (a fault planted by
    another test of this process may still patch the all-reduce)."""
    torch.set_num_threads(2)
    result = tool.run_rank(cell, 5, 20.0, 0, rank, port, device=torch.device("cpu"))
    if result is not None:
        queue.put(result)


def test_a_traced_smoke_run_on_two_ranks_counts_the_allreduce():
    import multiprocessing
    import queue as queues

    from port_bench.harness import program, runner

    cell = _cell("train", chips=2)
    port = runner._free_port()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(out, cell, r, port)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        result = out.get(timeout=600)
    except queues.Empty:
        result = None
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.terminate()
            p.join()
    assert result is not None and [p.exitcode for p in procs] == [0, 0]
    got = result["phases"]
    sd_unet, _ = program.seeded_weights(cell.config, 5, torch.device("cpu"))
    assert got["allreduce_mb.train"] == sum(v.numel() * 4 for v in sd_unet.values()) / 1e6
    assert got["spans_per_round"] == 8  # and parallel.sync_gradients
    assert got["idle_sum_pct.train"] == pytest.approx(
        result["metrics"]["device_idle_pct.train"]["value"], abs=1.0)
    delay = got["delay"]  # no NCCL kernel here; rank 1's host starts 20 ms late
    assert delay["skew_ms_each"] is None is delay["last_rank_ms_each"]
    assert len(delay["host_skew_ms_each"]) == tool.DELAY_STEPS
    # at least half the delay: the ranks leave the barrier a little apart
    assert all(ms >= 10.0 for ms in delay["host_skew_ms_each"]), delay
