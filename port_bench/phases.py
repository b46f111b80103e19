"""A traced run of one cell with the port's spans recorded: the cell's
``--trace 1`` line (``run.py``), from a device-only stretch over which the
spans are recorded too, with the device's idle time split by program phase
(``harness/phases.py``) added under 'phases'.

    python3 port_bench/phases.py --workload <cell> --seed <n> \\
        [--delay-ms 50] [--cost-cycles 2]

'phases' holds, for a 'sample' cell, ``estimator_host_ms.sample`` (mean ms
of an ``estimator`` span) and the idle shares of the stretch
``idle_estimator_pct.sample``, ``idle_sampler_pct.sample`` and
``idle_other_pct.sample``; for a 'train' cell ``train_host_ms.train``
(mean ms of a ``train.step`` span, rank 0), ``idle_forward_pct.train``,
``idle_backward_pct.train``, ``idle_optimizer_pct.train`` and
``idle_other_pct.train`` (each rank's idle seconds in the phase, averaged
over the cards, over rank 0's stretch, as ``device_idle_pct.train`` is
read) and, on several cards, ``allreduce_mb.train`` (``allreduce_bytes``
of ``parallel.sync_gradients`` a step, rank 0) and
``allreduce_skew_ms.train`` (mean over the steps), with each step's skew,
the skew of the spans' host starts and the all-reduce's duration on the
rank that started it last (the transfer alone).

``--delay-ms`` (several cards) runs a few more steps in which every card
waits for its device and the ranks meet on the host before the gradient
all-reduce, and rank 1 then sleeps that long: each step's skew should read
the delay, device and host alike. ``--cost-cycles`` (one card) runs device-only stretches without
and with recording in turns (off, on, on, off, a cycle) and times the
recorder's span alone: what recording costs."""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import runner, spec  # noqa: E402

DELAY_STEPS = 5
SPAN_ROUNDS = 50


def _one_round(driver):
    from port_bench.harness.sampling import Sampling

    if isinstance(driver, Sampling):
        driver.images.append(driver._chunk(len(driver.images), driver.sampler, driver.steps))
    else:
        driver.step()


def _recorded(driver, sync, rounds: int):
    """``rounds`` rounds profiled on the device with the spans recorded:
    (profile, seconds, the stretch's start on the spans' clock, spans)."""
    from medfusion_tpu_torch.utils import profiling

    from port_bench.harness import phases, trace

    box = {}

    def stretch():
        box["t0"] = time.time_ns()
        with profiling.recording() as rec:
            for _ in range(rounds):
                _one_round(driver)
        box["spans"] = phases.records(rec.spans)

    prof, seconds = trace.profiled(stretch, sync, host=False)
    return prof, seconds, box["t0"], box["spans"]


def _local(prof, seconds, t0, spans, kind):
    """This rank's reading of a recorded stretch."""
    from medfusion_tpu_torch.utils import profiling

    from port_bench.count.kernels import kind_of
    from port_bench.harness import phases

    dev = profiling.device_intervals(prof)
    t1 = t0 + round(seconds * 1e9)
    idle = phases.idle_intervals([(a, b) for _, a, b in dev], t0, t1)
    ms = {}
    for s in spans:
        ms.setdefault(s.name, []).append((s.end_ns - s.start_ns) * 1e-6)
    sync_spans = [s for s in spans if s.name == "parallel.sync_gradients"]
    return {"window_ns": t1 - t0, "idle_ns": phases.idle_split(idle, spans, phases.PHASES[kind]),
            "span_ms": {k: statistics.fmean(v) for k, v in ms.items()},
            "spans": len(spans), "rounds": 1 + max((s.round for s in spans), default=-1),
            "allreduce_bytes": [s.counters.get("allreduce_bytes", 0) for s in sync_spans],
            "collectives": max((s.counters.get("collectives", 0) for s in sync_spans),
                               default=0),
            "nccl": [(a, b) for name, a, b in dev if kind_of(name) == "nccl"],
            "sync_starts": [s.start_ns for s in sync_spans]}


def _skews(readings):
    """Each step's skew over the ranks of the gradient all-reduce's device
    starts and of their ``parallel.sync_gradients`` spans' host starts, and
    the all-reduce's duration on the last rank to start it (ms; the first
    and the last None, said on stderr, where a rank's traced NCCL kernels
    do not split into its steps)."""
    from port_bench.harness import phases

    host = phases.skews_ms([r["sync_starts"] for r in readings])
    try:
        kernels = [phases.allreduce_kernels(r["nccl"], r["rounds"], r["collectives"])
                   for r in readings]
    except ValueError as e:  # no NCCL kernel traced, or a rank's do not split into rounds
        first = [round((min(r["nccl"])[0] - r["sync_starts"][0]) * 1e-6, 3) if r["nccl"]
                 else None for r in readings]
        print(f"no all-reduce skew: {e}; NCCL kernels by rank "
              f"{[len(r['nccl']) for r in readings]}, the first starting (ms) after the "
              f"first sync span opened {first}", file=sys.stderr, flush=True)
        return None, host, None
    return (phases.skews_ms([[a for a, _ in k] for k in kernels]), host,
            phases.last_arrivals_ms(kernels))


def _summary(readings, kind):
    """The 'phases' numbers of the ranks' readings (rank 0's first)."""
    first = readings[0]
    window = first["window_ns"]
    out = {}
    for phase in sorted(first["idle_ns"]):
        mean = statistics.fmean(r["idle_ns"][phase] for r in readings)
        out[f"idle_{phase}_pct.{kind}"] = 100.0 * mean / window
    out[f"idle_sum_pct.{kind}"] = sum(v for k, v in out.items() if k.startswith("idle_"))
    if kind == "sample":
        out["estimator_host_ms.sample"] = first["span_ms"].get("estimator")
    else:
        out["train_host_ms.train"] = first["span_ms"].get("train.step")
    if first["allreduce_bytes"]:
        out["allreduce_mb.train"] = statistics.fmean(first["allreduce_bytes"]) / 1e6
        skews, host, last = _skews(readings)
        if skews is not None:
            out["allreduce_skew_ms.train"] = statistics.fmean(skews)
            out["allreduce_skew_ms_each"] = skews
            out["allreduce_last_rank_ms_each"] = last
        out["sync_host_skew_ms_each"] = host
    out["spans_per_round"] = first["spans"] / max(first["rounds"], 1)
    out["span_ms"] = first["span_ms"]  # rank 0's mean host ms of each span
    return out


def _gather(driver, local):
    import torch.distributed as dist

    if getattr(driver, "host_group", None) is None:  # one card (sampling has no group)
        return [local]
    out = [None] * dist.get_world_size(driver.host_group)
    dist.all_gather_object(out, local, group=driver.host_group)
    return out


def _delayed(driver, sync, delay_ms: float):
    """``DELAY_STEPS`` steps in which each card waits for its device and the
    ranks meet on the host before the gradient all-reduce, and rank 1 then
    sleeps ``delay_ms``: each step's skews, device and host (``_skews``)."""
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel import mesh

    plain = mesh.sync_gradients

    def late(model, group):
        sync()
        dist.barrier(group=driver.host_group)
        if driver.rank == 1:
            time.sleep(delay_ms * 1e-3)
        plain(model, group)

    mesh.sync_gradients = late
    try:
        prof, seconds, t0, spans = _recorded(driver, sync, DELAY_STEPS)
    finally:
        mesh.sync_gradients = plain
    return _skews(_gather(driver, _local(prof, seconds, t0, spans, "train")))


def _span_ns(per_round: int, on: bool, profiled: bool) -> float:
    """Mean ns of one empty ``annotate`` block, in ``SPAN_ROUNDS`` rounds of
    ``per_round`` spans (a fresh recording a round where ``on``), inside a
    device-only profile or not."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from medfusion_tpu_torch.utils import profiling

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=acts) if profiled else contextlib.nullcontext():
        t0 = time.perf_counter_ns()
        for _ in range(SPAN_ROUNDS):
            with profiling.recording() if on else contextlib.nullcontext():
                for _ in range(per_round):
                    with profiling.annotate("span.cost"):
                        pass
        return (time.perf_counter_ns() - t0) / (SPAN_ROUNDS * per_round)


def _cost(driver, sync, rounds: int, cycles: int, spans):
    """Host ms a round over device-only stretches of ``rounds`` rounds,
    recording off and on in turns (off, on, on, off a cycle), and an empty
    span's ns in rounds of as many spans as ``spans`` has a round."""
    import contextlib

    from medfusion_tpu_torch.utils import profiling

    from port_bench.harness import trace

    ms = {"off": [], "on": []}
    for _ in range(cycles):
        for on in (False, True, True, False):
            def stretch():
                with profiling.recording() if on else contextlib.nullcontext():
                    for _ in range(rounds):
                        _one_round(driver)

            _, seconds = trace.profiled(stretch, sync, host=False)
            ms["on" if on else "off"].append(seconds / rounds * 1e3)
    per_round = len(spans) // max(1, 1 + max(s.round for s in spans))
    span_ns = {"off": [], "on": [], "on_profiled": []}
    for _ in range(cycles):
        for key in ("off", "on", "on_profiled", "on_profiled", "on", "off"):
            span_ns[key].append(_span_ns(per_round, key != "off", key == "on_profiled"))
    return {"round_ms_off": ms["off"], "round_ms_on": ms["on"], "span_ns": span_ns}


def install(driver, found: dict, delay_ms: float = 0.0, cost_cycles: int = 0):
    """Replace ``driver.traced`` by the same reading with the spans
    recorded over the device-only stretch; rank 0's 'phases' numbers go
    into ``found``."""
    from port_bench.harness import trace
    from port_bench.harness.sampling import Sampling

    kind = "sample" if isinstance(driver, Sampling) else "train"

    def traced(sync):
        hooks = trace.Hooks()
        if kind == "sample":
            vae = driver.pipe.latent_embedder
            hooks.add("unet", driver.pipe.noise_estimator)
            hooks.add("decode", vae.inc_dec, vae.outc)
        rounds = driver.tr["trace_rounds"]
        try:
            prof, seconds, t0, spans = _recorded(driver, sync, rounds)
        finally:
            hooks.remove()
        summary = _summary(_gather(driver, _local(prof, seconds, t0, spans, kind)), kind)
        world = getattr(driver, "world", 1)
        if delay_ms and world > 1:
            skews, host, last = _delayed(driver, sync, delay_ms)
            summary["delay"] = {"ms": delay_ms, "skew_ms_each": skews,
                                "host_skew_ms_each": host, "last_rank_ms_each": last}
        if cost_cycles and world == 1:
            summary["cost"] = _cost(driver, sync, rounds, cost_cycles, spans)
        found.update(summary)
        host, _ = trace.profiled(lambda: _one_round(driver), sync, host=True)
        return prof, seconds, hooks.ms(), host

    driver.traced = traced


def run_rank(cell, seed, delay_ms=0.0, cost_cycles=0, rank=0, port=None, start=None,
             device=None):
    """``runner.run_rank`` with the spans recorded over the traced stretch;
    rank 0 returns the result with 'phases'. ``device``: as there."""
    found = {}
    if rank:
        os.environ["LOCAL_RANK"] = str(rank)
    result = runner.run_rank(
        cell, seed, 1.0, True, start or time.perf_counter(), rank=rank, port=port,
        device=device, faults=[lambda d: install(d, found, delay_ms, cost_cycles)])
    if result is not None:
        result["phases"] = found
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--delay-ms", type=float, default=0.0)
    ap.add_argument("--cost-cycles", type=int, default=0)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    runner.require_cards(cell.chips)
    port = runner._free_port() if cell.chips > 1 else None
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(cell, args.seed, args.delay_ms,
                                                args.cost_cycles, r, port))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    try:
        result = run_rank(cell, args.seed, args.delay_ms, args.cost_cycles, 0, port, START)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"a rank exited with {[p.exitcode for p in procs]}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
