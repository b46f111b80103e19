"""One run of one cell: set-up, the window (or the traced stretch), the
reading of the metrics, then the check against the plain reference once
the program's state is freed. A cell of several chips runs one process a
card; this process is rank 0 and alone prints."""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from port_bench.harness import check, guard, spec

KINDS = ("sample", "train")


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    kind: str  # the traffic's kind
    chips: int
    setup_s: float
    window_s: Optional[float] = None  # the timed window, trace off
    units: Optional[int] = None  # images or samples completed in the window, all ranks
    round_ms: Optional[List[float]] = None  # rank 0's chunk or step durations in the window
    trace: Optional[object] = None  # trace.TraceRun, trace on


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark runs only on the card", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        print(f"the cell asks for {n} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(3)


def run(workload: str, seed: int, seconds: float, traced: bool, start: float) -> Dict:
    cell = spec.find_cell(workload)
    if cell.traffic["kind"] not in KINDS:
        raise ValueError(f"traffic kind {cell.traffic['kind']!r} is not one of {KINDS}")
    require_cards(cell.chips)
    if cell.chips == 1:
        return run_rank(cell, seed, seconds, traced, start)
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(workload, seed, seconds, traced, r, port))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    try:
        result = run_rank(cell, seed, seconds, traced, start, rank=0, port=port)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return result


def _rank_main(workload, seed, seconds, traced, rank, port):
    os.environ["LOCAL_RANK"] = str(rank)
    cell = spec.find_cell(workload)
    run_rank(cell, seed, seconds, traced, time.perf_counter(), rank=rank, port=port)


def run_rank(cell, seed: int, seconds: float, traced: bool, start: float, rank: int = 0,
             port: Optional[int] = None, device=None, faults=None) -> Optional[Dict]:
    """The run on one rank; rank 0 returns the result. ``device`` (a CPU, in
    the tests) and ``faults`` (callables applied to the driver after its
    set-up, in the tests and the calibration) are not the command's."""
    import torch
    import torch.distributed as dist

    from port_bench.harness import sampling, trace, training

    world = cell.chips
    phases = {"imports": time.perf_counter() - start}
    if device is None:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    host_group = None
    if world > 1:
        from medfusion_tpu_torch.parallel.multihost import initialize_multihost

        initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device.type)
        host_group = dist.new_group(backend="gloo")
    kind = cell.traffic["kind"]
    module = {"sample": sampling, "train": training}[kind]
    driver = {"sample": sampling.Sampling, "train": training.Training}[kind](
        cell, seed, device, rank, world, host_group)
    for fault in faults or ():
        fault(driver)
    sync()
    phases["built"] = time.perf_counter() - start
    driver.prepare()
    sync()
    reading = Reading(kind=kind, chips=world, setup_s=time.perf_counter() - start)
    if rank == 0:
        print(f"set-up seconds: imports {phases['imports']:.3f}, the program built with its "
              f"weights {phases['built']:.3f}, warmed up {reading.setup_s:.3f}",
              file=sys.stderr, flush=True)
    prof = hooks = host_prof = None
    if traced:
        prof, window_s, hooks, host_prof = driver.traced(sync)
    else:
        window_s = driver.window(seconds, sync)
    attempted, failed = driver.counts()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    seen = trace.read_profile(prof) if traced else {"busy_s": 0.0}
    if host_group is not None:
        worst = torch.tensor([float(failed), float(peak)])
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=host_group)
        failed, peak = int(worst[0]), int(worst[1])
        busy = torch.tensor([seen["busy_s"] / world], dtype=torch.float64)
        dist.all_reduce(busy, group=host_group)
        seen["busy_s"] = float(busy)  # averaged over the cards
    if not traced:
        reading.window_s = window_s
        reading.units = driver.window_rounds * driver.rows_per_round
        reading.round_ms = driver.round_ms
        if rank == 0:
            _print_rounds(driver.round_ms)
    out = driver.release()
    if world > 1:
        dist.barrier(group=host_group)
        dist.destroy_process_group()
    if rank != 0:
        return None

    breakdown = None
    if traced:
        breakdown = {"device_ops": seen["breakdown"]["device_ops"],
                     "idle_gaps": trace.read_profile(host_prof)["breakdown"]["idle_gaps"]}
        del prof, host_prof
        work = _work(cell)
        reading.trace = trace.TraceRun(
            chips=world, rounds=cell.traffic["trace_rounds"], window_s=window_s,
            busy_s=seen["busy_s"], kernels=seen["kernels"], hooks=hooks,
            flops_per_round=work["flops"], bounds_per_round=work["bounds"])
    metrics = spec.read_metrics(cell.per_layer if traced else cell.end_to_end, reading)

    verdict = check.judge(module.numbers(cell, seed, out, device, world), cell.limits)
    verdict["correct"] = verdict["correct"] and failed == 0

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": world, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit_w"] = _power_limit()
    if traced:
        dev["busy_s"] = reading.trace.busy_s
        dev["window_s"] = window_s
    result = {"correct": verdict["correct"], "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["checks"]
    check.print_checks(verdict["checks"])
    guard.check()
    return result


def _print_rounds(ms: List[float]) -> None:
    """How the window's rounds spread (CUDA events at their ends), on
    stderr: their quartiles, and the mean of each third of the window."""
    import statistics

    if len(ms) < 6:
        return
    q = statistics.quantiles(ms, n=4)
    third = len(ms) // 3
    means = [statistics.fmean(ms[i * third:(i + 1) * third]) for i in range(3)]
    print(f"window rounds: {len(ms)}, ms quartiles {q[0]:.2f} {q[1]:.2f} {q[2]:.2f}, "
          f"thirds' means {means[0]:.2f} {means[1]:.2f} {means[2]:.2f}",
          file=sys.stderr, flush=True)


def _work(cell) -> Dict:
    """Model FLOPs and kernel bounds of one round on one rank."""
    from port_bench.count import kernels, work

    tr, cfg = cell.traffic, cell.config
    elt = {"bfloat16": 2, "float32": 4}[cfg["compute_dtype"]]
    if tr["kind"] == "sample":
        w = work.sample_chunk(cfg, tr["rows"], tr["steps"])
    else:
        w = work.train_step(cfg, tr["rows_per_rank"])
    return {"flops": w["flops"], "bounds": kernels.bound_seconds(w["calls"], elt)}
