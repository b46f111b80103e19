"""The readings that a cell's limits are set from, on the card at the cell's
own sizes:

* the program's numbers over many seeds (the lower reading: the largest);
* the control's: the plain reference computed with float8 operands (the
  precision below the bf16 that the configuration states) held to the
  float32 reference (the upper reading: the smallest);
* for training, each planted fault (``harness/faults.py``) held to the
  reference.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--faults half exchange] [--dump DIR]

Sampling runs ``--chunks`` whole chunks a seed at the cell's load and
compares as many images as a run does. ``--dump`` keeps each training
reading's leaf norms, both sides', in ``DIR/<what>.<seed>.pt``, with the
leaves' names and sizes in ``DIR/leaves.pt``, so that a number can be
chosen among several over the same runs. A cell of several chips runs one
process a card; rank 0 prints one JSON line per reading and the summary."""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import check, faults, runner, spec  # noqa: E402


def _say(rank, **kv):
    if rank == 0:
        print(json.dumps(kv), flush=True)


def program_numbers(cell, seed, device, rank=0, world=1, host_group=None, fault=None,
                    chunks=1, dump=None):
    """The program's numbers at ``seed`` (rank 0's; None elsewhere)."""
    import torch

    from port_bench.harness import sampling, training

    if cell.traffic["kind"] == "sample":
        d = sampling.Sampling(cell, seed, device)
        if fault:
            faults.FAULTS[fault](d)
        d.prepare()
        for _ in range(chunks):
            d.images.append(d._chunk(len(d.images), d.sampler, d.steps))
        return sampling.numbers(cell, seed, d.release(), device)
    d = training.Training(cell, seed, device, rank, world, host_group)
    if fault:
        faults.FAULTS[fault](d)
    try:
        d.prepare()
    finally:
        faults.undo(d)
    prog = d.release()
    del d
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    ref = training.reference_readings(cell.config, cell.traffic, seed, device, world,
                                      judged=prog.pop("grad_full", None))
    _dump(dump, f"fault-{fault}" if fault else "program", seed, prog, ref)
    return {**check.train_numbers(prog, ref), **worst_leaves(cell.config, prog, ref)}


def _dump(dump, what, seed, prog, ref):
    import torch

    if dump is not None:
        torch.save({"prog": prog, "ref": ref}, Path(dump) / f"{what}.{seed}.pt")


def _dump_leaves(dump, cfg):
    import torch

    from port_bench.reference import model as R

    with torch.device("meta"):
        params = sorted((n, p.numel()) for n, p in R.build(cfg, "unet").named_parameters())
    torch.save({"names": [n for n, _ in params], "numel": [k for _, k in params]},
               Path(dump) / "leaves.pt")


def worst_leaves(cfg, prog, ref):
    """The name of the leaf that sets each worst-leaf number."""
    import torch

    from port_bench.reference import model as R

    with torch.device("meta"):
        names = sorted(n for n, _ in R.build(cfg, "unet").named_parameters())
    out = {}
    for key in ("grad", "change"):
        r = ref[key]
        gap = (prog[key] - r).abs() / torch.clamp(r, min=float(r.median()))
        if key == "change":
            gap[ref["grad"] < check.NOUGHT * float(ref["grad"].median())] = 0
        out[f"{key}_worst_leaf"] = names[int(gap.argmax())]
    return out


def control_numbers(cell, seed, device, world=1, chunks=1, dump=None):
    """The float8 reference's numbers against the float32 reference's."""
    from port_bench.harness import sampling, seeded, training
    from port_bench.reference.precision import FP8

    if cell.traffic["kind"] == "sample":
        rows = cell.traffic["rows"]
        n = chunks * rows
        k = min(cell.traffic["check_rows"], n)
        pick = seeded.rng(seed, "sample").choice(n, size=k, replace=False)
        sample = sorted((int(i) // rows, int(i) % rows) for i in pick)
        ref = sampling.reference_images(cell.config, cell.traffic, seed, sample, device)
        low = sampling.reference_images(cell.config, cell.traffic, seed, sample, device,
                                        prec=FP8)
        return {"image": check.image_gap(low, ref)}
    low = training.reference_readings(cell.config, cell.traffic, seed, device, world, prec=FP8,
                                      keep_grad=True)
    ref = training.reference_readings(cell.config, cell.traffic, seed, device, world,
                                      judged=low.pop("grad_full"))
    _dump(dump, "control", seed, low, ref)
    return {**check.train_numbers(low, ref), **worst_leaves(cell.config, low, ref)}


def calibrate(cell, args, rank=0, port=None, device=None):
    import torch
    import torch.distributed as dist

    world = cell.chips
    if device is None:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    host_group = None
    if world > 1:
        from medfusion_tpu_torch.parallel.multihost import initialize_multihost

        initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device.type)
        host_group = dist.new_group(backend="gloo")
    readings = {}
    if args.dump is not None and rank == 0 and cell.traffic["kind"] == "train":
        Path(args.dump).mkdir(parents=True, exist_ok=True)
        _dump_leaves(args.dump, cell.config)
    runs = [("program", s, None) for s in args.seeds]
    runs += [(f"fault:{f}", s, f) for f in args.faults for s in args.control_seeds]
    for what, seed, fault in runs:
        t0 = time.perf_counter()
        nums = program_numbers(cell, seed, device, rank, world, host_group, fault, args.chunks,
                               args.dump)
        if rank == 0:
            readings.setdefault(what, []).append(nums)
            _say(rank, what=what, seed=seed, numbers=nums, seconds=time.perf_counter() - t0)
    if world > 1:
        dist.barrier(group=host_group)
        dist.destroy_process_group()
    if rank != 0:
        return
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, device, world, args.chunks, args.dump)
        readings.setdefault("control", []).append(nums)
        _say(rank, what="control", seed=seed, numbers=nums, seconds=time.perf_counter() - t0)
    summary = {}
    for what, rows in readings.items():
        pick = max if what == "program" else min
        summary[what] = {k: pick(r[k] for r in rows) for k in rows[0]
                         if not isinstance(rows[0][k], str)}
    _say(rank, what="summary", lower=summary.get("program"),
         upper={k: v for k, v in summary.items() if k != "program"})


def _rank_main(workload, args, rank, port):
    os.environ["LOCAL_RANK"] = str(rank)
    calibrate(spec.find_cell(workload), args, rank, port)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--dump", default=None, help="a directory for the training readings")
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    runner.require_cards(cell.chips)
    if cell.chips == 1:
        return calibrate(cell, args)
    port = runner._free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(args.workload, args, r, port))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    try:
        calibrate(cell, args, 0, port)
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.terminate()
                p.join()


if __name__ == "__main__":
    main()
