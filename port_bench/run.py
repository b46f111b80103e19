"""Run one cell of the benchmark of ``medfusion_tpu_torch`` once, on the
card(s) of this machine, and print its result as one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration (``configs/``), a
traffic mix (``traffic/<name>.json``, whose ``kind`` is 'sample' or
'train') and its limits (``limits/<cell>.json``). With ``--trace 0`` the
line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (``metrics/<name>.py``) read from a profiled stretch. Either way
the run's outputs are held to the plain reference (``reference/``) once
its window has closed, and each number compared is printed beside its
limit, last on stderr and last in the line. A cell of several chips runs
one process a card (this one is rank 0, the others are spawned), NCCL over
a free localhost port. Without CUDA, or with fewer cards than the cell
asks for, the run fails and prints no result."""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import runner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), START)
    if result is None:  # a rank other than 0
        return 0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
