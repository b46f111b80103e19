"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration's file, its traffic mix (``traffic/<name>.json``), its limits
(``limits/<cell>.json``) and the metrics it reports, each read by
``metrics/<name>.py``. Nothing here knows a cell, a configuration or a
metric by name: a cell is added by adding files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    cell that is not there and FileNotFoundError for a missing file."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name=name, chips=int(w["chips"]),
                config=_load_json(root / configs[w["config"]]["file"]),
                traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=_load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {'value', 'unit'}} of each metric whose reader finds something
    to read; a reader that finds nothing returns None and its metric is left
    out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
