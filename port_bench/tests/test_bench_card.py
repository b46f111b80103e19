"""The harness on the card at the smoke sizes: the kernels' routes at tiny
widths through the whole run, past the look for a full-size cell. Skips
without a card; run it on one with
``python -m pytest -p no:cacheprovider port_bench/tests/test_bench_card.py``."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench.harness import runner
from port_bench.tests import smoke

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["sample", "train"])
def test_smoke_cells_run_on_the_card(kind):
    device = _card()
    limits = {"image": 1.0} if kind == "sample" else {"loss": 1.0, "change": 1.0}
    cell = smoke.cell(kind, limits=limits)
    result = runner.run_rank(cell, 9, 0.5, False, time.perf_counter(), device=device)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
