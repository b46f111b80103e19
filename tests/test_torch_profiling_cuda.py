"""The port's spans and ``utils/profiling.py::trace`` on the card.

Every test here needs a CUDA card and skips without one. This file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling_cuda.py

* The spans' clock is the device trace's: a kernel launched inside a span
  starts on the device no earlier than the span opened, and a span closed
  after a ``synchronize`` closes no earlier than the kernel ended.
* ``trace(log_dir)``'s file holds the card's kernels and the spans, the
  kernels of a block that ends without a ``synchronize`` too, and a span
  around them as a ``user_annotation`` whose host interval holds them.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medfusion_tpu_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace has no CPU mode")
    x = torch.randn((2048, 2048), device="cuda")
    (x @ x).sum().item()  # cuBLAS's handle and the first launch, outside what is traced
    return x


def _kernels(events):
    return [e for e in events if e.get("cat") == "kernel"]


@pytest.mark.cuda
def test_spans_share_the_device_traces_clock(cuda):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            with profiling.annotate("clock"):
                for _ in range(4):
                    cuda = cuda @ cuda / 64
                torch.cuda.synchronize()
    (span,) = rec.spans
    kernels = profiling.device_intervals(prof)  # all launched inside the span
    assert len(kernels) >= 8, kernels
    assert all(span.start_ns <= a <= b <= span.end_ns for _, a, b in kernels), (span, kernels)


@pytest.mark.cuda
def test_trace_file_holds_the_kernels_and_the_spans(cuda, tmp_path):
    with profiling.trace(tmp_path / "tr"):
        with profiling.annotate("port.region"):
            for _ in range(3):
                cuda = cuda @ cuda / 64
            torch.cuda.synchronize()
        with profiling.annotate("port.unsynchronised"):
            for _ in range(3):
                cuda = cuda @ cuda / 64
    (path,) = (tmp_path / "tr").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (region,) = [e for e in events if e.get("name") == "port.region"
                 and e.get("cat") == "user_annotation"]
    start, end = region["ts"], region["ts"] + region["dur"]
    kernels = _kernels(events)
    assert len([k for k in kernels if start <= k["ts"] <= end]) >= 3
    assert len(kernels) >= 6, [k["name"] for k in kernels]
    assert [e for e in events if e.get("name") == "port.unsynchronised"]
