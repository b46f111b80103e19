"""``correct`` comes out false for the control and for each fault a cell can
have, through the rest of a run (past the harness's look for a card) at a
size the CPU holds. The program runs in float32 here, where it agrees with
the reference to round-off, so the limits of these tests sit between
that round-off and the faults."""

from __future__ import annotations

import torch

from port_bench import calibrate
from port_bench.harness import check
from port_bench.tests import smoke

SAMPLE_LIMITS = {"image": 1e-4}
TRAIN_LIMITS = {"loss": 1e-4, "grad": 1e-3, "change": 1e-2, "ema": 1e-2,
                "grad_diff_median_leaf": 1e-3}


def _sample():
    return smoke.f32(smoke.cell("sample", limits=SAMPLE_LIMITS))


def _train(chips=1):
    return smoke.f32(smoke.cell("train", chips=chips, limits=TRAIN_LIMITS))


def test_clean_runs_are_correct():
    for cell in (_sample(), _train()):
        result = smoke.run(cell)
        assert result["correct"], result["checks"]
        assert result["attempted"] > 0 and result["failed"] == 0
        assert list(result)[-1] == "checks"


def test_an_altered_answer_is_not_correct():
    result = smoke.run(_sample(), faults=["answer"])
    assert not result["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct():
    result = smoke.run(_train(), faults=["unchanged"])
    assert not result["correct"]
    assert result["checks"]["change"]["value"] == 1.0


def test_half_the_batch_left_out_is_not_correct():
    result = smoke.run(_train(), faults=["half"])
    assert not result["correct"]


def test_the_exchange_left_out_is_not_correct():
    torch.set_num_threads(2)
    clean = smoke.run_world(_train(chips=2))
    assert clean["correct"], clean["checks"]
    result = smoke.run_world(_train(chips=2), faults=["exchange"])
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct():
    torch.set_num_threads(2)
    dev = torch.device("cpu")
    for cell in (_sample(), _train()):
        numbers = calibrate.control_numbers(cell, 7, dev)
        assert not check.judge(numbers, cell.limits)["correct"], numbers
