"""The harness's contract on the CPU: it finds each cell's files by name,
fails without a card and without the program, and loads no JAX."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import guard, spec

ROOT = spec.ROOT


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("sample", "train")
        assert cell.limits, w["name"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.find_cell("no.such.cell")


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    from port_bench.harness.runner import Reading

    run = Reading(kind="sample", chips=1, setup_s=12.5, window_s=10.0, units=320)
    got = spec.read_metrics(_bench()["end_to_end"], run)
    assert got == {"sample_images_per_s": {"value": 32.0, "unit": "images/s"},
                   "setup_s": {"value": 12.5, "unit": "s"}}
    assert spec.read_metrics(_bench()["per_layer"], run) == {}


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["medfusion_tpu_torch", "medfusion_tpu_torch.ops",
                            "jaxtyping", "flaxen", "torch"]) == []
    assert guard.forbidden(["jax.numpy", "jaxlib", "flax.linen", "medfusion_tpu.ops",
                            "medfusion_tpu"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                                   "medfusion_tpu", "medfusion_tpu.ops"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench.harness import runner, sampling, training, guard\n"
            "from port_bench.count import work\n"
            "import port_bench.calibrate\n"
            "from medfusion_tpu_torch.cli import presets\n"
            "from medfusion_tpu_torch.train import make_diffusion_train_step\n"
            "from medfusion_tpu_torch.parallel import make_sharded_sampler, shard_params\n"
            "print(guard.forbidden(list(sys.modules)))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "chest.sample.b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench.tests import smoke\n"
            "print(smoke.run(smoke.cell('sample')))\n" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "medfusion_tpu_torch" in out.stderr
    assert "correct" not in out.stdout
