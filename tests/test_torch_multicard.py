"""``multicard_smoke.py``'s rank checks on the CPU: gloo processes at worlds
2 and 4, the smoke preset at tiny widths (the kernels' plain versions), and
one planted fault the checks must flag.

The script starts its ranks itself (``torch.distributed.run``); the four
runs start together once for the file and each test reads its run's output:

* world 2: every rank check and ``cli`` (``cli.sample_dataset`` under
  ``torch.distributed.run`` at two processes against alone);
* world 4: every rank check;
* world 2 with ``--fault skip-sync``: rank 1 takes part in
  ``sync_gradients``' collectives on copies and keeps its own gradients, so
  its data-parallel replicas drift; ``train`` must fail on the replicas.
* world 2 with ``--fault fsdp-scale``: rank 1 leaves its FSDP slices'
  gradients summed, not divided by the world; no replica shows it and
  AdamW nearly cancels the scale, so ``train`` must fail on the FSDP update
  held to the control, not on the bound against one card.

What the checks hold and why is in the script's docstring; the tolerances
are its own: the sampler's images and the CLI's PNGs bit for bit against the
same rows computed in one process at the ranks' batch, the replicas, the
tensor-parallel outputs, the pipelines and the checkpoint bit for bit, the
train steps against a one-process control. Without CUDA the script's
default run (four cards) exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "multicard_smoke.py"
RANK_CHECKS = ("init", "sampler", "train", "checkpoint", "ring", "moe", "pipeline")
RUNS = {"world2": (["--world", "2"], RANK_CHECKS + ("cli",)),
        "world4": (["--world", "4"], RANK_CHECKS),
        "fault": (["--world", "2", "--fault", "skip-sync"], ("train",)),
        "scale": (["--world", "2", "--fault", "fsdp-scale"], ("train",))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the runs at once; {name: (exit code, output)}."""
    tmp = tmp_path_factory.mktemp("multicard")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = {}
    for name, (flags, checks) in RUNS.items():
        log = open(tmp / f"{name}.log", "w+")
        cmd = [sys.executable, str(SCRIPT), "--device", "cpu", *flags, "--out",
               str(tmp / name), "--tmp", str(tmp / f"{name}-tmp"), "--rank-timeout", "150",
               *checks]
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                        stderr=subprocess.STDOUT), log)
    out = {}
    for name, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=200)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        log.seek(0)
        out[name] = (rc, log.read())
        log.close()
    return out


def _report(text, check):
    return [line for line in text.splitlines() if line.startswith(f"[{check}] ")]


@pytest.mark.parametrize("run,check", [(r, c) for r in ("world2", "world4")
                                       for c in RUNS[r][1]])
def test_check_passes(runs, run, check):
    rc, text = runs[run]
    lines = _report(text, check)
    assert lines and not any("FAILED" in line for line in lines), text[-6000:]
    assert any(line.endswith("(cpu)") for line in lines)  # beside the device


@pytest.mark.parametrize("run", ["world2", "world4"])
def test_run_ends_with_the_result_line(runs, run):
    rc, text = runs[run]
    assert rc == 0, text[-6000:]
    last = json.loads(text.strip().splitlines()[-1])
    world = int(RUNS[run][0][1])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": world}}
    kernels = json.loads(text.strip().splitlines()[-3])["kernels"]
    assert [k["name"] for k in kernels][:2] == ["group_norm_silu", "flash_attention"]
    assert all(k["launches_by_rank"] == [0] * world for k in kernels)  # plain versions


def test_exact_checks_are_reported(runs):
    _, text = runs["world4"]
    train = "\n".join(_report(text, "train"))
    assert train.count("replicas bit-equal after each step") == 4
    assert train.count("model ranks bit-equal on the TP output") == 2
    assert "(2, 2)" in train and "(1, 4)" in train and "(4, 1)" in train
    pipe = "\n".join(_report(text, "pipeline"))
    assert pipe.count("bit-equal to the stages in sequence") == 2
    assert "restored pieces" in "\n".join(_report(text, "checkpoint"))
    assert "bit-equal to the control (the same rows" in "\n".join(_report(text, "sampler"))
    _, text2 = runs["world2"]
    assert "PNGs byte-equal to the control" in "\n".join(_report(text2, "cli"))


def test_planted_skip_sync_fails_the_replicas(runs):
    rc, text = runs["fault"]
    assert rc == 1, text[-6000:]
    assert "[train] FAILED" in text and "replicas differ" in text
    assert "replicas differ: ['dp step 1 " in text  # caught at the first step
    assert '"ok": true' not in text


def test_planted_fsdp_scale_fails_the_control_gate(runs):
    rc, text = runs["scale"]
    assert rc == 1, text[-6000:]
    assert "[train] FAILED" in text
    # dp (checked first) passed; fsdp passed its replicas and the bound against
    # one card and fails the gate held to the control
    assert "RuntimeError: train fsdp: " in text
    assert "update departs from the control's by" in text
    assert '"ok": true' not in text


def test_default_run_needs_four_cards(tmp_path):
    """Without CUDA the default run exits non-zero with no result, as it
    does from a directory holding the script alone."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(SCRIPT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "multicard_smoke.py"
    alone.write_text(SCRIPT.read_text())
    res = subprocess.run([sys.executable, str(alone), "--device", "cpu"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_seeded_vae_decodes_to_zero_until_perturbed():
    """Why the sampler checks (and ``chip_smoke.py`` 18b-c) perturb the VAE:
    a preset's seeded VAE has zero-initialised convs, as the reference's,
    and decodes every latent to 0, so images compared on it are vacuous."""
    import torch

    import chip_smoke as cs
    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

    p = PRESETS["smoke"]
    vae = build_pipeline(p, device="cpu", seed=0).latent_embedder
    h, w, c = p.latent_shape
    z = torch.randn((2, c, h, w), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert not vae.decode(z).any()
        cs.perturb_(vae, torch.Generator().manual_seed(18))
        assert vae.decode(z).std() > 0
