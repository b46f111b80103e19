"""The port's serving (``medfusion_tpu_torch/demo/serving.py``) on the CPU,
after ``tests/test_serving.py``, and the kernel build's lock.

* ``MicroBatcher``: coalescing into full batches, padding a partial batch
  with its last request, error propagation, concurrent submitters; a row of
  a mixed batch equals the request's solo run within 1e-6.
* ``make_sample_batch_fn`` on the smoke preset against the JAX package's,
  diffusion (DDIM at eta 0) and flow (Heun), 3 steps, guidance 4, with
  JAX's ``fold_in`` draws given to the port through ``init_noise``: the
  decoded images within 2e-4 of their scale
  (``tests/test_torch_pipeline.py``); the port's own draws depend on
  ``(base_seed, seed)`` alone.
* ``ops.build.build_all`` from two threads at once runs one compiler a
  source (a stand-in ``nvcc`` that sleeps), and so does it from two
  processes at once (the ranks of a ``torchrun`` job, through the build
  directory's ``flock``); the launch counters lose no update under threads.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from medfusion_tpu.cli import presets as jax_presets
from medfusion_tpu.cli.presets import PRESETS as JAX_PRESETS
from medfusion_tpu.demo import serving as jax_serving
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxDiffusionPipeline
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlowPipeline
from medfusion_tpu_torch import ops
from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.demo.serving import (
    MicroBatcher,
    make_sample_batch_fn,
    slot_noise,
)
from medfusion_tpu_torch.ops import build
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from tests.test_torch_models import _randomize
from tests.test_torch_pipeline import _assert_close


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _ScaleEstimator(nn.Module):
    """eps = 0.1 x + 0.05 cond: the conds path without a network."""

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))  # the pipeline's device

    def forward(self, x_t, t, condition=None, cond_mask=None, self_cond=None):
        y = 0.1 * x_t
        if condition is not None:
            y = y + 0.05 * condition.to(x_t.dtype)[:, None, None, None]
        return y, []


def _batch_fn():
    sched = GaussianDiffusionSchedule.create(timesteps=20, schedule_strategy="scaled_linear",
                                             beta_start=0.002, beta_end=0.02)
    pipe = DiffusionPipeline(scheduler=sched, noise_estimator=_ScaleEstimator(),
                             latent_embedder=None, clip_x0=False, do_input_centering=False)
    return make_sample_batch_fn(pipe, (4, 4, 1), steps=10, conditional=True)


def test_microbatcher_coalesces_and_matches_solo_runs():
    fn = _batch_fn()
    mb = MicroBatcher(fn, batch_size=4, max_wait_s=0.2)
    try:
        futs = [mb.submit(seed=s, cond=s % 2) for s in range(8)]
        got = [f.result(timeout=60).numpy() for f in futs]
    finally:
        mb.close()
    assert mb.batches_run == 2  # 8 requests -> two full batches
    for s in range(8):  # a request's image does not depend on its batch
        solo = fn(torch.tensor([s] * 4), torch.tensor([s % 2] * 4))[0].numpy()
        np.testing.assert_allclose(got[s], solo, atol=1e-6, rtol=0)
    assert not np.allclose(got[0], got[2])


def test_microbatcher_pads_partial_batches():
    fn = _batch_fn()
    mb = MicroBatcher(fn, batch_size=4, max_wait_s=0.05)
    try:
        out = mb.submit(seed=123, cond=1).result(timeout=60)
    finally:
        mb.close()
    assert tuple(out.shape) == (4, 4, 1) and mb.batches_run == 1


def test_microbatcher_propagates_errors():
    def boom(seeds, conds):
        raise RuntimeError("device on fire")

    mb = MicroBatcher(boom, batch_size=2, max_wait_s=0.01)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            mb.submit(seed=0).result(timeout=10)
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(seed=1)


def test_microbatcher_concurrent_submitters():
    fn = _batch_fn()
    mb = MicroBatcher(fn, batch_size=4, max_wait_s=0.2)
    results = {}

    def client(s):
        results[s] = mb.submit(seed=s, cond=0).result(timeout=60).numpy()

    threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        mb.close()
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 8 and mb.batches_run <= 3
    assert not np.allclose(results[0], results[1])


def test_batch_fn_runs_without_grad_on_its_thread():
    """The worker thread enters inference mode itself: the caller's grad mode
    does not reach another thread."""
    seen = []

    class Spy(_ScaleEstimator):
        def forward(self, x_t, *args, **kwargs):
            seen.append(torch.is_grad_enabled())
            return super().forward(x_t, *args, **kwargs)

    sched = GaussianDiffusionSchedule.create(timesteps=20, schedule_strategy="linear")
    pipe = DiffusionPipeline(scheduler=sched, noise_estimator=Spy(), latent_embedder=None,
                             clip_x0=False, do_input_centering=False)
    mb = MicroBatcher(make_sample_batch_fn(pipe, (4, 4, 1), steps=2), batch_size=2)
    try:
        with torch.enable_grad():
            out = mb.submit(seed=1).result(timeout=60)
    finally:
        mb.close()
    assert seen and not any(seen) and not out.requires_grad


def test_slot_noise_depends_on_base_and_seed_alone():
    a = slot_noise((3, 3, 2), [5, 6, 5], base_seed=0, device="cpu")
    b = slot_noise((3, 3, 2), [5], base_seed=0, device="cpu")
    assert torch.equal(a[0], a[2]) and torch.equal(a[0], b[0])
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], slot_noise((3, 3, 2), [5], base_seed=1, device="cpu")[0])


def _jax_smoke(family):
    """The JAX sampling pipeline of ``cli.sample.load_pipeline`` for the
    smoke preset, with perturbed params of its modules' shapes."""
    p, key = JAX_PRESETS["smoke"], jax.random.PRNGKey(0)
    unet, vae = jax_presets.build_unet(p, "unet"), jax_presets.build_vae(p)
    if family == "flow":
        pipe = JaxFlowPipeline(noise_estimator=unet, latent_embedder=vae,
                               do_input_centering=False, shift=1.0)
    else:
        pipe = JaxDiffusionPipeline(scheduler=jax_presets.build_scheduler(p),
                                    noise_estimator=unet, latent_embedder=vae,
                                    do_input_centering=False, clip_x0=False)
    z, t = jnp.zeros((1, *p.latent_shape)), jnp.zeros((1,), jnp.int32)
    x = jnp.zeros((1, p.image_size, p.image_size, p.in_channels))
    shapes = {"noise_estimator": jax.eval_shape(unet.init, key, z, t, t)["params"],
              "latent_embedder": jax.eval_shape(vae.init, {"params": key, "sample": key},
                                                x)["params"]}
    return pipe, {k: _randomize(v, 11 + i) for i, (k, v) in enumerate(sorted(shapes.items()))}


@pytest.mark.parametrize("family", ["diffusion", "flow"])
def test_sample_batch_fn_matches_jax(family):
    p = JAX_PRESETS["smoke"]
    jpipe, params = _jax_smoke(family)
    base = jax.random.PRNGKey(0)
    jfn = jax_serving.make_sample_batch_fn(jpipe, params, p.latent_shape, steps=3,
                                           guidance_scale=4.0, conditional=True,
                                           base_key=base, family=family)
    seeds, conds = [3, 17, 3, 40], [1, 0, 1, 1]
    want = np.asarray(jfn(jnp.asarray(seeds, jnp.int32), jnp.asarray(conds, jnp.int32)))

    def jax_noise(slots):
        keys = [jax.random.fold_in(base, s) for s in slots]
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, p.latent_shape))
                                          for k in keys]))

    pipe = build_pipeline(PRESETS["smoke"], device="cpu", unet_params=params["noise_estimator"],
                          vae_params=params["latent_embedder"], family=family)
    fn = make_sample_batch_fn(pipe, p.latent_shape, steps=3, guidance_scale=4.0,
                              conditional=True, family=family, init_noise=jax_noise)
    got = fn(torch.tensor(seeds), torch.tensor(conds)).numpy()
    assert got.shape == want.shape == (4, 32, 32, 3) and np.abs(want).max() > 1e-2
    _assert_close(got, want, 2e-4)
    np.testing.assert_array_equal(got[0], got[2])  # one (seed, cond), one image


def _fake_nvcc(tmp_path):
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    script.chmod(0o755)
    return script, log


def test_build_all_from_two_threads_runs_one_compiler_a_source(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    for stem in ("a", "b"):
        (csrc / f"{stem}.cu").write_text(f"// {stem}\n")
    script, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    results, errors = [], []

    def worker():
        try:
            results.append(build.build_all())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 2 and results[0] == results[1]
    assert sorted(log.read_text().split()) == sorted(str(csrc / f"{s}.cu") for s in "ab")
    assert sorted(p.name for p in out.iterdir()) == sorted(v.name for v in results[0].values())


def test_build_all_from_two_processes_runs_one_compiler_a_source(tmp_path):
    """Two processes start ``build_all`` at once on the same build directory:
    one compiles each source, the other loads what it wrote."""
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    for stem in ("a", "b"):
        (csrc / f"{stem}.cu").write_text(f"// {stem}\n")
    script, log = _fake_nvcc(tmp_path)
    code = ("import json, sys\n"
            "from pathlib import Path\n"
            "from medfusion_tpu_torch.ops import build\n"
            "build.CSRC, build.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])\n"
            "build._nvcc = lambda: sys.argv[3]\n"
            "print(json.dumps({k: str(v) for k, v in build.build_all().items()}))\n")
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(csrc), str(out), str(script)],
                              cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    results = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        results.append(json.loads(stdout.splitlines()[-1]))
    assert results[0] == results[1]
    assert sorted(log.read_text().split()) == sorted(str(csrc / f"{s}.cu") for s in "ab")
    assert sorted(p.name for p in out.iterdir()) == sorted(Path(v).name
                                                          for v in results[0].values())


def test_launch_counters_lose_no_update_under_threads(monkeypatch):
    """Eight threads each count 2,000 launches through the wrappers' locked
    increment, with a short switch interval."""
    from medfusion_tpu_torch.ops import group_norm

    def count():
        for _ in range(2000):
            with build.LAUNCH_LOCK:
                group_norm.LAUNCHES += 1

    old = sys.getswitchinterval()
    ops.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ops.launch_counts()["group_norm_silu"] == 16000
    ops.reset_launch_counts()
