"""Checkpoints, resume, restarts and the stages' hand-over, on the CPU.

* ``utils/checkpoint.py``: save and restore bit for bit (model, AdamW
  moments, schedule, EMA, step), ``keep_top_k``, the best pointer and its
  sibling store.
* Both training CLIs (the autoencoder's also with ``--gan`` for the resume) on a small CheXpert_2 tree (PNG files, weighted
  sampling, flips): 4 steps straight equal 2 steps and a ``--resume`` to 4,
  bit for bit, with the resume inside an epoch and the run crossing into
  the next; the same after a crash injected at step 3 under
  ``--auto-restart``. ``--resume`` refuses another ``--use-ema``.
* ``--vae-ckpt`` from a port autoencoder run, plain or adversarial (its
  generator), and from an ``.npz`` of the JAX VAE's params (bare, under
  ``latent_embedder/`` or under a GAN state's ``gen/params/``), refused on
  a shape mismatch; ``cli.train_diffusion --vae-ckpt`` from a GAN run; ``cli.sample --ckpt --ema`` equal to a direct call with the
  restored EMA estimator and VAE; a label outside the preset's classes
  (CheXpert_2's 2) refused on the host.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.cli.presets import PRESETS as JAX_PRESETS
from medfusion_tpu.cli.presets import build_vae as jax_build_vae
from medfusion_tpu_torch.cli import presets, sample, train_autoencoder, train_diffusion
from medfusion_tpu_torch.train import TrainState, make_lr_schedule
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.resilience import run_with_auto_restore
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict
from tests.test_torch_data import write_chexpert_2
from tests.test_torch_models import _randomize


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE = presets.PRESETS["smoke"]


@pytest.fixture
def image_preset(monkeypatch):
    """The smoke networks on a CheXpert_2 tree (12 grey 40x36 PNGs)."""
    monkeypatch.setitem(presets.PRESETS, "smoke_chexpert",
                        dataclasses.replace(SMOKE, name="smoke_chexpert", dataset="chexpert_2"))
    return "smoke_chexpert"


def _equal_trees(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _state(seed, use_ema=True):
    torch.manual_seed(seed)
    model = presets.build_vae(SMOKE)
    return TrainState(model, lr=1e-3, use_ema=use_ema,
                      lr_schedule=make_lr_schedule("cosine", 2, 10))


def _step(state, seed):
    state.optimizer.zero_grad()
    x = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (2, 3, 32, 32))
                         .astype(np.float32))
    pred, _, kl = state.model(x, torch.zeros(2, 2, 8, 8))
    ((pred - x) ** 2).mean().add(kl).backward()
    state.apply_gradients()


def test_save_restore_is_bit_equal(tmp_path):
    state = _state(0)
    for i in range(3):
        _step(state, i)
    C.save_checkpoint(tmp_path, state, state.step, config={"a": 1}, extra={"k": "v"})
    other = _state(1)
    assert C.restore_checkpoint(tmp_path, other) == {"k": "v"}
    _equal_trees(other.state_dict(), state.state_dict())
    _step(state, 7)
    _step(other, 7)  # the optimizer, schedule and EMA continue alike
    _equal_trees(other.state_dict(), state.state_dict())
    assert json.loads((tmp_path / C.CONFIG_FILE).read_text()) == {"a": 1}
    payload = torch.load(C.step_file(tmp_path, 3), weights_only=True)
    assert payload["step"] == 3 and sorted(p.name for p in tmp_path.iterdir()) == [
        "config.json", "step_3.pt"]
    with pytest.raises(ValueError, match="EMA"):
        C.restore_checkpoint(tmp_path, _state(2, use_ema=False))
    with pytest.raises(FileNotFoundError):
        C.restore_checkpoint(tmp_path / "none", other)


def test_keep_top_k_and_the_best_pointer(tmp_path):
    ckpt = tmp_path / "checkpoints"
    state = _state(0)
    snapshots = {}
    for step, metric in zip(range(1, 6), (0.5, 0.2, 0.3, 0.4, 0.25)):
        _step(state, step)
        C.save_checkpoint(ckpt, state, step, keep_top_k=2)
        moved = C.save_best_checkpoint(ckpt, step, metric, state=state)
        assert moved == (step in (1, 2))
        snapshots[step] = copy.deepcopy(state.state_dict())  # not views of the live state
    assert C.latest_step(ckpt) == 5
    assert sorted(p.name for p in ckpt.iterdir()) == [C.BEST_FILE, "step_4.pt", "step_5.pt"]
    assert json.loads((ckpt / C.BEST_FILE).read_text())["step"] == 2
    best = _state(3)
    C.load_best_checkpoint(ckpt, best)  # step 2, from the sibling store
    _equal_trees(best.state_dict(), snapshots[2])
    assert [p.name for p in (tmp_path / "checkpoints_best").iterdir()] == ["step_2.pt"]
    assert not C.save_best_checkpoint(ckpt, 6, 0.9, minimize=True)
    assert C.save_best_checkpoint(tmp_path / "max", 1, 0.9, minimize=False)
    assert not C.save_best_checkpoint(tmp_path / "max", 2, 0.8, minimize=False)


CLIS = {
    "autoencoder": (train_autoencoder, "make_autoencoder_train_step", []),
    "diffusion": (train_diffusion, "make_diffusion_train_step", ["--use-ema"]),
    # the adversarial terms on from the second batch (optimizer steps 2 and
    # 3), so both players have trained before the resume at batch 2
    "vaegan": (train_autoencoder, "make_adversarial_train_step",
               ["--gan", "--start-gan-step", "1"]),
}


def _run(cli, preset, root, out, steps, *extra):
    module, _, flags = CLIS[cli]
    return module.main(["--preset", preset, "--device", "cpu", "--data-root", str(root),
                        "--out", str(out), "--max-steps", str(steps), "--ckpt-every", "2",
                        "--sample-every", "2", *flags, *extra])


def _final(out, step=4):
    return C.load_payload(out / "checkpoints", step)


@pytest.mark.parametrize("cli", CLIS)
def test_resume_equals_an_uninterrupted_run(tmp_path, image_preset, cli):
    root = write_chexpert_2(tmp_path / "data")
    straight = _run(cli, image_preset, root, tmp_path / "a", 4)[1]
    first = _run(cli, image_preset, root, tmp_path / "b", 2)[1]
    rest = _run(cli, image_preset, root, tmp_path / "b", 4, "--resume")[1]
    assert first + rest == straight
    _equal_trees(_final(tmp_path / "b"), _final(tmp_path / "a"))
    rows = [json.loads(r) for r in (tmp_path / "a" / "logs" / "metrics.jsonl").open()]
    assert rows[0]["step"] == 1 and "train/loss" in rows[0]
    assert (tmp_path / "a" / "images" / "sample_4.png").read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("cli", ["autoencoder", "diffusion"])
def test_no_donate_is_accepted_and_changes_nothing(tmp_path, image_preset, cli):
    """The JAX CLIs' --no-donate (a debug aid there) runs, and one step with
    it equals one without it: the port donates no buffers."""
    root = write_chexpert_2(tmp_path / "data")
    _run(cli, image_preset, root, tmp_path / "a", 1)
    _run(cli, image_preset, root, tmp_path / "b", 1, "--no-donate")
    _equal_trees(_final(tmp_path / "b", 1), _final(tmp_path / "a", 1))


@pytest.mark.parametrize("cli", ["autoencoder", "diffusion"])
def test_auto_restart_recovers_from_a_crash_at_step_3(tmp_path, image_preset, cli,
                                                      monkeypatch, capsys):
    root = write_chexpert_2(tmp_path / "data")
    _run(cli, image_preset, root, tmp_path / "a", 4)
    module, maker, _ = CLIS[cli]
    real = getattr(module, maker)
    crashes = []

    def crashing_maker(*args, **kwargs):
        step_fn = real(*args, **kwargs)

        def step(state, *a):
            if state.step == 2 and not crashes:
                crashes.append(state.step)
                raise RuntimeError("injected fault")
            return step_fn(state, *a)

        return step

    monkeypatch.setattr(module, maker, crashing_maker)
    _run(cli, image_preset, root, tmp_path / "b", 4, "--auto-restart", "1")
    assert crashes == [2] and "[auto-restart 1/1] RuntimeError: injected fault" in (
        capsys.readouterr().out)
    _equal_trees(_final(tmp_path / "b"), _final(tmp_path / "a"))


def test_auto_restore_reraises_sticky_cuda_errors_and_spent_budgets():
    calls = []

    def attempt(resume):
        calls.append(resume)
        raise RuntimeError("CUDA error: device-side assert triggered")

    with pytest.raises(RuntimeError, match="device-side assert"):
        run_with_auto_restore(attempt, max_restarts=3)
    assert calls == [False]

    def flaky(resume):
        calls.append(resume)
        raise OSError("disk")

    calls.clear()
    with pytest.raises(OSError):
        run_with_auto_restore(flaky, max_restarts=2)
    assert calls == [False, True, True]


def test_resume_refuses_a_config_mismatch(tmp_path):
    out = tmp_path / "d"
    train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--out", str(out),
                          "--max-steps", "1", "--use-ema"])
    with pytest.raises(SystemExit, match="use_ema=True"):
        train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--out", str(out),
                              "--max-steps", "2", "--resume"])
    with pytest.raises(SystemExit):  # --resume needs --out
        train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--resume"])


def _jax_vae_params(preset, seed=4):
    p = JAX_PRESETS[preset]
    x = jnp.zeros((1, p.image_size, p.image_size, p.in_channels))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jax_build_vae(p).init, {"params": key, "sample": key}, x)
    return _randomize(shapes["params"], seed)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(_flat(v, path + "/") if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def test_vae_ckpt_from_a_port_run_or_an_npz(tmp_path):
    ae = tmp_path / "ae"
    train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--out", str(ae),
                            "--max-steps", "2"])
    saved = C.load_payload(ae / "checkpoints")["state"]["model"]
    for path in (ae, ae / "checkpoints"):
        pipe = presets.build_train_pipeline(SMOKE, device="cpu", vae_ckpt=path)
        _equal_trees(pipe.latent_embedder.state_dict(), saved)

    params = _jax_vae_params("smoke")
    want = jax_params_to_state_dict(params, kind="vae")
    for prefix in ("", "latent_embedder/", "gen/params/"):
        npz = tmp_path / f"vae{len(prefix)}.npz"
        np.savez(npz, **_flat(params, prefix))
        pipe = presets.build_train_pipeline(SMOKE, device="cpu", vae_ckpt=npz)
        _equal_trees(pipe.latent_embedder.state_dict(), want)

    wide = dataclasses.replace(SMOKE, vae_hid_chs=(8, 16, 64))
    torch.manual_seed(0)
    C.save_checkpoint(tmp_path / "wide", TrainState(presets.build_vae(wide)), 1)
    with pytest.raises(ValueError, match="do not match the model"):
        presets.build_train_pipeline(SMOKE, device="cpu", vae_ckpt=tmp_path / "wide")
    flat = _flat(params)
    flat.pop(next(iter(flat)))
    np.savez(tmp_path / "short.npz", **flat)
    with pytest.raises(ValueError, match="missing"):
        presets.build_train_pipeline(SMOKE, device="cpu", vae_ckpt=tmp_path / "short.npz")
    with pytest.raises(FileNotFoundError):
        presets.build_train_pipeline(SMOKE, device="cpu", vae_ckpt=tmp_path / "none")


def test_vae_ckpt_from_a_gan_run(tmp_path):
    """The diffusion stage takes a VAEGAN run's generator, through
    ``build_train_pipeline`` and through ``cli.train_diffusion --vae-ckpt``."""
    ae = tmp_path / "vaegan"
    state, _ = train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--out",
                                       str(ae), "--max-steps", "1", "--gan",
                                       "--start-gan-step", "-1"])
    saved = C.load_payload(ae / "checkpoints")["state"]
    assert set(saved) == {"step", "gen", "disc"} and saved["step"] == 2
    _equal_trees(saved["gen"]["model"], state.gen.model.state_dict())
    pipe = presets.build_train_pipeline(SMOKE, device="cpu", vae_ckpt=ae)
    _equal_trees(pipe.latent_embedder.state_dict(), saved["gen"]["model"])
    _, losses, pipe = train_diffusion.main(["--preset", "smoke", "--device", "cpu",
                                            "--max-steps", "1", "--vae-ckpt", str(ae)])
    assert np.isfinite(losses).all()
    _equal_trees(pipe.latent_embedder.state_dict(), saved["gen"]["model"])
    with pytest.raises(ValueError, match="two-player"):  # a GAN resume of a plain run
        plain = tmp_path / "plain"
        train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--out", str(plain),
                                "--max-steps", "1"])
        C.restore_checkpoint(plain / "checkpoints", state)
    with pytest.raises(SystemExit, match="gan=False"):
        train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--out", str(plain),
                                "--max-steps", "2", "--gan", "--resume"])


def test_sample_cli_from_checkpoints_equals_a_direct_call(tmp_path):
    ae, d, out = tmp_path / "ae", tmp_path / "d", tmp_path / "s"
    train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--out", str(ae),
                            "--max-steps", "1"])
    state, _, _ = train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--out",
                                        str(d), "--max-steps", "3", "--use-ema",
                                        "--vae-ckpt", str(ae)])
    argv = ["--preset", "smoke", "--device", "cpu", "--steps", "3", "--n", "2",
            "--dtype", "f32", "--ckpt", str(d), "--vae-ckpt", str(ae)]
    got = sample.main([*argv, "--ema", "--out", str(out)])
    ema = C.load_payload(d / "checkpoints")["state"]["ema"]
    _equal_trees(ema, state.ema.state_dict())
    pipe = presets.build_pipeline(SMOKE, device="cpu", unet_state=ema, vae_ckpt=ae)
    for cond in (0, 1, None):
        c = None if cond is None else torch.full((2,), cond, dtype=torch.long)
        want = pipe.sample(2, SMOKE.latent_shape, condition=c,
                           generator=torch.Generator().manual_seed(0), steps=3,
                           guidance_scale=1.0 if cond is None else 8.0, eta=1.0)
        np.testing.assert_array_equal(got[cond], want.numpy())
    live = sample.main([*argv, "--out", str(tmp_path / "live")])
    assert not np.array_equal(live[0], got[0])  # the EMA is not the live model
    with pytest.raises(SystemExit, match="attention"):
        sample.main([*argv, "--attention", "spatial", "--out", str(out)])
    train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--out", str(tmp_path / "n"),
                          "--max-steps", "1"])
    with pytest.raises(SystemExit, match="use-ema"):
        sample.main([*argv[:-4], "--ckpt", str(tmp_path / "n"), "--ema", "--out", str(out)])


def test_a_label_outside_the_classes_is_refused_on_the_host(tmp_path, image_preset):
    root = write_chexpert_2(tmp_path / "data", labels=[0, 1, -1, "nan"] * 3)
    with pytest.raises(ValueError, match=r"batch labels \[2\] are outside \[0, 2\)"):
        train_diffusion.main(["--preset", image_preset, "--device", "cpu", "--data-root",
                              str(root), "--max-steps", "3"])
