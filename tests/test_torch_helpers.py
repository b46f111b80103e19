"""The port's ``cli.helpers`` on the CPU.

* ``latent-stats``' numbers against the JAX package's on injected draws:
  the smoke VAE on perturbed JAX params, the JAX encoder's draw fixed to
  the port's; the latents at the VAE's rtol 1e-4 / atol 1e-5, their mean,
  std and the suggested shift and scale at 1e-5; the CLI prints them as the
  JAX CLI does and writes both images.
* ``slerp`` against the JAX CLI's ``_batched_slerp`` at 1e-6.
* Every subcommand runs at the smoke preset on the CPU and writes its
  files; ``extract-vae`` gives a checkpoint that ``--vae-ckpt`` loads, equal
  to the adversarial run's generator, at its step.
* The refusals: ``--family flow``, an ``--estimator`` other than ``unet``,
  the kernel switches, and ``export-gif`` without PIL.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu.cli import presets as jax_presets
from medfusion_tpu.cli.helpers import _batched_slerp
from medfusion_tpu_torch.cli import helpers, presets, train_autoencoder
from medfusion_tpu_torch.data.png import read_png
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc

KEY = jax.random.PRNGKey(0)
SMOKE = presets.PRESETS["smoke"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_latent_stats_match_jax(monkeypatch):
    p = jax_presets.PRESETS["smoke"]
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    noise = np.random.default_rng(2).standard_normal((3, *p.latent_shape)).astype(np.float32)

    def diagonal_gaussian(h, key, sample=True):
        mean, logvar = jnp.split(h, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise), 0.0

    monkeypatch.setattr(jax_le, "diagonal_gaussian", diagonal_gaussian)
    jvae = jax_presets.build_vae(p)
    params = _randomize(jax.eval_shape(jvae.init, {"params": KEY, "sample": KEY},
                                       jnp.zeros((1, 32, 32, 3)))["params"], 6)
    # medfusion_tpu/cli/helpers.py::latent_stats
    z = jvae.apply({"params": params}, jnp.asarray(x), method=jvae.encode,
                   rngs={"sample": KEY})
    dec = jvae.apply({"params": params}, z, method=jvae.decode)
    vae = presets.build_vae(SMOKE)
    load_jax_params(vae, params, kind="vae")
    got_z, got_dec = helpers.latent_roundtrip(vae.eval(), nchw(x), nchw(noise))
    np.testing.assert_allclose(nhwc(got_z), np.asarray(z), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(got_dec), np.asarray(dec), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(helpers.latent_suggestion(got_z),
                               [float(z.mean()), float(z.std())], rtol=1e-5, atol=1e-6)


def test_latent_stats_cli(tmp_path, capsys):
    out = tmp_path / "stats"
    result = helpers.main(["latent-stats", "--device", "cpu", "--n", "3", "--out", str(out)])
    printed = capsys.readouterr().out
    assert (f"--latent-shift {result['latent_shift']:.4f} "
            f"--latent-scale {result['latent_scale']:.4f}") in printed
    assert f"mean {result['mean']:.4f}, std {result['std']:.4f}" in printed
    # the same numbers from the same draw
    vae = presets.load_vae(SMOKE, torch.device("cpu"), seed=0)
    ds = presets.build_dataset(SMOKE, None, n_synthetic=3, seed=0)
    x = nchw(np.stack([ds[i]["source"] for i in range(3)]))
    noise = torch.randn((3, SMOKE.emb_channels, *SMOKE.latent_shape[:2]),
                        generator=torch.Generator().manual_seed(0))
    z, _ = helpers.latent_roundtrip(vae, x, noise)
    assert helpers.latent_suggestion(z) == (result["mean"], result["std"])
    assert result["latent_scale"] == 1.0 / result["std"]
    hist = read_png(out / "latent_hist.png")
    assert hist.ndim == 3 and hist.shape[2] == 1 and (hist < 128).any()
    assert read_png(out / "roundtrip.png").shape[2] == 3


def test_slerp_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((1, 4, 4, 2)).astype(np.float32) for _ in range(2))
    lams = np.linspace(0, 1, 5, dtype=np.float32).reshape(-1, 1, 1, 1)
    for z2 in (b, a * 2):  # apart, and parallel (lerp)
        want = np.asarray(_batched_slerp(jnp.asarray(a), jnp.asarray(z2), jnp.asarray(lams)))
        got = helpers.slerp(torch.from_numpy(a), torch.from_numpy(z2), torch.from_numpy(lams))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


RUNS = {
    "export-images": ([], ["random_images.png"]),
    "export-gif": (["--steps", "3"], []),
    "interpolate": (["--steps", "4", "--n", "3"], ["interpolation.png"]),
    "interpolate-ddim-invert": (["--steps", "4", "--n", "3", "--ddim-invert"],
                                ["interpolation.png"]),
    "inpaint": (["--steps", "4"], ["inpaint.png"]),
    "inpaint-repaint": (["--steps", "6", "--resample-steps", "2", "--jump-length", "2"],
                        ["inpaint.png"]),
    "img2img": (["--steps", "5", "--label", "1", "--guidance-scale", "2"], ["img2img.png"]),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_helper_runs_on_cpu(tmp_path, capsys, run):
    flags, files = RUNS[run]
    cmd = run.split("-ddim")[0].split("-repaint")[0]
    out = tmp_path / ("trajectory.gif" if cmd == "export-gif" else "out")
    helpers.main([cmd, "--device", "cpu", "--out", str(out), *flags])
    if cmd == "export-gif":
        from PIL import Image

        # the seeded UNet's zero-init out head predicts eps = 0, so the
        # frames may coincide and the GIF writer merge them
        assert "(3 frames)" in capsys.readouterr().out
        with Image.open(out) as gif:
            assert gif.format == "GIF" and gif.size == (32, 32)
    for name in files:
        img = read_png(out / name)
        assert img.dtype == np.uint8 and img.shape[2] == 3


def test_extract_vae(tmp_path):
    state, _ = train_autoencoder.main(["--preset", "smoke", "--device", "cpu",
                                       "--max-steps", "1", "--gan", "--start-gan-step", "-1",
                                       "--out", str(tmp_path / "gan")])
    out = helpers.main(["extract-vae", "--device", "cpu", "--ckpt", str(tmp_path / "gan"),
                        "--out", str(tmp_path / "vae")])
    assert out.step == state.step == 2 and C.latest_step(tmp_path / "vae") == 2
    vae = presets.build_vae(SMOKE)
    C.restore_ae_params(tmp_path / "vae", vae)  # what --vae-ckpt does
    for k, v in state.gen.model.state_dict().items():
        assert torch.equal(vae.state_dict()[k], v), k
    with pytest.raises(SystemExit, match="not an adversarial"):
        helpers.main(["extract-vae", "--device", "cpu", "--ckpt", str(tmp_path / "vae"),
                      "--out", str(tmp_path / "again")])


@pytest.mark.parametrize("flags,why", [
    (["interpolate", "--family", "flow"], "item 3"),
    (["img2img", "--estimator", "dit"], "item 7"),
    (["inpaint", "--flash"], "item 10"),
    (["interpolate", "--no-fused-geglu"], "item 10"),
    (["export-gif", "--fused-up"], "item 10"),
], ids=["flow", "estimator", "flash", "no-fused-geglu", "fused-up"])
def test_helper_refusals(capsys, flags, why):
    with pytest.raises(SystemExit):
        helpers.main([*flags, "--device", "cpu"])
    assert why in capsys.readouterr().err


def test_export_gif_needs_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="PIL"):
        helpers.main(["export-gif", "--device", "cpu", "--out", str(tmp_path / "t.gif")])


def test_helpers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        helpers.main(["latent-stats"])
