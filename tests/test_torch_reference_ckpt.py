"""The reference's Lightning checkpoints (``medfusion_tpu_torch/utils/
torch_compat.py``) on the CPU, against the JAX package's reader.

A Lightning-format ``.ckpt`` (``state_dict`` with the ``noise_estimator.``
and ``latent_embedder.`` prefixes, ``hyper_parameters``,
``pytorch-lightning_version``) is written from perturbed JAX smoke params
through the JAX package's own ``to_torch_state_dict``, so its attention
projections carry the reference's 1x1-conv shapes. The JAX package's
reader (``load_torch_checkpoint`` and ``convert_state_dict``, what its
``cli.sample.load_pipeline`` runs for a ``.ckpt``) and the port's loaders
read it; the UNet forward (rtol 2e-4 / atol 2e-5) and the VAE decode
(1e-4 / 1e-5) agree.
``--vae-ckpt`` takes a reference autoencoder's file in
``cli.train_diffusion``; a file that needs more than tensors and plain
containers to unpickle is refused.
"""

import argparse
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.cli.presets import PRESETS as JAX_PRESETS
from medfusion_tpu.cli.presets import build_unet, build_vae
from medfusion_tpu.utils.torch_compat import (
    convert_state_dict,
    load_torch_checkpoint,
    to_torch_state_dict,
)
from medfusion_tpu_torch.cli import sample as port_sample
from medfusion_tpu_torch.cli import train_diffusion
from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline, load_vae
from medfusion_tpu_torch.utils import torch_compat
from tests.test_torch_models import _randomize, nchw, nhwc

UNET_TOL = dict(rtol=2e-4, atol=2e-5)
AE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _smoke_params(attention):
    """Perturbed JAX smoke params (numpy leaves; read, never written), of
    the modules the JAX ``load_pipeline`` builds."""
    p, key = JAX_PRESETS["smoke"], jax.random.PRNGKey(0)
    unet = build_unet(p, "unet", attention=attention)
    vae = build_vae(p)
    z = jnp.zeros((1, *p.latent_shape))
    t = jnp.zeros((1,), jnp.int32)
    x = jnp.zeros((1, p.image_size, p.image_size, p.in_channels))
    shapes = {"noise_estimator": jax.eval_shape(unet.init, key, z, t, t)["params"],
              "latent_embedder": jax.eval_shape(vae.init, {"params": key, "sample": key},
                                                x)["params"]}
    return {k: _randomize(v, 21 + i) for i, (k, v) in enumerate(sorted(shapes.items()))}


def _lightning(path, state_dict, hyper_parameters=None):
    torch.save({"state_dict": collections.OrderedDict(
                    (k, torch.from_numpy(np.ascontiguousarray(v))) for k, v in state_dict.items()),
                "hyper_parameters": hyper_parameters or {"lr": 1e-4, "use_ema": False},
                "pytorch-lightning_version": "1.9.0", "epoch": 3, "global_step": 1200}, path)
    return path


def _pipeline_ckpt(tmp_path, params):
    sd = {**to_torch_state_dict(params["noise_estimator"], kind="unet",
                                prefix="noise_estimator."),
          **to_torch_state_dict(params["latent_embedder"], kind="vae",
                                prefix="latent_embedder.")}
    sd["noise_scheduler.betas"] = np.linspace(0, 1, 20, dtype=np.float32)
    return _lightning(tmp_path / "pipeline.ckpt", sd)


@pytest.mark.parametrize("attention", ["none", "spatial"])
def test_pipeline_ckpt_matches_jax(tmp_path, attention):
    """``--ckpt x.ckpt``: the estimator and the file's latent embedder."""
    params = _smoke_params(attention)
    path = _pipeline_ckpt(tmp_path, params)
    # what the JAX load_pipeline runs for a .ckpt (cli/sample.py:59-67)
    sd = load_torch_checkpoint(str(path))
    jparams = {"noise_estimator": convert_state_dict(sd, strip_prefix="noise_estimator."),
               "latent_embedder": convert_state_dict(sd, strip_prefix="latent_embedder.")}
    p = JAX_PRESETS["smoke"]
    junet, jvae = build_unet(p, "unet", attention=attention), build_vae(p)
    args = argparse.Namespace(ckpt=str(path), vae_ckpt=None, ema=False)
    unet_state = port_sample.load_unet_state(path, False, {})
    assert port_sample.vae_source(args) == str(path)
    pipe = build_pipeline(PRESETS["smoke"], device="cpu", attention=attention,
                          unet_state=unet_state, vae_ckpt=port_sample.vae_source(args))
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    t, c = np.array([3, 17], np.int32), np.array([0, 1], np.int32)
    want, _ = jax.jit(junet.apply)({"params": jparams["noise_estimator"]}, jnp.asarray(z),
                                   jnp.asarray(t), jnp.asarray(c))
    dec = jax.jit(lambda v, z: jvae.apply(v, z, method=jvae.decode))(
        {"params": jparams["latent_embedder"]}, jnp.asarray(z))
    with torch.no_grad():
        got, _ = pipe.noise_estimator(nchw(z), torch.from_numpy(t).long(),
                                      torch.from_numpy(c).long())
        got_dec = pipe.latent_embedder.decode(nchw(z))
    assert np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **UNET_TOL)
    np.testing.assert_allclose(nhwc(got_dec), np.asarray(dec), **AE_TOL)
    if attention == "spatial":  # the file's 1x1-conv projections, fitted to Linear
        raw = torch_compat.read_state_dict(path)
        key = next(k for k in raw if k.endswith("attention.proj_in.weight"))
        assert raw[key].ndim == 4
    with pytest.raises(SystemExit, match="--ema"):
        port_sample.load_unet_state(path, True, {})


def test_sample_cli_takes_a_reference_ckpt(tmp_path):
    params = _smoke_params("none")
    path = _pipeline_ckpt(tmp_path, params)
    argv = ["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--steps", "2",
            "--n", "1"]
    got = port_sample.main([*argv, "--ckpt", str(path), "--out", str(tmp_path / "a")])
    sd = torch_compat.read_state_dict(path)
    direct = build_pipeline(PRESETS["smoke"], device="cpu",
                            unet_state=torch_compat.strip_prefix(sd, "noise_estimator."),
                            vae_ckpt=str(path))
    gen = torch.Generator().manual_seed(0)
    x_T = torch.randn((1, *PRESETS["smoke"].latent_shape), generator=gen)
    want = direct.denoise(x_T, condition=torch.zeros(1, dtype=torch.long), steps=2,
                          use_ddim=True, eta=1.0, guidance_scale=8.0, generator=gen)
    np.testing.assert_array_equal(got[0], want.numpy())


def test_vae_ckpt_in_train_diffusion(tmp_path):
    """``cli.train_diffusion --vae-ckpt`` with a reference autoencoder's
    ``.ckpt`` (its keys bare), strict, equal to the JAX params."""
    params = _smoke_params("none")["latent_embedder"]
    sd = to_torch_state_dict(params, kind="vae")
    path = _lightning(tmp_path / "vae.ckpt", sd)
    vae = load_vae(PRESETS["smoke"], torch.device("cpu"), 0, str(path))
    for k, v in vae.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    _, losses, pipe = train_diffusion.main(["--preset", "smoke", "--device", "cpu",
                                            "--max-steps", "1", "--vae-ckpt", str(path)])
    assert np.isfinite(losses).all()
    for k, v in pipe.latent_embedder.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(ValueError, match="do not match"):
        load_vae(PRESETS["smoke"], torch.device("cpu"), 0,
                 str(_lightning(tmp_path / "wrong.ckpt", {"inc.x": np.zeros(2, np.float32)})))


class Estimator:  # a class the reference's hyper_parameters would pickle
    pass


def test_unpickling_ckpt_is_refused(tmp_path):
    params = _smoke_params("none")
    sd = to_torch_state_dict(params["noise_estimator"], kind="unet", prefix="noise_estimator.")
    path = _lightning(tmp_path / "classes.ckpt", sd, {"noise_estimator": Estimator})
    with pytest.raises(ValueError, match="arbitrary unpickling"):
        port_sample.load_unet_state(path, False, {})
    with pytest.raises(ValueError, match="arbitrary unpickling"):
        port_sample.main(["--preset", "smoke", "--device", "cpu", "--ckpt", str(path),
                          "--out", str(tmp_path / "s")])
