"""The port's DDIM sampler (``denoise``) against the JAX package's on small
models with the same weights, in float32 on the CPU.

eta = 0 runs from the same x_T; eta = 1 replays the JAX noise: the JAX loop
draws ``keys = split(rng, n)``, then ``k_anc, k_ddim = split(keys[i])`` and
``normal(k, x.shape)`` for each, and the port takes those draws as its
``noise`` tensor [n, 2, *x.shape].

Tolerance: 1e-4 on the latent and 2e-4 on the decoded image, relative to
the array's largest magnitude (atol = tol * max(1, max|ref|), rtol = tol).
The UNet matches to ~1e-6 per call; ten steps compound that. The random UNet
is no denoiser, so its unclipped x_0 estimates are scaled by
sqrt(1/abar_t) (about 110 at t = 999) and the latents reach magnitudes of a
few hundred; an element that lands near zero then carries the error of the
whole array's scale, which an element-wise rtol alone would not admit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.latent_embedders import VAE as JaxVAE
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.models.latent_embedders import VAE
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.utils.weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEY = jax.random.PRNGKey(0)
LATENT = (2, 8, 8, 2)
STEPS = 10
UNET_KW = dict(in_ch=2, out_ch=2, hid_chs=(8, 16, 32), kernel_sizes=(3, 3, 3),
               strides=(1, 2, 2), time_emb_dim=32, cond_emb_num_classes=2,
               norm_name=("GROUP", {"num_groups": 4, "affine": True}),
               deep_supervision=0, use_attention="none")
VAE_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(4, 8, 16),
              kernel_sizes=(3, 3, 3), strides=(1, 2, 2), deep_supervision=0,
              norm_name=("GROUP", {"num_groups": 2, "affine": True}))
SCHED_KW = dict(timesteps=1000, schedule_strategy="scaled_linear",
                beta_start=0.002, beta_end=0.02)


def _randomize(shapes, seed):
    """N(0, s^2) leaves: s = 0.2 for vectors, min(0.2, fan_in^-1/2) for kernels."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)

    def draw(shape):
        std = 0.2 if len(shape) < 2 else min(0.2, float(np.prod(shape[:-1])) ** -0.5)
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_unflatten(treedef, [draw(l.shape) for l in leaves])


_PIPELINES = {}


def build_pipelines(estimate_variance=False):
    """(JAX pipeline, its params, port pipeline) on the same weights."""
    if estimate_variance in _PIPELINES:
        return _PIPELINES[estimate_variance]
    unet_kw = dict(UNET_KW, estimate_variance=estimate_variance)
    jax_unet, jax_vae = JaxUNet(**unet_kw), JaxVAE(**VAE_KW)
    z0 = jnp.zeros((1,) + LATENT[1:], jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = {
        "noise_estimator": _randomize(
            jax.eval_shape(jax_unet.init, KEY, z0, t0, t0)["params"], 11),
        "latent_embedder": _randomize(jax.eval_shape(
            jax_vae.init, {"params": KEY, "sample": KEY}, x0)["params"], 12),
    }
    jax_pipe = JaxPipeline(scheduler=JaxSchedule.create(**SCHED_KW),
                           noise_estimator=jax_unet, latent_embedder=jax_vae,
                           clip_x0=False, estimate_variance=estimate_variance)
    unet, vae = UNet(**unet_kw), VAE(**VAE_KW)
    load_jax_params(unet, params["noise_estimator"], kind="unet")
    load_jax_params(vae, params["latent_embedder"], kind="vae")
    pipe = DiffusionPipeline(scheduler=GaussianDiffusionSchedule.create(**SCHED_KW),
                             noise_estimator=unet.eval(), latent_embedder=vae.eval(),
                             clip_x0=False, estimate_variance=estimate_variance)
    _PIPELINES[estimate_variance] = jax_pipe, params, pipe
    return _PIPELINES[estimate_variance]


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


def _assert_close(actual, desired, tol):
    scale = max(1.0, float(np.abs(desired).max()))
    np.testing.assert_allclose(actual, desired, atol=tol * scale, rtol=tol)


def _jax_noise(rng, n, shape):
    """The draws the JAX loop makes, as [n, 2, *shape]."""
    out = []
    for key in jax.random.split(rng, n):
        k_anc, k_ddim = jax.random.split(key)
        out.append([np.asarray(jax.random.normal(k, shape)) for k in (k_anc, k_ddim)])
    return np.asarray(out, np.float32)


# name -> (pipeline settings, denoise arguments); every case runs STEPS steps
CASES = {
    # (a) eta 0 from the same x_T, no guidance
    "eta0": ({}, dict(eta=0.0)),
    # (b) eta 1 with the JAX noise replayed, batched CFG
    "eta1-cfg": ({}, dict(guidance_scale=3.0)),
    "trailing-start_idx-v": (dict(estimator_objective="v"),
                             dict(timestep_spacing="trailing", start_idx=3)),
    "trailing-eta0-cfg-rescale-x0-clip": (
        dict(estimator_objective="x_0", clip_x0=True),
        dict(eta=0.0, guidance_scale=3.0, timestep_spacing="trailing",
             guidance_rescale=0.7)),
    "ancestral-cfg-learned_variance": (
        dict(estimate_variance=True),
        dict(use_ddim=False, guidance_scale=3.0, guidance_rescale=0.7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_denoise_matches_jax(case):
    settings, args = CASES[case]
    settings = dict(settings)
    jax_pipe, params, pipe = build_pipelines(settings.pop("estimate_variance", False))
    jax_pipe = dataclasses.replace(jax_pipe, **settings)
    pipe = dataclasses.replace(pipe, **settings)
    kw = dict(dict(steps=STEPS, eta=1.0, guidance_scale=1.0), **args)
    x_T = np.random.default_rng(7).standard_normal(LATENT).astype(np.float32)
    cond = np.asarray([0, 1], np.int32)
    rng = jax.random.PRNGKey(5)
    ref = jax_pipe.denoise(params, jnp.asarray(x_T), rng, condition=jnp.asarray(cond),
                           decode=False, **kw)
    ref_img = jax_pipe.decode_latent(params, ref)
    if kw["eta"] == 0.0 and kw.get("use_ddim", True):
        # no noise reaches the result: the port draws its own
        noise = dict(generator=torch.Generator().manual_seed(0))
    else:
        noise = dict(noise=torch.from_numpy(_jax_noise(rng, STEPS, LATENT)))
    out = pipe.denoise(torch.from_numpy(x_T), condition=torch.from_numpy(cond).long(),
                       decode=False, **kw, **noise)
    assert np.abs(np.asarray(ref)).max() > 1e-2
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)
    img = pipe.decode_latent(out.movedim(-1, 1)).movedim(1, -1)
    assert img.shape == (2, 32, 32, 3)
    _assert_close(img.detach().numpy(), np.asarray(ref_img), 2e-4)


def test_encode_latent_matches_jax_moments(pipelines):
    """The reparameterised encode with injected noise, and the latent
    standardisation, against the JAX VAE's (mean, logvar)."""
    jax_pipe, params, pipe = pipelines
    vae = jax_pipe.latent_embedder
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    moments = np.asarray(vae.apply({"params": params["latent_embedder"]},
                                   jnp.asarray(x), False, method=vae._moments))
    mean, logvar = np.split(moments, 2, axis=-1)
    noise = np.random.default_rng(9).standard_normal(mean.shape).astype(np.float32)
    scale, shift = 0.5, 0.1
    ref = (mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * noise - shift) * scale
    pipe = dataclasses.replace(pipe, latent_scale=scale, latent_shift=shift)
    with torch.no_grad():
        z = pipe.encode_latent(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
                               torch.from_numpy(np.moveaxis(noise, -1, 1).copy()))
    np.testing.assert_allclose(np.moveaxis(z.numpy(), 1, -1), ref, atol=1e-5, rtol=1e-4)


def test_sample_returns_channels_last_images(pipelines):
    _, _, pipe = pipelines
    imgs = pipe.sample(2, LATENT[1:], condition=torch.tensor([0, 1]),
                       generator=torch.Generator().manual_seed(1), steps=3,
                       guidance_scale=2.0)
    assert imgs.shape == (2, 32, 32, 3) and torch.isfinite(imgs).all()


def test_unported_options_raise(pipelines, capsys, tmp_path):
    """The other estimator families, once refused naming ROADMAP, sample
    (the OpenAI UNet here); consistency sampling is refused with what the
    JAX CLI refuses with it (a classifier, the flow family); a noise tensor
    of the wrong layout is refused."""
    from medfusion_tpu_torch.cli import sample

    _, _, pipe = pipelines
    out = sample.main(["--preset", "smoke", "--device", "cpu", "--estimator", "openai",
                       "--dtype", "f32", "--steps", "2", "--n", "2", "--out",
                       str(tmp_path / "s")])
    assert all(np.isfinite(v).all() for v in out.values())
    for flags, why in ((["--sampler", "consistency", "--family", "flow"], "own ODE sampler"),
                       (["--sampler", "consistency", "--classifier-ckpt", "runs/classifier"],
                        "consistency sampling")):
        with pytest.raises(SystemExit):
            sample.main(["--preset", "smoke", "--device", "cpu", *flags])
        assert why in capsys.readouterr().err
    x = torch.zeros(LATENT)
    with pytest.raises(ValueError, match="noise must have shape"):
        pipe.denoise(x, steps=2, noise=torch.zeros(3, 2, *LATENT))
