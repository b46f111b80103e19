"""The port's samplers against the JAX package's, on tiny UNets in float32
on the CPU: DDIM with self-conditioning, ``un_cond``, cold diffusion,
inpainting and RePaint; DPM-Solver++(2M), also on a zero-terminal-SNR
schedule; EDM with churn off and on; the encoder-propagation sampler; and
``img2img``, ``interpolate``, ``sample_inpaint`` and ``invert``.

The weights are the JAX params (perturbed normals) loaded into the port.
The JAX draws are rebuilt from its keys as each sampler splits them and
injected into the port (the layouts in ``pipelines/diffusion/ddim.py``,
``edm.py``, ``fast.py`` and ``editing.py``). The pipelines have no latent
embedder, so the samplers run on the latent directly.

The port runs on one CPU thread here (``one_thread``): the tiny
convolutions take milliseconds each on many threads of a loaded machine
and microseconds on one.

Tolerance: 1e-4 of the result's scale (atol = 1e-4 x max(1, max|ref|),
rtol = 1e-4), as ``tests/test_torch_pipeline.py`` holds ``denoise``: the
UNet agrees to ~1e-6 a call, and a few steps compound it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.pipelines.diffusion import repaint_op_schedule as jax_ops
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion import repaint_op_schedule
from medfusion_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_pipeline import _assert_close, _randomize

KEY = jax.random.PRNGKey(0)
LATENT = (2, 8, 8, 2)
T, STEPS = 20, 6
UNET_KW = dict(in_ch=2, out_ch=2, hid_chs=(8, 16), kernel_sizes=(3, 3), strides=(1, 2),
               time_emb_dim=16, cond_emb_num_classes=2, deep_supervision=0,
               norm_name=("GROUP", {"num_groups": 4, "affine": True}))
SCHED_KW = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002,
                beta_end=0.02)

_PAIRS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(self_cond=False, zero_snr=False, **settings):
    """(JAX pipeline, params, port pipeline) on the same weights."""
    if self_cond not in _PAIRS:
        kw = dict(UNET_KW, use_self_conditioning=self_cond)
        jax_unet = JaxUNet(**kw)
        z0 = jnp.zeros((1,) + LATENT[1:], jnp.float32)
        t0 = jnp.zeros((1,), jnp.int32)
        params = {"noise_estimator": _randomize(
            jax.eval_shape(jax_unet.init, KEY, z0, t0, t0)["params"], 21 + self_cond)}
        unet = UNet(**kw)
        load_jax_params(unet, params["noise_estimator"], kind="unet")
        _PAIRS[self_cond] = jax_unet, params, unet.eval()
    jax_unet, params, unet = _PAIRS[self_cond]
    common = dict(clip_x0=False, use_self_conditioning=self_cond, **settings)
    jp = JaxPipeline(scheduler=JaxSchedule.create(zero_terminal_snr=zero_snr, **SCHED_KW),
                     noise_estimator=jax_unet, **common)
    tp = DiffusionPipeline(scheduler=GaussianDiffusionSchedule.create(
        zero_terminal_snr=zero_snr, **SCHED_KW), noise_estimator=unet, **common)
    return jp, params, tp


def normals(keys, shape, width=None):
    """normal(k, shape) for each key, or for each of split(key, width)."""
    if width is None:
        return np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])
    return np.stack([normals(jax.random.split(k, width), shape) for k in keys])


def t_(a, dtype=None):
    out = torch.from_numpy(np.asarray(a).copy())
    return out if dtype is None else out.to(dtype)


X_T = np.random.default_rng(7).standard_normal(LATENT).astype(np.float32)
COND = np.asarray([0, 1], np.int32)
UNCOND = 1 - COND
KNOWN = np.random.default_rng(8).uniform(-1, 1, LATENT).astype(np.float32)
MASK = np.zeros(LATENT[:3] + (1,), np.float32)
MASK[:, :, :4] = 1.0

# name -> (pipeline settings, denoise arguments; known=True inpaints KNOWN)
DDIM_CASES = {
    "selfcond-uncond-v": (dict(self_cond=True, estimator_objective="v"),
                          dict(guidance_scale=3.0, un_cond=True)),
    "ancestral-cold-selfcond-x0": (dict(self_cond=True, estimator_objective="x_0"),
                                   dict(use_ddim=False, cold_diffusion=True,
                                        guidance_scale=3.0)),
    "inpaint-eps-cfg": (dict(), dict(guidance_scale=3.0, known=True)),
    "repaint-r2-j2": (dict(estimator_objective="v"),
                      dict(known=True, resample_steps=2, jump_length=2)),
}


@pytest.mark.parametrize("case", sorted(DDIM_CASES))
def test_denoise_options_match_jax(case):
    settings, args = DDIM_CASES[case]
    jp, params, tp = pair(**settings)
    args = dict(dict(steps=STEPS, eta=1.0), **args)
    jkw, tkw = dict(args), dict(args)
    if args.pop("un_cond", False):
        jkw["un_cond"], tkw["un_cond"] = jnp.asarray(UNCOND), t_(UNCOND).long()
    width = 2
    if args.get("known"):
        jkw.update(known=jnp.asarray(KNOWN), mask=jnp.asarray(MASK))
        tkw.update(known=t_(KNOWN), mask=t_(MASK))
        width = 3
    rng = jax.random.PRNGKey(3)
    rows = STEPS
    if args.get("resample_steps", 1) > 1:
        ops = repaint_op_schedule(STEPS, args["jump_length"], args["resample_steps"])
        assert ops == jax_ops(STEPS, args["jump_length"], args["resample_steps"])
        assert any(to < frm for frm, to in ops)
        rows = len(ops)
    noise = normals(jax.random.split(rng, rows), LATENT, width)
    ref = jp.denoise(params, jnp.asarray(X_T), rng, condition=jnp.asarray(COND),
                     decode=False, **jkw)
    out = tp.denoise(t_(X_T), condition=t_(COND).long(), decode=False,
                     noise=t_(noise), **tkw)
    assert np.abs(np.asarray(ref)).max() > 1e-2
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)
    if args.get("known"):  # the kept region is exactly the known latent
        keep = np.broadcast_to(MASK, LATENT) == 1
        np.testing.assert_array_equal(out.numpy()[keep], KNOWN[keep])


@pytest.mark.parametrize("zero_snr", [False, True], ids=["eps-linspace-cfg", "v-zero_snr-trailing"])
def test_dpmpp_matches_jax(zero_snr):
    settings = dict(zero_snr=True, estimator_objective="v") if zero_snr else {}
    jp, params, tp = pair(**settings)
    kw = dict(steps=STEPS, guidance_scale=3.0,
              timestep_spacing="trailing" if zero_snr else "linspace")
    ref = jp.denoise_dpmpp(params, jnp.asarray(X_T), condition=jnp.asarray(COND),
                           decode=False, **kw)
    out = tp.denoise_dpmpp(t_(X_T), condition=t_(COND).long(), decode=False, **kw)
    assert np.isfinite(np.asarray(ref)).all() and np.abs(np.asarray(ref)).max() > 1e-2
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)


@pytest.mark.parametrize("churn", [0.0, 2.0], ids=["heun", "heun-churn"])
def test_edm_matches_jax(churn):
    jp, params, tp = pair(estimator_objective="v")
    rng = jax.random.PRNGKey(4)
    kw = dict(steps=STEPS, guidance_scale=3.0, s_churn=churn)
    ref = jp.denoise_edm(params, jnp.asarray(X_T), rng=rng if churn else None,
                         condition=jnp.asarray(COND), decode=False, **kw)
    churn_noise = t_(normals(jax.random.split(rng, STEPS), LATENT)) if churn else None
    out = tp.denoise_edm(t_(X_T), condition=t_(COND).long(), decode=False,
                         churn_noise=churn_noise, **kw)
    assert np.abs(np.asarray(ref)).max() > 1e-2
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)


def test_edm_takes_a_fractional_time_and_refuses_what_jax_refuses():
    _, _, tp = pair()
    seen = []
    real = tp.noise_estimator.time_embedder.forward
    tp.noise_estimator.time_embedder.forward = lambda t: seen.append(t) or real(t)
    try:
        tp.denoise_edm(t_(X_T), steps=3, decode=False)
    finally:
        del tp.noise_estimator.time_embedder.forward
    assert len(seen) == 5  # Heun: 2n - 1 forwards
    assert all(t.dtype == torch.float32 for t in seen)
    assert any((t != t.round()).any() for t in seen)
    with pytest.raises(ValueError, match="zero-terminal-SNR"):
        pair(zero_snr=True, estimator_objective="v")[2].denoise_edm(t_(X_T), steps=3)
    with pytest.raises(ValueError, match="self-cond"):
        pair(self_cond=True)[2].denoise_edm(t_(X_T), steps=3)


def test_fast_sampler_matches_jax_and_denoise():
    jp, params, tp = pair()
    rng = jax.random.PRNGKey(6)
    noise = normals(jax.random.split(rng, STEPS), LATENT)
    kw = dict(steps=STEPS, guidance_scale=3.0, eta=1.0)
    cond = dict(condition=t_(COND).long(), un_cond=t_(UNCOND).long())
    ref = jp.denoise_fast(params, jnp.asarray(X_T), rng, condition=jnp.asarray(COND),
                          un_cond=jnp.asarray(UNCOND), decode=False,
                          encoder_key_every=3, **kw)
    out = tp.denoise_fast(t_(X_T), decode=False, encoder_key_every=3, noise=t_(noise),
                          **cond, **kw)
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)
    # key 1 is denoise with the step's one draw in both noise slots
    every = tp.denoise_fast(t_(X_T), decode=False, encoder_key_every=1, noise=t_(noise),
                            **cond, **kw)
    exact = tp.denoise(t_(X_T), decode=False, noise=t_(np.stack([noise, noise], 1)),
                       **cond, **kw)
    torch.testing.assert_close(every, exact, rtol=1e-6, atol=1e-6)
    assert (out - exact).abs().max() > 1e-6  # key 3 skips the encoder on 4 steps


def test_img2img_interpolate_and_sample_inpaint_match_jax():
    jp, params, tp = pair(do_input_centering=True)
    image = KNOWN
    rng = jax.random.PRNGKey(9)
    k_enc, k_noise, k_loop = jax.random.split(rng, 3)
    ref = jp.img2img(params, rng, jnp.asarray(image), strength=0.5,
                     condition=jnp.asarray(COND), steps=STEPS, decode=False)
    out = tp.img2img(t_(image), strength=0.5, condition=t_(COND).long(), steps=STEPS,
                     decode=False, x_noise=t_(normals([k_noise], LATENT)[0]),
                     noise=t_(normals(jax.random.split(k_loop, STEPS), LATENT, 2)))
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)

    img2 = X_T * 0.5
    k1, k2, k_loop = jax.random.split(rng, 3)
    ref = jp.interpolate(params, rng, jnp.asarray(image), jnp.asarray(img2), i=5,
                         condition=jnp.asarray(COND), lam=0.3, decode=False)
    n1, n2 = normals([k1, k2], LATENT)
    out = tp.interpolate(t_(image), t_(img2), i=5, condition=t_(COND).long(), lam=0.3,
                         decode=False, noise1=t_(n1), noise2=t_(n2),
                         noise=t_(normals(jax.random.split(k_loop, 5), LATENT, 2)))
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)

    k_init, k_loop = jax.random.split(rng)
    ref = jp.sample_inpaint(params, rng, jnp.asarray(KNOWN), jnp.asarray(MASK),
                            condition=jnp.asarray(COND), steps=STEPS, decode=False)
    out = tp.sample_inpaint(t_(KNOWN), t_(MASK), condition=t_(COND).long(), steps=STEPS,
                            decode=False, x_T=t_(normals([k_init], LATENT)[0]),
                            noise=t_(normals(jax.random.split(k_loop, STEPS), LATENT, 3)))
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)


@pytest.mark.parametrize("objective", ["x_T", "v"])
def test_invert_matches_jax_and_round_trips(objective):
    jp, params, tp = pair(estimator_objective=objective)
    x_0 = KNOWN
    kw = dict(steps=STEPS, guidance_scale=3.0)
    ref = jp.invert(params, jnp.asarray(x_0), condition=jnp.asarray(COND), **kw)
    out = tp.invert(t_(x_0), condition=t_(COND).long(), **kw)
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)
    back = tp.denoise(out, condition=t_(COND).long(), eta=0.0, decode=False,
                      generator=torch.Generator().manual_seed(0), **kw)
    ref_back = jp.denoise(params, ref, KEY, condition=jnp.asarray(COND), eta=0.0,
                          decode=False, **kw)
    _assert_close(back.numpy(), np.asarray(ref_back), 1e-4)


def test_denoise_checks_its_noise_layout():
    _, _, tp = pair()
    x = t_(X_T)
    with pytest.raises(ValueError, match=r"noise must have shape \(6, 3"):
        tp.denoise(x, steps=STEPS, known=t_(KNOWN), mask=t_(MASK),
                   noise=torch.zeros(STEPS, 2, *LATENT))
    with pytest.raises(ValueError, match="requires known"):
        tp.denoise(x, steps=STEPS, resample_steps=2, jump_length=2)
    with pytest.raises(ValueError, match="BOTH"):
        tp.denoise(x, steps=STEPS, known=t_(KNOWN))
