"""The port's flow-matching family against the JAX package's
``FlowMatchingPipeline``, float32 on the CPU: the training loss and its
gradients (logit-normal time with mean, std and shift, and uniform time;
the deep-supervision pyramid), Euler and Heun sampling with CFG and the
grid shift, ``img2img``, inpainting with ``resample_steps`` 2, ``invert``
and both ``interpolate`` modes.

Tiny UNets with perturbed JAX params loaded into the port, no latent
embedder. The JAX draws are rebuilt from its keys (``split(rng, 4)`` for the
loss; the per-step ``split(key, 3)`` chain for inpainting) and fed to the
port, which runs on one CPU thread here.

Tolerances: the loss at rtol 1e-5 and each gradient tensor within 2e-5 of
its max (``tests/test_torch_train.py``); every sampler at 1e-4 of the
latent's scale (``tests/test_torch_samplers.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlow
from medfusion_tpu.pipelines.flow import shift_time as jax_shift_time
from medfusion_tpu_torch.cli import sample, train_diffusion
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline, shift_time
from medfusion_tpu_torch.train import TrainState, make_flow_train_step
from medfusion_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_models import _randomize
from tests.test_torch_pipeline import _assert_close
from tests.test_torch_train import _batch, _close_tensors, _tree

B = 2
SHAPE = (B, 8, 8, 2)
STEPS = 4
UNET_KW = dict(in_ch=2, out_ch=2, hid_chs=(8, 16), kernel_sizes=(3, 3), strides=(1, 2),
               time_emb_dim=16, cond_emb_num_classes=2,
               norm_name=("GROUP", {"num_groups": 4, "affine": True}))
COND = np.asarray([0, 1], np.int32)
X_T = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
KNOWN = np.random.default_rng(8).uniform(-1, 1, SHAPE).astype(np.float32)
MASK = np.zeros(SHAPE[:3] + (1,), np.float32)
MASK[:, :, :4] = 1.0

_UNETS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unets(deep_supervision=False):
    """(JAX UNet, its params, the port's UNet) on the same weights."""
    if deep_supervision not in _UNETS:
        kw = dict(UNET_KW, deep_supervision=deep_supervision)
        jax_unet = JaxUNet(**kw)
        z0 = jnp.zeros((1,) + SHAPE[1:], jnp.float32)
        t0 = jnp.zeros((1,), jnp.int32)
        params = _randomize(jax.eval_shape(jax_unet.init, jax.random.PRNGKey(0), z0, t0,
                                           t0)["params"], 41 + deep_supervision)
        unet = UNet(**kw)
        load_jax_params(unet, params, kind="unet")
        _UNETS[deep_supervision] = jax_unet, params, unet
    return _UNETS[deep_supervision]


def pair(deep_supervision=False, **settings):
    jax_unet, params, unet = unets(deep_supervision)
    jp = JaxFlow(noise_estimator=jax_unet, **settings)
    tp = FlowMatchingPipeline(noise_estimator=unet.eval(), **settings)
    return jp, {"noise_estimator": params}, tp


def t_(a):
    return torch.from_numpy(np.asarray(a).copy())


def normal(key, shape=SHAPE):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def test_shift_time_matches_jax():
    t = np.linspace(0, 1, 11, dtype=np.float32)
    for sh in (1.0, 3.0):
        np.testing.assert_allclose(shift_time(torch.from_numpy(t), sh).numpy(),
                                   np.asarray(jax_shift_time(jnp.asarray(t), sh)), rtol=1e-7)


# name -> (deep supervision, pipeline settings)
LOSS_CASES = {
    "logit_normal-shift3-deep_supervision": (True, dict(logit_mean=0.3, logit_std=0.8,
                                                        shift=3.0)),
    "uniform-centered": (False, dict(timestep_sampling="uniform", do_input_centering=True)),
}


def loss_draws(rng, sampling):
    """The JAX train_loss's draws from ``rng``: split(rng, 4)."""
    _, k_t, k_noise, k_cfg = jax.random.split(rng, 4)
    draw = jax.random.normal if sampling == "logit_normal" else jax.random.uniform
    return {"t_draw": t_(np.asarray(draw(k_t, (B,), jnp.float32))),
            "eps": t_(normal(k_noise)),
            "drop": torch.tensor(bool(jax.random.uniform(k_cfg, ()) < 0.5))}


def kept_key(sampling):
    """A key whose CFG draw keeps the labels."""
    for i in range(100):
        rng = jax.random.PRNGKey(500 + i)
        if not bool(loss_draws(rng, sampling)["drop"]):
            return rng
    raise AssertionError("no key keeps the labels")


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_flow_train_loss_and_gradients_match_jax(case):
    ds, settings = LOSS_CASES[case]
    settings = dict(dict(do_input_centering=False), **settings)
    jp, params, tp = pair(ds, **settings)
    sampling = settings.get("timestep_sampling", "logit_normal")
    rng = kept_key(sampling)
    jbatch, tbatch = _batch(SHAPE)

    def loss_fn(p):
        return jp.train_loss({"noise_estimator": p}, jbatch, rng)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["noise_estimator"])
    unet = tp.noise_estimator
    unet.zero_grad(set_to_none=True)
    tloss, tmetrics = tp.train_loss(tbatch, loss_draws(rng, sampling))
    tloss.backward()
    assert set(tmetrics) == {"loss", "L2", "moe_aux"}
    assert float(tmetrics["moe_aux"]) == 0.0 and abs(float(loss)) > 1e-2
    for k in ("loss", "L2"):
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    port = {k: (q.grad if q.grad is not None else torch.zeros_like(q))
            for k, q in unet.named_parameters()}
    _close_tensors(port, _tree(grads), what=case)
    if ds:
        assert all(port[k].abs().max() > 0 for k in port if k.startswith("outc_ver"))
    unet.zero_grad(set_to_none=True)


def test_flow_train_step_is_the_diffusion_step():
    """``make_flow_train_step`` updates the UNet with AdamW and EMA from the
    flow loss: the step's loss is the loss of the state before it."""
    _, _, unet = unets()
    model = UNet(**dict(UNET_KW, deep_supervision=False))
    model.load_state_dict(unet.state_dict())
    tp = FlowMatchingPipeline(noise_estimator=model, do_input_centering=False)
    state = TrainState(model, lr=1e-3, use_ema=True)
    draws = tp.train_draws(B, SHAPE[1:], generator=torch.Generator().manual_seed(0))
    _, tbatch = _batch(SHAPE)
    with torch.no_grad():
        before, _ = tp.train_loss(tbatch, draws)
    metrics = make_flow_train_step(tp)(state, tbatch, draws)
    assert state.step == 1 and float(metrics["loss"]) == pytest.approx(float(before), rel=1e-6)
    with torch.no_grad():
        after, _ = tp.train_loss(tbatch, draws)
    assert float(after) < float(before)
    assert set(draws) == {"enc_noise", "t_draw", "eps", "drop"}


# name -> (pipeline settings, denoise arguments)
DENOISE_CASES = {
    "euler": (dict(), dict(heun=False)),
    "heun-cfg-uncond-shift3": (dict(shift=3.0), dict(guidance_scale=3.0, un_cond=True)),
    "heun-cfg-shift2-override": (dict(), dict(guidance_scale=2.0, shift=2.0)),
}


@pytest.mark.parametrize("case", sorted(DENOISE_CASES))
def test_flow_denoise_matches_jax(case):
    settings, args = DENOISE_CASES[case]
    jp, params, tp = pair(**settings)
    jkw, tkw = dict(args), dict(args)
    if args.get("un_cond"):
        jkw["un_cond"], tkw["un_cond"] = jnp.asarray(1 - COND), t_(1 - COND).long()
    ref = jp.denoise(params, jnp.asarray(X_T), None, condition=jnp.asarray(COND),
                     steps=STEPS, decode=False, **jkw)
    out = tp.denoise(t_(X_T), condition=t_(COND).long(), steps=STEPS, decode=False, **tkw)
    assert np.abs(np.asarray(ref)).max() > 1e-2
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)


def test_flow_img2img_and_inpainting_match_jax():
    jp, params, tp = pair(do_input_centering=True, shift=2.0)
    rng = jax.random.PRNGKey(9)
    _, k_noise = jax.random.split(rng)
    ref = jp.img2img(params, rng, jnp.asarray(KNOWN), strength=0.5,
                     condition=jnp.asarray(COND), steps=STEPS, guidance_scale=2.0,
                     decode=False)
    out = tp.img2img(t_(KNOWN), strength=0.5, condition=t_(COND).long(), steps=STEPS,
                     guidance_scale=2.0, decode=False, x_noise=t_(normal(k_noise)))
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)

    resample = 2
    k_init, k_loop = jax.random.split(rng)
    rows = []
    for key in jax.random.split(k_loop, STEPS):
        row = []
        for _ in range(resample):
            k_proj, k_re, key = jax.random.split(key, 3)
            row.append([normal(k_proj), normal(k_re)])
        rows.append(row)
    ref = jp.sample_inpaint(params, rng, jnp.asarray(KNOWN), jnp.asarray(MASK),
                            condition=jnp.asarray(COND), steps=STEPS,
                            resample_steps=resample, decode=False)
    out = tp.sample_inpaint(t_(KNOWN), t_(MASK), condition=t_(COND).long(), steps=STEPS,
                            resample_steps=resample, decode=False,
                            x_T=t_(normal(k_init)), noise=t_(np.asarray(rows)))
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)
    keep = np.broadcast_to(MASK, SHAPE) == 1
    np.testing.assert_array_equal(out.numpy()[keep], KNOWN[keep])


@pytest.mark.parametrize("heun", [True, False], ids=["heun", "euler"])
def test_flow_invert_matches_jax(heun):
    jp, params, tp = pair(shift=3.0)
    kw = dict(steps=STEPS, guidance_scale=2.0, heun=heun)
    ref = jp.invert(params, jnp.asarray(KNOWN), condition=jnp.asarray(COND), **kw)
    out = tp.invert(t_(KNOWN), condition=t_(COND).long(), **kw)
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)


@pytest.mark.parametrize("ode_invert", [False, True], ids=["lerp", "ode_invert"])
def test_flow_interpolate_matches_jax(ode_invert):
    jp, params, tp = pair()
    rng = jax.random.PRNGKey(11)
    img2 = X_T * 0.5
    kw = dict(strength=0.8, lam=0.3, ode_invert=ode_invert, steps=STEPS)
    ref = jp.interpolate(params, rng, jnp.asarray(KNOWN), jnp.asarray(img2),
                         condition=jnp.asarray(COND), decode=False, **kw)
    draws = {}
    if not ode_invert:
        k1, k2, _ = jax.random.split(rng, 3)
        draws = dict(noise1=t_(normal(k1)), noise2=t_(normal(k2)))
    out = tp.interpolate(t_(KNOWN), t_(img2), condition=t_(COND).long(), decode=False,
                         **draws, **kw)
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)


def test_flow_refuses_what_jax_refuses():
    _, _, tp = pair()
    x = t_(X_T)
    with pytest.raises(ValueError, match="t_start"):
        tp.denoise(x, t_start=0.0)
    with pytest.raises(ValueError, match="BOTH"):
        tp.denoise(x, known=t_(KNOWN))
    with pytest.raises(ValueError, match="requires known"):
        tp.denoise(x, resample_steps=2)
    with pytest.raises(ValueError, match="noise must have shape"):
        tp.denoise(x, steps=STEPS, known=t_(KNOWN), mask=t_(MASK),
                   noise=torch.zeros(STEPS, 1, 3, *SHAPE))
    with pytest.raises(ValueError, match="shift"):
        FlowMatchingPipeline(noise_estimator=tp.noise_estimator, shift=0.5)
    with pytest.raises(ValueError, match="timestep_sampling"):
        FlowMatchingPipeline(noise_estimator=tp.noise_estimator, timestep_sampling="beta")
    with pytest.raises(ValueError, match="strength"):
        tp.img2img(x, strength=0.0)


def test_train_diffusion_cli_trains_and_samples_the_flow_family(tmp_path, capsys):
    """``cli.train_diffusion --family flow`` trains with EMA and writes its
    Heun sample grid; ``cli.sample --family flow --ckpt --ema`` samples the
    run, and the diffusion family refuses it (its config says flow)."""
    run = tmp_path / "flow"
    state, losses, pipe = train_diffusion.main([
        "--preset", "smoke", "--device", "cpu", "--max-steps", "2", "--family", "flow",
        "--flow-shift", "2", "--time-sampling", "uniform", "--use-ema", "--sample-every",
        "2", "--out", str(run)])
    assert isinstance(pipe, FlowMatchingPipeline) and pipe.shift == 2.0
    assert pipe.timestep_sampling == "uniform" and np.isfinite(losses).all()
    assert (run / "images" / "sample_2.png").exists()
    argv = ["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--n", "2", "--steps",
            "3", "--ckpt", str(run), "--ema", "--out", str(tmp_path / "s")]
    results = sample.main([*argv, "--family", "flow", "--flow-shift", "2"])
    assert all(np.isfinite(v).all() for v in results.values())
    with pytest.raises(SystemExit, match="family"):
        sample.main(argv)
