"""The port's training-loss options against the JAX package's
``DiffusionPipeline.train_loss``, float32 on the CPU: self-conditioning,
the learned-variance KL/NLL term (eps, v and x_0 objectives), the
deep-supervision terms, Min-SNR weighting and zero-terminal-SNR schedules,
alone and all together.

A three-level UNet (one deep-supervision head where asked) on 16x16
latents, without a latent embedder, weights from numpy seeds; T = 20, so
that a batch of 4 can hold both t = 0 (the NLL branch) and t = T-1 (the
zero-SNR terminal step). The JAX step's draws are rebuilt from its key
(``k_enc, k_t, k_noise, k_cfg, k_sc = split(rng, 5)``) and fed to the port;
the key is chosen so that the labels are kept and t holds 0 and T-1.

Tolerances (as ``tests/test_torch_train.py``): loss and metrics rtol 1e-5;
gradients per tensor atol 2e-5 x max|g| (floored at 1e-6 x the model's
largest |g|), rtol 2e-3. The port runs on one CPU thread here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_models import _randomize
from tests.test_torch_train import _batch, _close_tensors, _tree

T, B = 20, 4
SHAPE = (B, 16, 16, 2)
UNET_KW = dict(in_ch=2, out_ch=2, hid_chs=(8, 8, 16), kernel_sizes=(3,) * 3,
               strides=(1, 2, 2), time_emb_dim=16, cond_emb_num_classes=2,
               norm_name=("GROUP", {"num_groups": 4, "affine": True}))
SCHED_KW = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002,
                beta_end=0.02)

# name -> (UNet options, pipeline options, zero-terminal-SNR schedule)
CASES = {
    "self_conditioning-x0-zero_snr": (dict(use_self_conditioning=True),
                                      dict(estimator_objective="x_0"), True),
    "variance-eps": (dict(estimate_variance=True), dict(), False),
    "variance-v": (dict(estimate_variance=True), dict(estimator_objective="v"), False),
    "variance-x0": (dict(estimate_variance=True), dict(estimator_objective="x_0"), False),
    "deep_supervision-l2": (dict(deep_supervision=True), dict(loss="l2"), False),
    "min_snr-eps": (dict(), dict(min_snr_gamma=5.0), False),
    "min_snr-v-zero_snr": (dict(), dict(estimator_objective="v", min_snr_gamma=5.0), True),
    "all-v-zero_snr": (dict(use_self_conditioning=True, estimate_variance=True,
                            deep_supervision=True),
                       dict(estimator_objective="v", min_snr_gamma=5.0), True),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draws_of(rng):
    """The JAX train_loss's draws from ``rng``, as the port takes them."""
    _, k_t, k_noise, k_cfg, _ = jax.random.split(rng, 5)
    t = np.array(jax.random.randint(k_t, (B,), 0, T, dtype=jnp.int32))
    return {"t": torch.from_numpy(t).long(),
            "x_T": torch.from_numpy(np.array(jax.random.normal(k_noise, SHAPE, jnp.float32))),
            "drop": torch.tensor(bool(jax.random.uniform(k_cfg, ()) < 0.5))}


def step_key():
    """A key whose draws keep the labels and put t at 0 and T-1."""
    for i in range(5000):
        rng = jax.random.PRNGKey(1000 + i)
        d = draws_of(rng)
        t = set(d["t"].tolist())
        if not bool(d["drop"]) and {0, T - 1} <= t:
            return rng
    raise AssertionError("no key puts t at 0 and T-1")


KEY_T = step_key()


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_loss_option_matches_jax(case):
    unet_opts, pipe_opts, zero_snr = CASES[case]
    kw = dict(dict(UNET_KW, deep_supervision=False), **unet_opts)
    jax_unet = JaxUNet(**kw)
    z0 = jnp.zeros((1,) + SHAPE[1:], jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    params = _randomize(jax.eval_shape(jax_unet.init, jax.random.PRNGKey(0), z0, t0,
                                       t0)["params"], 31)
    unet = UNet(**kw)
    load_jax_params(unet, params, kind="unet")  # strict=True
    common = dict(classifier_free_guidance_dropout=0.5, do_input_centering=False,
                  clip_x0=False, estimate_variance=kw.get("estimate_variance", False),
                  use_self_conditioning=kw.get("use_self_conditioning", False), **pipe_opts)
    jp = JaxPipeline(scheduler=JaxSchedule.create(zero_terminal_snr=zero_snr, **SCHED_KW),
                     noise_estimator=jax_unet, **common)
    tp = DiffusionPipeline(scheduler=GaussianDiffusionSchedule.create(
        zero_terminal_snr=zero_snr, **SCHED_KW), noise_estimator=unet, **common)
    jbatch, tbatch = _batch(SHAPE)

    def loss_fn(p):
        return jp.train_loss({"noise_estimator": p}, jbatch, KEY_T)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tloss, tmetrics = tp.train_loss(tbatch, draws_of(KEY_T))
    tloss.backward()
    assert np.isfinite(float(loss)) and abs(float(loss)) > 1e-2
    expect = {"loss", "L1", "L2", "moe_aux"} | ({"variance_scale", "variance_loss"}
                                     if common["estimate_variance"] else set())
    assert set(tmetrics) == expect
    for k in expect:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    port = {k: (q.grad if q.grad is not None else torch.zeros_like(q))
            for k, q in unet.named_parameters()}
    _close_tensors(port, _tree(grads), what=case)
    if kw["deep_supervision"]:
        assert all(port[k].abs().max() > 0 for k in port if k.startswith("outc_ver"))


def test_min_snr_weight_keeps_the_zero_snr_terminal_step():
    from medfusion_tpu.core import schedules as JS
    from medfusion_tpu_torch.core import schedules as S

    js = JaxSchedule.create(zero_terminal_snr=True, **SCHED_KW)
    ts = GaussianDiffusionSchedule.create(zero_terminal_snr=True, **SCHED_KW)
    t = np.arange(T, dtype=np.int32)
    for objective in ("x_T", "x_0", "v"):
        ref = np.asarray(JS.min_snr_weight(js, jnp.asarray(t), 5.0, objective))
        out = S.min_snr_weight(ts, torch.from_numpy(t).long(), 5.0, objective).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, err_msg=objective)
    assert out[-1] == 1.0
