"""The port's diffusion schedule against the JAX package's.

Tables are built in float64 and rounded to float32 by both packages, so they
must be bit-equal; the grids are integer and must be equal. The step
functions are float32 elementwise math and agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core import schedules as JS
from medfusion_tpu_torch.core import schedules as S

TABLES = ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_mean_coef1", "posterior_mean_coef2", "posterior_variance")


def _pair(strategy="scaled_linear"):
    kw = dict(timesteps=1000, schedule_strategy=strategy, beta_start=0.002,
              beta_end=0.02)
    return JS.GaussianDiffusionSchedule.create(**kw), S.GaussianDiffusionSchedule.create(**kw)


@pytest.mark.parametrize("strategy", ["scaled_linear", "linear", "cosine"])
def test_tables_bit_equal(strategy):
    js, ts = _pair(strategy)
    for name in TABLES:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.dtype == b.dtype == np.float32, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("steps", [8, 50, 61, 150])
@pytest.mark.parametrize("spacing", ["linspace", "trailing"])
def test_ddim_grids_equal(steps, spacing):
    js, ts = _pair()
    assert np.array_equal(np.asarray(js.ddim_timesteps(steps, spacing)),
                          ts.ddim_timesteps_host(steps, spacing))


def _data(shape=(3, 4, 4, 2), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_q_sample_matches():
    js, ts = _pair()
    x0, xT, _ = _data()
    t = np.asarray([-1, 500, 1000], np.int32)  # both clamps and one interior step
    ref = JS.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(xT))
    out = S.q_sample(ts, torch.from_numpy(x0), torch.from_numpy(t).long(),
                     torch.from_numpy(xT))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("clip", [True, False])
def test_ancestral_step_from_eps_matches(clip):
    js, ts = _pair()
    xt, eps, noise = _data(seed=1)
    t = np.asarray([0, 17, 999], np.int32)  # t=0 zeroes the std
    rx, r0 = JS.ancestral_step_from_eps(js, jnp.asarray(xt), jnp.asarray(t),
                                        jnp.asarray(eps), jnp.asarray(noise), clip=clip)
    ox, o0 = S.ancestral_step_from_eps(ts, torch.from_numpy(xt), torch.from_numpy(t).long(),
                                       torch.from_numpy(eps), torch.from_numpy(noise),
                                       clip=clip)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(o0.numpy(), np.asarray(r0), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("t,t_next", [(999, 992), (60, 53), (6, 0)])
def test_ddim_step_matches(eta, t, t_next):
    js, ts = _pair()
    x0, xT, noise = _data(seed=2)
    ref = JS.ddim_step(js, jnp.asarray(x0), jnp.asarray(xT), t, t_next,
                       jnp.asarray(noise), eta)
    out = S.ddim_step(ts, torch.from_numpy(x0), torch.from_numpy(xT), t, t_next,
                      torch.from_numpy(noise), eta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_inversions_match():
    js, ts = _pair()
    xt, v, x0 = _data(seed=3)
    t = np.asarray([1, 400, 998], np.int32)
    jt, tt = jnp.asarray(t), torch.from_numpy(t).long()
    for jf, tf, a, b in ((JS.estimate_x_0, S.estimate_x_0, xt, v),
                         (JS.estimate_x_T, S.estimate_x_T, xt, x0),
                         (JS.estimate_x_0_from_v, S.estimate_x_0_from_v, xt, v)):
        ref = jf(js, jnp.asarray(a), jnp.asarray(b), jt, clip=False)
        out = tf(ts, torch.from_numpy(a), torch.from_numpy(b), tt, clip=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
