"""The port's diffusion schedule against the JAX package's.

Tables are built in float64 and rounded to float32 by both packages, so they
must be bit-equal, also on a zero-terminal-SNR schedule (with +inf where
JAX has it); the grids are integer and must be equal. The step functions
are float32 elementwise math and agree to 1e-6, with the same non-finite
elements at the zero-SNR terminal step; the Karras sigma grid to 2e-6 (a
float32 power, see its test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core import schedules as JS
from medfusion_tpu_torch.core import schedules as S


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _zero_snr_pair():
    kw = dict(timesteps=1000, schedule_strategy="scaled_linear", beta_start=0.002,
              beta_end=0.02, zero_terminal_snr=True)
    return JS.GaussianDiffusionSchedule.create(**kw), S.GaussianDiffusionSchedule.create(**kw)


def test_zero_terminal_snr_tables_bit_equal():
    """abar_T = 0 exactly; the reciprocal tables are +inf there, as JAX's."""
    js, ts = _zero_snr_pair()
    assert ts.zero_terminal_snr and float(ts.alphas_cumprod[-1]) == 0.0
    for name in TABLES:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert np.array_equal(a, b), name
    assert np.isinf(ts.sqrt_recip_alphas_cumprod[-1].item())
    np.testing.assert_array_equal(
        S.rescale_zero_terminal_snr(np.linspace(0.002**0.5, 0.02**0.5, 50) ** 2),
        JS.rescale_zero_terminal_snr(np.linspace(0.002**0.5, 0.02**0.5, 50) ** 2))


# t of each sample: interior steps and the zero-SNR terminal step
T_ZERO = np.asarray([0, 500, 999], np.int32)


@pytest.mark.parametrize("zero_snr", [False, True], ids=["plain", "zero_snr"])
def test_terminal_safe_inversions_and_variances_match(zero_snr):
    js, ts = _zero_snr_pair() if zero_snr else _pair()
    xt, a, b = _data(seed=4)
    jt, tt = jnp.asarray(T_ZERO), torch.from_numpy(T_ZERO).long()
    j = lambda v: jnp.asarray(v)
    tr = torch.from_numpy
    pairs = [
        (JS.estimate_x_T_safe(js, j(xt), j(a), jt, clip=False),
         S.estimate_x_T_safe(ts, tr(xt), tr(a), tt, clip=False)),
        (JS.estimate_x_T_from_v(js, j(xt), j(a), jt), S.estimate_x_T_from_v(ts, tr(xt), tr(a), tt)),
        (JS.estimate_x_0(js, j(xt), j(a), jt, clip=False),  # inf/NaN at the terminal step
         S.estimate_x_0(ts, tr(xt), tr(a), tt, clip=False)),
        (JS.posterior_variance(js, jt, 4, log=True, var_scale=j(b) * 0.5 + 0.5),
         S.posterior_variance(ts, tt, 4, log=True, var_scale=tr(b) * 0.5 + 0.5)),
        (JS.posterior_variance(js, jt, 4, log=False), S.posterior_variance(ts, tt, 4, log=False)),
        (JS.snr(js, jt), S.snr(ts, tt)),
        (JS.kdiff_sigmas(js), S.kdiff_sigmas(ts)),
        (JS.kl_gaussians(j(xt), j(a), j(b), j(a * 0.5)),
         S.kl_gaussians(tr(xt), tr(a), tr(b), tr(a * 0.5))),
    ]
    for clip in (True, False):
        pairs += list(zip(JS.cold_diffusion_step(js, j(xt), jt, j(a), clip=clip),
                          S.cold_diffusion_step(ts, tr(xt), tt, tr(a), clip=clip)))
    for i, (ref, out) in enumerate(pairs):
        ref = np.asarray(ref)
        assert np.array_equal(np.isfinite(ref), np.isfinite(out.numpy())), i
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6, err_msg=str(i))
    assert zero_snr == (not np.isfinite(np.asarray(pairs[2][0])[2]).all())


@pytest.mark.parametrize("t,t_next", [(999, 949), (49, 0)])
def test_ddim_step_at_the_zero_snr_terminal_step(t, t_next):
    js, ts = _zero_snr_pair()
    x0, xT, noise = _data(seed=5)
    ref = JS.ddim_step(js, jnp.asarray(x0), jnp.asarray(xT), t, t_next, jnp.asarray(noise), 1.0)
    out = S.ddim_step(ts, torch.from_numpy(x0), torch.from_numpy(xT), t, t_next,
                      torch.from_numpy(noise), 1.0)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,rho", [(1, 7.0), (6, 7.0), (18, 7.0), (25, 3.0)])
def test_karras_grid_and_fractional_t_match(n, rho):
    js, ts = _pair()
    jsig, tsig = JS.kdiff_sigmas(js), S.kdiff_sigmas(ts)
    ref = np.asarray(JS.karras_sigma_grid(jsig[0], jsig[-1], n, rho))
    out = S.karras_sigma_grid(tsig[0], tsig[-1], n, rho)
    assert out.shape == (n + 1,) and out[-1] == 0.0
    # rtol 2e-6, not 1e-6: the grid is x ** 7 of float32 values, and XLA's
    # float32 pow departs from the float64 grid by up to 1.2e-6 here,
    # torch's by 5.8e-7
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6)
    # below the table's lowest sigma (the grid's 0) t clamps to 0, above the
    # highest to T-1
    probe = np.concatenate([ref, [1e-9, 1e4]]).astype(np.float32)
    ref_t = np.asarray(JS.sigma_to_t_frac(js, jnp.asarray(probe)))
    out_t = S.sigma_to_t_frac(ts, torch.from_numpy(probe))
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), ref_t, rtol=1e-6, atol=1e-6)
