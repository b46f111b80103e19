"""One training step of the port against the JAX package with the Pallas
backward reached, and three steps with EMA through a frozen VAE, on the
CPU. Split from ``tests/test_torch_train.py`` (whose helpers and stated
tolerances these tests use) so that each file runs in about a minute.

* ``make_diffusion_train_step`` on the "lane" spatial UNet (self-attention
  at 1,024 tokens in the head layout and 256 tokens in the token layout)
  with the JAX flash-attention switch on: a spy shows that the JAX step
  reached ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and, through the token
  layout's ``_flash_mha_bwd``, ``_flash_bwd``, run in interpret mode. Loss,
  gradients (from Adam's first moment, m = 0.1 g), moments and updated
  parameters.
* Three steps of the narrow spatial UNet on the latents of a frozen VAE,
  with EMA, without flash attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.train import TrainState as JaxTrainState
from medfusion_tpu.train import make_diffusion_train_step as jax_make_step
from medfusion_tpu_torch.train import TrainState, ema_decay, make_diffusion_train_step
from tests.test_torch_train import (  # noqa: F401  (bwd_spy is a fixture)
    LR,
    _batch,
    _close_params,
    _close_tensors,
    _draws,
    _keep_key,
    _pipelines,
    _tree,
    _unet_pair,
    _vae_pair,
    bwd_spy,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_step_matches_jax_with_the_pallas_backward(bwd_spy):
    """One step of the lane spatial UNet, pixel-space (no latent
    embedder), B=2: loss, gradients, Adam moments and updated params."""
    jax_ops.enable_flash_attention(True)
    jax_unet, params, unet = _unet_pair("lane", 2, 32)
    jp, tp = _pipelines(jax_unet, unet)
    shape = (2, 32, 32, 2)
    jbatch, tbatch = _batch(shape)
    rng = _keep_key(shape)
    jstate = JaxTrainState.create(params, optax.adamw(LR, weight_decay=1e-2))
    jstate, jmetrics = jax_make_step(jp)(jstate, None, jbatch, rng)
    assert {"_bwd_dq_kernel", "_bwd_dkv_kernel", "_flash_bwd"} <= set(bwd_spy)

    state = TrainState(unet, lr=LR)
    metrics = make_diffusion_train_step(tp)(state, tbatch, _draws(rng, shape))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    adam = jstate.opt_state[0]
    grads = {k: torch.from_numpy(v.numpy() / 0.1) for k, v in _tree(adam.mu).items()}
    _close_tensors(dict((k, p.grad) for k, p in unet.named_parameters()), grads,
                   what="grad")
    moments = [(k, state.optimizer.state[p]) for k, p in unet.named_parameters()]
    _close_tensors({k: s["exp_avg"] for k, s in moments}, _tree(adam.mu), what="m")
    _close_tensors({k: s["exp_avg_sq"] for k, s in moments}, _tree(adam.nu),
                   atol_frac=4e-5, rtol=4e-3, what="v")  # squares: twice the error
    _close_params(dict(unet.named_parameters()), _tree(jstate.params), steps=1)


def test_train_steps_with_ema_match_jax_through_a_frozen_vae(monkeypatch):
    """Three steps (the EMA decay is 0, 0, then 1 - 2^(-2/3)) of the narrow
    spatial UNet on the latents of a frozen VAE, without flash attention."""
    jax_vae, vae_params, vae = _vae_pair()
    jax_unet, params, unet = _unet_pair("narrow", 2, 8)
    jp, tp = _pipelines(jax_unet, unet, jax_vae=jax_vae, vae=vae)
    enc_noise = np.random.default_rng(9).standard_normal((2, 8, 8, 2)).astype(np.float32)

    def fixed_noise(x, rng, sample=True):
        mean, logvar = jnp.split(x, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(enc_noise), None

    monkeypatch.setattr(jax_le, "diagonal_gaussian", fixed_noise)
    jbatch, tbatch = _batch((2, 16, 16, 1), seed=3)
    jstate = JaxTrainState.create(params, optax.adamw(LR, weight_decay=1e-2), use_ema=True)
    jstep = jax_make_step(jp)
    state = TrainState(unet, lr=LR, use_ema=True)
    step = make_diffusion_train_step(tp)
    for i in range(3):
        rng = jax.random.PRNGKey(20 + i)
        jstate, jm = jstep(jstate, vae_params, jbatch, rng)
        m = step(state, tbatch, _draws(rng, (2, 8, 8, 2), enc_noise))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i == 0 else 1e-4, err_msg=f"step {i}")
    assert state.step == 3 and ema_decay(2) > 0.3
    _close_params(dict(unet.named_parameters()), _tree(jstate.params), steps=3)
    _close_params(dict(state.ema.named_parameters()), _tree(jstate.ema_params), steps=3)
    ema = _tree(jstate.ema_params)
    live = _tree(jstate.params)
    assert max((ema[k] - live[k]).abs().max().item() for k in ema) > 1e-5  # not the params
