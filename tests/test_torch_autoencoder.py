"""The port's autoencoder training against the JAX package, on the CPU.

* ``ssim`` and ``ssim_loss_per_image`` (float32, atol 1e-6), at a size
  above the 11-tap window and at sizes that shrink it.
* ``VAE.forward`` against JAX ``VAE.__call__(train=True)`` on the same
  perturbed weights (the output heads are zero-initialised, so unperturbed
  weights would make the comparison vacuous) and the same reparameterisation
  draw: the JAX module's ``diagonal_gaussian`` is replaced by one that adds
  a fixed numpy draw, the port gets the same draw. The VAE tolerances of
  ``tests/test_torch_models.py`` (rtol 1e-4, atol 1e-5).
* The loss and its metrics against ``AutoencoderTrainer.loss``: rtol 1e-5
  (the SSIM metric, near 0 on noise images, also atol 1e-6 as SSIM).
* One Adam step against ``make_autoencoder_train_step``: the gradients
  (Adam's first moment is 0.1 g) and the first moment at 2e-5 of each
  tensor's max (rtol 2e-3), the second moment at twice that (squares), and
  the parameters by the rule of ``tests/test_torch_train.py``: Adam's first
  step moves every element by about lr, so an element whose gradient is
  rounding noise may move the other way (atol 2 lr, and 99.9 % of the
  elements within 1e-3 lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu.losses.ssim import ssim as jax_ssim
from medfusion_tpu.train import TrainState as JaxTrainState
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu.train.autoencoder import make_autoencoder_train_step as jax_make_step
from medfusion_tpu.train.autoencoder import ssim_loss_per_image as jax_ssim_loss
from medfusion_tpu_torch.losses import ssim
from medfusion_tpu_torch.models.latent_embedders import VAE
from medfusion_tpu_torch.train import TrainState
from medfusion_tpu_torch.train.autoencoder import (
    AutoencoderTrainer,
    make_autoencoder_train_step,
    ssim_loss_per_image,
)
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_train import _close_params, _close_tensors

KEY = jax.random.PRNGKey(0)
LR = 1e-4
# a small chest-like VAE: RGB, two downsamplings, one deep-supervision head
VAE_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(4, 8, 16),
              kernel_sizes=(3, 3, 3), strides=(1, 2, 2), deep_supervision=1,
              norm_name=("GROUP", {"num_groups": 2, "affine": True}))
SHAPE = (2, 16, 16, 3)
LATENT = (2, 4, 4, 2)


@pytest.mark.parametrize("side", [24, 9, 6], ids=["window-11", "window-9", "window-5"])
@pytest.mark.parametrize("size_average,nonneg", [(True, False), (False, True)])
def test_ssim_matches_jax(side, size_average, nonneg):
    rng = np.random.default_rng(side)
    x = rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.2, x.shape), 0, 1).astype(np.float32)
    want = jax_ssim(jnp.asarray(x), jnp.asarray(y), data_range=1.0,
                    size_average=size_average, nonnegative_ssim=nonneg)
    got = ssim(nchw(x), nchw(y), data_range=1.0, size_average=size_average,
               nonnegative_ssim=nonneg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        nhwc(ssim_loss_per_image(nchw(2 * x - 1.2), nchw(2 * y - 1))),
        np.asarray(jax_ssim_loss(jnp.asarray(2 * x - 1.2), jnp.asarray(2 * y - 1))),
        rtol=0, atol=1e-6)


def test_ssim_is_differentiable():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, 16, 16)).astype(np.float32))
    y = x.clone().requires_grad_(True)
    ssim(x, y + 0.1).backward()
    assert y.grad is not None and torch.isfinite(y.grad).all() and y.grad.abs().max() > 0


def _pair(seed=3):
    jax_vae = jax_le.VAE(**VAE_KW)
    x0 = jnp.zeros((1, *SHAPE[1:]), jnp.float32)
    params = _randomize(jax.eval_shape(
        jax_vae.init, {"params": KEY, "sample": KEY}, x0)["params"], seed)
    vae = VAE(**VAE_KW)
    load_jax_params(vae, params, kind="vae")
    return jax_vae, params, vae


@pytest.fixture
def fixed_noise(monkeypatch):
    """The JAX VAE's reparameterisation with a fixed numpy draw."""
    noise = np.random.default_rng(9).standard_normal(LATENT).astype(np.float32)

    def diagonal_gaussian(x, rng, sample=True):
        mean, logvar = jnp.split(x, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        z = mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise)
        kl = 0.5 * jnp.sum(mean**2 + jnp.exp(logvar) - 1.0 - logvar) / x.shape[0]
        return z, kl

    monkeypatch.setattr(jax_le, "diagonal_gaussian", diagonal_gaussian)
    return noise


def _images(seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, SHAPE).astype(np.float32)


def test_vae_training_forward_matches_jax(fixed_noise):
    jax_vae, params, vae = _pair()
    x = _images()
    pred, pred_ver, kl = jax_vae.apply({"params": params}, jnp.asarray(x), train=True,
                                       rngs={"sample": KEY})
    with torch.no_grad():
        got, got_ver, got_kl = vae(nchw(x), nchw(fixed_noise))
    assert len(got_ver) == len(pred_ver) == 1
    np.testing.assert_allclose(nhwc(got), np.asarray(pred), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(got_ver[0]), np.asarray(pred_ver[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_kl.item(), float(kl), rtol=1e-5)
    assert np.abs(np.asarray(pred_ver[0])).max() > 1e-2  # the heads are not zero


@pytest.mark.parametrize("pixel_loss", ["l2", "l1"])
def test_autoencoder_loss_and_metrics_match_jax(fixed_noise, pixel_loss):
    jax_vae, params, vae = _pair()
    x = _images()
    kw = dict(pixel_loss=pixel_loss, embedding_loss_weight=1e-6)
    loss, metrics = JaxTrainer(autoencoder=jax_vae, **kw).loss(
        params, None, {"source": jnp.asarray(x)}, KEY)
    got, got_metrics = AutoencoderTrainer(vae, **kw).loss(nchw(x), nchw(fixed_noise))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert set(got_metrics) == set(metrics) == {"loss", "emb_loss", "L1", "L2", "ssim"}
    for k, v in metrics.items():
        # the SSIM metric, a mean of terms of order one, at SSIM's atol
        np.testing.assert_allclose(float(got_metrics[k]), float(v), rtol=1e-5,
                                   atol=1e-6 if k == "ssim" else 0, err_msg=k)


def test_autoencoder_refuses_what_is_not_ported():
    """An unknown flavour is refused (the 'vqvae' flavour runs:
    tests/test_torch_vqvae.py); an LPIPS perceiver is taken (its loss:
    tests/test_torch_lpips.py)."""
    from medfusion_tpu_torch.losses import LPIPS

    _, _, vae = _pair()
    with pytest.raises(ValueError, match="flavour"):
        AutoencoderTrainer(vae, flavor="vq")
    assert isinstance(AutoencoderTrainer(vae, perceiver=LPIPS()).perceiver, LPIPS)
    assert AutoencoderTrainer(vae, flavor="vqvae").flavor == "vqvae"


def _vae_tree(tree):
    return jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), kind="vae")


def test_adam_step_matches_jax(fixed_noise):
    jax_vae, params, vae = _pair()
    x = _images()
    trainer_kw = dict(pixel_loss="l2", embedding_loss_weight=1e-6)
    jstate = JaxTrainState.create(params, optax.adam(LR))
    jstate, jmetrics = jax_make_step(JaxTrainer(autoencoder=jax_vae, **trainer_kw))(
        jstate, None, {"source": jnp.asarray(x)}, KEY)

    state = TrainState(vae, lr=LR, weight_decay=0.0)
    step = make_autoencoder_train_step(AutoencoderTrainer(vae, **trainer_kw))
    metrics = step(state, {"source": torch.from_numpy(x)}, torch.from_numpy(fixed_noise))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    adam = jstate.opt_state[0]
    grads = {k: v / 0.1 for k, v in _vae_tree(adam.mu).items()}
    named = dict(vae.named_parameters())
    _close_tensors({k: p.grad for k, p in named.items()}, grads, what="grad")
    moments = {k: state.optimizer.state[p] for k, p in named.items()}
    _close_tensors({k: s["exp_avg"] for k, s in moments.items()}, _vae_tree(adam.mu), what="m")
    _close_tensors({k: s["exp_avg_sq"] for k, s in moments.items()}, _vae_tree(adam.nu),
                   atol_frac=4e-5, rtol=4e-3, what="v")
    _close_params(named, _vae_tree(jstate.params), steps=1)
