"""The port's LPIPS and MS-SSIM, and autoencoder training with ``--lpips``,
against the JAX package, on the CPU, f32.

* ``ms_ssim`` at 256^2 and at 64^2 (whose last two scales, 8^2 and 4^2,
  shrink the 11-tap window to 7 and 3): within 1e-5.
* LPIPS (2-D, 3-D, 1-channel, ``normalize``) on the JAX VGG16 params
  perturbed away from their init (He-scaled kernels, biases N(0, 0.1^2)),
  carried across by ``utils/weights.py``: within 1e-4 relative, and its
  gradient with respect to pred within 2e-5 of the gradient's max.
* The LPIPS term in autoencoder training: the 'vqvae' flavour's
  ``rec_loss`` (LPIPS at pyramid depths 0 and 1, not 2) and its gradients
  with respect to each level's prediction; one training step's loss and
  parameter gradients through the whole autoencoder, 'vae' through a VAE
  and 'vqvae' through a VQVAE (codebook included); the adversarial
  generator loss with the perceiver in the adaptive lambda (the loss, each
  lambda and adversarial term at rtol 1e-5) and the out head's gradients
  (JAX's adversarial gradient reaches only the heads, so the body's differ
  by design: ``tests/test_torch_adversarial.py``). Gradients within 2e-5
  of each tensor's max (rtol 2e-3), as ``tests/test_torch_autoencoder.py``.

Images are 32^2 (the deep-supervision level 16^2) so that VGG16's fifth
stage has a pixel. The port runs on one CPU thread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu.losses.lpips import LPIPS as JaxLPIPS
from medfusion_tpu.losses.ssim import ms_ssim as jax_ms_ssim
from medfusion_tpu.train.adversarial import AdversarialTrainer as JaxAdversarialTrainer
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu_torch.losses import ms_ssim
from medfusion_tpu_torch.losses.lpips import LPIPS, frozen_lpips, load_vgg16_npz
from medfusion_tpu_torch.models.latent_embedders import VAE, VQVAE
from medfusion_tpu_torch.train.adversarial import AdversarialTrainer
from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer
from medfusion_tpu_torch.utils.weights import (
    jax_gan_to_state_dicts,
    jax_params_to_state_dict,
    jax_vgg16_to_state_dict,
    load_jax_params,
)
from tests.test_torch_adversarial import DISC_KW, HEADS, _jax_discs, _split
from tests.test_torch_models import _randomize, nchw
from tests.test_torch_train import _close_tensors
from tests.test_torch_vqvae import _margin, _spread

KEY = jax.random.PRNGKey(0)
VAE_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(4, 8),
              kernel_sizes=(3, 3), strides=(1, 2), deep_supervision=1,
              norm_name=("GROUP", {"num_groups": 2, "affine": True}))
SHAPE = (2, 32, 32, 3)
LATENT = (2, 16, 16, 2)
TRAINER_KW = dict(pixel_loss="l2", embedding_loss_weight=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("side", [256, 64], ids=["256", "64-window-shrinks"])
def test_ms_ssim_matches_jax(side):
    rng = np.random.default_rng(side)
    x = rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    want = np.asarray(jax.jit(jax_ms_ssim, static_argnames="size_average")(
        jnp.asarray(x), jnp.asarray(y), size_average=False))
    got = ms_ssim(nchw(x), nchw(y), size_average=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ms_ssim(nchw(x), nchw(y)).item(), want.mean(), rtol=0, atol=1e-5)
    assert 0.1 < float(want.min()) < 0.999


@functools.lru_cache(maxsize=None)
def _lpips_params():
    """The JAX LPIPS params: He-scaled kernels, biases N(0, 0.1^2)."""
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(JaxLPIPS().init, KEY, x, x)["params"]
    rng = np.random.default_rng(7)

    def draw(s):
        if len(s.shape) == 1:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) * (2 / np.prod(s.shape[:-1])) ** 0.5
                ).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _port_lpips(normalize=False):
    return frozen_lpips(jax_vgg16_to_state_dict(_lpips_params()), "cpu", normalize=normalize)


def _to_port(x):
    """JAX layout [B, H, W, C] or [B, D, H, W, C] -> NCHW or NCDHW."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


CASES = {"2d": ((2, 32, 32, 3), False), "3d": ((1, 2, 32, 32, 3), False),
         "grey": ((2, 32, 32, 1), False), "normalize": ((2, 32, 32, 3), True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lpips_and_its_gradient_match_jax(case):
    shape, normalize = CASES[case]
    rng = np.random.default_rng(11)
    lo = 0.0 if normalize else -1.0
    pred = rng.uniform(lo, 1, shape).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.3, shape), lo, 1).astype(np.float32)
    jnet, params = JaxLPIPS(normalize=normalize), _lpips_params()
    weights = np.arange(1, shape[0] + 1, dtype=np.float32).reshape(-1, *[1] * (len(shape) - 1))

    def weighted(p, t):  # distinct weights, so that each sample's gradient is checked
        val = jnet.apply({"params": params}, p, t)
        return jnp.sum(val * weights), val

    (_, want), want_grad = jax.jit(jax.value_and_grad(weighted, has_aux=True))(pred, target)
    want = np.asarray(want)
    p = _to_port(pred).requires_grad_(True)
    got = _port_lpips(normalize)(p, _to_port(target))
    assert got.shape == want.shape == (shape[0],) + (1,) * (len(shape) - 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4)
    (got * torch.from_numpy(weights)).sum().backward()
    want_grad = np.moveaxis(np.asarray(want_grad), -1, 1)
    np.testing.assert_allclose(p.grad.numpy(), want_grad, rtol=0,
                               atol=2e-5 * np.abs(want_grad).max())
    assert float(want.min()) > 1e-3


def test_lpips_module_holds_torchvision_keys(tmp_path):
    """The backbone's keys are torchvision's ``features.{idx}``; both npz
    layouts load (torchvision keys, and the JAX package's flax keys)."""
    keys = set(LPIPS().vgg.state_dict())
    idx = sorted({int(k.split(".")[1]) for k in keys})
    assert idx == [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    sd = jax_vgg16_to_state_dict(_lpips_params())
    np.savez(tmp_path / "tv.npz", **{k: v.numpy() for k, v in sd.items()},
             **{"classifier.0.weight": np.zeros((2, 2), np.float32)})
    flat = {f"{m}/{leaf}": v for m, d in _lpips_params()["vgg"].items() for leaf, v in d.items()}
    np.savez(tmp_path / "flax.npz", **flat)
    for name in ("tv.npz", "flax.npz"):
        got = load_vgg16_npz(tmp_path / name)
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd)


# ---- the LPIPS term in autoencoder training ----------------------------------


def _fix_noise(monkeypatch, shape):
    """The JAX VAE's reparameterisation with a fixed numpy draw of ``shape``."""
    noise = np.random.default_rng(9).standard_normal(shape).astype(np.float32)

    def diagonal_gaussian(x, rng, sample=True):
        mean, logvar = jnp.split(x, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        z = mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise)
        kl = 0.5 * jnp.sum(mean**2 + jnp.exp(logvar) - 1.0 - logvar) / x.shape[0]
        return z, kl

    monkeypatch.setattr(jax_le, "diagonal_gaussian", diagonal_gaussian)
    return noise


@pytest.fixture
def fixed_noise(monkeypatch):
    return _fix_noise(monkeypatch, LATENT)


def _images(seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, SHAPE).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _vae_params(seed=3):
    x0 = jnp.zeros((1, *SHAPE[1:]), jnp.float32)
    return _randomize(jax.eval_shape(jax_le.VAE(**VAE_KW).init,
                                     {"params": KEY, "sample": KEY}, x0)["params"], seed)


def _port_trainer(flavor="vae"):
    vae = VAE(**VAE_KW)
    load_jax_params(vae, _vae_params(), kind="vae")
    return AutoencoderTrainer(vae, flavor=flavor, perceiver=_port_lpips(), **TRAINER_KW)


@pytest.mark.parametrize("flavor", ["vqvae"])
def test_rec_loss_with_lpips_matches_jax(flavor):
    """rec_loss over three pyramid levels (32^2, 16^2 and 16^2 again as
    depth 2, where LPIPS is off) and its gradients; the 'vae' flavour's is
    in the training step below."""
    rng = np.random.default_rng(4)
    target = _images()
    preds = [rng.uniform(-1, 1, s).astype(np.float32)
             for s in (SHAPE, (2, 16, 16, 3), (2, 16, 16, 3))]
    jtrainer = JaxTrainer(autoencoder=None, flavor=flavor, perceiver=JaxLPIPS(), **TRAINER_KW)
    fn = jax.jit(jax.value_and_grad(
        lambda ps: jtrainer.rec_loss(_lpips_params(), ps[0], ps[1:], jnp.asarray(target)),
    ))
    want, want_grads = fn([jnp.asarray(p) for p in preds])
    ported = [nchw(p).requires_grad_(True) for p in preds]
    got = _port_trainer(flavor).rec_loss(ported[0], ported[1:], nchw(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    _close_tensors({str(i): p.grad for i, p in enumerate(ported)},
                   {str(i): nchw(np.asarray(g)) for i, g in enumerate(want_grads)},
                   what="d rec / d pred")
    without = AutoencoderTrainer(None, flavor=flavor, **TRAINER_KW).rec_loss(
        nchw(preds[0]), [nchw(p) for p in preds[1:]], nchw(target))
    assert abs(got.item() - without.item()) > 1e-2 * abs(got.item())  # LPIPS counts


def test_training_step_with_lpips_matches_jax(fixed_noise):
    x = _images()
    jtrainer = JaxTrainer(autoencoder=jax_le.VAE(**VAE_KW), perceiver=JaxLPIPS(), **TRAINER_KW)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jtrainer.loss, has_aux=True))(
        _vae_params(), _lpips_params(), {"source": jnp.asarray(x)}, KEY)
    trainer = _port_trainer()
    got, got_metrics = trainer.loss(nchw(x), nchw(fixed_noise))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got.backward()
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), kind="vae")
    _close_tensors({k: p.grad for k, p in trainer.autoencoder.named_parameters()}, want,
                   what="grad")
    assert not any(p.requires_grad for p in trainer.perceiver.parameters())


def test_vqvae_training_step_with_lpips_matches_jax():
    """The 'vqvae' flavour through a VQVAE (a codebook of 16; the
    out-encoder and the codebook spread as in ``tests/test_torch_vqvae.py``,
    on the first images whose latent keeps every nearest code 1e-3 ahead)."""
    cfg = dict(VAE_KW, num_embeddings=16)
    kw = dict(TRAINER_KW, flavor="vqvae", embedding_loss_weight=1.0)
    jvq = jax_le.VQVAE(**cfg)
    params = _spread(_randomize(jax.eval_shape(jvq.init, KEY, jnp.zeros((1, *SHAPE[1:])))[
        "params"], 3))
    encode = jax.jit(lambda x: jvq.apply({"params": params}, x, train=True,
                                         method=jvq.encode))
    codebook = np.asarray(params["quantizer"]["codebook"])
    x = next(x for x in map(_images, range(10))
             if _margin(np.asarray(encode(jnp.asarray(x))), codebook)[0].min() > 1e-3)
    jtrainer = JaxTrainer(autoencoder=jvq, perceiver=JaxLPIPS(), **kw)
    (loss, _), grads = jax.jit(jax.value_and_grad(jtrainer.loss, has_aux=True))(
        params, _lpips_params(), {"source": jnp.asarray(x)}, KEY)
    vq = VQVAE(**cfg)
    load_jax_params(vq, params, kind="vae")
    trainer = AutoencoderTrainer(vq, perceiver=_port_lpips(), **kw)
    got, _ = trainer.loss(nchw(x))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got.backward()
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), kind="vae")
    _close_tensors({k: p.grad for k, p in vq.named_parameters()}, want, what="grad")
    assert want["quantizer.embedder.weight"].abs().max() > 0


def test_adversarial_lambda_carries_the_perceiver(monkeypatch):
    """GAN on: the loss, lambda and the adversarial term (the lambda's rec
    gradient holds the LPIPS term) against JAX's ``generator_loss`` with
    the perceiver's params, and the out head's gradients; one pyramid level
    at 16^2, one discriminator."""
    kw = dict(VAE_KW, deep_supervision=0)
    x = _images()[:, :16, :16]
    noise = _fix_noise(monkeypatch, (2, 8, 8, 2))
    params = _randomize(jax.eval_shape(jax_le.VAE(**kw).init, {"params": KEY, "sample": KEY},
                                       jnp.zeros((1, 16, 16, 3)))["params"], 3)
    jdisc, disc_vars = _jax_discs("conv")
    disc_params, disc_stats = _split({"disc_0": disc_vars["disc_0"]})
    jtrainer = JaxAdversarialTrainer(
        ae_trainer=JaxTrainer(autoencoder=jax_le.VAE(**kw), perceiver=JaxLPIPS(), **TRAINER_KW),
        discriminator=jdisc, n_discriminators=1, start_gan_train_step=0)
    (loss, (metrics, *_)), grads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.generator_loss(p, disc_params, disc_stats, _lpips_params(),
                                          {"source": jnp.asarray(x)}, KEY, jnp.asarray(4)),
        has_aux=True))(params)
    from medfusion_tpu_torch.models import latent_embedders as le

    discs = torch.nn.ModuleList([le.Discriminator(**DISC_KW["conv"])])
    gen_sd, disc_sd = jax_gan_to_state_dicts(params, disc_params, disc_stats)
    discs.load_state_dict(disc_sd, strict=True)
    vae = VAE(**kw)
    vae.load_state_dict(gen_sd, strict=True)
    trainer = AdversarialTrainer(AutoencoderTrainer(vae, perceiver=_port_lpips(), **TRAINER_KW),
                                 discs.requires_grad_(False), start_gan_train_step=0)
    got, got_metrics, _, _ = trainer.generator_loss(nchw(x), nchw(noise), 4)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    lam = float(metrics["lambda_0"])
    assert 1e-3 < lam < 1e3
    np.testing.assert_allclose(float(got_metrics["lambda_0"]), lam, rtol=1e-5)
    np.testing.assert_allclose(float(got_metrics["gan_loss_0"]), float(metrics["gan_loss_0"]),
                               rtol=1e-5)
    got.backward()
    want = jax_gan_to_state_dicts(jax.tree_util.tree_map(np.asarray, grads), {})[0]
    heads = {k for k in want if k.startswith(HEADS)}
    assert heads
    _close_tensors({k: p.grad for k, p in vae.named_parameters() if k in heads},
                   {k: want[k] for k in heads}, what="head")
