"""The port's VQVAE family and the autoencoders' attention blocks against the
JAX package, on the CPU.

* ``VectorQuantizer``: the code indices equal, z_q and the loss at 1e-6,
  and the straight-through gradients (into z and into the codebook) at
  1e-6. The inputs sit near the codes so that the nearest code beats the
  second-nearest by more than 1e-3 (asserted): XLA and PyTorch sum the
  distances in other orders, which could flip a closer race. The codebook's
  init is U(-1/K, 1/K).
* ``VQVAE`` (hid 4, 8, one deep-supervision head, 16^2 RGB, perturbed flax
  params, a codebook of 16): ``encode``, ``decode`` and the training forward
  at the VAE's rtol 1e-4 / atol 1e-5, with the code indices of the port's
  latent equal to those of JAX's; the 'vqvae' flavour's loss and metrics at
  rtol 1e-5, and two Adam steps' losses. The out-encoder and the codebook are
  scaled by 10 (latents of order 5, codes 2 apart), and the images are the
  first seeded draw whose latent keeps the 1e-3 margin at every position.
* The VAE and the VQVAE with 'linear' and 'spatial' attention in their down
  and up blocks (hid 8, 16: 8 heads of 1 and 2 channels) at the attention
  UNet's rtol 3e-4 / atol 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu.train import TrainState as JaxTrainState
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu.train.autoencoder import make_autoencoder_train_step as jax_make_step
from medfusion_tpu_torch.models import latent_embedders as le
from medfusion_tpu_torch.train import TrainState
from medfusion_tpu_torch.train.autoencoder import (
    AutoencoderTrainer,
    make_autoencoder_train_step,
)
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEY = jax.random.PRNGKey(0)
K = 16
VQ_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(4, 8),
             kernel_sizes=(3, 3), strides=(1, 2), deep_supervision=1,
             norm_name=("GROUP", {"num_groups": 2, "affine": True}), num_embeddings=K)
SHAPE = (2, 16, 16, 3)


def _images(seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, SHAPE).astype(np.float32)


def _images_with_margin(jvq, params):
    """The first images of seeds 0, 1, ... whose JAX latent has every
    position's nearest code ahead of the second by more than 1e-3."""
    encode = jax.jit(lambda x: jvq.apply({"params": params}, x, train=True,
                                         method=jvq.encode))
    codebook = np.asarray(params["quantizer"]["codebook"])
    for seed in range(10):
        x = _images(seed)
        if _margin(np.asarray(encode(jnp.asarray(x))), codebook)[0].min() > 1e-3:
            return x
    raise AssertionError("no draw keeps the margin")


def _spread(params):
    """The out-encoder and the codebook scaled by 10."""
    params = dict(params)
    params["out_enc"] = jax.tree_util.tree_map(lambda a: 10 * a, params["out_enc"])
    params["quantizer"] = {"codebook": 10 * params["quantizer"]["codebook"]}
    return params


def _margin(z, codebook):
    """Per position, the second-nearest code's squared distance minus the
    nearest's (float64), and the nearest's index."""
    flat = z.reshape(-1, z.shape[-1]).astype(np.float64)
    d = ((flat[:, None, :] - codebook[None].astype(np.float64)) ** 2).sum(-1)
    part = np.sort(d, axis=1)
    return part[:, 1] - part[:, 0], d.argmin(1)


def test_vector_quantizer_matches_jax():
    rng = np.random.default_rng(0)
    codebook = rng.standard_normal((K, 4)).astype(np.float32)
    idx = rng.integers(0, K, (2, 5, 6))
    z = (codebook[idx] + 0.1 * rng.standard_normal((2, 5, 6, 4))).astype(np.float32)
    margin, nearest = _margin(z, codebook)
    assert margin.min() > 1e-3
    r = rng.standard_normal(z.shape).astype(np.float32)

    jq = jax_le.VectorQuantizer(num_embeddings=K, emb_channels=4)
    params = {"params": {"codebook": jnp.asarray(codebook)}}

    def f(z, params):
        z_q, loss = jq.apply(params, z)
        return jnp.sum(z_q * jnp.asarray(r)) + 3.0 * loss, (z_q, loss)

    (_, (z_q, loss)), (gz, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), params)

    q = le.VectorQuantizer(K, 4)
    q.embedder.weight.data.copy_(torch.from_numpy(codebook))
    zt = nchw(z).requires_grad_(True)
    np.testing.assert_array_equal(q.nearest(zt).numpy(), nearest)
    got_q, got_loss = q(zt)
    (got_q * nchw(r)).sum().add(3.0 * got_loss).backward()
    np.testing.assert_allclose(nhwc(got_q.detach()), np.asarray(z_q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-6)
    np.testing.assert_allclose(nhwc(zt.grad), np.asarray(gz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(q.embedder.weight.grad.numpy(),
                               np.asarray(gp["params"]["codebook"]), rtol=1e-6, atol=1e-6)


def test_vector_quantizer_init_and_keys():
    torch.manual_seed(0)
    vq = le.VQVAE(**VQ_KW)
    w = vq.quantizer.embedder.weight
    assert w.shape == (K, 2) and w.abs().max() <= 1.0 / K and w.std() > 0.2 / K
    assert {"quantizer.embedder.weight", "out_enc.conv.weight"} <= set(vq.state_dict())


def _vq_pair(seed=3, **kw):
    cfg = {**VQ_KW, **kw}
    jvq = jax_le.VQVAE(**cfg)
    x0 = jnp.zeros((1, *SHAPE[1:]), jnp.float32)
    params = _spread(_randomize(jax.eval_shape(jvq.init, KEY, x0)["params"], seed))
    vq = le.VQVAE(**cfg)
    load_jax_params(vq, params, kind="vae")
    return jvq, params, vq


def test_vqvae_matches_jax():
    jvq, params, vq = _vq_pair()
    x = _images_with_margin(jvq, params)
    variables = {"params": params}
    z = jvq.apply(variables, jnp.asarray(x), train=True, method=jvq.encode)
    pred, pred_ver, emb_loss = jvq.apply(variables, jnp.asarray(x), train=True)
    dec = jvq.apply(variables, z, train=True, method=jvq.decode)
    with torch.no_grad():
        got_z = vq.encode(nchw(x))
        got, got_ver, got_loss = vq(nchw(x))
        got_dec = vq.decode(nchw(np.asarray(z)))
    np.testing.assert_allclose(nhwc(got_z), np.asarray(z), rtol=1e-4, atol=1e-5)
    margin, nearest = _margin(np.asarray(z), np.asarray(params["quantizer"]["codebook"]))
    assert margin.min() > 1e-3
    np.testing.assert_array_equal(vq.quantizer.nearest(got_z).numpy(), nearest)
    assert len(set(nearest.tolist())) > 1
    for a, b in ((got, pred), (got_ver[0], pred_ver[0]), (got_dec, dec)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_loss.item(), float(emb_loss), rtol=1e-4)
    assert np.abs(np.asarray(pred_ver[0])).max() > 1e-2  # the heads are not zero


def test_vqvae_flavour_loss_and_step_match_jax():
    jvq, params, vq = _vq_pair()
    x = _images_with_margin(jvq, params)
    kw = dict(flavor="vqvae", pixel_loss="l2", embedding_loss_weight=1.0)
    loss, metrics = JaxTrainer(autoencoder=jvq, **kw).loss(
        params, None, {"source": jnp.asarray(x)}, KEY)
    trainer = AutoencoderTrainer(vq, **kw)
    got, got_metrics = trainer.loss(nchw(x))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert set(got_metrics) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_metrics[k]), float(v), rtol=1e-5,
                                   atol=1e-6 if k == "ssim" else 0, err_msg=k)
    # two Adam steps on the batch: the second step's loss is of the updated
    # weights, codebook included
    jstate = JaxTrainState.create(params, optax.adam(1e-4))
    jstep = jax_make_step(JaxTrainer(autoencoder=jvq, **kw))
    state = TrainState(vq, lr=1e-4, weight_decay=0.0)
    step = make_autoencoder_train_step(trainer)
    for _ in range(2):
        jstate, jm = jstep(jstate, None, {"source": jnp.asarray(x)}, KEY)
        m = step(state, {"source": torch.from_numpy(x)}, None)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["emb_loss"]), float(jm["emb_loss"]), rtol=1e-5)
    grad = vq.quantizer.embedder.weight.grad
    assert state.step == 2 and grad is not None and grad.abs().max() > 0


ATTN_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(8, 16),
               kernel_sizes=(3, 3), strides=(1, 2), deep_supervision=1,
               norm_name=("GROUP", {"num_groups": 2, "affine": True}))


@pytest.mark.parametrize("attention", ["linear", "spatial"])
@pytest.mark.parametrize("family", ["vae", "vqvae"])
def test_attention_autoencoders_match_jax(family, attention):
    x = _images()
    x0 = jnp.zeros((1, *SHAPE[1:]), jnp.float32)
    if family == "vae":
        jmod = jax_le.VAE(use_attention=attention, **ATTN_KW)
        params = _randomize(jax.eval_shape(jmod.init, {"params": KEY, "sample": KEY},
                                           x0)["params"], 4)
        mod = le.VAE(use_attention=attention, **ATTN_KW)
        want = jmod.apply({"params": params}, jnp.asarray(x), train=True, sample=False)
        run = lambda: mod(nchw(x), sample=False)  # noqa: E731
    else:
        jmod = jax_le.VQVAE(use_attention=attention, num_embeddings=K, **ATTN_KW)
        params = _spread(_randomize(jax.eval_shape(jmod.init, KEY, x0)["params"], 4))
        x = _images_with_margin(jmod, params)
        mod = le.VQVAE(use_attention=attention, num_embeddings=K, **ATTN_KW)
        want = jmod.apply({"params": params}, jnp.asarray(x), train=True)
        run = lambda: mod(nchw(x))  # noqa: E731
    sd = jax_params_to_state_dict(params, kind="vae")
    assert any(".attention.attention." in k for k in sd)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = run()
    for a, b in zip(got[:2], want[:2]):
        for p, q in zip([a] if isinstance(a, torch.Tensor) else a,
                        [b] if not isinstance(b, list) else b):
            np.testing.assert_allclose(nhwc(p), np.asarray(q), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=3e-4)
