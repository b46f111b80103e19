"""The port's 3-D (volumetric) models and data against the JAX package on
the CPU: the modules of ``tests/test_3d.py`` at ``spatial_dims=3`` on
[B, C, D, H, W] (the JAX side channels-last [B, D, H, W, C]).

* The VAE and VQVAE (forward, encode, decode; the VAE's draw injected into
  the JAX reparameterisation), both discriminators (the PatchGAN's 3-D
  BatchNorm in train mode), the UNet with each attention, the legacy UNet
  and the OpenAI UNet with its 3-D rules (upsampling and average pooling of
  the inner two dims, conv downsampling at stride (1, 2, 2)).
* The autoencoder step's loss and gradients (SSIM on volumes).
* DDIM on a 3-D latent with the JAX draws injected.
* The NIfTI reader and writer against the JAX package's, and
  ``SimpleDataset3D`` items against the JAX dataset's for one seed.
* GroupNorm's plain version on 5-D tensors, and the kernel's launch plan at
  the chest VAE's 3-D shapes (its partly resident cluster route).

Tolerances: the UNets rtol 2e-4 / atol 2e-5, the autoencoders and
discriminators 1e-4 / 1e-5, the denoise loop 1e-4 of the latent's scale,
gradients 2e-5 of each tensor's max (``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.data import datasets_3d as jax_ds3d
from medfusion_tpu.data import nifti as jax_nifti
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.models.unet_legacy import UNetLegacy as JaxLegacy
from medfusion_tpu.models.unet_openai import UNetOpenAI as JaxOpenAI
from medfusion_tpu.ops.group_norm import group_norm_silu_reference as jax_gn_reference
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.data import nifti
from medfusion_tpu_torch.data.datasets_3d import SimpleDataset3D, crop_or_pad
from medfusion_tpu_torch.models import latent_embedders as le
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.models.unet_legacy import UNetLegacy
from medfusion_tpu_torch.models.unet_openai import UNetOpenAI
from medfusion_tpu_torch.ops import group_norm as G
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer
from medfusion_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    jax_variables_to_state_dict,
    load_jax_params,
)
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_pipeline import _assert_close, _jax_noise
from tests.test_torch_train import _close_tensors
from tests.test_torch_vqvae import _margin, _spread

KEY = jax.random.PRNGKey(0)
UNET_TOL = dict(rtol=2e-4, atol=2e-5)
AE_TOL = dict(rtol=1e-4, atol=1e-5)
GN2 = ("GROUP", {"num_groups": 2, "affine": True})
AE_KW = dict(in_channels=1, out_channels=1, spatial_dims=3, emb_channels=2, hid_chs=(4, 8),
             strides=(1, 2), kernel_sizes=(3, 3), norm_name=GN2)
VOL = (2, 8, 8, 8, 1)
LATENT = (2, 4, 4, 4, 2)
T_IN = np.array([3, 17], np.int32)
COND = np.array([0, 1], np.int32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_ops.enable_fused_group_norm(False)
    yield
    torch.set_num_threads(n)


def _vol(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _params(jm, seed, *args, **kwargs):
    shapes = jax.eval_shape(jm.init, {"params": KEY, "sample": KEY, "dropout": KEY},
                            *args, **kwargs)
    return _randomize(shapes["params"], seed)


@pytest.fixture
def fixed_noise(monkeypatch):
    """The JAX VAE's reparameterisation with a fixed numpy draw."""
    noise = np.random.default_rng(9).standard_normal(LATENT).astype(np.float32)

    def diagonal_gaussian(x, rng, sample=True):
        mean, logvar = jnp.split(x, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        z = mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise) if sample else mean
        kl = 0.5 * jnp.sum(mean**2 + jnp.exp(logvar) - 1.0 - logvar) / x.shape[0]
        return z, kl

    monkeypatch.setattr(jax_le, "diagonal_gaussian", diagonal_gaussian)
    return noise


def _vae_pair(seed=3):
    jvae = jax_le.VAE(**AE_KW, deep_supervision=1)
    params = _params(jvae, seed, jnp.zeros(VOL, jnp.float32))
    vae = le.VAE(**AE_KW, deep_supervision=1)
    load_jax_params(vae, params, kind="vae")
    return jvae, params, vae


def _vq_pair(seed=3):
    cfg = dict(AE_KW, num_embeddings=16, deep_supervision=0)
    jvq = jax_le.VQVAE(**cfg)
    params = _spread(_params(jvq, seed, jnp.zeros(VOL, jnp.float32)))
    vq = le.VQVAE(**cfg)
    load_jax_params(vq, params, kind="vae")
    encode = jax.jit(lambda x: jvq.apply({"params": params}, x, train=True,
                                         method=jvq.encode))
    codebook = np.asarray(params["quantizer"]["codebook"])
    for s in range(10):  # volumes whose nearest codes are not near ties
        x = _vol(VOL, s)
        if _margin(np.asarray(encode(jnp.asarray(x))), codebook)[0].min() > 1e-3:
            return jvq, params, vq, x
    raise AssertionError("no draw keeps the margin")


def test_vae3d_matches_jax(fixed_noise):
    jvae, params, vae = _vae_pair()
    x = _vol(VOL)
    v = {"params": params}
    pred, pred_ver, kl = jvae.apply(v, jnp.asarray(x), train=True, rngs={"sample": KEY})
    z = jvae.apply(v, jnp.asarray(x), method=jvae.encode, rngs={"sample": KEY})
    dec = jvae.apply(v, z, method=jvae.decode)
    with torch.no_grad():
        got, got_ver, got_kl = vae(nchw(x), nchw(fixed_noise))
        got_z = vae.encode(nchw(x), nchw(fixed_noise))
        got_dec = vae.decode(nchw(np.asarray(z)))
    assert got.shape == (2, 1, 8, 8, 8) and got_ver[0].shape == (2, 1, 4, 4, 4)
    for a, b in ((got, pred), (got_ver[0], pred_ver[0]), (got_z, z), (got_dec, dec)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), **AE_TOL)
    np.testing.assert_allclose(got_kl.item(), float(kl), rtol=1e-5)
    assert np.abs(np.asarray(pred_ver[0])).max() > 1e-2  # the heads are not zero


def test_vqvae3d_matches_jax():
    jvq, params, vq, x = _vq_pair()
    v = {"params": params}
    pred, _, emb_loss = jvq.apply(v, jnp.asarray(x), train=True)
    z = jvq.apply(v, jnp.asarray(x), train=True, method=jvq.encode)
    dec = jvq.apply(v, z, train=True, method=jvq.decode)
    with torch.no_grad():
        got, _, got_loss = vq(nchw(x))
        got_dec = vq.decode(vq.encode(nchw(x)))
    np.testing.assert_allclose(nhwc(got), np.asarray(pred), **AE_TOL)
    np.testing.assert_allclose(nhwc(got_dec), np.asarray(dec), **AE_TOL)
    np.testing.assert_allclose(got_loss.item(), float(emb_loss), rtol=1e-4)


@pytest.mark.parametrize("flavor", ["vae", "vqvae"])
def test_autoencoder3d_step_gradients_match_jax(flavor, fixed_noise):
    """The AE train step's loss (L2 + SSIM on volumes + the KL or codebook
    term) and every parameter's gradient."""
    if flavor == "vae":
        jm, params, m = _vae_pair()
        x, noise = _vol(VOL), nchw(fixed_noise)
    else:
        jm, params, m, x = _vq_pair()
        noise = None
    kw = dict(flavor=flavor, pixel_loss="l2", embedding_loss_weight=1e-2)
    jtrainer = JaxTrainer(autoencoder=jm, **kw)

    def f(p):
        return jtrainer.loss(p, None, {"source": jnp.asarray(x)}, KEY)[0]

    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    got, _ = AutoencoderTrainer(m, **kw).loss(nchw(x), noise)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), kind="vae")
    _close_tensors({k: p.grad for k, p in m.named_parameters()}, ref, what="grad")


@pytest.mark.parametrize("kind", ["conv", "patch"])
def test_discriminators3d_match_jax(kind):
    """The GROUP-normed conv discriminator (test_3d's) and the PatchGAN,
    whose BATCH norms are ``nn.BatchNorm3d`` in train mode (the batch's
    statistics and the running buffers' update)."""
    x = _vol((2, 16, 16, 16, 1), seed=2)
    if kind == "conv":
        kw = dict(spatial_dims=3, hid_chs=(4, 8), kernel_sizes=(3, 3), strides=(1, 2),
                  norm_name=GN2)
        jd, d = jax_le.Discriminator(**kw), le.Discriminator(in_channels=1, **kw)
        params = _params(jd, 4, jnp.asarray(x))
        want = jd.apply({"params": params}, jnp.asarray(x))
        load_jax_params(d, params, kind="vae")
        stats = None
    else:
        kw = dict(spatial_dims=3, hid_chs=(4, 8, 8), kernel_sizes=(4, 4, 4), strides=(2, 2, 1))
        jd, d = jax_le.NLayerDiscriminator(**kw), le.NLayerDiscriminator(in_channels=1, **kw)
        shapes = jax.eval_shape(lambda x: jd.init(KEY, x, train=True), jnp.asarray(x))
        params = _randomize(shapes["params"], 4)
        init_stats = jax.tree_util.tree_map_with_path(  # flax's: mean 0, var 1
            lambda path, leaf: np.full(leaf.shape, path[-1].key == "var", np.float32),
            shapes["batch_stats"])
        want, upd = jax.jit(lambda v, x: jd.apply(v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": init_stats}, jnp.asarray(x))
        d.load_state_dict(jax_variables_to_state_dict(
            {"params": params, "batch_stats": init_stats}), strict=True)
        assert isinstance(d.encoder[0].norm, torch.nn.BatchNorm3d)
        stats = upd["batch_stats"]
    d.train()
    with torch.no_grad():
        got = d(nchw(x))
    assert np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **AE_TOL)
    if stats is not None:  # the running means (torch's running_var is unbiased)
        want_sd = jax_variables_to_state_dict({"params": params, "batch_stats": stats})
        for k, v in d.state_dict().items():
            if k.endswith("running_mean"):
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), **AE_TOL)


def _unet_kw(attention):
    return dict(in_ch=2, out_ch=2, spatial_dims=3, hid_chs=(8, 16), kernel_sizes=(3, 3),
                strides=(1, 2), time_emb_dim=16, cond_emb_num_classes=2, deep_supervision=0,
                use_attention=attention, norm_name=GN2)


def _unet_inputs():
    return _vol(LATENT, seed=3), jnp.asarray(T_IN), jnp.asarray(COND)


@pytest.mark.parametrize("attention", ["none", "linear", "spatial"])
def test_unet3d_matches_jax(attention):
    """The UNet on a 3-D latent; its attention over D*H*W tokens."""
    jm = JaxUNet(**_unet_kw(attention))
    z, t, c = _unet_inputs()
    params = _params(jm, 5, jnp.asarray(z), t, c)
    want, _ = jm.apply({"params": params}, jnp.asarray(z), t, c)
    m = UNet(**_unet_kw(attention))
    load_jax_params(m, params, kind="unet")
    with torch.no_grad():
        got, ver = m(nchw(z), torch.from_numpy(T_IN).long(), torch.from_numpy(COND).long())
    assert ver == [] and np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **UNET_TOL)


def test_unet_legacy3d_matches_jax():
    kw = _unet_kw("none")
    jm = JaxLegacy(**kw)
    z, t, c = _unet_inputs()
    params = _params(jm, 6, jnp.asarray(z), t, c)
    want, _ = jm.apply({"params": params}, jnp.asarray(z), t, c)
    m = UNetLegacy(**kw)
    load_jax_params(m, params, kind="unet_legacy")
    with torch.no_grad():
        got, _ = m(nchw(z), torch.from_numpy(T_IN).long(), torch.from_numpy(COND).long())
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **UNET_TOL)


OPENAI_CASES = {
    "conv-updown": dict(conv_resample=True, resblock_updown=False),
    "pool-updown": dict(conv_resample=False, resblock_updown=False),
    "resblock-updown": dict(resblock_updown=True, use_scale_shift_norm=True),
}


@pytest.mark.parametrize("case", sorted(OPENAI_CASES))
def test_openai3d_matches_jax(case):
    """The OpenAI UNet at ``spatial_dims=3``: D stays 4 through both levels
    (its 3-D rules act on H and W only), attention at the second level."""
    kw = dict(in_channels=2, model_channels=8, out_channels=2, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), spatial_dims=3,
              num_classes=2, num_heads=2, norm_groups=4, **OPENAI_CASES[case])
    jm = JaxOpenAI(**kw)
    z = _vol((2, 4, 8, 8, 2), seed=7)
    t, c = jnp.asarray(T_IN), jnp.asarray(COND)
    params = _params(jm, 8, jnp.asarray(z), t, c)
    want, _ = jm.apply({"params": params}, jnp.asarray(z), t, c)
    m = UNetOpenAI(**kw)
    load_jax_params(m, params, kind="openai")
    with torch.no_grad():
        h = m.input_blocks[0](nchw(z), None)
        for block in m.input_blocks[1:]:
            h = m._run(block, h, m.time_embed(torch.zeros(2, 8)), None)
        assert tuple(h.shape[2:]) == (4, 4, 4)  # (1, 2, 2) downsampling
        got, _ = m(nchw(z), torch.from_numpy(T_IN).long(), torch.from_numpy(COND).long())
    assert got.shape == (2, 2, 4, 8, 8) and np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **UNET_TOL)


def test_ddim3d_matches_jax():
    """DDIM (eta 1, CFG 4) over a 3-D latent with the JAX draws injected."""
    steps = 4
    jm = JaxUNet(**_unet_kw("none"))
    z, t, c = _unet_inputs()
    params = _params(jm, 5, jnp.asarray(z), t, c)
    jsched = JaxSchedule.create(timesteps=10, schedule_strategy="linear")
    jpipe = JaxPipeline(scheduler=jsched, noise_estimator=jm, latent_embedder=None,
                        do_input_centering=False)
    m = UNet(**_unet_kw("none"))
    load_jax_params(m, params, kind="unet")
    sched = GaussianDiffusionSchedule.create(timesteps=10, schedule_strategy="linear")
    pipe = DiffusionPipeline(scheduler=sched, noise_estimator=m.eval(), latent_embedder=None,
                             do_input_centering=False)
    x_T = _vol(LATENT, seed=11) * 2
    rng = jax.random.PRNGKey(4)
    want = jpipe.denoise({"noise_estimator": params}, jnp.asarray(x_T), rng, condition=c,
                         steps=steps, use_ddim=True, eta=1.0, guidance_scale=4.0)
    got = pipe.denoise(torch.from_numpy(x_T), condition=torch.from_numpy(COND).long(),
                       steps=steps, use_ddim=True, eta=1.0, guidance_scale=4.0,
                       noise=torch.from_numpy(_jax_noise(rng, steps, LATENT)))
    assert got.shape == LATENT
    _assert_close(got.numpy(), np.asarray(want), 1e-4)


def test_group_norm_reference_5d_and_3d_vae_launch_plan():
    """Kernel 1's plain version on [B, C, D, H, W] against the JAX package's
    reference, and the launch plan at the chest VAE's 3-D GroupNorm shapes
    (8 groups, a 64x128x128 volume): the widest level's group of 8.4 M
    elements takes the cluster route, partly resident."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 5, 8)).astype(np.float32)  # channels-last
    scale, bias = rng.standard_normal((2, 8)).astype(np.float32)
    for silu in (False, True):
        want = jax_gn_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4,
                                1e-5, silu)
        got = G.group_norm_silu(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), 4,
                                1e-5, apply_silu=silu)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    plans = {c: G.launch_plan(2, c, 64 * 128 * 128 // (c // 64) ** 3, 8, torch.float32)
             for c in (64, 128, 256, 512)}
    big = plans[64]
    assert big["n"] == 8 * 64 * 128 * 128 and big["route"] == "cluster"
    assert big["cluster"] == G.MAX_CLUSTER and big["resident"] < big["slice"]
    assert all(p["route"] == "cluster" for p in plans.values())


def test_nifti_roundtrip_matches_jax(tmp_path):
    """The port's writer read by the JAX reader and the other way round,
    plain and gzipped, and the header's scaling applied as JAX applies it."""
    rng = np.random.default_rng(1)
    vol = rng.integers(-300, 300, (5, 6, 7)).astype(np.int16)
    for name in ("a.nii", "b.nii.gz"):
        nifti.write_nifti(tmp_path / f"port-{name}", vol, pixdim=(1.5, 1.0, 2.0))
        jax_nifti.write_nifti(tmp_path / f"jax-{name}", vol, pixdim=(1.5, 1.0, 2.0))
        for src in ("port", "jax"):
            got, hdr = nifti.read_nifti(tmp_path / f"{src}-{name}", with_header=True)
            want, jhdr = jax_nifti.read_nifti(tmp_path / f"{src}-{name}", with_header=True)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, vol)
            assert hdr == jhdr
        assert (tmp_path / f"port-{name}").read_bytes() == (tmp_path / f"jax-{name}").read_bytes() \
            or name.endswith(".gz")  # gzip stamps the time
    nifti.write_nifti(tmp_path / "s.nii.gz", vol, scl_slope=0.5, scl_inter=-3.0)
    got = nifti.read_nifti(tmp_path / "s.nii.gz")
    np.testing.assert_array_equal(got, jax_nifti.read_nifti(tmp_path / "s.nii.gz"))
    np.testing.assert_allclose(got, vol * 0.5 - 3.0)
    with pytest.raises(ValueError, match="NIfTI"):
        (tmp_path / "bad.nii").write_bytes(b"\0" * 400)
        nifti.read_nifti(tmp_path / "bad.nii")


@pytest.mark.parametrize("ext", ["npy", "nii.gz"])
def test_simple_dataset3d_matches_jax(tmp_path, ext):
    rng = np.random.default_rng(2)
    for i, shape in enumerate([(10, 12, 9), (7, 12, 14), (9, 9, 9)]):
        vol = rng.standard_normal(shape).astype(np.float32) * 100
        if ext == "npy":
            np.save(tmp_path / f"v{i}.npy", vol)
        else:
            nifti.write_nifti(tmp_path / f"v{i}.nii.gz", vol)
    for kw in (dict(image_resize=(8, 10, 12), flip=True, image_crop=(6, None, 14)),
               dict(flip=True, use_znorm=False)):
        port = SimpleDataset3D(tmp_path, crawler_ext=ext, seed=5, **kw)
        ref = jax_ds3d.SimpleDataset3D(tmp_path, crawler_ext=ext, seed=5, **kw)
        assert len(port) == len(ref) == 3
        for i in range(3):
            a, b = port[i], ref[i]
            assert a["uid"] == b["uid"]
            np.testing.assert_allclose(a["source"], b["source"], rtol=1e-6, atol=1e-6)
    vol = rng.standard_normal((3, 5, 4, 1))
    np.testing.assert_array_equal(crop_or_pad(vol, (5, 3, None)),
                                  jax_ds3d.crop_or_pad(vol, (5, 3, None)))


def test_vae3d_pipeline_decode_shapes():
    """A 3-D latent pipeline's decode through the VAE: [B, D, H, W, C]."""
    _, _, vae = _vae_pair()
    sched = GaussianDiffusionSchedule.create(timesteps=10, schedule_strategy="linear")
    m = UNet(**dict(_unet_kw("none"), in_ch=2, out_ch=2))
    pipe = DiffusionPipeline(scheduler=sched, noise_estimator=m.eval(), latent_embedder=vae,
                             do_input_centering=False)
    pipe = dataclasses.replace(pipe, clip_x0=False)
    out = pipe.sample(2, LATENT[1:], condition=torch.from_numpy(COND).long(), steps=2,
                      use_ddim=True, eta=0.0, generator=torch.Generator().manual_seed(0))
    assert out.shape == VOL and torch.isfinite(out).all()
