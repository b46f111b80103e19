"""Non-learnable interpolation in the port against the JAX package on the
CPU: ``avg_pool_same`` (2-D and 3-D, MONAI padding, padding counted),
``pixel_shuffle`` / ``pixel_unshuffle``, ``BasicDown`` / ``BasicUp`` with
and without ``learnable_interpolation`` and ``use_res``, and the UNet, the
legacy UNet (its decoders concatenating their skips), the VAE (with the
autoencoders' ``dropout``) and the VQVAE built with
``learnable_interpolation=False``.

Flax params are perturbed away from init (``tests/test_torch_models.py::
_randomize``) and carried across by ``utils/weights.py::load_jax_params``
with ``strict=True``; the tensors cross at the boundary (NHWC on the JAX
side, NCHW here). The JAX side runs its plain GroupNorm and attention.
Tolerance: f32 rtol 1e-4 / atol 1e-5 (``tests/test_full_model_parity.py``);
the pixel shuffles, index gathers, bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.models.unet_legacy import UNetLegacy as JaxLegacy
from medfusion_tpu.nn import blocks as jax_blocks
from medfusion_tpu.nn import functional as jax_fn
from medfusion_tpu_torch.models import latent_embedders as le
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.models.unet_legacy import UNetLegacy
from medfusion_tpu_torch.nn import blocks
from medfusion_tpu_torch.nn import functional as FN
from medfusion_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_families import same_masks  # noqa: F401  (a fixture)
from tests.test_torch_models import _randomize, nchw, nhwc

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-5)
GN4 = ("GROUP", {"num_groups": 4, "affine": True})
T_IN = np.array([3, 17], np.int32)
COND = np.array([0, 1], np.int32)
MASK = np.array([1.0, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_ops.enable_fused_group_norm(False)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(jm, seed, *args, **kwargs):
    shapes = jax.eval_shape(jm.init, {"params": KEY, "sample": KEY, "dropout": KEY},
                            *args, **kwargs)
    return _randomize(shapes["params"], seed)


def _assert_live(want):
    assert np.abs(np.asarray(want)).max() > 1e-2  # not a zero-init head's output


# ---- functional ----------------------------------------------------------------


POOL_CASES = {
    "2d_k3_s2": ((2, 9, 10, 3), 3, 2),
    "2d_k2_s2": ((2, 8, 8, 3), 2, 2),
    "2d_k4_s2": ((1, 7, 6, 2), 4, 2),
    "2d_k3_s1x2": ((1, 6, 8, 2), 3, (1, 2)),
    "3d_k3_s2": ((2, 6, 8, 8, 3), 3, 2),
    "3d_k3_s122": ((1, 4, 8, 6, 2), 3, (1, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pool_same_matches_jax(case):
    """MONAI padding (k - s + 1) // 2 of zeros, counted in every mean."""
    shape, k, s = POOL_CASES[case]
    x = _x(shape, 1)
    want = jax_fn.avg_pool_same(jnp.asarray(x), k, s)
    got = FN.avg_pool_same(nchw(x), k, s)
    assert tuple(nhwc(got).shape) == tuple(want.shape)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_pixel_shuffles_match_jax_bit_for_bit():
    """Channel order (c r1 r2), as the JAX package's einops patterns."""
    x = _x((2, 8, 6, 3), 2)
    down = jax_blocks.pixel_unshuffle(jnp.asarray(x))
    got_down = blocks.pixel_unshuffle(nchw(x))
    np.testing.assert_array_equal(nhwc(got_down), np.asarray(down))
    up = jax_blocks.pixel_shuffle(down)
    got_up = blocks.pixel_shuffle(got_down)
    np.testing.assert_array_equal(nhwc(got_up), np.asarray(up))
    np.testing.assert_array_equal(nhwc(got_up), x)


# ---- BasicDown / BasicUp ---------------------------------------------------------


RESAMPLE_CASES = {  # (kind, learnable, use_res, in, out, kernel, stride)
    "down_learnable": ("down", True, False, 4, 8, 3, 2),
    "down_learnable_res": ("down", True, True, 2, 8, 3, 2),
    "down_pool": ("down", False, False, 4, 4, 3, 2),
    "down_pool_k2": ("down", False, False, 4, 4, 2, 2),
    "up_learnable": ("up", True, False, 8, 4, 2, 2),
    "up_learnable_res": ("up", True, True, 8, 2, 2, 2),
    "up_resize": ("up", False, False, 4, 4, 2, 2),
    "up_resize_k3": ("up", False, False, 4, 4, 3, 2),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_basic_down_and_up_match_jax(case):
    """The strided conv or the pool, the resize + conv or the resize alone,
    and ``use_res``'s pixel-(un)shuffle residual (2-D)."""
    kind, learnable, use_res, cin, cout, k, s = RESAMPLE_CASES[case]
    x = _x((2, 8, 8, cin), 3)
    cls, port_cls = ((jax_blocks.BasicDown, blocks.BasicDown) if kind == "down"
                     else (jax_blocks.BasicUp, blocks.BasicUp))
    jm = cls(2, cout, k, s, learnable, use_res)
    m = port_cls(2, cin, cout, k, s, learnable, use_res)
    if learnable:
        params = _params(jm, 4, jnp.asarray(x))
        want = jm.apply({"params": params}, jnp.asarray(x))
        load_jax_params(m, params, kind="vae")
    else:
        assert jm.init(KEY, jnp.asarray(x)) == {} and not list(m.parameters())
        want = jm.apply({}, jnp.asarray(x))
    with torch.no_grad():
        got = m(nchw(x))
    assert tuple(nhwc(got).shape) == tuple(want.shape)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


# ---- the models ------------------------------------------------------------------


def _unet_kw(**kw):
    return dict(in_ch=2, out_ch=2, hid_chs=(8, 16, 16), kernel_sizes=(3, 3, 3),
                strides=(1, 2, 2), time_emb_dim=16, cond_emb_num_classes=2,
                norm_name=GN4, learnable_interpolation=False, **kw)


@pytest.mark.parametrize("attention", ["none", "spatial"])
def test_unet_without_learnable_interpolation_matches_jax(attention):
    """Average-pooled encoder levels and resized decoder levels, no
    ``down_conv`` / ``up_conv`` leaves; deep supervision on."""
    kw = _unet_kw(use_attention=attention, deep_supervision=1)
    jm, m = JaxUNet(**kw), UNet(**kw)
    x = _x((2, 8, 8, 2), 5)
    params = _params(jm, 6, jnp.asarray(x), T_IN, COND)
    assert not any(k in str(jax.tree_util.tree_structure(params))
                   for k in ("down_conv", "up_conv"))
    load_jax_params(m, params, kind="unet")
    want, want_ver = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), T_IN, COND, None,
                                       MASK)
    with torch.no_grad():
        got, got_ver = m(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                         torch.from_numpy(MASK))
    _assert_live(want)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    assert len(got_ver) == len(want_ver) == 1
    np.testing.assert_allclose(nhwc(got_ver[0]), np.asarray(want_ver[0]), **TOL)


def _legacy_kw(**kw):
    return dict(in_ch=2, out_ch=2, hid_chs=(8, 16, 16), kernel_sizes=(1, 3, 3),
                strides=(1, 2, 2), time_emb_dim=16, cond_emb_num_classes=2,
                norm_name=GN4, learnable_interpolation=False, **kw)


@pytest.mark.parametrize("spatial_dims", [2, 3])
def test_legacy_unet_concatenates_its_skips_as_jax(spatial_dims):
    """The decoders concatenate the resized input and the skip (16 + 8 and
    16 + 16 channels) and attend at those widths (the spatial transformer's
    GroupNorm at 24 channels, C/G 6; the linear attention at 32); the
    deep-supervision heads read the decoder outputs."""
    kw = _legacy_kw(spatial_dims=spatial_dims, use_attention=["spatial", "linear", "none"],
                    deep_supervision=True)
    jm, m = JaxLegacy(**kw), UNetLegacy(**kw)
    x = _x((2,) + (8,) * spatial_dims + (2,), 7)
    params = _params(jm, 8, jnp.asarray(x), T_IN, COND)
    assert params["decoders_0"]["conv_block"]["block_0"]["basic_block"]["conv"]["conv"][
        "kernel"].shape[-2] == 24
    assert params["decoders_0"]["attention"]["attention"]["norm"]["norm"]["scale"].shape == (24,)
    load_jax_params(m, params, kind="unet_legacy")
    want, want_ver = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), T_IN, COND, None,
                                       MASK)
    with torch.no_grad():
        got, got_ver = m(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                         torch.from_numpy(MASK))
    _assert_live(want)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    assert len(got_ver) == len(want_ver) == 2
    for a, b in zip(got_ver, want_ver):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), **TOL)


AE_KW = dict(in_channels=2, out_channels=2, emb_channels=2, hid_chs=(8, 16, 16),
             kernel_sizes=(3, 3, 3), strides=(1, 2, 2), norm_name=GN4,
             learnable_interpolation=False, deep_supervision=1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_same_mask"])
def test_vae_without_learnable_interpolation_and_with_dropout_matches_jax(request, train):
    """The VAE's mean path (``sample=False``) through pooled encoders and
    resized decoders, ``dropout`` 0.3 in the down and up blocks; in train
    mode with the same dropout masks on both sides, which pins where the
    dropout sits."""
    if train:
        request.getfixturevalue("same_masks")
    kw = dict(AE_KW, use_attention=["none", "linear", "none"], dropout=0.3)
    jm, m = jax_le.VAE(**kw), le.VAE(**kw)
    x = _x((2, 8, 8, 2), 9)
    params = _params(jm, 10, jnp.asarray(x))
    load_jax_params(m, params, kind="vae")
    assert sum(isinstance(mod, torch.nn.Dropout) for mod in m.modules()) > 0
    want, want_ver, want_kl = jm.apply({"params": params}, jnp.asarray(x), train=train,
                                       sample=False, rngs={"dropout": KEY})
    m.train(train)
    with torch.no_grad():
        got, got_ver, got_kl = m(nchw(x), sample=False)
    _assert_live(want)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(nhwc(got_ver[0]), np.asarray(want_ver[0]), **TOL)
    np.testing.assert_allclose(got_kl.item(), float(want_kl), rtol=1e-4)
    if train:  # the masks were applied: the eval output differs
        plain, _, _ = jm.apply({"params": params}, jnp.asarray(x), sample=False)
        assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-3


def test_vqvae_without_learnable_interpolation_matches_jax():
    kw = dict(AE_KW, num_embeddings=8, deep_supervision=0)
    jm, m = jax_le.VQVAE(**kw), le.VQVAE(**kw)
    x = _x((2, 8, 8, 2), 11)
    params = _params(jm, 12, jnp.asarray(x))
    load_jax_params(m, params, kind="vae")
    want, _, want_loss = jm.apply({"params": params}, jnp.asarray(x), train=True)
    want_z = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got, _, got_loss = m(nchw(x))
        got_z = m.encode(nchw(x))
    np.testing.assert_allclose(nhwc(got_z), np.asarray(want_z), **TOL)
    _assert_live(want)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-4)
