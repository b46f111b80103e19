"""The port's UNet and VAE against the JAX modules on the same weights.

Flax params are perturbed away from their init (the output convs are
zero-initialised, so unperturbed weights would make the comparison
vacuous), carried across with ``jax_params_to_state_dict`` and loaded with
``strict=True``. Both sides run in float32 on the CPU; the port's GroupNorm
takes its plain version there.

Each comparison runs with the JAX package's fused-GroupNorm switch off and
on. The JAX wrapper only reaches its Pallas kernel (in interpret mode on the
CPU) when C is a multiple of lcm(C/G, 128), so the switch-on cases use the
"lane" configurations, with widths of 128 and 256; a counting spy shows the
kernel was really reached (and not reached with the switch off). The narrow
configurations are those of ``tests/test_full_model_parity.py``.

Tolerances are those of ``tests/test_full_model_parity.py``: UNet rtol 2e-4 /
atol 2e-5, VAE rtol 1e-4 / atol 1e-5 (float32 convs summed in another order
by XLA and by PyTorch, through 20+ layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.ops.group_norm as jax_gn
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.models.latent_embedders import VAE as JaxVAE
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu_torch.models.latent_embedders import VAE
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params

KEY = jax.random.PRNGKey(0)

UNET_CFGS = {
    "narrow": dict(hid=(8, 16, 32), groups=4, shape=(2, 16, 16, 2), t_dim=32),
    "lane": dict(hid=(128, 128, 256), groups=32, shape=(2, 8, 8, 4), t_dim=32),
}
VAE_CFGS = {
    "narrow": dict(hid=(4, 8, 16), groups=2, shape=(2, 16, 16, 1), emb=2),
    "lane": dict(hid=(128, 128), groups=8, shape=(2, 16, 16, 3), emb=4),
}


def _randomize(shapes, seed):
    """Every leaf of the param tree replaced by N(0, s^2) draws (numpy):
    s = 0.2 for vectors, and for kernels min(0.2, fan_in^-1/2), so that the
    wide configurations keep activations of order one."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)

    def draw(shape):
        std = 0.2 if len(shape) < 2 else min(0.2, float(np.prod(shape[:-1])) ** -0.5)
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_unflatten(treedef, [draw(l.shape) for l in leaves])


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


@pytest.fixture
def pallas_spy(monkeypatch):
    """Counts calls of the JAX package's Pallas GroupNorm launcher."""
    calls = []
    real = jax_gn._pallas_group_norm_silu

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_gn, "_pallas_group_norm_silu", spy)
    return calls


def _expect_kernel(pallas_spy, fused):
    if fused:
        assert pallas_spy, "the JAX Pallas GroupNorm kernel was not reached"
    else:
        assert not pallas_spy


def build_unet_pair(cfg, seed=3, ds=1, use_res_block=True):
    c = UNET_CFGS[cfg]
    n = len(c["hid"])
    kw = dict(in_ch=c["shape"][-1], out_ch=c["shape"][-1], hid_chs=c["hid"],
              kernel_sizes=(3,) * n, strides=(1,) + (2,) * (n - 1),
              time_emb_dim=c["t_dim"], cond_emb_num_classes=2,
              norm_name=("GROUP", {"num_groups": c["groups"], "affine": True}),
              deep_supervision=ds, use_attention="none",
              use_res_block=use_res_block)
    jax_unet = JaxUNet(**kw)
    x0 = jnp.zeros((1,) + c["shape"][1:], jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    params = _randomize(jax.eval_shape(jax_unet.init, KEY, x0, t0, t0)["params"], seed)
    unet = UNet(**kw)
    load_jax_params(unet, params, kind="unet")
    return jax_unet, params, unet.eval()


def build_vae_pair(cfg, seed=1, ds=1):
    c = VAE_CFGS[cfg]
    n = len(c["hid"])
    kw = dict(in_channels=c["shape"][-1], out_channels=c["shape"][-1],
              emb_channels=c["emb"], hid_chs=c["hid"], kernel_sizes=(3,) * n,
              strides=(1,) + (2,) * (n - 1), deep_supervision=ds,
              norm_name=("GROUP", {"num_groups": c["groups"], "affine": True}))
    jax_vae = JaxVAE(**kw)
    x0 = jnp.zeros((1,) + c["shape"][1:], jnp.float32)
    params = _randomize(jax.eval_shape(
        jax_vae.init, {"params": KEY, "sample": KEY}, x0)["params"], seed)
    vae = VAE(**kw)
    load_jax_params(vae, params, kind="vae")
    return jax_vae, params, vae.eval()


@pytest.mark.parametrize("cfg,fused,use_res_block", [
    ("narrow", False, True),
    ("narrow", False, False),  # UnetBasicBlock stages
    ("lane", False, True),
    ("lane", True, True),
], ids=["narrow-xla_gn", "narrow-basic_blocks", "lane-xla_gn", "lane-pallas_gn"])
def test_unet_matches_jax(cfg, fused, use_res_block, pallas_spy):
    jax_ops.enable_fused_group_norm(fused)
    jax_unet, params, unet = build_unet_pair(cfg, use_res_block=use_res_block)
    shape = UNET_CFGS[cfg]["shape"]
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    t = np.asarray([3, 7], np.int32)
    c = np.asarray([0, 1], np.int32)
    mask = np.asarray([0.0, 1.0], np.float32)  # CFG's zeroed label embedding
    y, y_ver = jax.jit(jax_unet.apply)({"params": params}, jnp.asarray(x),
                                       jnp.asarray(t), jnp.asarray(c), None,
                                       jnp.asarray(mask))
    _expect_kernel(pallas_spy, fused)
    with torch.no_grad():
        ty, ty_ver = unet(nchw(x), torch.from_numpy(t).long(),
                          torch.from_numpy(c).long(), torch.from_numpy(mask))
    assert np.abs(np.asarray(y)).max() > 1e-2  # not the zero-init output
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), rtol=2e-4, atol=2e-5)
    assert len(y_ver) == len(ty_ver) == 1
    np.testing.assert_allclose(nhwc(ty_ver[0]), np.asarray(y_ver[0]),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("cfg,fused", [("narrow", False), ("lane", False), ("lane", True)],
                         ids=["narrow-xla_gn", "lane-xla_gn", "lane-pallas_gn"])
def test_vae_matches_jax(cfg, fused, pallas_spy):
    jax_ops.enable_fused_group_norm(fused)
    jax_vae, params, vae = build_vae_pair(cfg)
    shape = VAE_CFGS[cfg]["shape"]
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    # encode on the mean path
    apply = jax.jit(jax_vae.apply, static_argnames=("sample", "method"))
    z = apply({"params": params}, jnp.asarray(x), sample=False,
              method=jax_vae.encode)
    # decode a latent of unit scale, and the deep-supervision head
    zr = np.random.default_rng(4).standard_normal(z.shape).astype(np.float32)
    dec = apply({"params": params}, jnp.asarray(zr), method=jax_vae.decode)
    pred, pred_ver, _ = apply({"params": params}, jnp.asarray(x), sample=False)
    _expect_kernel(pallas_spy, fused)
    with torch.no_grad():
        tz = vae.encode(nchw(x), sample=False)
        tdec = vae.decode(nchw(zr))
        tpred, tver = vae.decode_with_vertical(tz)
    np.testing.assert_allclose(nhwc(tz), np.asarray(z), rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(dec)).max() > 1e-2
    np.testing.assert_allclose(nhwc(tdec), np.asarray(dec), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(tpred), np.asarray(pred), rtol=1e-4, atol=1e-5)
    assert len(pred_ver) == len(tver) == 1
    np.testing.assert_allclose(nhwc(tver[0]), np.asarray(pred_ver[0]),
                               rtol=1e-4, atol=1e-5)


def test_state_dict_keys_cover_the_module():
    """The carried state dict names exactly the port's parameters."""
    _, params, unet = build_unet_pair("narrow", ds=0)
    sd = jax_params_to_state_dict(params, kind="unet")
    assert set(sd) == set(unet.state_dict())
    for k, v in unet.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_unet_rejects_attention():
    with pytest.raises(NotImplementedError, match="second slice"):
        UNet(in_ch=2, out_ch=2, hid_chs=(8, 16), kernel_sizes=(3, 3),
             strides=(1, 2), use_attention="linear",
             norm_name=("GROUP", {"num_groups": 4}))
