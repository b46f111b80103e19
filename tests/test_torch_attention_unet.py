"""The port's UNet with attention against the JAX UNet, on the CPU in
float32, at the tolerances of ``tests/test_full_model_parity.py`` (rtol
3e-4 / atol 3e-5: float32 convs and projections summed in another order
through 20+ layers).

'spatial' and 'linear' run with the JAX flash-attention and fused-GEGLU
switches off and on; a counting spy shows which Pallas launchers the "on"
runs reached (the 'linear' UNet attends to one embedding token, so none).
The attention UNet's state-dict keys equal JAX ``to_torch_state_dict``'s,
and the UNet refuses an unknown attention type and a head count that does
not divide an attended width. Flax params are perturbed away from their
init, as in ``tests/test_torch_models.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.ops.geglu as jax_geglu
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.utils.torch_compat import to_torch_state_dict
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the package re-binds the name ``flash_attention`` to its wrapper function
jax_fa = importlib.import_module("medfusion_tpu.ops.flash_attention")
KEY = jax.random.PRNGKey(0)

UNET_CFGS = {
    # narrow: the parity test's shapes
    "narrow": dict(hid=(8, 16, 32), groups=4, shape=(2, 16, 16, 2), t_dim=32),
    # lane: self-attention over 32x32 = 1024 tokens (level 1) and 16x16 =
    # 256 tokens (level 2) at C = 128, 8 heads x d=16: the JAX head-layout
    # and token-layout Pallas kernels (hd % 128 == 0) and the fused GEGLU
    # kernel (C % 128 == 0) take these shapes
    "lane": dict(hid=(128, 128, 128), groups=32, shape=(2, 32, 32, 2), t_dim=32),
    # widths that 32 heads divide: 2 heads give d = 16 and 32, 32 heads d = 1
    # and 2 (the chest UNet's attn_heads 2 and 32 at narrow widths)
    "heads": dict(hid=(32, 32, 64), groups=4, shape=(2, 16, 16, 2), t_dim=32),
}


@pytest.fixture
def pallas_spy(monkeypatch):
    """Counts calls of the JAX package's Pallas attention and GEGLU
    launchers, by name."""
    calls = []
    for mod, name in ((jax_fa, "_fwd_call"), (jax_fa, "_fwd_mha_call"),
                      (jax_geglu, "_fused_call")):
        real = getattr(mod, name)

        def spy(*args, _n=name, _r=real, **kwargs):
            calls.append(_n)
            return _r(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    return calls


def _unet_kw(cfg, attention):
    c = UNET_CFGS[cfg]
    n = len(c["hid"])
    return dict(in_ch=c["shape"][-1], out_ch=c["shape"][-1], hid_chs=c["hid"],
                kernel_sizes=(3,) * n, strides=(1,) + (2,) * (n - 1),
                time_emb_dim=c["t_dim"], cond_emb_num_classes=2,
                norm_name=("GROUP", {"num_groups": c["groups"], "affine": True}),
                deep_supervision=0, use_attention=attention)


def _unet_pair(cfg, attention, seed=5, attn_heads=8):
    kw = dict(_unet_kw(cfg, attention), attn_heads=attn_heads)
    jax_unet = JaxUNet(**kw)
    shape = UNET_CFGS[cfg]["shape"]
    x0 = jnp.zeros((1,) + shape[1:], jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    params = _randomize(jax.eval_shape(jax_unet.init, KEY, x0, t0, t0)["params"], seed)
    unet = UNet(**kw)
    load_jax_params(unet, params, kind="unet")
    return jax_unet, params, unet.eval()


@pytest.mark.parametrize("attention,cfg,kernels", [
    ("spatial", "narrow", False),
    ("spatial", "lane", True),
    ("linear", "narrow", False),
    ("linear", "narrow", True),
], ids=["spatial-xla", "spatial-pallas", "linear-xla", "linear-kernels_on"])
def test_unet_with_attention_matches_jax(attention, cfg, kernels, pallas_spy):
    jax_ops.enable_flash_attention(kernels)
    jax_ops.enable_fused_geglu(kernels)
    jax_unet, params, unet = _unet_pair(cfg, attention)
    shape = UNET_CFGS[cfg]["shape"]
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    t = np.asarray([3, 7], np.int32)
    c = np.asarray([0, 1], np.int32)
    mask = np.asarray([0.0, 1.0], np.float32)
    y, _ = jax.jit(jax_unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(c), None, jnp.asarray(mask))
    if kernels and attention == "spatial":
        assert set(pallas_spy) == {"_fwd_call", "_fwd_mha_call", "_fused_call"}
    else:  # 'linear' attends to one embedding token: no kernel runs
        assert not pallas_spy
    with torch.no_grad():
        ty, _ = unet(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(c).long(),
                     torch.from_numpy(mask))
    assert np.abs(np.asarray(y)).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("kernels", [False, True], ids=["xla", "kernels_on"])
@pytest.mark.parametrize("heads", [2, 32])
def test_spatial_unet_matches_jax_at_other_head_counts(heads, kernels):
    """The spatial UNet at ``attn_heads`` 2 and 32 (head widths 16/32 and
    1/2 here; on the chest UNet 128-512 and 8-32) against the JAX UNet
    with its flash-attention and fused-GEGLU switches off and on, at the
    attention UNet's tolerances."""
    jax_ops.enable_flash_attention(kernels)
    jax_ops.enable_fused_geglu(kernels)
    jax_unet, params, unet = _unet_pair("heads", "spatial", attn_heads=heads)
    shape = UNET_CFGS["heads"]["shape"]
    x = np.random.default_rng(heads).standard_normal(shape).astype(np.float32)
    t = np.asarray([5, 9], np.int32)
    c = np.asarray([1, 0], np.int32)
    y, _ = jax.jit(jax_unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(c))
    with torch.no_grad():
        ty, _ = unet(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(c).long())
    assert np.abs(np.asarray(y)).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("attention", ["linear", "spatial"])
def test_attention_unet_state_dict_keys_match_jax_export(attention):
    _, params, unet = _unet_pair("narrow", attention)
    assert set(unet.state_dict()) == set(to_torch_state_dict(params, kind="unet"))
    sd = jax_params_to_state_dict(params, kind="unet")
    for k, v in unet.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_unet_rejects_unknown_attention_type():
    with pytest.raises(ValueError, match="use_attention"):
        UNet(**_unet_kw("narrow", "flash"))
    with pytest.raises(ValueError, match="use_attention"):
        UNet(**_unet_kw("narrow", ["none", "spatial"]))  # one per level: 3


def test_unet_rejects_heads_that_do_not_divide_a_level():
    with pytest.raises(ValueError, match="does not divide"):
        UNet(**_unet_kw("narrow", "spatial"), attn_heads=3)
    with pytest.raises(ValueError, match="attn_heads must be"):
        UNet(**_unet_kw("narrow", "spatial"), attn_heads=0)
    UNet(**_unet_kw("narrow", "none"), attn_heads=3)  # no attended level
    UNet(**_unet_kw("narrow", ["none", "none", "spatial"]), attn_heads=16)
