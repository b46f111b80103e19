"""The port's other estimator families (legacy, OpenAI, lucidrains UNets),
the diffusers autoencoders, and the LAYER / INSTANCE / affine-free GROUP
norms and dropout of ``nn/blocks.py``, against the JAX package on the CPU.

Tiny configurations after ``tests/test_unet_{legacy,openai,lucidrains}.py``
and ``tests/test_latent_embedders_diffusers.py``; the flax params are
perturbed away from init (``tests/test_torch_models.py::_randomize``: the
zero-init output convs would make a comparison vacuous), carried across by
``utils/weights.py::load_jax_params`` and loaded with ``strict=True``. The
JAX side runs its plain GroupNorm and attention (the kernel switches off).

Dropout cannot share flax's RNG, so a dropout module is held to JAX in
eval mode (the identity of ``deterministic=True``), and in train mode with
the same mask injected on both sides (the mask a function of the tensor's
channels-last shape; flax's ``random.bernoulli`` and torch's
``F.dropout`` patched), which pins where the dropout sits; torch's own
dropout is held to its keep share and 1/(1 - p) scale.

Tolerances: the UNet families rtol 2e-4 / atol 2e-5, the autoencoders
1e-4 / 1e-5 (``tests/test_full_model_parity.py``).
"""

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import medfusion_tpu.models.latent_embedders_diffusers as jax_led
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.models.latent_embedders import Discriminator as JaxDiscriminator
from medfusion_tpu.models.unet_legacy import UNetLegacy as JaxLegacy
from medfusion_tpu.models.unet_lucidrains import UNetLucidrains as JaxLucid
from medfusion_tpu.models.unet_openai import UNetOpenAI as JaxOpenAI
from medfusion_tpu.nn import blocks as jax_blocks
from medfusion_tpu_torch.models import latent_embedders_diffusers as led
from medfusion_tpu_torch.models.latent_embedders import Discriminator
from medfusion_tpu_torch.models.unet_legacy import UNetLegacy
from medfusion_tpu_torch.models.unet_lucidrains import UNetLucidrains
from medfusion_tpu_torch.models.unet_openai import SDResBlock, UNetOpenAI
from medfusion_tpu_torch.nn import blocks
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc

KEY = jax.random.PRNGKey(0)
UNET_TOL = dict(rtol=2e-4, atol=2e-5)
AE_TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
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
    shapes = jax.eval_shape(jm.init, {"params": KEY, "sample": KEY}, *args, **kwargs)
    return _randomize(shapes["params"], seed)


# ---- the injected dropout mask ------------------------------------------------


def _mask(shape, keep):
    """The mask of a tensor whose channels-last shape is ``shape``, drawn in
    its memory order, so that [B, H, W, C] and its [B, H*W, C] tokens (the
    JAX transformer block's and the port's layouts) get the same one."""
    n = int(np.prod(shape))
    return (np.random.default_rng(n * 31 + shape[-1]).uniform(size=n) < keep).reshape(shape)


@pytest.fixture
def same_masks(monkeypatch):
    """flax's and torch's dropout with the same masks: a port tensor of 4
    dims is NCHW (its mask drawn NHWC and moved), of 3 dims [B, N, C]."""
    monkeypatch.setattr(flax_stochastic.random, "bernoulli",
                        lambda rng, p, shape: jnp.asarray(_mask(tuple(shape), p)))

    def dropout(x, p=0.5, training=True, inplace=False):
        if not training:
            return x
        shape = (x.shape[0], *x.shape[2:], x.shape[1]) if x.ndim == 4 else tuple(x.shape)
        m = torch.from_numpy(_mask(shape, 1 - p))
        if x.ndim == 4:
            m = m.movedim(-1, 1)
        return torch.where(m, x / (1 - p), torch.zeros_like(x))

    monkeypatch.setattr(F, "dropout", dropout)


# ---- norms and dropout of nn/blocks ---------------------------------------------


NORMS = {
    "layer": ("LAYER", {}),
    "instance": ("INSTANCE", {}),
    "instance_affine": ("INSTANCE", {"affine": True}),
    "group_no_affine": ("GROUP", {"num_groups": 4, "affine": False}),
    "group_eps": ("GROUP", {"num_groups": 2, "eps": 1e-3}),
}


@pytest.mark.parametrize("name", sorted(NORMS))
def test_norms_match_jax(name):
    norm = NORMS[name]
    jn = jax_blocks.Norm(norm, 8)
    x = _x((2, 5, 6, 8)) * 3 + 1
    variables = jn.init(KEY, jnp.asarray(x))
    params = _randomize(variables.get("params", {}), 1)
    want = jn.apply({"params": params} if params else {}, jnp.asarray(x))
    port = blocks.make_norm(norm, 8)
    sd = jax_params_to_state_dict({"norm": params} if params else {}, kind="vae")
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    assert (len(list(port.parameters())) == 2) == bool(params)
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dropout_keeps_its_share_and_scale():
    torch.manual_seed(0)
    blk = blocks.BasicBlock(2, 4, 16, 1, 1, ("GROUP", {"num_groups": 4}), "SWISH",
                            dropout=0.25)
    assert blk.norm.fuse_silu is False and blk.act is F.silu  # not fused under dropout
    drop = blk.drop.train()
    y = drop(torch.ones(200_000))
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.25) < 5e-3
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    x = torch.randn(2, 4, 6, 6)
    blk.eval()
    assert torch.equal(blk(x), blk(x))  # eval: the identity


def _legacy(dropout=0.0, **kw):
    kw = dict(in_ch=2, out_ch=2, hid_chs=(8, 16, 32), kernel_sizes=(1, 3, 3),
              strides=(1, 2, 2), time_emb_dim=32, cond_emb_num_classes=2,
              norm_name=("GROUP", {"num_groups": 4, "affine": True}), dropout=dropout, **kw)
    jm = JaxLegacy(**kw)
    x = _x((B, 8, 8, 2))
    params = _params(jm, 11, x, T_IN, COND)
    model = UNetLegacy(**kw)
    load_jax_params(model, params, kind="unet_legacy")
    return jm, params, model, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_same_mask"])
def test_dropout_position_matches_jax(request, train):
    """Dropout in the legacy UNet's encoders and decoders (BasicBlocks,
    the linear attention's out projection, the spatial transformer's
    attentions and its unfused GEGLU) and in the conv discriminator."""
    if train:
        request.getfixturevalue("same_masks")
    jm, params, model, x = _legacy(dropout=0.3, use_attention=["none", "linear", "spatial"],
                                   deep_supervision=False)
    rngs = {"dropout": KEY}
    y, _ = jm.apply({"params": params}, x, T_IN, COND, None, MASK, train=train, rngs=rngs)
    model.train(train)
    with torch.no_grad():
        ty, _ = model(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                      torch.from_numpy(MASK))
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)
    if train:  # the masks were applied: the eval output differs
        y_eval, _ = jm.apply({"params": params}, x, T_IN, COND, None, MASK)
        assert np.abs(np.asarray(y) - np.asarray(y_eval)).max() > 1e-3
    kw = dict(hid_chs=(4, 8), kernel_sizes=(3, 3), strides=(1, 2),
              norm_name=("GROUP", {"num_groups": 2, "affine": True}), dropout=0.3)
    jd = JaxDiscriminator(**kw)
    img = _x((B, 16, 16, 3), 5)
    dparams = _params(jd, 12, img)
    want = jd.apply({"params": dparams}, img, train=train, rngs=rngs)
    disc = Discriminator(**kw)
    load_jax_params(disc, dparams, kind="vae")
    disc.train(train)
    with torch.no_grad():
        got = disc(nchw(img))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **AE_TOL)


def test_openai_resblock_dropout_sits_before_the_last_conv(same_masks):
    """The JAX package's SDResBlock cannot build a Dropout in its setup-style
    __call__ (flax raises for dropout > 0), so the port's position is held
    to the block computed by hand: the mask before ``out_layers.3``."""
    torch.manual_seed(0)
    blk = SDResBlock(8, 16, 8, dropout=0.3, norm_groups=4).train()
    nn_init = torch.nn.init
    nn_init.normal_(blk.out_layers[3].weight, std=0.2)
    x, emb = torch.randn(2, 8, 6, 6), torch.randn(2, 16)
    with torch.no_grad():
        h = blk.in_layers(x) + blk.emb_layers(emb)[..., None, None]
        h = blk.out_layers[:2](h)
        want = x + blk.out_layers[3](F.dropout(h, 0.3, True))
        got = blk(x, emb)
        blk.eval()
        plain = blk(x, emb)
    torch.testing.assert_close(got, want)
    assert (got - plain).abs().max() > 1e-3


# ---- the legacy UNet ------------------------------------------------------------


LEGACY_CASES = {
    "deep_supervision": dict(deep_supervision=True),
    "variance_self_cond": dict(estimate_variance=True, use_self_conditioning=True,
                               deep_supervision=0),
    "attention": dict(use_attention=["none", "linear", "spatial"], deep_supervision=1),
    "basic_blocks": dict(use_res_block=False, deep_supervision=0),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_unet_matches_jax(case):
    kw = LEGACY_CASES[case]
    jm, params, model, x = _legacy(**kw)
    sc = _x(x.shape, 3) if kw.get("use_self_conditioning") else None
    y, y_ver = jax.jit(jm.apply)({"params": params}, x, T_IN, COND, sc, MASK)
    with torch.no_grad():
        ty, ty_ver = model(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                           torch.from_numpy(MASK), None if sc is None else nchw(sc))
    assert np.abs(np.asarray(y)).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)
    assert len(ty_ver) == len(y_ver)
    for a, b in zip(ty_ver, y_ver):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), **UNET_TOL)


# ---- the OpenAI UNet ----------------------------------------------------------------


OPENAI_BASE = dict(in_channels=2, model_channels=16, out_channels=2, num_res_blocks=1,
                   attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
                   num_classes=3, norm_groups=8)
OPENAI_CASES = {
    "base": {},
    "scale_shift_updown_new_order": dict(use_scale_shift_norm=True, resblock_updown=True,
                                         num_head_channels=8, num_heads=-1,
                                         use_new_attention_order=True,
                                         attention_resolutions=(1, 2)),
    "avgpool_heads_upsample": dict(conv_resample=False, attention_resolutions=(1, 2),
                                   num_heads_upsample=2),
    "spatial_transformer": dict(use_spatial_transformer=True, transformer_depth=2,
                                context_dim=8, num_heads=2),
    "chest_like": dict(use_scale_shift_norm=True, resblock_updown=True,
                       attention_resolutions=(), num_res_blocks=2, num_heads=8),
}


def openai_pair(seed=21, **options):
    kw = dict(OPENAI_BASE, **options)
    jm = JaxOpenAI(**kw)
    x = _x((B, 8, 8, 2))
    ctx = _x((B, 3, 8), 4) if kw.get("use_spatial_transformer") else None
    params = _params(jm, seed, x, T_IN, COND, context=ctx)
    model = UNetOpenAI(**kw)
    load_jax_params(model, params, kind="openai")
    return jm, params, model, x, ctx


@pytest.mark.parametrize("case", sorted(OPENAI_CASES))
def test_openai_unet_matches_jax(case):
    jm, params, model, x, ctx = openai_pair(**OPENAI_CASES[case])
    y, y_ver = jax.jit(jm.apply)({"params": params}, x, T_IN, COND, None, MASK,
                                 context=ctx)
    with torch.no_grad():
        ty, ty_ver = model(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                           torch.from_numpy(MASK),
                           context=None if ctx is None else torch.from_numpy(ctx))
    assert y_ver == [] and ty_ver == []
    assert np.abs(np.asarray(y)).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)
    with pytest.raises(ValueError, match="self-conditioning"):
        model(nchw(x), torch.from_numpy(T_IN), self_cond=nchw(x))


# ---- the lucidrains UNet -------------------------------------------------------------


LUCID_BASE = dict(dim=8, dim_mults=(1, 2), channels=2, resnet_block_groups=4)
LUCID_CASES = {
    "base": {},
    "self_cond_variance_learned_sinusoidal": dict(self_condition=True,
                                                  learned_variance=True,
                                                  learned_sinusoidal_cond=True),
    "three_levels_out_dim": dict(dim_mults=(1, 2, 2), init_dim=8, out_dim=3),
}


def lucid_pair(seed=23, **options):
    kw = dict(LUCID_BASE, **options)
    jm = JaxLucid(**kw)
    x = _x((B, 8, 8, 2))
    params = _params(jm, seed, x, T_IN)
    model = UNetLucidrains(**kw)
    load_jax_params(model, params, kind="lucidrains")
    return jm, params, model, x


@pytest.mark.parametrize("case", sorted(LUCID_CASES))
def test_lucidrains_unet_matches_jax(case):
    kw = LUCID_CASES[case]
    jm, params, model, x = lucid_pair(**kw)
    sc = _x(x.shape, 5) if kw.get("self_condition") else None
    y, _ = jax.jit(jm.apply)({"params": params}, x, T_IN, COND, sc)
    with torch.no_grad():
        ty, ty_ver = model(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                           None, None if sc is None else nchw(sc))
        tc, _ = model(nchw(x), torch.from_numpy(T_IN), None, None,
                      None if sc is None else nchw(sc))
    assert ty_ver == [] and torch.equal(ty, tc)  # the label is ignored
    assert np.abs(np.asarray(y)).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)


def test_lucidrains_wsconv_eps_follows_the_activation_dtype():
    """bf16 activations take eps 1e-3 over the float32 weight statistics."""
    torch.manual_seed(0)
    conv = UNetLucidrains(**LUCID_BASE).downs[0][0].block1.proj
    with torch.no_grad():
        conv.weight.mul_(1e-2)  # variance near the eps
    x = torch.randn(1, 8, 5, 5)
    w = conv.weight
    mean, var = w.mean((1, 2, 3), keepdim=True), w.var((1, 2, 3), keepdim=True, unbiased=False)
    for dtype, eps in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
        want = F.conv2d(x, ((w - mean) * torch.rsqrt(var + eps)), conv.bias, padding=1)
        with torch.no_grad():
            got = conv.to(dtype)(x.to(dtype)).float()
        conv.float()
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * want.abs().max().item())


# ---- the diffusers autoencoders --------------------------------------------------------


AE_BASE = dict(in_channels=3, out_channels=3, emb_channels=2, block_out_channels=(8, 16, 16),
               layers_per_block=1, norm_num_groups=4)
IMG = (B, 16, 16, 3)
LATENT = (B, 4, 4, 2)


@pytest.fixture
def fixed_posterior(monkeypatch):
    """The JAX posterior with a fixed numpy draw, as the port takes it."""
    noise = _x(LATENT, 9)

    def gaussian(moments, rng=None, sample=True):
        mean, logvar = jnp.split(moments, 2, axis=-1)
        kl = 0.5 * jnp.sum(mean ** 2 + jnp.exp(logvar) - 1.0 - logvar) / moments.shape[0]
        return (mean + jnp.exp(0.5 * logvar) * noise if sample else mean), kl

    monkeypatch.setattr(jax_led, "_diffusers_gaussian", gaussian)
    return noise


def ae_pair(kind, seed=25):
    if kind == "kl":
        jm, model = jax_led.AutoencoderKLDiffusers(**AE_BASE), led.AutoencoderKLDiffusers(**AE_BASE)
    else:
        kw = dict(AE_BASE, num_embeddings=16)
        jm, model = jax_led.VQModelDiffusers(**kw), led.VQModelDiffusers(**kw)
    x = np.random.default_rng(1).uniform(-1, 1, IMG).astype(np.float32)
    params = _params(jm, seed, x)
    load_jax_params(model, params, kind="diffusers")
    return jm, params, model, x


def test_diffusers_kl_matches_jax(fixed_posterior):
    jm, params, model, x = ae_pair("kl")
    rngs = {"sample": KEY}
    pred, ver, kl = jm.apply({"params": params}, x, rngs=rngs)
    z = jm.apply({"params": params}, x, sample=False, method=jm.encode)
    dec = jm.apply({"params": params}, np.asarray(z) + 0.5, method=jm.decode)
    _, _, _, h, _ = jm.apply({"params": params}, x, rngs=rngs, method=jm.forward_with_hiddens)
    with torch.no_grad():
        tpred, tver, tkl = model(nchw(x), nchw(fixed_posterior))
        tz = model.encode(nchw(x), sample=False)
        tdec = model.decode(tz + 0.5)
        out = model.forward_with_hiddens(nchw(x), nchw(fixed_posterior))
    assert ver == [] and tver == [] and out[1] == [] and out[4] == []
    np.testing.assert_allclose(nhwc(tz), np.asarray(z), **AE_TOL)
    np.testing.assert_allclose(nhwc(tdec), np.asarray(dec), **AE_TOL)
    np.testing.assert_allclose(nhwc(tpred), np.asarray(pred), **AE_TOL)
    np.testing.assert_allclose(nhwc(out[3]), np.asarray(h), **AE_TOL)
    torch.testing.assert_close(out[0], tpred)
    np.testing.assert_allclose(tkl.item(), float(kl), rtol=1e-5)
    assert model.out_head(0) is model.decoder.conv_out


def test_diffusers_vq_matches_jax():
    jm, params, model, x = ae_pair("vq")
    pred, _, loss = jm.apply({"params": params}, x)
    zq = jm.apply({"params": params}, x, method=jm.encode)
    with torch.no_grad():
        tpred, _, tloss = model(nchw(x))
        tzq = model.encode(nchw(x))
    np.testing.assert_allclose(nhwc(tzq), np.asarray(zq), **AE_TOL)
    np.testing.assert_allclose(nhwc(tpred), np.asarray(pred), **AE_TOL)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-4)
    assert np.abs(np.asarray(pred)).max() > 1e-2


@pytest.mark.parametrize("updown", ["up", "down_sde", "none_mish", "up_fir", "down_fir"])
def test_diffusers_resnet_options_match_jax(updown):
    kw = dict(in_channels=8, out_channels=16, groups=4, temb_channels=6, groups_out=8,
              output_scale_factor=2.0, updown=updown.replace("_mish", ""),
              non_linearity="mish" if updown.endswith("mish") else "swish")
    jm = jax_led.DResnetBlock(**kw)
    x, temb = _x((B, 6, 6, 8)), _x((B, 6), 1)
    params = _params(jm, 27, x, temb)
    blk = led.DResnetBlock(**kw)
    load_jax_params(blk, params, kind="diffusers")
    want = jm.apply({"params": params}, x, temb)
    with torch.no_grad():
        got = blk(nchw(x), torch.from_numpy(temb))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **AE_TOL)


def test_converters_are_strict():
    """Every port key has its flax leaf and every flax leaf is read: a
    missing or an extra leaf raises."""
    _, params, model, _ = lucid_pair()
    extra = {**params, "stray": {"kernel": np.zeros((1, 1), np.float32)}}
    with pytest.raises(ValueError, match="does not hold"):
        load_jax_params(model, extra, kind="lucidrains")
    _, oparams, omodel, _, _ = openai_pair()
    missing = {k: v for k, v in oparams.items() if k != "out_2"}
    with pytest.raises(ValueError, match="no flax leaf"):
        load_jax_params(omodel, missing, kind="openai")
