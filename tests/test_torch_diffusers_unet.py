"""The port's FIR resamplers, diffusers block inventory and conditional
diffusers UNet against the JAX package on the CPU.

The JAX package's own parity files for these modules read the reference's
vendored torch code; here the port is held to the JAX modules directly, on
perturbed flax params (``tests/test_torch_models.py::_randomize``) carried
across by ``utils/weights.py::load_jax_params`` with ``strict=True``:

* ``upfirdn2d`` over (up, down, pad) cases and both FIR resamplers with and
  without their conv;
* every one of the 14 block types the two factories build, the three
  reference quirks (the down blocks' loop-rebound downsampler width,
  ``AttnSkipUpBlock``'s groups, its one attention after all resnets) and the
  factories' head count for the cross-attention blocks;
* ``UNet2DConditionDiffusers`` at a tiny width with 1-D labels, 2-D label
  grids, ``cond_mask`` and no condition, and one ``train_loss`` with its
  gradients through the port's ``DiffusionPipeline``;
* the other direction: a seeded port state dict through the JAX package's
  ``convert_diffusers_{block,unet}_state_dict`` gives the same outputs, so
  the port's keys are the reference's; the reference's ``Conv2d_0`` alias of
  an upsampler's ``conv`` loads with ``strict=True``.

Tolerances: the blocks rtol 1e-4 / atol 1e-5, the UNet rtol 2e-4 / atol
2e-5 (``tests/test_full_model_parity.py``), gradients each tensor within
2e-5 of its max (``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.models.diffusers_blocks as jax_db
import medfusion_tpu.models.unet_diffusers as jax_ud
from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.models import diffusers_blocks as db
from medfusion_tpu_torch.models import unet_diffusers as ud
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.utils.weights import jax_diffusers_unet_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_train import _batch, _close_tensors

KEY = jax.random.PRNGKey(0)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
UNET_TOL = dict(rtol=2e-4, atol=2e-5)
B = 2
TEMB = 6
CTX = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(jm, seed, *args, **kwargs):
    shapes = jax.eval_shape(jm.init, KEY, *args, **kwargs)
    return _randomize(shapes["params"], seed)


def _same(got, want, tol):
    """Nested tuples of NCHW tensors (or floats) against NHWC arrays."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, tol)
    elif isinstance(got, torch.Tensor):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **tol)
    else:
        assert float(got) == float(want)


# ---- upfirdn2d and the FIR resamplers -------------------------------------------


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (3, 2)), (1, 1, (0, 0)), (3, 1, (1, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _x((2, 9, 11, 5))
    k = np.outer([1, 3, 3, 1], [1, 2, 3, 4]).astype(np.float32)  # not symmetric
    k /= k.sum()
    want = jax_db.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad)
    got = db.upfirdn2d(nchw(x), torch.from_numpy(k), up=up, down=down, pad=pad)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **BLOCK_TOL)


def test_fir_functions_match_jax():
    x = _x((2, 6, 7, 3), 1)
    for jf, tf in ((jax_db.fir_upsample_2d, db.fir_upsample_2d),
                   (jax_db.fir_downsample_2d, db.fir_downsample_2d)):
        for kernel in ((1, 3, 3, 1), (1, 2, 1)):
            want = jf(jnp.asarray(x), kernel)
            got = tf(nchw(x), kernel)
            np.testing.assert_allclose(nhwc(got), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("use_conv", [False, True])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_fir_modules_match_jax(kind, use_conv):
    jcls, tcls = ((jax_db.FirUpsample, db.FirUpsample) if kind == "up"
                  else (jax_db.FirDownsample, db.FirDownsample))
    x = _x((B, 6, 6, 4), 2)
    jm = jcls(4, 6, use_conv=use_conv)
    params = _params(jm, 3, x) if use_conv else {}
    model = tcls(4, 6, use_conv=use_conv)
    if use_conv:
        load_jax_params(model, params, kind="diffusers_blocks")
        assert model.Conv2d_0.weight.shape == (6, 4, 3, 3)
    want = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = model(nchw(x))
    assert got.shape[1] == (6 if use_conv else 4)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **BLOCK_TOL)


# ---- the factories' 14 block types ---------------------------------------------------


def _inputs(c_in, side):
    """x (NHWC), temb and a context of 3 tokens, as numpy."""
    return _x((B, side, side, c_in), 4), _x((B, TEMB), 5), _x((B, 3, CTX), 6)


# each type's factory arguments
DOWN = {
    "DownBlock2D": dict(num_layers=2, in_channels=8, out_channels=16, resnet_groups=4),
    "CrossAttnDownBlock2D": dict(num_layers=2, in_channels=8, out_channels=16,
                                 resnet_groups=4, attn_num_head_channels=8,
                                 cross_attention_dim=CTX),
    "AttnDownBlock2D": dict(num_layers=2, in_channels=8, out_channels=16, resnet_groups=4,
                            attn_num_head_channels=8),
    "SkipDownBlock2D": dict(num_layers=2, in_channels=32, out_channels=32),
    "AttnSkipDownBlock2D": dict(num_layers=2, in_channels=32, out_channels=32,
                                attn_num_head_channels=16),
    "DownEncoderBlock2D": dict(num_layers=2, in_channels=8, out_channels=16,
                               resnet_groups=4, downsample_padding=0),
    "AttnDownEncoderBlock2D": dict(num_layers=2, in_channels=8, out_channels=16,
                                   resnet_groups=4, attn_num_head_channels=8),
}
UP = {
    "UpBlock2D": dict(num_layers=2, in_channels=8, prev_output_channel=16, out_channels=16,
                      resnet_groups=4),
    "CrossAttnUpBlock2D": dict(num_layers=2, in_channels=8, prev_output_channel=16,
                               out_channels=16, resnet_groups=4, attn_num_head_channels=4,
                               cross_attention_dim=CTX),
    "AttnUpBlock2D": dict(num_layers=2, in_channels=8, prev_output_channel=16,
                          out_channels=16, resnet_groups=4, attn_num_head_channels=8),
    "SkipUpBlock2D": dict(num_layers=2, in_channels=32, prev_output_channel=32,
                          out_channels=32),
    "AttnSkipUpBlock2D": dict(num_layers=2, in_channels=32, prev_output_channel=32,
                              out_channels=32, attn_num_head_channels=16),
    # the decoder blocks ignore prev_output_channel, which the factory takes
    "UpDecoderBlock2D": dict(num_layers=2, in_channels=8, prev_output_channel=8,
                             out_channels=16, resnet_groups=4),
    "AttnUpDecoderBlock2D": dict(num_layers=2, in_channels=8, prev_output_channel=8,
                                 out_channels=16, resnet_groups=4, attn_num_head_channels=8),
}


def _down_args(name, kw):
    """The block's positional inputs (NHWC numpy)."""
    x, temb, ctx = _inputs(kw["in_channels"], 8)
    if name in ("DownEncoderBlock2D", "AttnDownEncoderBlock2D"):
        return (x,)
    if name == "CrossAttnDownBlock2D":
        return (x, temb, ctx)
    if name in ("DownBlock2D", "AttnDownBlock2D"):
        return (x, temb)
    return (x, temb, _x((B, 8, 8, 3), 7))  # the skip blocks' RGB stream


def _up_args(name, kw):
    side = 4
    x, temb, ctx = _inputs(kw["prev_output_channel"], side)
    if name in ("UpDecoderBlock2D", "AttnUpDecoderBlock2D"):
        return (x,)
    # the resnets pop from the end: the first resnet takes an ``out``-wide
    # state, the last an ``in``-wide one
    states = [_x((B, side, side, kw["in_channels"] if i == 0 else kw["out_channels"]), 10 + i)
              for i in range(kw["num_layers"])]
    if name == "CrossAttnUpBlock2D":
        return (x, states, temb, ctx)
    if name in ("UpBlock2D", "AttnUpBlock2D"):
        return (x, states, temb)
    return (x, states, temb, _x((B, side // 2, side // 2, 3), 8))


def _block_args(name):
    if name in DOWN:
        kw = dict(DOWN[name], temb_channels=TEMB, add_downsample=True)
        return kw, _down_args(name, kw)
    kw = dict(UP[name], temb_channels=TEMB, add_upsample=True)
    return kw, _up_args(name, kw)


def _factories(name):
    return ((jax_db.get_down_block, db.get_down_block) if name in DOWN
            else (jax_db.get_up_block, db.get_up_block))


def _to_torch(args):
    return [[nchw(s) for s in a] if isinstance(a, list)
            else nchw(a) if a.ndim == 4 else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("name", sorted(DOWN) + sorted(UP))
def test_block_types_match_jax(name):
    kw, args = _block_args(name)
    jax_factory, factory = _factories(name)
    jm = jax_factory(name, **kw)
    params = _params(jm, 31, *args)
    tm = load_jax_params(factory(name, **kw), params, kind="diffusers_blocks")
    want = jm.apply({"params": params}, *args)
    with torch.no_grad():
        got = tm(*_to_torch(args))
    _same(got, want, BLOCK_TOL)


def test_factories_name_every_type_and_drop_the_unetres_prefix():
    downs = set(DOWN)
    ups = set(UP)
    assert len(downs) == len(ups) == 7
    blk = db.get_down_block("UNetResDownBlock2D", 1, 8, 8, TEMB, True, resnet_groups=4)
    assert isinstance(blk, ud._DownBlock) and not hasattr(blk, "attentions")
    with pytest.raises(ValueError, match="does not exist"):
        db.get_down_block("NoSuchBlock2D", 1, 8, 8, TEMB, True)
    with pytest.raises(ValueError, match="cross_attention_dim"):
        db.get_up_block("CrossAttnUpBlock2D", 1, 8, 8, 8, TEMB, True, resnet_groups=4)


@pytest.mark.parametrize("kind,heads", [("down", 1), ("down", 2), ("down", 8), ("up", 4)])
def test_factory_head_count_of_the_cross_blocks_matches_jax(kind, heads):
    """The factories give a cross-attention block ``out // heads_arg`` heads
    of ``out // (out // heads_arg)`` channels, as JAX computes it."""
    if kind == "down":
        jm = jax_db.get_down_block("CrossAttnDownBlock2D", 1, 16, 16, TEMB, False,
                                   attn_num_head_channels=heads, resnet_groups=4,
                                   cross_attention_dim=CTX)
        tm = db.get_down_block("CrossAttnDownBlock2D", 1, 16, 16, TEMB, False,
                               attn_num_head_channels=heads, resnet_groups=4,
                               cross_attention_dim=CTX)
    else:
        jm = jax_db.get_up_block("CrossAttnUpBlock2D", 1, 16, 16, 16, TEMB, False,
                                 attn_num_head_channels=heads, resnet_groups=4,
                                 cross_attention_dim=CTX)
        tm = db.get_up_block("CrossAttnUpBlock2D", 1, 16, 16, 16, TEMB, False,
                             attn_num_head_channels=heads, resnet_groups=4,
                             cross_attention_dim=CTX)
    attn = tm.attentions[0].transformer_blocks[0].attn1
    assert attn.heads == jm.attn_head_dim
    assert attn.dim_head == 16 // jm.attn_head_dim


def test_down_blocks_build_their_downsampler_from_the_rebound_width():
    """num_layers == 1 with in != out: the downsampler takes ``in`` channels
    on both sides (and cannot run); with two layers it takes ``out``."""
    for n, width in ((1, 8), (2, 16)):
        jm = jax_db.get_down_block("AttnDownBlock2D", n, 8, 16, TEMB, True,
                                   attn_num_head_channels=8, resnet_groups=4)
        tm = db.get_down_block("AttnDownBlock2D", n, 8, 16, TEMB, True,
                               attn_num_head_channels=8, resnet_groups=4)
        assert tm.downsamplers[0].conv.in_channels == width
        x = _x((B, 8, 8, 8))
        if n == 1:
            with pytest.raises(Exception):
                jax.eval_shape(jm.init, KEY, x, _x((B, TEMB)))
            with pytest.raises(RuntimeError):
                tm(nchw(x), torch.zeros(B, TEMB))
        else:
            shapes = jax.eval_shape(jm.init, KEY, x, _x((B, TEMB)))
            assert shapes["params"]["downsamplers_0"]["conv"]["kernel"].shape[2] == width


def test_skip_up_groups_and_one_attention_quirks():
    """AttnSkipUpBlock takes min(res_in + res_skip // 4, 32) groups where
    SkipUpBlock takes min((res_in + res_skip) // 4, 32), and one attention
    after all its resnets; AttnSkipDownBlock one a resnet."""
    skip = db.get_up_block("SkipUpBlock2D", 2, 32, 32, 32, TEMB, True)
    attn = db.get_up_block("AttnSkipUpBlock2D", 2, 32, 32, 32, TEMB, True)
    assert [r.norm1.num_groups for r in skip.resnets] == [16, 16]
    assert [r.norm1.num_groups for r in attn.resnets] == [32, 32]
    assert len(attn.attentions) == 1
    down = db.get_down_block("AttnSkipDownBlock2D", 2, 32, 32, TEMB, True)
    assert len(down.attentions) == 2


# ---- the conditional UNet ------------------------------------------------------------


UNET_KW = dict(in_channels=2, out_channels=2, block_out_channels=(8, 16),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
               norm_num_groups=4, cross_attention_dim=CTX, attention_head_dim=2,
               num_classes=3)
T_IN = np.array([3, 17], np.int32)


def unet_pair(seed=41, **options):
    kw = dict(UNET_KW, **options)
    jm = jax_ud.UNet2DConditionDiffusers(**kw)
    x = _x((B, 8, 8, 2))
    params = _params(jm, seed, x, T_IN, np.array([0, 1], np.int32))
    model = ud.UNet2DConditionDiffusers(**kw)
    load_jax_params(model, params, kind="diffusers_unet")
    return jm, params, model, x


CONDITIONS = {
    "labels": (np.array([0, 2], np.int32), None),
    "label_grid": (np.array([[0, 1, 2], [2, 2, 1]], np.int32), None),
    "cond_mask": (np.array([1, 2], np.int32), np.array([1.0, 0.0], np.float32)),
    "none": (None, None),
}


@pytest.mark.parametrize("case", sorted(CONDITIONS))
def test_unet_matches_jax(case):
    # without a condition the cross-attentions attend to x itself, which
    # needs every width equal to cross_attention_dim (in JAX as in torch)
    jm, params, model, x = unet_pair(**(dict(block_out_channels=(CTX, CTX))
                                        if case == "none" else {}))
    cond, mask = CONDITIONS[case]
    y, y_ver = jax.jit(jm.apply)({"params": params}, x, T_IN, cond, None, mask)
    with torch.no_grad():
        ty, ty_ver = model(nchw(x), torch.from_numpy(T_IN),
                           None if cond is None else torch.from_numpy(cond),
                           None if mask is None else torch.from_numpy(mask))
    assert y_ver == [] and ty_ver == []
    assert np.abs(np.asarray(y)).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)


def test_unet_three_levels_and_odd_time_width_match_jax():
    kw = dict(block_out_channels=(4, 8, 8), norm_num_groups=2, layers_per_block=2,
              down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                                "DownBlock2D"),
              up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"))
    jm, params, model, x = unet_pair(43, **kw)
    cond = np.array([1, 0], np.int32)
    y, _ = jax.jit(jm.apply)({"params": params}, x, T_IN, cond)
    with torch.no_grad():
        ty, _ = model(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(cond))
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)
    for dim in (7, 8):
        t = np.array([0, 5, 999], np.int32)
        np.testing.assert_allclose(
            ud.diffusers_timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_ud.diffusers_timestep_embedding(jnp.asarray(t), dim)),
            rtol=1e-5, atol=1e-5)  # float32 sines of arguments up to 999
    with pytest.raises(ValueError, match="self-conditioning"):
        model(nchw(x), torch.from_numpy(T_IN), self_cond=nchw(x))


def test_unet_default_width_and_head_split():
    """The defaults: 320/640/1,280/1,280 with 8 heads, so a head of 40, 80
    and 160 channels (the parameters counted on the meta device)."""
    with torch.device("meta"):
        model = ud.UNet2DConditionDiffusers(in_channels=8, out_channels=8)
    heads = {blk.attentions[0].transformer_blocks[0].attn1.dim_head
             for blk in model.down_blocks if hasattr(blk, "attentions")}
    assert heads == {40, 80, 160}
    assert model.mid_block.attentions[0].transformer_blocks[0].attn1.heads == 8
    jm = jax_ud.UNet2DConditionDiffusers(in_channels=8, out_channels=8)
    shapes = jax.eval_shape(jm.init, KEY, np.zeros((1, 32, 32, 8), np.float32),
                            np.zeros((1,), np.int32), np.zeros((1,), np.int32))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want == 859_545_544


def test_unet_train_loss_and_gradients_match_jax():
    jm, params, model, _ = unet_pair(45)
    common = dict(estimator_objective="x_T", do_input_centering=False, clip_x0=False)

    def sched(mod):
        return mod.create(timesteps=20, schedule_strategy="scaled_linear", beta_start=0.002,
                          beta_end=0.02)

    jp = JaxPipeline(scheduler=sched(JaxSchedule), noise_estimator=jm, **common)
    tp = DiffusionPipeline(scheduler=sched(S.GaussianDiffusionSchedule),
                           noise_estimator=model, **common)
    shape = (2, 8, 8, 2)
    jbatch, tbatch = _batch(shape)
    rng = jax.random.PRNGKey(3)
    _, k_t, k_noise, k_cfg, _ = jax.random.split(rng, 5)
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 20))),
             "x_T": torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
             "drop": torch.tensor(bool(jax.random.uniform(k_cfg, ()) < 0.5))}

    def loss_fn(p):
        return jp.train_loss({"noise_estimator": p}, jbatch, rng)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tloss, tmetrics = tp.train_loss(tbatch, draws)
    tloss.backward()
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    ref = jax_diffusers_unet_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), model)
    _close_tensors({k: q.grad for k, q in model.named_parameters()}, ref, what="unet")


# ---- the port's state dicts through the JAX converters -------------------------------


def _np_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _perturb_(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))


def _with_alias(sd):
    """A reference state dict: each upsampler's ``conv`` also under
    ``Conv2d_0``, as ``Upsample2D`` registers it."""
    out = dict(sd)
    for k, v in sd.items():
        if ".upsamplers.0.conv." in k or k.startswith("upsamplers.0.conv."):
            out[k.replace("upsamplers.0.conv.", "upsamplers.0.Conv2d_0.")] = v
    return out


def test_port_unet_state_dict_through_the_jax_converter():
    torch.manual_seed(0)
    model = ud.UNet2DConditionDiffusers(**UNET_KW)
    _perturb_(model, 1)
    sd = _with_alias(_np_sd(model))
    assert any("Conv2d_0" in k for k in sd)
    fresh = ud.UNet2DConditionDiffusers(**UNET_KW)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jm = jax_ud.UNet2DConditionDiffusers(**UNET_KW)
    params = jax_ud.convert_diffusers_unet_state_dict(sd)
    x, cond = _x((B, 8, 8, 2), 9), np.array([2, 1], np.int32)
    y, _ = jax.jit(jm.apply)({"params": params}, x, T_IN, cond)
    with torch.no_grad():
        ty, _ = fresh(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(cond))
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), **UNET_TOL)


@pytest.mark.parametrize("name", ["AttnUpBlock2D", "AttnSkipUpBlock2D", "AttnDownBlock2D",
                                  "SkipDownBlock2D"])
def test_port_block_state_dict_through_the_jax_converter(name):
    kw, args = _block_args(name)
    jax_factory, factory = _factories(name)
    jm = jax_factory(name, **kw)
    torch.manual_seed(0)
    model = factory(name, **kw)
    _perturb_(model, 2)
    sd = _with_alias(_np_sd(model))
    fresh = factory(name, **kw)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    params = jax_db.convert_diffusers_block_state_dict(sd)
    want = jm.apply({"params": params}, *args)
    with torch.no_grad():
        got = fresh(*_to_torch(args))
    _same(got, want, BLOCK_TOL)


def test_an_alias_that_differs_from_its_twin_is_refused():
    blk = db.get_up_block("AttnUpBlock2D", 1, 8, 16, 16, TEMB, True, resnet_groups=4,
                          attn_num_head_channels=8)
    sd = _with_alias(blk.state_dict())
    sd["upsamplers.0.Conv2d_0.bias"] = sd["upsamplers.0.Conv2d_0.bias"] + 1
    with pytest.raises(ValueError, match="differs from its twin"):
        blk.load_state_dict(sd, strict=True)
