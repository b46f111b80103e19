"""The constructor options and host helpers of the port against the JAX
package on the CPU:

* the embedders: ``SinusoidalPosEmb(downscale_freq_shift, max_period,
  flip_sin_to_cos)``, ``LearnedSinusoidalPosEmb`` (an odd width padded with
  a zero column) and ``TimeEmbedding(pos_embedder, pos_emb_dim, act_name)``,
  the learned leaf ``time_embedder/pos_embedder/weights`` carried by
  ``load_jax_params`` with ``strict=True``;
* ``UNet(use_time_embedder=False)``, with and without the label embedder;
* ``EncoderUNetOpenAI(spatial_dims=3)`` with the 'adaptive' and 'spatial'
  pools (attention at one resolution), its logits and input gradient; the
  'attention' pool refused in 3-D, where the JAX package fails on a shape;
* the flow pipeline's ``loss`` ('l1', 'mse'; an unknown name refused) and
  ``time_scale``, the loss and its gradients with the JAX draws injected;
* ``AutoencoderTrainer.perceptual_loss_weight`` and
  ``AdversarialTrainer.lambda_eps``;
* the host helpers: the SD schedule helpers, ``to_array_16bit`` and
  ``filter_weights`` bit for bit, ``lambda_linear_schedule`` at the JAX
  float32 values (rtol 1e-6) and under ``LambdaLR``.

Flax params are perturbed away from init (``tests/test_torch_models.py::
_randomize``). Tolerances: f32 modules rtol 1e-4 / atol 1e-5
(``tests/test_full_model_parity.py``); losses rtol 1e-5 and gradients within
2e-5 of each tensor's max (``tests/test_torch_train.py``).
"""

import dataclasses
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu import ops as jax_ops
from medfusion_tpu.core import schedules as jax_sched
from medfusion_tpu.data.transforms import to_array_16bit as jax_to_array_16bit
from medfusion_tpu.models import embedders as jax_emb
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.models.unet_openai import EncoderUNetOpenAI as JaxEncoder
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlow
from medfusion_tpu.train.adversarial import AdversarialTrainer as JaxAdversarialTrainer
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu.train.lr_schedules import lambda_linear_schedule as jax_lambda_linear
from medfusion_tpu.utils.checkpoint import filter_weights as jax_filter_weights
from medfusion_tpu_torch import core
from medfusion_tpu_torch.data.transforms import to_array_16bit
from medfusion_tpu_torch.models import embedders as emb
from medfusion_tpu_torch.models import latent_embedders as le
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.models.unet_openai import EncoderUNetOpenAI
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.train.adversarial import AdversarialTrainer
from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer
from medfusion_tpu_torch.train.lr_schedules import lambda_linear_schedule, make_lr_schedule
from medfusion_tpu_torch.utils.checkpoint import filter_weights
from medfusion_tpu_torch.utils.weights import (
    jax_classifier_to_state_dict,
    jax_gan_to_state_dicts,
    jax_params_to_state_dict,
    load_jax_params,
)
from tests.test_torch_adversarial import DISC_KW, LEVEL_SHAPES, _jax_discs, _split
from tests.test_torch_flow import kept_key, loss_draws, pair
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_train import _batch, _close_tensors, _tree
from tests.test_torch_vqvae import _images_with_margin, _vq_pair

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-5)
T_IN = np.array([3, 17], np.int32)
COND = np.array([0, 1], np.int32)
MASK = np.array([1.0, 0.0], np.float32)
TIMES = np.array([0.0, 1.0, 17.0, 999.0], np.float32)


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


# ---- the embedders -----------------------------------------------------------------


SINUSOIDAL_CASES = {
    "defaults": dict(emb_dim=16),
    "shift0_flip": dict(emb_dim=16, downscale_freq_shift=0.0, flip_sin_to_cos=True),
    "period100_odd": dict(emb_dim=9, max_period=100),
    "odd_flip": dict(emb_dim=7, flip_sin_to_cos=True, downscale_freq_shift=0.5),
}


@pytest.mark.parametrize("case", sorted(SINUSOIDAL_CASES))
def test_sinusoidal_pos_emb_options_match_jax(case):
    kw = SINUSOIDAL_CASES[case]
    want = jax_emb.SinusoidalPosEmb(**kw).apply({}, jnp.asarray(TIMES))
    got = emb.SinusoidalPosEmb(**kw)(torch.from_numpy(TIMES))
    assert got.shape == (len(TIMES), kw["emb_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("emb_dim", [8, 7])
def test_learned_sinusoidal_pos_emb_matches_jax(emb_dim):
    """[t | sin | cos] of learned frequencies; an odd width pads a zero
    column, so the output is ``emb_dim + 1`` wide either way."""
    jm = jax_emb.LearnedSinusoidalPosEmb(emb_dim)
    params = _params(jm, 1, jnp.asarray(TIMES))
    want = jm.apply({"params": params}, jnp.asarray(TIMES))
    m = emb.LearnedSinusoidalPosEmb(emb_dim)
    m.load_state_dict({"weights": torch.from_numpy(np.asarray(params["weights"]))},
                      strict=True)
    got = m(torch.from_numpy(TIMES))
    assert got.shape == (len(TIMES), emb_dim + 1) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if emb_dim % 2:
        assert torch.all(got[:, -1] == 0)


def test_lucidrains_unet_refuses_an_odd_learned_sinusoidal_width():
    """The reference asserts an even ``learned_sinusoidal_dim``; the JAX UNet
    sizes its Dense to the unpadded width there, so the port refuses the
    setting rather than pad it into another parameter tree. An even width
    builds, with the learned embedder's ``dim + 1`` features."""
    from medfusion_tpu_torch.models.unet_lucidrains import UNetLucidrains

    with pytest.raises(ValueError, match="must be even"):
        UNetLucidrains(dim=8, dim_mults=(1, 2), learned_sinusoidal_cond=True,
                       learned_sinusoidal_dim=7)
    m = UNetLucidrains(dim=8, dim_mults=(1, 2), learned_sinusoidal_cond=True,
                       learned_sinusoidal_dim=6)
    assert m.time_mlp[1].in_features == 7


class _Holder(torch.nn.Module):
    """A module whose one child is ``time_embedder`` (the UNets' name)."""

    def __init__(self, time_embedder):
        super().__init__()
        self.time_embedder = time_embedder


TIME_EMBEDDING_CASES = {
    "defaults": dict(),
    "sinusoidal_width12_gelu": dict(pos_emb_dim=12, act_name="gelu"),
    "learned_odd_relu": dict(pos_embedder="learned", pos_emb_dim=5, act_name="relu"),
    "learned_even": dict(pos_embedder="learned", pos_emb_dim=8),
}


@pytest.mark.parametrize("case", sorted(TIME_EMBEDDING_CASES))
def test_time_embedding_options_match_jax_and_load_strictly(case):
    kw = dict(TIME_EMBEDDING_CASES[case])
    learned = kw.pop("pos_embedder", None) == "learned"
    jkw = dict(kw, pos_embedder=jax_emb.LearnedSinusoidalPosEmb) if learned else kw
    pkw = dict(kw, pos_embedder=emb.LearnedSinusoidalPosEmb) if learned else kw
    jm = jax_emb.TimeEmbedding(emb_dim=16, **jkw)
    params = _params(jm, 2, jnp.asarray(TIMES))
    assert ("pos_embedder" in params) == learned
    want = jm.apply({"params": params}, jnp.asarray(TIMES))
    holder = load_jax_params(_Holder(emb.TimeEmbedding(emb_dim=16, **pkw)),
                             {"time_embedder": params}, kind="unet")
    keys = set(holder.state_dict())
    assert {"time_embedder.time_emb.1.weight", "time_embedder.time_emb.3.weight"} <= keys
    assert ("time_embedder.time_emb.0.weights" in keys) == learned
    with torch.no_grad():
        got = holder.time_embedder(torch.from_numpy(TIMES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- the UNet without its time embedder -----------------------------------------


@pytest.mark.parametrize("classes", [None, 2], ids=["no_labels", "labels"])
def test_unet_without_time_embedder_matches_jax(classes):
    """No ``time_embedder``: the blocks take the label embedding alone, or
    no embedding (no ``local_embedder``) when there is no label embedder."""
    kw = dict(in_ch=2, out_ch=2, hid_chs=(8, 16, 16), kernel_sizes=(3, 3, 3),
              strides=(1, 2, 2), time_emb_dim=16, cond_emb_num_classes=classes,
              norm_name=("GROUP", {"num_groups": 4, "affine": True}),
              use_time_embedder=False, deep_supervision=0)
    jm, m = JaxUNet(**kw), UNet(**kw)
    x = _x((2, 8, 8, 2), 3)
    params = _params(jm, 4, jnp.asarray(x), T_IN, COND)
    load_jax_params(m, params, kind="unet")
    keys = set(m.state_dict())
    assert not any(k.startswith("time_embedder") for k in keys)
    assert any("local_embedder" in k for k in keys) == (classes is not None)
    want, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), T_IN, COND, None, MASK)
    with torch.no_grad():
        got, _ = m(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long(),
                   torch.from_numpy(MASK))
    assert np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


# ---- the 3-D classifier ---------------------------------------------------------


CLF3D_KW = dict(image_size=8, in_channels=2, model_channels=8, out_channels=3,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                spatial_dims=3, num_head_channels=4, norm_groups=4)
VOLUME = (2, 4, 8, 8, 2)


@pytest.mark.parametrize("pool", ["adaptive", "spatial"])
def test_classifier_3d_matches_jax(pool):
    """Logits and the input gradient of the log-probability of a label (the
    classifier guidance's gradient) on [B, C, D, H, W]; the downsample at
    stride (1, 2, 2), attention over the 4 x 4 x 4 tokens after it."""
    jm = JaxEncoder(pool=pool, **CLF3D_KW)
    x, t = _x(VOLUME, 5), np.array([10, 500], np.int32)
    params = _params(jm, 6, jnp.asarray(x), jnp.asarray(t))
    m = EncoderUNetOpenAI(pool=pool, **CLF3D_KW)
    load_jax_params(m, params, kind="openai")
    m.eval()

    def jax_score(x):
        logits = jm.apply({"params": params}, x, jnp.asarray(t))
        return jax.nn.log_softmax(logits)[:, 1].sum(), logits

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_score, has_aux=True))(
        jnp.asarray(x))
    tx = nchw(x).requires_grad_(True)
    got = m(tx, torch.from_numpy(t))
    torch.log_softmax(got, dim=-1)[:, 1].sum().backward()
    assert np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    g = nhwc(tx.grad)
    np.testing.assert_allclose(g, np.asarray(want_grad), rtol=1e-4,
                               atol=2e-5 * np.abs(np.asarray(want_grad)).max())


def test_classifier_3d_attention_pool_is_refused_where_jax_fails():
    """The JAX pool's positional embedding has the 2-D token count
    (image_size // ds)^2 + 1, so a 3-D input fails to broadcast; the port
    refuses the configuration when it is built."""
    kw = dict(CLF3D_KW, pool="attention")
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        jax.eval_shape(JaxEncoder(**kw).init, KEY, jnp.zeros(VOLUME),
                       jnp.zeros((2,), jnp.int32))
    with pytest.raises(ValueError, match="2-D only"):
        EncoderUNetOpenAI(**kw)


# ---- the flow pipeline's loss and time scale ---------------------------------------


FLOW_CASES = {
    "l1": dict(loss="l1"),
    "mse_time_scale10": dict(loss="mse", time_scale=10.0),
    "l1_time_scale1_deep_supervision": dict(loss="l1", time_scale=1.0),
}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_flow_loss_and_time_scale_match_jax(case):
    """The velocity loss of ``loss`` at model time ``t * time_scale``, and
    each gradient; the 'L2' metric stays the squared error."""
    settings = dict(FLOW_CASES[case], do_input_centering=False,
                    timestep_sampling="uniform")
    ds = case.endswith("deep_supervision")
    jp, params, tp = pair(ds, **settings)
    rng = kept_key("uniform")
    jbatch, tbatch = _batch((2, 8, 8, 2))

    def loss_fn(p):
        return jp.train_loss({"noise_estimator": p}, jbatch, rng)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["noise_estimator"])
    unet = tp.noise_estimator
    unet.zero_grad(set_to_none=True)
    tloss, tmetrics = tp.train_loss(tbatch, loss_draws(rng, "uniform"))
    tloss.backward()
    for k in ("loss", "L2"):
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    if settings["loss"] == "l1":
        assert abs(float(metrics["loss"]) - float(metrics["L2"])) > 1e-3
    port = {k: (q.grad if q.grad is not None else torch.zeros_like(q))
            for k, q in unet.named_parameters()}
    _close_tensors(port, _tree(grads), what=case)
    unet.zero_grad(set_to_none=True)


def test_flow_sampling_follows_time_scale_and_unknown_loss_is_refused():
    """The sampler's model time is ``t * time_scale`` too (Euler, 3 steps)."""
    jp, params, tp = pair(False, time_scale=10.0)
    x = _x((2, 8, 8, 2), 7)
    want = jp.denoise(params, jnp.asarray(x), KEY, condition=jnp.asarray(COND), steps=3,
                      heun=False)
    got = tp.denoise(torch.from_numpy(x), condition=torch.from_numpy(COND).long(), steps=3,
                     heun=False, decode=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    with pytest.raises(ValueError, match="unknown loss"):
        JaxFlow(noise_estimator=None, loss="huber")
    with pytest.raises(ValueError, match="unknown loss"):
        FlowMatchingPipeline(noise_estimator=tp.noise_estimator, loss="huber")


# ---- the trainers' options ---------------------------------------------------------


class _JaxPerceiver(fnn.Module):
    """A parameter-free stand-in for LPIPS: 2 x each image's mean |d|."""

    @fnn.compact
    def __call__(self, pred, target):
        return 2.0 * jnp.mean(jnp.abs(pred - target), axis=(1, 2, 3), keepdims=True)


def _perceiver(pred, target):
    return 2.0 * (pred - target).abs().mean(dim=(1, 2, 3), keepdim=True)


def test_perceptual_loss_weight_matches_jax():
    """The VQVAE's loss (pyramid depths 0 and 1 both perceived) with the
    perceiver's term weighted 0.3, against the JAX trainer's, and against
    the weight of 1."""
    jvq, params, vq = _vq_pair()
    x = _images_with_margin(jvq, params)
    kw = dict(flavor="vqvae", pixel_loss="l2", embedding_loss_weight=1.0)
    jloss = JaxTrainer(autoencoder=jvq, perceiver=_JaxPerceiver(), perceptual_loss_weight=0.3,
                       **kw).loss(params, {}, {"source": jnp.asarray(x)}, KEY)[0]
    with torch.no_grad():
        got = AutoencoderTrainer(vq, perceiver=_perceiver, perceptual_loss_weight=0.3,
                                 **kw).loss(nchw(x))[0]
        unit = AutoencoderTrainer(vq, perceiver=_perceiver, **kw).loss(nchw(x))[0]
    np.testing.assert_allclose(got.item(), float(jloss), rtol=1e-5)
    assert abs(got.item() - unit.item()) > 1e-3 * abs(unit.item())


def test_lambda_eps_matches_jax():
    """The adaptive lambda ||d rec/d w|| / (||d gan/d w|| + lambda_eps) at
    lambda_eps 0.05 (the VQGAN of ``tests/test_torch_adversarial.py``), and
    apart from the default's."""
    jvq, params, vq = _vq_pair()
    x = _images_with_margin(jvq, params)
    jdisc, disc_vars = _jax_discs("conv")
    kw = dict(flavor="vqvae", pixel_loss="l2", embedding_loss_weight=1.0)
    d_params, d_stats = _split(disc_vars)
    jtrainer = JaxAdversarialTrainer(ae_trainer=JaxTrainer(autoencoder=jvq, **kw),
                                     discriminator=jdisc, n_discriminators=2,
                                     start_gan_train_step=0, lambda_eps=0.05)
    loss, (metrics, _, _, _) = jax.jit(jtrainer.generator_loss)(
        params, d_params, d_stats, None, {"source": jnp.asarray(x)}, KEY, jnp.asarray(2))
    discs = torch.nn.ModuleList([le.Discriminator(**DISC_KW["conv"]) for _ in LEVEL_SHAPES])
    discs.load_state_dict(jax_gan_to_state_dicts({}, d_params)[1], strict=True)
    trainer = AdversarialTrainer(AutoencoderTrainer(vq, **kw), discs, start_gan_train_step=0,
                                 lambda_eps=0.05)
    got, got_metrics, _, _ = trainer.generator_loss(nchw(x), None, 2)
    default = dataclasses.replace(trainer, lambda_eps=1e-4)
    _, default_metrics, _, _ = default.generator_loss(nchw(x), None, 2)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    for k in ("lambda_0", "lambda_1", "gan_loss_0", "gan_loss_1"):
        np.testing.assert_allclose(float(got_metrics[k]), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
        if k.startswith("lambda"):
            assert float(default_metrics[k]) > 1.01 * float(got_metrics[k])


# ---- the host helpers ---------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_sd_beta_schedules_match_jax_bit_for_bit(schedule):
    got = core.sd_make_beta_schedule(schedule, 1000, 1e-4, 2e-2)
    want = jax_sched.sd_make_beta_schedule(schedule, 1000, 1e-4, 2e-2)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown"):
        core.sd_make_beta_schedule("quadratic", 10)


@pytest.mark.parametrize("method", ["uniform", "quad"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_sd_ddim_helpers_match_jax_bit_for_bit(method, eta):
    steps = core.sd_ddim_timesteps(50, 1000, method)
    np.testing.assert_array_equal(steps, jax_sched.sd_ddim_timesteps(50, 1000, method))
    alphacums = np.cumprod(1.0 - core.sd_make_beta_schedule("linear", 1000))
    got = core.sd_ddim_sampling_parameters(alphacums, steps, eta)
    want = jax_sched.sd_ddim_sampling_parameters(alphacums, steps, eta)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        core.sd_ddim_timesteps(50, 1000, "cubic")


def test_betas_for_alpha_bar_matches_jax_bit_for_bit():
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    for max_beta in (0.999, 0.02):
        np.testing.assert_array_equal(core.betas_for_alpha_bar(200, alpha_bar, max_beta),
                                      jax_sched.betas_for_alpha_bar(200, alpha_bar, max_beta))


LAMBDA_CASES = {  # tests/test_lr_cli_wiring.py's multi-cycle case, and a third cycle
    "two_cycles": dict(warm_up_steps=[10, 5], f_min=[0.1, 0.01], f_max=[1.0, 0.5],
                       f_start=[1e-6, 1e-6], cycle_lengths=[50, 100]),
    "three_cycles": dict(warm_up_steps=[4, 6, 2], f_min=[0.5, 0.2, 0.0],
                         f_max=[1.0, 0.8, 0.4], f_start=[0.1, 1e-3, 0.4],
                         cycle_lengths=[20, 30, 10]),
}


@pytest.mark.parametrize("case", sorted(LAMBDA_CASES))
def test_lambda_linear_schedule_matches_jax(case):
    kw = LAMBDA_CASES[case]
    ours, ref = lambda_linear_schedule(**kw), jax_lambda_linear(**kw)
    for step in [0, 3, 4, 10, 19, 20, 21, 30, 49, 50, 52, 55, 60, 120, 149]:
        np.testing.assert_allclose(ours(step), float(ref(jnp.asarray(step))), rtol=1e-6,
                                   err_msg=f"step={step}")
    with pytest.raises(ValueError, match="one entry a cycle"):
        lambda_linear_schedule(warm_up_steps=[1, 2])


def test_lambda_linear_schedule_drives_lambda_lr():
    """Under ``LambdaLR`` update i runs at base_lr x schedule(i); the CLI's
    flat single cycle is the same function."""
    kw = LAMBDA_CASES["two_cycles"]
    w = torch.nn.Parameter(torch.zeros(()))
    opt = torch.optim.SGD([w], lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda_linear_schedule(**kw))
    mult = lambda_linear_schedule(**kw)
    for i in range(60):
        assert opt.param_groups[0]["lr"] == pytest.approx(0.1 * mult(i), rel=1e-12)
        opt.step()
        sched.step()
    flat = make_lr_schedule("lambda_linear", warmup_steps=100)
    single = lambda_linear_schedule(warm_up_steps=(100,))
    assert [flat(s) for s in (0, 50, 99, 100, 10**6)] == [single(s) for s in
                                                          (0, 50, 99, 100, 10**6)]


def test_to_array_16bit_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 65536, (5, 7), dtype=np.uint16),
                rng.integers(0, 65536, (4, 6, 3), dtype=np.uint16),
                rng.integers(0, 256, (3, 3), dtype=np.uint8)):
        got, want = to_array_16bit(img), jax_to_array_16bit(img)
        assert got.dtype == want.dtype == np.int32 and got.ndim == 3
        np.testing.assert_array_equal(got, want)
        assert not np.shares_memory(got, img)


@pytest.mark.parametrize("regex", [None, r"^(in_conv|out_blocks|outc)"], ids=["all", "regex"])
def test_filter_weights_matches_jax_bit_for_bit(regex):
    """Source entries where the key matches and the shape agrees (the
    target's ``outc`` is wider, so it stays), the target's elsewhere."""
    kw = dict(in_ch=2, hid_chs=(8, 16), kernel_sizes=(3, 3), strides=(1, 2),
              time_emb_dim=16, cond_emb_num_classes=2, deep_supervision=0,
              norm_name=("GROUP", {"num_groups": 4, "affine": True}))
    x0 = jnp.zeros((1, 8, 8, 2))
    source = _params(JaxUNet(out_ch=2, **kw), 8, x0, T_IN[:1], COND[:1])
    target = _params(JaxUNet(out_ch=4, **kw), 9, x0, T_IN[:1], COND[:1])
    want = jax_filter_weights(source, target, regex)
    got = filter_weights(jax_params_to_state_dict(source), jax_params_to_state_dict(target),
                         regex)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want))
    assert list(got) == list(jax_params_to_state_dict(target))
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    src_sd = jax_params_to_state_dict(source)
    taken = {k for k in got if k in src_sd and torch.equal(got[k], src_sd[k])}
    assert "outc.conv.conv.weight" not in taken and taken
    if regex is not None:
        assert all(k.startswith(("in_conv", "out_blocks", "outc")) for k in taken)


def test_openai_3d_kernels_carry_across():
    """The 3-D classifier's conv kernels [kd, kh, kw, I, O] -> [O, I, kd,
    kh, kw] by the OpenAI rule, every flax leaf read."""
    jm = JaxEncoder(pool="adaptive", **CLF3D_KW)
    params = _params(jm, 7, jnp.zeros(VOLUME), jnp.zeros((2,), jnp.int32))
    m = EncoderUNetOpenAI(pool="adaptive", **CLF3D_KW)
    sd = jax_classifier_to_state_dict(params, m)
    k = np.asarray(params["input_blocks_0_0"]["kernel"])
    assert sd["input_blocks.0.0.weight"].shape == (8, 2, 3, 3, 3)
    np.testing.assert_array_equal(sd["input_blocks.0.0.weight"].numpy(),
                                  np.transpose(k, (4, 3, 0, 1, 2)))
