"""The port's adversarial autoencoder training against the JAX package, on the CPU.

A narrow VAE (hid 4, 8, one deep-supervision head, 16^2 RGB images) and
two narrow discriminators of each flavour, one per pyramid level, all with
their flax params perturbed away from init (the zero-init heads would make
lambda hit its clip and the comparisons say nothing) and carried across
with ``utils/weights.py``. The JAX VAE's reparameterisation draw is replaced
by a fixed numpy draw, which the port gets too.

* The discriminator losses at 1e-6; ``interpolate_area`` at 1e-6.
* Both discriminators' train-mode forward at the VAE's rtol 1e-4 / atol
  1e-5, and the PatchGAN's BatchNorm buffers: ``running_mean`` equal to
  flax's, ``running_var`` by torch's rule (each update takes the unbiased
  batch variance, n/(n-1) times the biased one flax takes).
* The generator loss with the GAN on and off: the loss, each ``gan_loss_i``
  and ``lambda_i`` at rtol 1e-5 (off: the terms and lambda 0 in the port).
* The generator's gradients: the out heads' equal JAX's; with the GAN off
  every gradient equals JAX's; with it on, the body's gradients equal JAX's
  rec-only gradient plus sum_i lambda_i w grad(-sum D_i(pred_i)), built
  with ``jax.grad`` through the JAX package's own ``vae.apply`` and
  ``disc.apply``. A separate test pins that the JAX package's body
  gradients are the same with the GAN on and off (its adversarial term
  reaches only the heads; ROADMAP Queue 3).
* The discriminator step: loss, gradients and BatchNorm buffers.
* One full two-player Adam step against ``make_adversarial_train_step``,
  both players active: the metrics, the discriminators' parameters and
  moments, the out heads' parameters, and the BatchNorm buffers.
Gradients and moments are held as in ``tests/test_torch_autoencoder.py``
(2e-5 of each tensor's max, rtol 2e-3); a discriminator's gradients through
train-mode BatchNorm at 1e-4 of the tensor's max, since its backward
subtracts sums of similar size (and flax takes the variance as E[x^2] -
E[x]^2); a conv bias before a BatchNorm, whose gradient is zero but for
rounding, only small on both sides. Adam's first step moves an element by
about lr whatever its gradient, so the parameters after it are held within
2 lr, and within 1e-3 lr where the element's gradient is above 1 % of its
tensor's largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu.losses import gan as jax_gan
from medfusion_tpu.nn.functional import interpolate_area as jax_interpolate_area
from medfusion_tpu.train.adversarial import AdversarialTrainer as JaxAdversarialTrainer
from medfusion_tpu.train.adversarial import GANTrainState as JaxGANTrainState
from medfusion_tpu.train.adversarial import init_discriminators
from medfusion_tpu.train.adversarial import make_adversarial_train_step as jax_make_step
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu_torch.losses import gan
from medfusion_tpu_torch.models import latent_embedders as le
from medfusion_tpu_torch.nn.functional import interpolate_area
from medfusion_tpu_torch.train import GANTrainState
from medfusion_tpu_torch.train.adversarial import (
    AdversarialTrainer,
    make_adversarial_train_step,
)
from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer
from medfusion_tpu_torch.utils.weights import jax_gan_to_state_dicts
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_train import LR, _close_tensors


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEY = jax.random.PRNGKey(0)
VAE_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(4, 8),
              kernel_sizes=(3, 3), strides=(1, 2), deep_supervision=1,
              norm_name=("GROUP", {"num_groups": 2, "affine": True}))
DISC_KW = {
    "conv": dict(hid_chs=(4, 8), kernel_sizes=(3, 3), strides=(1, 2),
                 norm_name=("GROUP", {"num_groups": 2, "affine": True})),
    "patch": dict(hid_chs=(4, 8, 8), kernel_sizes=(4, 4, 4), strides=(2, 2, 1)),
}
DISC_CLS = {"conv": "Discriminator", "patch": "NLayerDiscriminator"}
SHAPE = (2, 16, 16, 3)
LATENT = (2, 8, 8, 2)
LEVEL_SHAPES = [(1, 16, 16, 3), (1, 8, 8, 3)]
TRAINER_KW = dict(pixel_loss="l2", embedding_loss_weight=1e-6)
HEADS = ("outc.", "outc_ver.")
BN_ATOL = 1e-4  # of a tensor's max, for gradients through train-mode BatchNorm


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


def _jax_discs(kind, seed=5):
    """The JAX discriminator and its per-level variables, params perturbed
    (BatchNorm statistics at their init, mean 0 and var 1)."""
    disc = getattr(jax_le, DISC_CLS[kind])(**DISC_KW[kind])
    variables = _np_tree(jax.jit(lambda: init_discriminators(disc, KEY, LEVEL_SHAPES))())
    for i, v in enumerate(variables.values()):
        v["params"] = _randomize(v["params"], seed + i)
    return disc, variables


def _split(variables):
    params = {k: v["params"] for k, v in variables.items()}
    stats = {k: v["batch_stats"] for k, v in variables.items() if "batch_stats" in v}
    return params, stats


@functools.lru_cache(maxsize=None)
def _jax_side(kind, start, seed=3):
    """(JAX trainer, ae params, disc variables): functional, so shared by
    the tests (numpy leaves)."""
    jvae = jax_le.VAE(**VAE_KW)
    x0 = jnp.zeros((1, *SHAPE[1:]), jnp.float32)
    ae_params = _randomize(jax.eval_shape(
        jvae.init, {"params": KEY, "sample": KEY}, x0)["params"], seed)
    jdisc, disc_vars = _jax_discs(kind)
    jtrainer = JaxAdversarialTrainer(ae_trainer=JaxTrainer(autoencoder=jvae, **TRAINER_KW),
                                     discriminator=jdisc, n_discriminators=2,
                                     start_gan_train_step=start)
    return jtrainer, ae_params, disc_vars


def _setup(kind, start):
    """(JAX trainer, ae params, disc variables, port trainer, port discs):
    the port's modules fresh, with the JAX side's weights."""
    jtrainer, ae_params, disc_vars = _jax_side(kind, start)
    vae = le.VAE(**VAE_KW)
    discs = torch.nn.ModuleList([getattr(le, DISC_CLS[kind])(**DISC_KW[kind])
                                 for _ in LEVEL_SHAPES])
    gen_sd, disc_sd = jax_gan_to_state_dicts(ae_params, *_split(disc_vars))
    vae.load_state_dict(gen_sd, strict=True)
    discs.load_state_dict(disc_sd, strict=True)
    trainer = AdversarialTrainer(AutoencoderTrainer(vae, **TRAINER_KW), discs,
                                 start_gan_train_step=start)
    return jtrainer, ae_params, disc_vars, trainer, discs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bn_counts(discs):
    """Record each BatchNorm call's n = B * H * W (per channel)."""
    counts = {}

    def hook(name):
        def fn(module, inputs, output):
            x = inputs[0]
            counts.setdefault(name, []).append(x.numel() // x.shape[1])
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in discs.named_modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    return counts, handles


def _before_bn(discs):
    """The conv biases that feed a BatchNorm: their gradient is zero but for
    rounding (the norm takes out the batch mean)."""
    return {f"{k.rsplit('.', 1)[0]}.conv.bias" for k, m in discs.named_modules()
            if isinstance(m, torch.nn.BatchNorm2d)}


def _flax_stats_by_key(stats_seq):
    """[disc_stats trees] -> {port buffer stem: [(mean, var), ...]}."""
    out = {}
    for stats in stats_seq:
        for name, layers in stats.items():
            i = name.rsplit("_", 1)[1]
            for layer, st in layers.items():
                stem = f"{i}.encoder.{layer.rsplit('_', 1)[1]}.norm"
                out.setdefault(stem, []).append(
                    (np.asarray(st["norm"]["norm"]["mean"]),
                     np.asarray(st["norm"]["norm"]["var"])))
    return out


def _check_bn_buffers(discs, stats_seq, counts):
    """The port's buffers against flax's sequence of running statistics
    (its init first): the means equal, the variances by torch's update rule
    t_k = 0.9 t_(k-1) + n/(n-1) (r_k - 0.9 r_(k-1))."""
    buffers = dict(discs.named_buffers())
    for stem, seq in _flax_stats_by_key(stats_seq).items():
        ns = counts.get(stem, [])
        # flax's sequence repeats a tree where a level was not called
        seq = [seq[0]] + [s for s, prev in zip(seq[1:], seq) if not np.array_equal(s[1], prev[1])]
        assert len(seq) - 1 == len(ns), (stem, len(seq), ns)
        want = seq[0][1].astype(np.float64)
        for (_, r), (_, r_prev), n in zip(seq[1:], seq, ns):
            want = 0.9 * want + n / (n - 1) * (r.astype(np.float64) - 0.9 * r_prev)
        np.testing.assert_allclose(buffers[f"{stem}.running_mean"].numpy(), seq[-1][0],
                                   rtol=1e-5, atol=1e-6, err_msg=stem)
        np.testing.assert_allclose(buffers[f"{stem}.running_var"].numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=stem)
        assert int(buffers[f"{stem}.num_batches_tracked"]) == len(ns)


# ---- losses and the area interpolation --------------------------------------


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss", "exp_d_loss"])
def test_d_losses_match_jax(name):
    rng = np.random.default_rng(0)
    real, fake = (rng.normal(0, 1.5, (2, 1, 5, 5)).astype(np.float32) for _ in range(2))
    want = getattr(jax_gan, name)(jnp.asarray(real), jnp.asarray(fake))
    got = getattr(gan, name)(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("size", [(8, 8), (4, 4), (5, 3), (16, 16)])
def test_interpolate_area_matches_jax(size):
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = jax_interpolate_area(jnp.asarray(x), size)
    np.testing.assert_allclose(nhwc(interpolate_area(nchw(x), size)), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# ---- the discriminators -------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv", "patch"])
def test_discriminators_match_jax_in_train_mode(kind):
    jdisc, variables = _jax_discs(kind)
    _, _, _, _, discs = _setup(kind, start=0)
    counts, handles = _bn_counts(discs)
    stats_seq = [_split(variables)[1]]
    for i, shape in enumerate(LEVEL_SHAPES):
        x = np.random.default_rng(i).uniform(-1, 1, (2, *shape[1:])).astype(np.float32)
        v = variables[f"disc_{i}"]
        want, upd = jax.jit(functools.partial(jdisc.apply, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
        with torch.no_grad():
            got = discs[i](nchw(x))
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-5)
        assert np.abs(np.asarray(want)).max() > 1e-2  # the head is not zero
        if "batch_stats" in upd:
            stats_seq.append({**stats_seq[-1], f"disc_{i}": _np_tree(upd["batch_stats"])})
    for h in handles:
        h.remove()
    if kind == "patch":
        _check_bn_buffers(discs, stats_seq, counts)
    else:
        assert not list(discs.buffers())


# ---- the generator step -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_generator_fn(kind):
    """JAX ``generator_loss`` and its gradient, jitted (step traced); run
    only under ``fixed_noise``, whose draw the trace holds."""
    jtrainer, _, disc_vars = _jax_side(kind, 0)
    params, stats = _split(disc_vars)

    def loss_fn(p, x, step):
        return jtrainer.generator_loss(p, params, stats, None, {"source": x}, KEY, step)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_generator(kind, step):
    """(loss, metrics, pred, pred_ver, new_stats, grads) at ``step`` on
    ``_images()``, numpy leaves."""
    _, ae_params, _ = _jax_side(kind, 0)
    (loss, (metrics, pred, pred_ver, new_stats)), grads = _jax_generator_fn(kind)(
        ae_params, jnp.asarray(_images()), jnp.asarray(step))
    return _np_tree((loss, metrics, pred, pred_ver, new_stats, grads))


def _port_generator(trainer, x, noise, step):
    vae = trainer.ae_trainer.autoencoder
    trainer.discriminators.requires_grad_(False)
    vae.zero_grad(set_to_none=True)
    loss, metrics, pred, pred_ver = trainer.generator_loss(nchw(x), nchw(noise), step)
    loss.backward()
    trainer.discriminators.requires_grad_(True)
    return loss, metrics, {k: p.grad for k, p in vae.named_parameters()}


def _vae_sd(tree):
    return jax_gan_to_state_dicts(_np_tree(tree), {})[0]


@pytest.mark.parametrize("kind", ["conv", "patch"])
@pytest.mark.parametrize("active", [True, False], ids=["gan_on", "gan_off"])
def test_generator_loss_matches_jax(fixed_noise, kind, active):
    jtrainer, ae_params, disc_vars, trainer, discs = _setup(kind, start=0)
    x, step = _images(), 4 if active else 0
    counts, handles = _bn_counts(discs)
    loss, metrics, _, _, new_stats, _ = _jax_generator(kind, step)
    got, got_metrics, _ = _port_generator(trainer, x, fixed_noise, step)
    for h in handles:
        h.remove()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert set(got_metrics) == set(metrics)
    for k in ("img_loss", "emb_loss", "loss_0", "L1", "L2"):
        np.testing.assert_allclose(float(got_metrics[k]), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
    for i in range(2):
        if active:
            lam = float(metrics[f"lambda_{i}"])
            assert 1e-3 < lam < 1e3  # off the clip
            np.testing.assert_allclose(float(got_metrics[f"lambda_{i}"]), lam, rtol=1e-5)
            np.testing.assert_allclose(float(got_metrics[f"gan_loss_{i}"]),
                                       float(metrics[f"gan_loss_{i}"]), rtol=1e-5)
        else:
            # JAX reports the lambda of its closure; the port calls no D
            assert float(metrics[f"gan_loss_{i}"]) == 0.0
            assert float(got_metrics[f"gan_loss_{i}"]) == float(got_metrics[f"lambda_{i}"]) == 0
    if kind == "patch":
        seq = [_split(disc_vars)[1]] + ([_np_tree(new_stats)] if active else [])
        _check_bn_buffers(discs, seq, counts)


def test_generator_gradients_match_the_reference(fixed_noise):
    """GAN on: the heads' gradients equal JAX's; the body's equal JAX's
    rec-only gradient plus sum_i lambda_i w grad(-sum D_i(pred_i)), the
    reference's whole-generator adversarial gradient, built from the JAX
    modules. GAN off: every gradient equals JAX's."""
    jtrainer, ae_params, disc_vars, trainer, _ = _setup("conv", start=0)
    x = _images()
    _, metrics, _, _, _, g_on = _jax_generator("conv", 4)
    _, _, _, _, _, g_off = _jax_generator("conv", 0)
    jvae, jdisc = jtrainer.ae_trainer.autoencoder, jtrainer.discriminator
    params, _ = _split(disc_vars)
    lams = [float(metrics[f"lambda_{i}"]) for i in range(2)]

    def adversarial(p):
        pred, pred_ver, _ = jvae.apply({"params": p}, jnp.asarray(x), train=True,
                                       rngs={"sample": KEY})
        return sum(lam * jtrainer.gan_loss_weight
                   * -jnp.sum(jdisc.apply({"params": params[f"disc_{i}"]}, out, train=True))
                   for i, (lam, out) in enumerate(zip(lams, [pred, *pred_ver])))

    g_adv = jax.jit(jax.grad(adversarial))(ae_params)
    whole = jax.tree_util.tree_map(lambda a, b: a + b, g_off, g_adv)
    _, _, grads = _port_generator(trainer, x, fixed_noise, 4)
    want_on, want_whole = _vae_sd(g_on), _vae_sd(whole)
    heads = {k for k in grads if k.startswith(HEADS)}
    _close_tensors({k: grads[k] for k in heads}, {k: want_on[k] for k in heads}, what="head")
    _close_tensors({k: g for k, g in grads.items() if k not in heads},
                   {k: g for k, g in want_whole.items() if k not in heads}, what="body")
    # the adversarial part of the body's gradient is not small
    adv = _vae_sd(g_adv)
    assert max(adv[k].abs().max().item() / want_whole[k].abs().max().item()
               for k in adv if k not in heads) > 0.1

    _, _, grads_off = _port_generator(trainer, x, fixed_noise, 0)
    _close_tensors(grads_off, _vae_sd(g_off), what="gan off")


def test_jax_adversarial_gradient_reaches_only_the_heads(fixed_noise):
    """The JAX package's fault, pinned: its generator gradients with the GAN
    on and off are equal bit for bit everywhere but the out heads
    (``vae_img_loss`` applies the adversarial term to the head on a
    stop-gradient hidden state, medfusion_tpu/train/adversarial.py:166-185)."""
    g_on = _vae_sd(_jax_generator("conv", 4)[-1])
    g_off = _vae_sd(_jax_generator("conv", 0)[-1])
    for k in g_on:
        if k.startswith(HEADS):
            assert (g_on[k] - g_off[k]).abs().max() > 1e-3, k
        else:
            assert torch.equal(g_on[k], g_off[k]), k


# ---- the discriminator step and the full step ---------------------------------


@pytest.mark.parametrize("kind", ["conv", "patch"])
def test_discriminator_step_matches_jax(fixed_noise, kind):
    jtrainer, ae_params, disc_vars, trainer, discs = _setup(kind, start=0)
    x = _images()
    pred = np.random.default_rng(4).uniform(-1, 1, SHAPE).astype(np.float32)
    pred_1 = np.random.default_rng(5).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    params, stats = _split(disc_vars)
    (loss, (metrics, new_stats)), grads = jax.jit(jax.value_and_grad(
        jtrainer.discriminator_loss, has_aux=True))(
        params, stats, {"source": jnp.asarray(x)}, jnp.asarray(pred), [jnp.asarray(pred_1)],
        jnp.asarray(3))
    counts, handles = _bn_counts(discs)
    got, got_metrics = trainer.discriminator_loss(nchw(x), nchw(pred), [nchw(pred_1)], 3)
    got.backward()
    for h in handles:
        h.remove()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    assert set(got_metrics) == set(metrics) == {"loss_1", "loss_1_0", "loss_1_1"}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_metrics[k]), float(v), rtol=1e-6, err_msg=k)
    want = jax_gan_to_state_dicts({}, _np_tree(grads))[1]
    got_grads = {k: p.grad for k, p in discs.named_parameters()}
    top = max(g.abs().max().item() for g in want.values())
    for k in _before_bn(discs):
        assert max(got_grads.pop(k).abs().max(), want.pop(k).abs().max()) < 1e-5 * top, k
    _close_tensors(got_grads, want, atol_frac=BN_ATOL if kind == "patch" else 2e-5,
                   what="D grad")
    if kind == "patch":
        # flax's statistics after each level's D(real), then after its D(fake)
        seq, cur = [stats], dict(stats)
        target_1 = jax_interpolate_area(jnp.asarray(x), (8, 8))
        for i, real in enumerate([jnp.asarray(x), target_1]):
            _, upd = jtrainer.discriminator.apply(
                {"params": params[f"disc_{i}"], "batch_stats": cur[f"disc_{i}"]}, real,
                train=True, mutable=["batch_stats"])
            cur = {**cur, f"disc_{i}": _np_tree(upd["batch_stats"])}
            seq.append(cur)
            cur = {**cur, f"disc_{i}": _np_tree(new_stats[f"disc_{i}"])}
            seq.append(cur)
        _check_bn_buffers(discs, seq, counts)
    # a closed gate calls no discriminator and gives no gradient
    discs.zero_grad(set_to_none=True)
    off, off_metrics = trainer.discriminator_loss(nchw(x), nchw(pred), [nchw(pred_1)], 0)
    assert float(off) == 0.0 and not off.requires_grad and set(off_metrics) == set(metrics)


@pytest.mark.parametrize("kind", ["conv", "patch"])
def test_two_player_adam_step_matches_jax(fixed_noise, kind):
    """One batch through both players, both active (start -1): the metrics,
    the discriminators after their Adam step (parameters and moments), the
    out heads after theirs; the body's gradients differ by design (the
    JAX truncation above)."""
    jtrainer, ae_params, disc_vars, trainer, discs = _setup(kind, start=-1)
    x = _images()
    jstate = JaxGANTrainState.create(ae_params, disc_vars, optax.adam(LR), optax.adam(LR))
    jstate, jmetrics = jax_make_step(jtrainer)(jstate, None, {"source": jnp.asarray(x)}, KEY)

    state = GANTrainState(trainer.ae_trainer.autoencoder, discs, lr=LR)
    metrics = make_adversarial_train_step(trainer)(state, {"source": torch.from_numpy(x)},
                                                   torch.from_numpy(fixed_noise))
    assert state.step == int(jstate.step) == 2 and state.gen.step == state.disc.step == 1
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(metrics["loss_1"]) > 0 and float(metrics["gan_loss_0"]) != 0

    named = {k: p for k, p in discs.named_parameters() if k not in _before_bn(discs)}
    adam = jstate.disc.opt_state[0]
    want_m = jax_gan_to_state_dicts({}, _np_tree(adam.mu))[1]
    want_p = jax_gan_to_state_dicts({}, _np_tree(jstate.disc.params))[1]
    _close_tensors({k: state.disc.optimizer.state[p]["exp_avg"] for k, p in named.items()},
                   {k: want_m[k] for k in named},
                   atol_frac=BN_ATOL if kind == "patch" else 2e-5, what="D m")
    _close_after_adam(named, want_p, want_m)
    gen_named = dict(trainer.ae_trainer.autoencoder.named_parameters())
    want = _vae_sd(jstate.gen.params)
    heads = [k for k in gen_named if k.startswith(HEADS)]
    want_m = _vae_sd(jstate.gen.opt_state[0].mu)
    _close_after_adam({k: gen_named[k] for k in heads}, want, want_m)
    if kind == "patch":
        buffers = dict(discs.named_buffers())
        for stem, seq in _flax_stats_by_key([_np_tree(jstate.disc_stats)]).items():
            np.testing.assert_allclose(buffers[f"{stem}.running_mean"].numpy(), seq[-1][0],
                                       rtol=1e-5, atol=1e-6, err_msg=stem)
            assert int(buffers[f"{stem}.num_batches_tracked"]) == 3  # D(pred), D(real), D(fake)


def _close_after_adam(port, ref, ref_m):
    """Parameters after one Adam step: within 2 lr, and within 1e-3 lr where
    the gradient (m = 0.1 g) is above 1 % of its tensor's largest."""
    for k, p in port.items():
        r, m = ref[k].numpy(), np.abs(ref_m[k].numpy())
        d = np.abs(p.detach().numpy() - r)
        assert d.max() <= 2 * LR, (k, d.max())
        big = m > 1e-2 * m.max()
        assert (d[big] <= 1e-3 * LR + 1e-6 * np.abs(r[big])).all(), k


def test_discriminator_count_is_checked():
    vae = le.VAE(**VAE_KW)
    with pytest.raises(ValueError, match="adversarial levels"):
        AdversarialTrainer(AutoencoderTrainer(vae), torch.nn.ModuleList(
            [le.Discriminator(**DISC_KW["conv"])]))


def test_vqgan_generator_loss_matches_jax():
    """The VQGAN (``--model vqvae --gan``): the 'vqvae' flavour's rec loss
    (pyramid-weighted means) and the commitment loss (weight 1) under the
    adversarial terms, GAN on; the VQVAE of tests/test_torch_vqvae.py, whose
    images keep the code margin."""
    from tests.test_torch_vqvae import _images_with_margin, _vq_pair

    jvq, params, vq = _vq_pair()
    x = _images_with_margin(jvq, params)
    jdisc, disc_vars = _jax_discs("conv")
    kw = dict(flavor="vqvae", pixel_loss="l2", embedding_loss_weight=1.0)
    jtrainer = JaxAdversarialTrainer(ae_trainer=JaxTrainer(autoencoder=jvq, **kw),
                                     discriminator=jdisc, n_discriminators=2,
                                     start_gan_train_step=0)
    d_params, d_stats = _split(disc_vars)
    loss, (metrics, _, _, _) = jax.jit(jtrainer.generator_loss)(
        params, d_params, d_stats, None, {"source": jnp.asarray(x)}, KEY, jnp.asarray(2))
    discs = torch.nn.ModuleList([le.Discriminator(**DISC_KW["conv"]) for _ in LEVEL_SHAPES])
    discs.load_state_dict(jax_gan_to_state_dicts({}, d_params)[1], strict=True)
    trainer = AdversarialTrainer(AutoencoderTrainer(vq, **kw), discs, start_gan_train_step=0)
    got, got_metrics, _, _ = trainer.generator_loss(nchw(x), None, 2)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    for k in ("emb_loss", "img_loss", "lambda_0", "lambda_1", "gan_loss_0", "gan_loss_1"):
        np.testing.assert_allclose(float(got_metrics[k]), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
