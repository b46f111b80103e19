"""Classifier guidance in the port against the JAX package, float32 on the
CPU: ``EncoderUNetOpenAI`` with each of its four pools (attention at 2
heads, so that the head-major and qkv-major channel layouts differ), the
key rule's round trip, ``make_classifier_grad``, guided DDIM and DPM++,
and one classifier train step.

Perturbed JAX params converted by ``utils/weights.py``
(``jax_classifier_to_state_dict``, loaded with ``strict=True``). The port
runs on one CPU thread here; its attention is the kernels' plain version.
One case forces the JAX classifier's attention through its Pallas kernel
(interpret mode) at 16 tokens, forward only.

Tolerances: the classifier's logits rtol 2e-4 / atol 2e-5 (the UNet's);
the classifier gradient within 1e-4 of max|g|; the guided samplers 1e-4 of
the latent's scale; the train step's loss at rtol 1e-5, its gradients
within 2e-5 of each tensor's max, and the weights after its AdamW update
within 1e-3 lr where the gradient is above rounding noise (within 2 lr
elsewhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.models.unet_openai import EncoderUNetOpenAI as JaxClassifier
from medfusion_tpu.models.unet_openai import _openai_key_to_path
from medfusion_tpu.models.unet_openai import sd_timestep_embedding as jax_sd_embedding
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.pipelines.diffusion import make_classifier_grad as jax_classifier_grad
from medfusion_tpu.train import ClassifierTrainer as JaxTrainer
from medfusion_tpu.train import TrainState as JaxTrainState
from medfusion_tpu.train import make_classifier_train_step as jax_make_step
from medfusion_tpu_torch.cli import sample, train_classifier
from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.models.unet_openai import (
    EncoderUNetOpenAI,
    openai_key_to_path,
    sd_timestep_embedding,
)
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline, make_classifier_grad
from medfusion_tpu_torch.train import ClassifierTrainer, TrainState, make_classifier_train_step
from medfusion_tpu_torch.utils.weights import jax_classifier_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_pipeline import _assert_close
from tests.test_torch_samplers import normals
from tests.test_torch_train import LR

KEY = jax.random.PRNGKey(0)
B, T = 2, 20
SHAPE = (B, 8, 8, 2)
CLF_KW = dict(image_size=8, in_channels=2, model_channels=32, out_channels=3,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              num_head_channels=32)
# name -> classifier options: every pool, both channel layouts, FiLM norms
# and residual downsampling
CASES = {
    "adaptive-legacy": dict(pool="adaptive"),
    "attention-new_order": dict(pool="attention", use_new_attention_order=True),
    "spatial-scale_shift-updown": dict(pool="spatial", use_scale_shift_norm=True,
                                       resblock_updown=True),
    "spatial_v2-legacy": dict(pool="spatial_v2"),
}
X = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
TS = np.asarray([3, 17], np.int32)
LABEL = np.asarray([2, 0], np.int32)

_CLASSIFIERS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def classifiers(case):
    """(JAX classifier, its perturbed params, the port's with them)."""
    if case not in _CLASSIFIERS:
        kw = dict(CLF_KW, **CASES[case])
        jc = JaxClassifier(**kw)
        shapes = jax.eval_shape(jc.init, KEY, jnp.zeros((1,) + SHAPE[1:]),
                                jnp.zeros((1,), jnp.int32))["params"]
        params = _randomize(shapes, 51 + len(_CLASSIFIERS))
        tc = EncoderUNetOpenAI(**kw)
        tc.load_state_dict(jax_classifier_to_state_dict(params, tc), strict=True)
        _CLASSIFIERS[case] = jc, params, tc.eval()
    return _CLASSIFIERS[case]


def t_(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_timestep_embedding_is_cos_first_as_jax():
    t = np.asarray([0.0, 3.0, 999.0, 12.5], np.float32)
    for dim in (32, 33):
        ref = np.asarray(jax_sd_embedding(jnp.asarray(t), dim))
        # f32 sin/cos of arguments up to 999: an ulp of the argument is 6e-5
        np.testing.assert_allclose(sd_timestep_embedding(t_(t), dim).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
    assert sd_timestep_embedding(t_(t[:1]), 32)[0, 0] == 1.0  # cos(0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_classifier_matches_jax(case):
    jc, params, tc = classifiers(case)
    ref = np.asarray(jax.jit(jc.apply)({"params": params}, jnp.asarray(X), jnp.asarray(TS)))
    with torch.no_grad():
        out = tc(nchw(X), t_(TS).long())
    assert out.shape == (B, 3) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_classifier_matches_jax_through_its_pallas_attention(monkeypatch):
    """The JAX classifier with its token-layout flash-attention kernel
    (interpret mode on the CPU) forced at its 16-token levels, forward
    only, at the logits' tolerance."""
    import medfusion_tpu.ops as jax_ops

    jc, params, tc = classifiers("adaptive-legacy")
    calls = []
    kernel = jax_ops._FAT_IMPL
    monkeypatch.setattr(jax_ops, "_FAT_IMPL", lambda *a: calls.append(a[0].shape) or kernel(*a))
    monkeypatch.setattr(jax_ops, "_MIN_KV_TOKENS", 1)
    monkeypatch.setattr(jax_ops, "_FLASH_ATTENTION", True)
    ref = np.asarray(jc.apply({"params": params}, jnp.asarray(X), jnp.asarray(TS)))
    assert calls == [(B, 16, 64)] * 2  # the level-1 block and the middle block
    with torch.no_grad():
        out = tc(nchw(X), t_(TS).long())
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_key_rule_round_trips(case):
    """Every key of the port's classifier goes to a flax path of the JAX
    params by the port's copy of the key rule, one to one, and the copy
    agrees with the JAX package's rule."""
    _, params, tc = classifiers(case)
    flax_paths = {"/".join(str(k.key) for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    sd = tc.state_dict()
    mapped = {openai_key_to_path(k, v.ndim) for k, v in sd.items()}
    assert mapped == flax_paths and len(mapped) == len(sd)
    for k, v in sd.items():
        assert openai_key_to_path(k, v.ndim) == _openai_key_to_path(k, v.ndim)
        assert openai_key_to_path(k) == _openai_key_to_path(k)
    extra = {**params, "stray": {"kernel": np.zeros((1, 1), np.float32)}}
    with pytest.raises(ValueError, match="stray"):
        jax_classifier_to_state_dict(extra, tc)


def test_classifier_grad_matches_jax():
    jc, params, tc = classifiers("attention-new_order")
    ref = np.asarray(jax.jit(jax_classifier_grad(
        lambda x, t: jc.apply({"params": params}, x, t), jnp.asarray(LABEL)))(
        jnp.asarray(X), jnp.asarray(TS)))
    grad = make_classifier_grad(tc, t_(LABEL))
    with torch.no_grad():  # as the samplers call it
        out = grad(nchw(X), t_(TS).long())
    assert not out.requires_grad and all(p.grad is None for p in tc.parameters())
    out = nhwc(out)
    scale = np.abs(ref).max()
    assert scale > 1e-3
    np.testing.assert_allclose(out, ref, atol=1e-4 * scale, rtol=0)


def guided_pair(objective="x_T"):
    kw = dict(in_ch=2, out_ch=2, hid_chs=(8, 16), kernel_sizes=(3, 3), strides=(1, 2),
              time_emb_dim=16, cond_emb_num_classes=2, deep_supervision=0,
              norm_name=("GROUP", {"num_groups": 4, "affine": True}))
    jax_unet = JaxUNet(**kw)
    z0 = jnp.zeros((1,) + SHAPE[1:], jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    params = _randomize(jax.eval_shape(jax_unet.init, KEY, z0, t0, t0)["params"], 61)
    unet = UNet(**kw)
    load_jax_params(unet, params, kind="unet")
    sched = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002,
                 beta_end=0.02)
    common = dict(clip_x0=False, estimator_objective=objective)
    jp = JaxPipeline(scheduler=JaxSchedule.create(**sched), noise_estimator=jax_unet, **common)
    tp = DiffusionPipeline(scheduler=GaussianDiffusionSchedule.create(**sched),
                           noise_estimator=unet.eval(), **common)
    return jp, {"noise_estimator": params}, tp


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_guided_samplers_match_jax(sampler):
    jc, cparams, tc = classifiers("adaptive-legacy")
    jp, params, tp = guided_pair()
    cond = np.asarray([0, 1], np.int32)
    kw = dict(steps=4, guidance_scale=2.0, decode=False)
    jg = dict(classifier_grad=jax_classifier_grad(
        lambda x, t: jc.apply({"params": cparams}, x, t), jnp.asarray(cond)),
        classifier_scale=30.0)
    tg = dict(classifier_grad=make_classifier_grad(tc, t_(cond)), classifier_scale=30.0)
    if sampler == "ddim":
        rng = jax.random.PRNGKey(5)
        ref = jax.jit(lambda p, x: jp.denoise(p, x, rng, condition=jnp.asarray(cond),
                                              eta=1.0, **kw, **jg))(params, jnp.asarray(X))
        noise = t_(normals(jax.random.split(rng, 4), SHAPE, 2))
        run = lambda **g: tp.denoise(t_(X), condition=t_(cond).long(), eta=1.0,  # noqa: E731
                                     noise=noise, **kw, **g)
    else:
        ref = jax.jit(lambda p, x: jp.denoise_dpmpp(p, x, condition=jnp.asarray(cond), **kw,
                                                    **jg))(params, jnp.asarray(X))
        run = lambda **g: tp.denoise_dpmpp(t_(X), condition=t_(cond).long(),  # noqa: E731
                                           **kw, **g)
    out = run(**tg)
    # guidance moves the result by more than ten times the tolerance
    assert (out - run()).abs().max() > 3e-3
    _assert_close(out.numpy(), np.asarray(ref), 1e-4)
    v_pipe = guided_pair("v")[2]
    with pytest.raises(ValueError, match="eps"):
        v_pipe.denoise_dpmpp(t_(X), steps=2, **tg)
    with pytest.raises(ValueError, match="eps"):
        v_pipe.denoise(t_(X), steps=2, **tg)


def test_classifier_train_step_matches_jax():
    jc, params, _ = classifiers("attention-new_order")
    tc = EncoderUNetOpenAI(**dict(CLF_KW, **CASES["attention-new_order"]))
    tc.load_state_dict(jax_classifier_to_state_dict(params, tc), strict=True)
    sched = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002,
                 beta_end=0.02)
    lr = LR  # _close_params' step size
    jtrainer = JaxTrainer(classifier=jc, scheduler=JaxSchedule.create(**sched))
    ttrainer = ClassifierTrainer(classifier=tc, scheduler=GaussianDiffusionSchedule.create(
        **sched))
    x = np.random.default_rng(4).uniform(-1, 1, SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    _, k_t, k_noise, _ = jax.random.split(rng, 4)
    draws = {"t": t_(np.asarray(jax.random.randint(k_t, (B,), 0, T, jnp.int32))).long(),
             "eps": t_(np.asarray(jax.random.normal(k_noise, SHAPE, jnp.float32)))}
    batch = {"source": jnp.asarray(x), "target": jnp.asarray(LABEL)}
    jstate = JaxTrainState.create(params, optax.adamw(lr))
    jstate, metrics = jax_make_step(jtrainer)(jstate, None, batch, rng)
    loss = metrics["loss"]
    # the step's gradients from Adam's first moment: mu = (1 - b1) g
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                                   jstate.opt_state[0].mu)

    state = TrainState(tc, lr=lr, weight_decay=1e-4)
    tm = make_classifier_train_step(ttrainer)(
        state, {"source": t_(x), "target": t_(LABEL).long()}, draws)
    assert state.step == 1
    np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=1e-5)
    assert float(tm["acc"]) == float(metrics["acc"])
    ref = jax_classifier_to_state_dict(grads, tc)
    top = max(r.abs().max().item() for r in ref.values())
    for k, q in tc.named_parameters():
        r = ref[k].numpy()
        atol = max(2e-5 * np.abs(r).max(), 1e-6 * top)
        np.testing.assert_allclose(q.grad.numpy(), r, atol=atol, rtol=2e-3, err_msg=k)
    # AdamW's first step moves each weight by ~lr sign(g); a gradient that is
    # rounding noise (e.g. a per-channel constant under a GroupNorm of one
    # channel a group, a key bias under the softmax) moves it by up to 2 lr
    # either way, so those weights are held to 2 lr and the rest to 1e-3 lr
    after = jax_classifier_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), tc)
    for k, q in tc.named_parameters():
        d = np.abs(q.detach().numpy() - after[k].numpy())
        settled = np.abs(ref[k].numpy()) > 1e-5 * top
        assert d.max() <= 2 * lr, k
        assert (d[settled] <= 1e-3 * lr + 1e-6 * np.abs(after[k].numpy()[settled])).all(), k


def test_train_classifier_cli_resume_is_exact(tmp_path, capsys):
    """Four steps straight, and two then a ``--resume`` to four, give the
    same weights and optimizer state bit for bit (the attention pool's
    backward included); the run loads for guided sampling, and a run saved
    with another pool is refused."""
    argv = ["--preset", "smoke", "--device", "cpu", "--model-channels", "32", "--pool",
            "attention", "--batch-size", "2", "--ckpt-every", "2"]
    straight, losses = train_classifier.main([*argv, "--max-steps", "4",
                                              "--out", str(tmp_path / "a")])
    train_classifier.main([*argv, "--max-steps", "2", "--out", str(tmp_path / "b")])
    resumed, tail = train_classifier.main([*argv, "--max-steps", "4", "--resume",
                                           "--out", str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == straight.step == 4 and tail == losses[2:]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    p = train_classifier.PRESETS["smoke"]
    clf = train_classifier.load_classifier(p, tmp_path / "a", 32, "attention", device="cpu")
    assert not any(q.requires_grad for q in clf.parameters())
    with pytest.raises(SystemExit, match="pool"):
        train_classifier.load_classifier(p, tmp_path / "a", 32, "adaptive", device="cpu")
    with pytest.raises(SystemExit, match="pool"):
        train_classifier.main([*argv[:-4], "--pool", "adaptive", "--max-steps", "5",
                               "--resume", "--out", str(tmp_path / "b")])
    results = sample.main(["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--n",
                           "2", "--steps", "2", "--out", str(tmp_path / "s"),
                           "--classifier-ckpt", str(tmp_path / "a"),
                           "--classifier-model-channels", "32", "--classifier-pool",
                           "attention"])
    assert all(np.isfinite(v).all() for v in results.values())
