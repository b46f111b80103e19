"""The port's diffusion training against the JAX package, on the CPU.

* ``ema_decay`` against the JAX values for steps 0 ... 10^6; the
  learning-rate schedules against ``medfusion_tpu.train.lr_schedules``; one
  ``TrainState`` AdamW step against ``optax.adamw``.
* ``train_loss`` per objective; a bf16 step against the f32 step; the
  synthetic data and batches; the CLI on the CPU.
* ``tests/test_torch_train_step.py`` holds the train step against the JAX
  step with the Pallas backward reached, and three steps with EMA through
  a frozen VAE, with this file's helpers and tolerances.

The random draws are rebuilt from the JAX step's key as the JAX pipeline
splits it (``k_enc, k_t, k_noise, k_cfg = split(rng, 5)[:4]``) and fed to
the port. The VAE draws its sampling noise inside flax from ``k_enc``; the
tests replace ``diagonal_gaussian`` of the JAX VAE module by one that adds a
fixed numpy noise, and hand the same noise to the port.

Tolerances (float32 on both sides; convolutions and products summed in
another order through 20+ layers, forward and backward):

* loss: rtol 1e-5 for one step; 1e-4 after an update (the parameters
  already differ in their last bits);
* gradients, Adam's moments: per tensor, atol 2e-5 x max|g| and rtol 2e-3,
  with atol floored at 1e-6 x the model's largest |g|: a gradient that is 0
  in exact arithmetic (the key projection's bias: softmax ignores a constant
  added to a row's logits) is rounding noise on both sides;
* updated parameters: Adam's first step moves every element by about lr
  (m / sqrt(v) = sign(g)), so an element whose gradient is within the
  gradients' tolerance of 0 may move the other way in the other framework.
  The parameters are held to atol = 2 lr per step, and at least 99.9 % of
  the elements to 1e-3 lr.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu import ops as jax_ops
from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.core.schedules import v_target as jax_v_target
from medfusion_tpu.models.latent_embedders import VAE as JaxVAE
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.train import TrainState as JaxTrainState
from medfusion_tpu.train import ema_decay as jax_ema_decay
from medfusion_tpu.train import make_diffusion_train_step as jax_make_step
from medfusion_tpu_torch.cli import presets, train_diffusion
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.models.latent_embedders import VAE
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.train import TrainState, ema_decay, make_diffusion_train_step
from medfusion_tpu_torch.train.lr_schedules import make_lr_schedule
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jax_fa = importlib.import_module("medfusion_tpu.ops.flash_attention")
KEY = jax.random.PRNGKey(0)
LR = 1e-4
T = 1000

UNET_CFGS = {
    # self-attention at 32^2 = 1024 tokens (head layout) and 16^2 = 256
    # tokens (token layout), C = 128 = 8 heads x d=16: the JAX Pallas
    # forward and backward take these shapes
    "lane": dict(hid=(128, 128, 128), groups=32, heads=8, t_dim=32),
    "narrow": dict(hid=(8, 16, 32), groups=4, heads=2, t_dim=32),
}


@pytest.fixture
def bwd_spy(monkeypatch):
    calls = []
    for name in ("_bwd_dq_kernel", "_bwd_dkv_kernel", "_flash_bwd"):
        real = getattr(jax_fa, name)

        def spy(*args, _n=name, _r=real, **kwargs):
            calls.append(_n)
            return _r(*args, **kwargs)

        monkeypatch.setattr(jax_fa, name, spy)
    return calls


def _unet_pair(cfg, in_ch, side, seed=5):
    c = UNET_CFGS[cfg]
    n = len(c["hid"])
    kw = dict(in_ch=in_ch, out_ch=in_ch, hid_chs=c["hid"], kernel_sizes=(3,) * n,
              strides=(1,) + (2,) * (n - 1), time_emb_dim=c["t_dim"],
              cond_emb_num_classes=2, deep_supervision=0, use_attention="spatial",
              attn_heads=c["heads"],
              norm_name=("GROUP", {"num_groups": c["groups"], "affine": True}))
    jax_unet = JaxUNet(**kw)
    x0 = jnp.zeros((1, side, side, in_ch), jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    params = _randomize(jax.eval_shape(jax_unet.init, KEY, x0, t0, t0)["params"], seed)
    unet = UNet(**kw)
    load_jax_params(unet, params, kind="unet")
    return jax_unet, params, unet


def _vae_pair(seed=1):
    kw = dict(in_channels=1, out_channels=1, emb_channels=2, hid_chs=(4, 8),
              kernel_sizes=(3, 3), strides=(1, 2), deep_supervision=0,
              norm_name=("GROUP", {"num_groups": 2, "affine": True}))
    jax_vae = JaxVAE(**kw)
    x0 = jnp.zeros((1, 16, 16, 1), jnp.float32)
    params = _randomize(jax.eval_shape(
        jax_vae.init, {"params": KEY, "sample": KEY}, x0)["params"], seed)
    vae = VAE(**kw)
    load_jax_params(vae, params, kind="vae")
    return jax_vae, params, vae.eval().requires_grad_(False)


def _pipelines(jax_unet, unet, objective="x_T", jax_vae=None, vae=None,
               do_input_centering=False):
    common = dict(estimator_objective=objective, classifier_free_guidance_dropout=0.5,
                  do_input_centering=do_input_centering, clip_x0=False, loss="l1")
    sched = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002,
                 beta_end=0.02)
    jp = JaxPipeline(scheduler=JaxSchedule.create(**sched), noise_estimator=jax_unet,
                     latent_embedder=jax_vae, **common)
    tp = DiffusionPipeline(scheduler=S.GaussianDiffusionSchedule.create(**sched),
                           noise_estimator=unet, latent_embedder=vae, **common)
    return jp, tp


def _draws(rng, latent_shape, enc_noise=None):
    """The JAX pipeline's draws from ``rng``, as torch tensors."""
    _, k_t, k_noise, k_cfg, _ = jax.random.split(rng, 5)
    b = latent_shape[0]
    t = jax.random.randint(k_t, (b,), 0, T, dtype=jnp.int32)
    x_T = jax.random.normal(k_noise, latent_shape, jnp.float32)
    drop = jax.random.uniform(k_cfg, ()) < 0.5
    out = {"t": torch.from_numpy(np.array(t)).long(),
           "x_T": torch.from_numpy(np.array(x_T)), "drop": torch.tensor(bool(drop))}
    if enc_noise is not None:
        out["enc_noise"] = torch.from_numpy(enc_noise)
    return out


def _keep_key(latent_shape):
    """A step key whose CFG draw keeps the labels (so the label embedding
    has a gradient)."""
    for i in range(100):
        rng = jax.random.PRNGKey(100 + i)
        if not bool(_draws(rng, latent_shape)["drop"]):
            return rng
    raise AssertionError("no key keeps the labels")


def _batch(shape, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.arange(shape[0], dtype=np.int32) % 2
    return ({"source": jnp.asarray(x), "target": jnp.asarray(y)},
            {"source": torch.from_numpy(x), "target": torch.from_numpy(y).long()})


def _tree(tree):
    """A flax-shaped tree (params, Adam moments) as a torch state dict."""
    return jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), kind="unet")


def _close_tensors(port, ref, atol_frac=2e-5, rtol=2e-3, what=""):
    assert set(port) == set(ref)
    top = max(r.abs().max().item() for r in ref.values())
    for k, r in ref.items():
        p = port[k].detach().float().numpy()
        r = r.float().numpy()
        atol = max(atol_frac * np.abs(r).max(), 5e-2 * atol_frac * top)
        np.testing.assert_allclose(p, r, atol=atol, rtol=rtol, err_msg=f"{what} {k}")


def _close_params(port, ref, steps):
    worst, n_close, n = 0.0, 0, 0
    for k, r in ref.items():
        d = np.abs(port[k].detach().numpy() - r.numpy())
        worst = max(worst, d.max())
        n_close += int((d <= 1e-3 * LR + 1e-6 * np.abs(r.numpy())).sum())
        n += d.size
    assert worst <= 2 * LR * steps, worst
    assert n_close >= 0.999 * n, (n_close, n)


# ---- EMA, schedules, AdamW -------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(update_after_step=5, inv_gamma=2.0, power=0.75,
                                         min_value=0.1, max_value=0.999)],
                         ids=["defaults", "custom"])
def test_ema_decay_matches_jax(kw):
    for step in [0, 1, 2, 3, 6, 7, 10, 100, 1000, 31600, 10**5, 10**6]:
        ref = float(jax_ema_decay(jnp.asarray(step), **kw))
        np.testing.assert_allclose(ema_decay(step, **kw), ref, rtol=1e-6, atol=1e-7,
                                   err_msg=f"step={step}")


@pytest.mark.parametrize("name,warmup", [("const", 0), ("const", 5), ("cosine", 4),
                                         ("cosine", 0), ("lambda_linear", 6),
                                         ("lambda_linear", 0)])
def test_lr_schedule_matches_jax(name, warmup):
    from medfusion_tpu.train.lr_schedules import make_lr_schedule as jax_schedule

    ref = jax_schedule(name, LR, warmup_steps=warmup, total_steps=20)
    mult = make_lr_schedule(name, warmup_steps=warmup, total_steps=20)
    for step in list(range(25)) + [9999, 10000, 10001]:
        np.testing.assert_allclose(LR * mult(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{name} step={step}")


def test_adamw_steps_match_optax():
    """Three AdamW steps with weight decay 0.01, and the lr schedule's
    warmup, against optax.adamw: params and moments (f32, rtol 1e-5)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    from medfusion_tpu.train.lr_schedules import make_lr_schedule as jax_schedule

    tx = optax.adamw(jax_schedule("const", LR, warmup_steps=2), weight_decay=1e-2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    state = TrainState(model, lr=LR, lr_schedule=make_lr_schedule("const", 2))
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    assert state.step == 3
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                   atol=1e-7)
        st = state.optimizer.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(jstate[0].mu[k]),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(jstate[0].nu[k]),
                                   rtol=1e-5, atol=1e-10)


def test_v_target_matches_jax():
    sched_kw = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002,
                    beta_end=0.02)
    rng = np.random.default_rng(4)
    x0, eps = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    t = np.asarray([0, 500, 999], np.int32)
    ref = jax_v_target(JaxSchedule.create(**sched_kw), jnp.asarray(x0), jnp.asarray(eps),
                       jnp.asarray(t))
    out = S.v_target(S.GaussianDiffusionSchedule.create(**sched_kw), torch.from_numpy(x0),
                     torch.from_numpy(eps), torch.from_numpy(t).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


# ---- the training loss and step ---------------------------------------------


@pytest.mark.parametrize("objective,centering", [("x_T", False), ("x_0", True),
                                                ("v", False)])
def test_train_loss_matches_jax_per_objective(objective, centering):
    jax_unet, params, unet = _unet_pair("narrow", 2, 16)
    jp, tp = _pipelines(jax_unet, unet, objective, do_input_centering=centering)
    jbatch, tbatch = _batch((2, 16, 16, 2))
    rng = _keep_key((2, 16, 16, 2))
    loss, metrics = jax.jit(jp.train_loss)({"noise_estimator": params}, jbatch, rng)
    tloss, tmetrics = tp.train_loss(tbatch, _draws(rng, (2, 16, 16, 2)))
    assert float(loss) > 1e-2
    for k in ("loss", "L1", "L2"):
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)


def test_bf16_step_keeps_f32_masters_and_matches_the_f32_loss():
    """make_diffusion_train_step(compute_dtype=bf16): master params,
    gradients and optimizer state stay f32, the caller's modules are not
    cast, and the loss agrees with the f32 step's within rtol 5e-2 (as
    tests/test_train.py holds the JAX bf16 step)."""
    p = presets.PRESETS["smoke"]
    losses, states = {}, {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        pipe = presets.build_train_pipeline(p, device="cpu", attention="spatial",
                                            attn_heads=2, seed=1)
        state = TrainState(pipe.noise_estimator, lr=1e-3, use_ema=True)
        step = make_diffusion_train_step(pipe, compute_dtype=dtype)
        gen = torch.Generator().manual_seed(0)
        ds_batch = {"source": torch.rand((4, 32, 32, 3), generator=gen) * 2 - 1,
                    "target": torch.tensor([0, 1, 0, 1])}
        draws = pipe.train_draws(4, p.latent_shape, generator=gen)
        losses[name] = float(step(state, ds_batch, draws)["loss"])
        states[name] = state
        assert all(q.dtype == torch.float32 for q in pipe.latent_embedder.parameters())
    state = states["bf16"]
    assert {q.dtype for q in state.model.parameters()} == {torch.float32}
    assert {q.grad.dtype for q in state.model.parameters()} == {torch.float32}
    assert {q.dtype for q in state.ema.parameters()} == {torch.float32}
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for v in s.values() if v.is_floating_point())
    np.testing.assert_allclose(losses["bf16"], losses["f32"], rtol=5e-2)


def test_train_loss_refuses_what_is_not_ported(capsys):
    """The flow family refuses the diffusion-schedule options, as the JAX
    CLI does; the eps objective is refused on a zero-terminal-SNR schedule,
    as the JAX pipeline refuses it."""
    with pytest.raises(SystemExit):
        train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--family", "flow",
                              "--min-snr-gamma", "5"])
    assert "the flow family has no schedule" in capsys.readouterr().err
    _, _, unet = _unet_pair("narrow", 2, 16)
    sched = S.GaussianDiffusionSchedule.create(timesteps=T, zero_terminal_snr=True)
    with pytest.raises(ValueError, match="zero-terminal-SNR"):
        DiffusionPipeline(scheduler=sched, noise_estimator=unet)
    with pytest.raises(SystemExit):
        train_diffusion.main(["--preset", "smoke", "--device", "cpu",
                              "--zero-terminal-snr"])


# ---- data and CLI ------------------------------------------------------------


def test_synthetic_data_and_batches_match_jax():
    from medfusion_tpu.data import SimpleDataModule as JaxDM
    from medfusion_tpu.data import SyntheticDataset2D as JaxDS
    from medfusion_tpu_torch.data import SimpleDataModule, SyntheticDataset2D

    kw = dict(n=10, image_size=16, channels=3, num_classes=2, seed=3)
    ref = JaxDM(JaxDS(**kw), batch_size=4, seed=7, num_workers=1)
    dm = SimpleDataModule(SyntheticDataset2D(**kw), batch_size=4, seed=7)
    for epoch in (0, 1):
        got = list(dm.train_dataloader(epoch))
        want = list(ref.train_dataloader(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("flags", [[], ["--attention", "spatial", "--attention-heads", "2",
                                        "--use-ema", "--bf16", "--objective", "v",
                                        "--lr-schedule", "cosine"],
                                   ["--objective", "v", "--zero-terminal-snr",
                                    "--min-snr-gamma", "5"]],
                         ids=["defaults", "spatial-bf16-ema", "v-zero_snr-min_snr"])
def test_train_cli_runs_on_cpu(flags, capsys):
    state, losses, _ = train_diffusion.main(["--preset", "smoke", "--device", "cpu",
                                          "--max-steps", "2", *flags])
    assert state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    assert (state.ema is not None) == ("--use-ema" in flags)
    out = capsys.readouterr().out
    assert "step 1 loss" in out and "done: 2 steps" in out


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_diffusion.main(["--preset", "smoke", "--max-steps", "1"])
    with pytest.raises(SystemExit):
        train_diffusion.main(["--preset", "smoke", "--device", "cpu",
                              "--attention-heads", "4"])
