"""Training the port's other estimator families and the diffusers
autoencoders against the JAX package on the CPU, ``--remat``, and the CLIs.

* One diffusion ``train_loss`` of the legacy, OpenAI and lucidrains UNets
  (tiny configurations of ``tests/test_torch_families.py``, perturbed flax
  params) with the same draws on both sides: the metrics at rtol 1e-5 and
  each gradient tensor within 2e-5 of its max (``tests/test_torch_train.py``).
* One autoencoder loss of the diffusers KL and VQ models (L2, no SSIM, the
  embedding loss at weight 1; the JAX posterior's draw replaced by the
  port's), and the adversarial VQGAN flavour: one PatchGAN, the lambda at
  ``decoder.conv_out.weight``, the discriminator's gate at half of the
  generator's.
* ``remat``: a training step with recomputed blocks (and dropout, whose
  masks the recompute replays from the global RNG) equals the plain step,
  through the bf16 parameter casts that ``functional_call`` swaps in.
* The CLIs with each new ``--estimator`` and ``--model`` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.latent_embedders import NLayerDiscriminator as JaxPatchGAN
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.train.adversarial import AdversarialTrainer as JaxAdversarialTrainer
from medfusion_tpu.train.adversarial import init_discriminators
from medfusion_tpu.train.autoencoder import AutoencoderTrainer as JaxTrainer
from medfusion_tpu_torch.cli import (
    distill,
    helpers,
    presets,
    sample,
    sample_dataset,
    train_autoencoder,
    train_diffusion,
)
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.models.latent_embedders import NLayerDiscriminator
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.train.adversarial import AdversarialTrainer
from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer
from medfusion_tpu_torch.train.diffusion import estimator_params
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.weights import (
    jax_classifier_to_state_dict,
    jax_diffusers_vae_to_state_dict,
    jax_gan_to_state_dicts,
    jax_lucidrains_to_state_dict,
    jax_params_to_state_dict,
)
from tests.test_torch_families import (  # noqa: F401  (fixed_posterior: a fixture)
    IMG,
    KEY,
    _legacy,
    _randomize,
    ae_pair,
    fixed_posterior,
    lucid_pair,
    nchw,
    openai_pair,
)
from tests.test_torch_train import _batch, _close_tensors

SMOKE = presets.PRESETS["smoke"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sched(mod):
    return mod.create(timesteps=20, schedule_strategy="scaled_linear", beta_start=0.002,
                      beta_end=0.02)


FAMILIES = {
    "unet_legacy": (lambda: _legacy(deep_supervision=1)[:3],
                    lambda g, m: jax_params_to_state_dict(g, "unet_legacy")),
    "openai": (lambda: openai_pair(use_scale_shift_norm=True, resblock_updown=True)[:3],
               jax_classifier_to_state_dict),
    "lucidrains": (lambda: lucid_pair(self_condition=False)[:3], jax_lucidrains_to_state_dict),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_train_loss_and_gradients_match_jax(family):
    make, to_sd = FAMILIES[family]
    jm, params, model = make()
    common = dict(estimator_objective="x_T", do_input_centering=False, clip_x0=False)
    jp = JaxPipeline(scheduler=_sched(JaxSchedule), noise_estimator=jm, **common)
    tp = DiffusionPipeline(scheduler=_sched(S.GaussianDiffusionSchedule), noise_estimator=model,
                           **common)
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
    ref = to_sd(jax.tree_util.tree_map(np.asarray, grads), model)
    _close_tensors({k: q.grad for k, q in model.named_parameters()}, ref, what=family)


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_diffusers_autoencoder_loss_and_gradients_match_jax(fixed_posterior, kind):
    jm, params, model, x = ae_pair(kind)
    flavor = "vae" if kind == "kl" else "vqvae"
    kw = dict(flavor=flavor, pixel_loss="l2", embedding_loss_weight=1.0, use_ssim=False)
    jt = JaxTrainer(autoencoder=jm, **kw)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jt.loss, has_aux=True))(
        params, None, {"source": jnp.asarray(x)}, KEY)
    trainer = AutoencoderTrainer(model, **kw)
    tloss, tmetrics = trainer.loss(nchw(x), nchw(fixed_posterior) if kind == "kl" else None)
    tloss.backward()
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]), rtol=1e-4,
                                   err_msg=k)
    ref = jax_diffusers_vae_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), model)
    _close_tensors({k: q.grad for k, q in model.named_parameters()}, ref, what=kind)


def test_diffusers_vqgan_step_matches_jax():
    """The VQGAN of the diffusers family: at generator step 6 (terms on
    after 4) the loss, lambda and adversarial term, and the gradient of the
    lambda's anchor ``decoder.conv_out``; the discriminator's loss at step
    3 (its gate at 2 is open) and at step 1 (closed)."""
    jm, params, model, x = ae_pair("vq")
    kw = dict(flavor="vqvae", pixel_loss="l2", embedding_loss_weight=1.0, use_ssim=False)
    dkw = dict(hid_chs=(4, 8, 8), kernel_sizes=(4, 4, 4), strides=(2, 2, 1))
    jdisc = JaxPatchGAN(**dkw)
    disc_vars = jax.tree_util.tree_map(np.asarray, init_discriminators(jdisc, KEY, [IMG]))
    disc_vars["disc_0"]["params"] = _randomize(disc_vars["disc_0"]["params"], 7)
    dparams = {"disc_0": disc_vars["disc_0"]["params"]}
    dstats = {"disc_0": disc_vars["disc_0"]["batch_stats"]}
    jtr = JaxAdversarialTrainer(ae_trainer=JaxTrainer(autoencoder=jm, **kw), discriminator=jdisc,
                                n_discriminators=1, start_gan_train_step=4,
                                start_disc_train_step=2)
    discs = torch.nn.ModuleList([NLayerDiscriminator(**dkw)])
    discs.load_state_dict(jax_gan_to_state_dicts({}, dparams, dstats)[1], strict=True)
    trainer = AdversarialTrainer(AutoencoderTrainer(model, **kw), discs,
                                 start_gan_train_step=4, start_disc_train_step=2)
    batch = {"source": jnp.asarray(x)}
    (loss, (metrics, pred, _, _)), grads = jax.jit(jax.value_and_grad(
        jtr.generator_loss, has_aux=True))(params, dparams, dstats, None, batch, KEY,
                                           jnp.asarray(6))
    discs.requires_grad_(False)
    tloss, tmetrics, tpred, _ = trainer.generator_loss(nchw(x), None, 6)
    tloss.backward()
    discs.requires_grad_(True)
    for k in ("lambda_0", "gan_loss_0", "img_loss", "emb_loss"):
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]), rtol=1e-4, err_msg=k)
    assert 1e-3 < float(metrics["lambda_0"]) < 1e3  # off its clip
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    head = jax_diffusers_vae_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), model)
    _close_tensors({k: q.grad for k, q in model.named_parameters() if "conv_out" in k
                    and k.startswith("decoder")},
                   {k: v for k, v in head.items() if "conv_out" in k and k.startswith("decoder")},
                   what="conv_out")
    for step, on in ((3, True), (1, False)):
        dloss, _ = jtr.discriminator_loss(dparams, dstats, batch, pred, [], jnp.asarray(step))
        tdloss, _ = trainer.discriminator_loss(nchw(x), tpred.detach(), [], step)
        assert (abs(float(dloss)) > 1e-3) == on
        np.testing.assert_allclose(tdloss.item(), float(dloss), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("family", ["unet", "openai"])
def test_remat_step_equals_the_plain_step(family):
    """Gradient checkpointing (with dropout 0.3 in every block) recomputes
    the blocks in the backward from the bf16 casts of the masters; the loss
    and every gradient equal the plain step's at the same seed (to 1e-6 of
    the tensor's max: the same operations in the same order)."""
    options = dict(dropout=0.3)
    if family == "openai":
        options["attention_resolutions"] = (2,)
    out = {}
    for remat in (False, True):
        with presets.seeded(torch.device("cpu"), 0):
            model = presets.build_unet(SMOKE, family, remat=remat, **options)
        pipe = DiffusionPipeline(scheduler=_sched(S.GaussianDiffusionSchedule),
                                 noise_estimator=model, do_input_centering=False,
                                 compute_dtype=torch.bfloat16)
        _, tbatch = _batch((2, 8, 8, 2))
        draws = pipe.train_draws(2, (8, 8, 2), generator=torch.Generator().manual_seed(1))
        torch.manual_seed(5)  # the dropout masks
        loss, _ = pipe.train_loss(tbatch, draws,
                                  estimator_params=estimator_params(model, torch.bfloat16))
        loss.backward()
        out[remat] = (loss.detach(), {k: q.grad for k, q in model.named_parameters()})
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=0,
                                   atol=1e-6 * g.abs().max().item(), msg=k)


# ---- the CLIs --------------------------------------------------------------------


@pytest.mark.parametrize("estimator", ["unet_legacy", "openai", "lucidrains"])
def test_estimator_clis_run_on_cpu(tmp_path, estimator):
    """``--estimator`` through training (the config records the family, a
    resume with another is refused), ``cli.sample`` from the checkpoint
    (the family from its config), ``cli.sample_dataset``, ``cli.helpers``
    and ``cli.distill``; ``--remat`` where the family has it."""
    common = ["--preset", "smoke", "--device", "cpu"]
    run = tmp_path / "run"
    extra = ["--attention", "spatial"] if estimator == "unet_legacy" else ["--remat"]
    state, losses, pipe = train_diffusion.main(
        [*common, "--estimator", estimator, "--max-steps", "1", "--out", str(run),
         "--use-ema", *extra])
    assert np.isfinite(losses).all() and state.step == 1
    assert getattr(pipe.noise_estimator, "remat", False) == (estimator == "openai")
    with pytest.raises(SystemExit, match="estimator"):
        train_diffusion.main([*common, "--max-steps", "2", "--out", str(run), "--use-ema",
                              "--resume", *extra])
    out = sample.main([*common, "--ckpt", str(run), "--ema", "--dtype", "f32", "--steps", "2",
                       "--n", "2", *extra[:2 if estimator == "unet_legacy" else 0],
                       "--out", str(tmp_path / "s")])
    assert all(v.shape == (2, 32, 32, 3) and np.isfinite(v).all() for v in out.values())
    if estimator == "unet_legacy":
        return
    dirs = sample_dataset.main([*common, "--ckpt", str(run), "--dtype", "f32", "--steps-list",
                                "2", "--n-samples", "2", "--chunk", "2", "--out",
                                str(tmp_path / "fake")])
    assert len(list(dirs[(2, 0)].glob("*.png"))) == 2
    helpers.main(["interpolate", "--device", "cpu", "--ckpt", str(run), "--steps", "2",
                  "--out", str(tmp_path / "h")])
    assert list((tmp_path / "h").glob("*.png"))
    recs = distill.main([*common, "--method", "pd", "--estimator", estimator, "--teacher-ckpt",
                         str(run), "--objective", "x_T", "--start-steps", "4", "--stages", "1",
                         "--iters-per-stage", "1", "--out", str(tmp_path / "d")])
    assert np.isfinite(recs[0]["losses"]).all()


@pytest.mark.parametrize("model", ["diffusers_kl", "diffusers_vq"])
def test_diffusers_autoencoder_gan_resume_is_exact(tmp_path, model):
    """``--model diffusers_* --gan``: one PatchGAN, the discriminator's terms
    on from optimizer step 2 and the generator's from 4; 3 batches straight
    equal 2 and a ``--resume`` to 3, bit for bit."""
    common = ["--preset", "smoke", "--device", "cpu", "--model", model, "--gan",
              "--start-gan-step", "4", "--ckpt-every", "1", "--sample-every", "0"]
    a, losses = train_autoencoder.main([*common, "--max-steps", "3", "--out", str(tmp_path / "a")])
    assert len(a.disc.model) == 1 and isinstance(a.disc.model[0], NLayerDiscriminator)
    assert np.isfinite(losses).all()
    train_autoencoder.main([*common, "--max-steps", "2", "--out", str(tmp_path / "b")])
    b, _ = train_autoencoder.main([*common, "--max-steps", "3", "--out", str(tmp_path / "b"),
                                   "--resume"])
    for name, ref in a.gen.model.state_dict().items():
        assert torch.equal(b.gen.model.state_dict()[name], ref), name
    for name, ref in a.disc.model.state_dict().items():
        assert torch.equal(b.disc.model.state_dict()[name], ref), name
    assert C.latest_step(tmp_path / "b" / "checkpoints") == 3


@pytest.mark.parametrize("argv", [
    [train_diffusion, "--estimator", "openai", "--remat"],
    [train_diffusion, "--estimator", "lucidrains"],
    [train_autoencoder, "--model", "diffusers_vq", "--gan"],
], ids=["openai-remat", "lucidrains", "diffusers_vq-gan"])
def test_new_families_default_to_the_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli, *flags = argv
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--preset", "smoke", "--max-steps", "1", *flags])
