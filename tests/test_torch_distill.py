"""The port's distillation (``train/{distillation,consistency,reflow}.py``)
against the JAX package's, float32 on the CPU, and ``cli.distill``.

A tiny DiT (hidden 16, one block: its JAX graphs compile in a few
seconds), with perturbed JAX params for the teacher and others for the
student (and the target network), no latent embedder; the CLI runs use the
smoke preset's UNet. The JAX losses draw
from their keys; the tests rebuild those draws (``split(rng)`` -> the
level index, then the noise; the flow time straight from the key; the
consistency sampler's ``fold_in(rng, i)``) and feed them to the port.

Tolerances: losses and metrics rtol 1e-5; each gradient tensor within
2e-5 of its max (``tests/test_torch_train.py``); latents and samples at
1e-4 of their scale (``tests/test_torch_samplers.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.dit import DiT as JaxDiT
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlow
from medfusion_tpu.train import consistency as jcm
from medfusion_tpu.train import distillation as jpd
from medfusion_tpu.train import reflow as jrf
from medfusion_tpu_torch.cli import distill, sample
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.models.dit import DiT
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.train import consistency as CM
from medfusion_tpu_torch.train import distillation as PD
from medfusion_tpu_torch.train import reflow as RF
from medfusion_tpu_torch.utils.weights import jax_dit_to_state_dict
from tests.test_torch_models import _randomize
from tests.test_torch_pipeline import _assert_close
from tests.test_torch_train import _close_tensors

B = 2
SHAPE = (B, 8, 8, 2)
T = 40
SCHED = dict(timesteps=T, schedule_strategy="scaled_linear", beta_start=0.002, beta_end=0.02)
DIT_KW = dict(in_ch=2, patch_size=2, hidden_size=16, depth=1, num_heads=2,
              cond_emb_num_classes=2)
COND = np.array([0, 1], np.int32)
X0 = np.random.default_rng(5).uniform(-1, 1, SHAPE).astype(np.float32)
_PARAMS, _PAIRS = {}, {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params(seed):
    """Perturbed flax params of the tiny DiT (cached by seed)."""
    if seed not in _PARAMS:
        z = jnp.zeros((1,) + SHAPE[1:], jnp.float32)
        t = jnp.zeros((1,), jnp.int32)
        _PARAMS[seed] = _randomize(jax.eval_shape(JaxDiT(**DIT_KW).init,
                                                  jax.random.PRNGKey(0), z, t, t)["params"], seed)
    return _PARAMS[seed]


def tparams(seed):
    """The same params as a port parameter dict."""
    return jax_dit_to_state_dict(params(seed))


def estimator(seed):
    dit = DiT(**DIT_KW)
    dit.load_state_dict(tparams(seed))
    return dit


def diffusion_pair(objective):
    common = dict(estimator_objective=objective, clip_x0=False, do_input_centering=False)
    jp = JaxPipeline(scheduler=JaxSchedule.create(**SCHED), noise_estimator=JaxDiT(**DIT_KW),
                     **common)
    student = estimator(71)
    tp = DiffusionPipeline(scheduler=S.GaussianDiffusionSchedule.create(**SCHED),
                           noise_estimator=student, **common)
    return jp, tp, student


def _t(a):
    return torch.from_numpy(np.array(a))


def batches(guided):
    jb = {"source": jnp.asarray(X0), "target": jnp.asarray(COND)}
    tb = {"source": _t(X0), "target": _t(COND).long()}
    if guided:
        jb["un_cond"] = jnp.asarray(1 - COND)
        tb["un_cond"] = 1 - tb["target"]
    return jb, tb


def check(tloss, tmetrics, student, loss, metrics, grads):
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    tloss.backward()
    _close_tensors({k: q.grad for k, q in student.named_parameters()},
                   jax_dit_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.mark.parametrize("T_,n", [(1000, 208), (1000, 16), (40, 4), (40, 20)])
def test_student_grid_matches_jax(T_, n):
    i = np.arange(1, n + 1, dtype=np.int32)
    want = [np.asarray(a) for a in jpd.student_timestep_grid(T_, n)(jnp.asarray(i))]
    got = [a.numpy() for a in PD.student_timestep_grid(T_, n)(torch.from_numpy(i))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    trailing = S.GaussianDiffusionSchedule.create(timesteps=T_).ddim_timesteps_host(n, "trailing")
    np.testing.assert_array_equal(np.sort(trailing),
                                  PD.student_sample_timesteps(S.GaussianDiffusionSchedule.create(
                                      timesteps=T_), n).numpy())
    assert [PD.next_stage_steps(k) for k in (8, 3, 1)] == [4, 1, None]


# name -> (objective, teacher guidance)
PD_CASES = {"v": ("v", 1.0), "eps-guided": ("x_T", 2.0)}


@pytest.mark.parametrize("case", sorted(PD_CASES))
def test_progressive_distillation_loss_matches_jax(case):
    objective, tg = PD_CASES[case]
    jp, tp, student = diffusion_pair(objective)
    n = 4
    jb, tb = batches(tg != 1.0)
    rng = jax.random.PRNGKey(11)
    k_i, k_noise = jax.random.split(rng)
    draws = {"i": _t(jax.random.randint(k_i, (B,), 1, n + 1)),
             "noise": _t(jax.random.normal(k_noise, SHAPE))}
    jloss = jpd.make_distillation_loss(jp, n, tg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda s: jloss(s, params(72), jb, rng), has_aux=True))(params(71))
    tloss, tmetrics = PD.make_distillation_loss(tp, n, tg)(
        dict(student.named_parameters()), tparams(72), tb, draws)
    check(tloss, tmetrics, student, loss, metrics, grads)
    if tg == 1.0:  # the targets themselves
        want = jax.jit(lambda i, z: jpd.distillation_targets(
            jp, {"noise_estimator": params(72)}, jnp.asarray(X0), i, z, n,
            jnp.asarray(COND)))(jnp.asarray(draws["i"].numpy()),
                                jnp.asarray(draws["noise"].numpy()))
        got = PD.distillation_targets(tp, tparams(72), tb["source"], draws["i"],
                                      draws["noise"], n, tb["target"])
        for w, g in zip(want, got):
            _assert_close(g.numpy().reshape(np.shape(w)), np.asarray(w), 1e-4)


# name -> (solver, huber_c, teacher guidance, EMA target)
CD_CASES = {"euler-l2-ema-guided": ("euler", None, 2.0, True),
            "heun-huber": ("heun", 0.03, 1.0, False)}


@pytest.mark.parametrize("case", sorted(CD_CASES))
def test_consistency_distillation_loss_matches_jax(case):
    solver, huber, tg, ema = CD_CASES[case]
    jp, tp, student = diffusion_pair("v")
    n_grid = 6
    jb, tb = batches(tg != 1.0)
    rng = jax.random.PRNGKey(12)
    k_n, k_noise = jax.random.split(rng)
    draws = {"n": _t(jax.random.randint(k_n, (B,), 0, n_grid - 1)),
             "eps": _t(jax.random.normal(k_noise, SHAPE))}
    target = 73 if ema else 71
    kw = dict(n_grid=n_grid, sigma_data=0.5, huber_c=huber, teacher_guidance_scale=tg,
              solver=solver)
    jloss = jcm.make_consistency_distillation_loss(jp, **kw)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda s: jloss(s, params(target), params(72), jb, rng), has_aux=True))(params(71))
    tloss, tmetrics = CM.make_consistency_distillation_loss(tp, **kw)(
        dict(student.named_parameters()), tparams(target), tparams(72), tb, draws)
    check(tloss, tmetrics, student, loss, metrics, grads)


def test_consistency_training_loss_and_curriculum_match_jax():
    jp, tp, student = diffusion_pair("x_T")
    n_grid = 7
    jb, tb = batches(False)
    rng = jax.random.PRNGKey(13)
    kw = dict(n_grid=n_grid, sigma_data=0.5, huber_c=0.01)
    jloss = jcm.make_consistency_training_loss(jp, **kw)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda s: jloss(s, jb, rng), has_aux=True))(params(71))
    # the JAX draw: categorical over the grid pairs, then eps
    k_n, k_noise = jax.random.split(rng)
    logits = CM.ct_grid_logits(tp.scheduler, n_grid)
    draws = {"n": _t(jax.random.categorical(k_n, jnp.asarray(logits.numpy()), shape=(B,))),
             "eps": _t(jax.random.normal(k_noise, SHAPE))}
    tloss, tmetrics = CM.make_consistency_training_loss(tp, **kw)(
        dict(student.named_parameters()), tb, draws)
    check(tloss, tmetrics, student, loss, metrics, grads)
    for args in ((100, 10, 1280, None), (7, 10, 40, None), (30, 10, 1280, 2), (5, 3, 3, None)):
        assert CM.ct_curriculum_grid(*args) == jcm.ct_curriculum_grid(*args)
    n = CM.ct_draws(logits, 4096, SHAPE[1:], generator=torch.Generator().manual_seed(0))["n"]
    freq = np.bincount(n.numpy(), minlength=n_grid - 1) / 4096
    np.testing.assert_allclose(freq, torch.softmax(logits, 0).numpy(), atol=0.03)


def test_consistency_sample_matches_jax():
    jp, tp, student = diffusion_pair("v")
    tp.noise_estimator.load_state_dict(tparams(72))
    rng = jax.random.PRNGKey(14)
    steps = 3
    x_T = np.random.default_rng(9).standard_normal(SHAPE).astype(np.float32)
    tree = {"noise_estimator": params(72)}
    want = jax.jit(lambda x: jcm.consistency_sample(
        jp, tree, x, rng=rng, steps=steps, condition=jnp.asarray(COND), decode=False))(x_T)
    noise = torch.stack([_t(jax.random.normal(jax.random.fold_in(rng, i), SHAPE))
                         for i in range(steps - 1)])
    got = CM.consistency_sample(tp, _t(x_T), noise=noise, steps=steps,
                                condition=_t(COND).long(), decode=False)
    _assert_close(got.numpy(), np.asarray(want), 1e-4)
    one = CM.consistency_sample(tp, _t(x_T), steps=1, condition=_t(COND).long(), decode=False)
    _assert_close(one.numpy(), np.asarray(jax.jit(lambda x: jcm.consistency_sample(
        jp, tree, x, steps=1, condition=jnp.asarray(COND), decode=False))(x_T)), 1e-4)
    with pytest.raises(ValueError, match="noise must have shape"):
        CM.consistency_sample(tp, _t(x_T), noise=noise[:1], steps=steps, decode=False)


@pytest.mark.parametrize("distill_t", [None, 1.0], ids=["sampled-t", "one-step"])
def test_reflow_pairs_and_loss_match_jax(distill_t):
    """The teacher's ODE pairs from the same z1, then the reflow loss on
    them with the time drawn from the key (logit-normal, shift 2) or fixed."""
    jm = JaxDiT(**DIT_KW)
    teacher, student = estimator(72), estimator(71)
    kw = dict(do_input_centering=False, shift=2.0)
    jf = JaxFlow(noise_estimator=jm, **kw)
    tf = FlowMatchingPipeline(noise_estimator=teacher, **kw)
    rng = jax.random.PRNGKey(15)
    if "reflow" not in _PAIRS:  # the same JAX pairs for both cases
        _PAIRS["reflow"] = jrf.generate_reflow_pairs(
            jf, {"noise_estimator": params(72)}, rng, B, SHAPE[1:],
            condition=jnp.asarray(COND), steps=3)
    z1, z0 = _PAIRS["reflow"]
    t_z1, t_z0 = RF.generate_reflow_pairs(tf, _t(z1), condition=_t(COND).long(), steps=3)
    _assert_close(t_z0.numpy(), np.asarray(z0), 1e-4)
    jb = {"z0": z0, "z1": z1, "target": jnp.asarray(COND)}
    tb = {"z0": _t(z0), "z1": t_z1, "target": _t(COND).long()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda s: jrf.make_reflow_loss(jf, distill_t)(s, jb, rng), has_aux=True))(params(71))
    ts = FlowMatchingPipeline(noise_estimator=student, **kw)
    draws = {"t_draw": _t(jax.random.normal(rng, (B,)))}
    tloss, tmetrics = RF.make_reflow_loss(ts, distill_t)(dict(student.named_parameters()), tb,
                                                         draws)
    check(tloss, tmetrics, student, loss, metrics, grads)


def test_train_steps_update_the_student():
    """The three train steps run an AdamW step on the student (the cast
    and frozen teacher/target parameters take no update)."""
    from medfusion_tpu_torch.train import TrainState

    _, tp, student = diffusion_pair("v")
    teacher = estimator(72)
    _, tb = batches(False)
    gen = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = TrainState(student, lr=1e-3, use_ema=True)
    m = PD.make_distillation_train_step(tp, 4)(
        state, teacher, tb, PD.distillation_draws(B, SHAPE[1:], 4, generator=gen))
    m2 = CM.make_consistency_train_step(tp, n_grid=5)(
        state, teacher, tb, CM.consistency_draws(B, SHAPE[1:], 5, generator=gen))
    assert state.step == 2 and np.isfinite([float(m["loss"]), float(m2["loss"])]).all()
    assert all(torch.equal(v, teacher.state_dict()[k]) for k, v in before.items())


def test_distill_cli_methods_run_on_cpu(tmp_path, capsys):
    """Each method on the smoke preset: pd (two stages, then a resume that
    fast-forwards both), cd with an EMA target and a guided teacher, then
    ``cli.sample --sampler consistency`` from it, ct, and reflow from a flow
    run (pool regeneration and the one-step phase)."""
    from medfusion_tpu_torch.cli import train_diffusion

    base = ["--preset", "smoke", "--device", "cpu", "--iters-per-stage", "2"]
    pd_out = tmp_path / "pd"
    recs = distill.main([*base, "--method", "pd", "--start-steps", "2", "--out", str(pd_out),
                         "--ckpt-every", "1"])
    assert [r["tag"] for r in recs] == ["stage 2-step", "stage 1-step"]
    assert all(len(r["losses"]) == 2 for r in recs)
    again = distill.main([*base, "--method", "pd", "--start-steps", "2", "--out", str(pd_out),
                          "--resume"])
    assert all(r["losses"] == [] for r in again)
    cd_out = tmp_path / "cd"
    distill.main([*base, "--method", "cd", "--cd-ema", "--teacher-guidance", "2", "--cd-solver",
                  "euler", "--out", str(cd_out)])
    imgs = sample.main(["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--sampler",
                        "consistency", "--objective", "v", "--ckpt", str(cd_out / "consistency"),
                        "--ema",
                        "--steps", "2", "--n", "2", "--out", str(tmp_path / "s")])
    assert all(v.shape == (2, 32, 32, 3) and np.isfinite(v).all() for v in imgs.values())
    (ct_rec,) = distill.main([*base, "--method", "ct", "--ct-doublings", "2", "--out",
                              str(tmp_path / "ct")])
    assert "ct curriculum: N=21" in capsys.readouterr().out
    flow = tmp_path / "flow"
    train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--family", "flow",
                          "--max-steps", "1", "--out", str(flow)])
    recs = distill.main([*base, "--method", "reflow", "--teacher-ckpt", str(flow),
                         "--reflow-teacher-steps", "2", "--pair-batches", "2", "--regen-every",
                         "2", "--reflow-distill-iters", "1", "--out", str(tmp_path / "rf")])
    assert [r["tag"] for r in recs] == ["reflow", "reflow_1step"]
    assert np.isfinite(ct_rec["losses"]).all() and all(np.isfinite(r["losses"]).all()
                                                       for r in recs)


@pytest.mark.parametrize("flags,why", [
    (["--method", "ct", "--teacher-ckpt", "runs/d"], "teacher-free"),
    (["--estimator", "openai"], None),
    (["--estimator", "dit", "--attention", "spatial"], "own attention"),
], ids=["ct-teacher", "openai", "dit-attention"])
def test_distill_cli_refusals(capsys, tmp_path, flags, why):
    """What the JAX CLI refuses is refused; a case without a reason (the
    OpenAI family, ported since) distils one iteration."""
    argv = ["--preset", "smoke", "--device", "cpu", *flags]
    if why is None:
        recs = distill.main([*argv, "--method", "ct", "--ct-doublings", "1",
                             "--iters-per-stage", "1", "--out", str(tmp_path / "d")])
        assert all(np.isfinite(r["losses"]).all() for r in recs)
        return
    with pytest.raises(SystemExit):
        distill.main(argv)
    assert why in capsys.readouterr().err


def test_distill_refuses_what_the_jax_package_refuses():
    _, tp, _ = diffusion_pair("v")
    import dataclasses

    with pytest.raises(ValueError, match="student_steps"):
        PD.make_distillation_loss(tp, T)
    with pytest.raises(ValueError, match="clip_x0=False"):
        CM.make_consistency_training_loss(dataclasses.replace(tp, clip_x0=True))
    with pytest.raises(ValueError, match="solver"):
        CM.make_consistency_distillation_loss(tp, solver="rk4")
    with pytest.raises(ValueError, match="distill_t"):
        RF.make_reflow_loss(None, distill_t=1.5)
