"""The port's DiT (``medfusion_tpu_torch/models/dit.py``) against the JAX
package's, float32 on the CPU, and its CLIs.

Tiny DiTs (hidden 32, 2 heads, depth 2, patch 2) whose flax params are
perturbed away from zero first: a fresh DiT outputs exactly zero
(adaLN-Zero and the zero final layer), so an unperturbed comparison proves
nothing. The JAX side runs with flash attention off (its default), i.e.
its plain attention. Latents of 8 x 12 (non-square) check the patch order.

Tolerances: the forward at the UNet's, rtol 2e-4 / atol 2e-5; one
training loss at rtol 1e-5 and each gradient tensor within 2e-5 of its
max (``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.cli import presets as jax_presets
from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.dit import DiT as JaxDiT
from medfusion_tpu.models.dit import sincos_2d_pos_embed as jax_sincos
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu_torch.cli import helpers, presets, sample, sample_dataset, train_diffusion
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.models.dit import DiT, sincos_2d_pos_embed
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.utils.weights import jax_dit_to_state_dict, load_jax_params
from tests.test_torch_models import _randomize, nchw, nhwc
from tests.test_torch_train import _batch, _close_tensors
from tests.torch_parallel_worker import one_rank_group

SMOKE = presets.PRESETS["smoke"]
KW = dict(in_ch=2, patch_size=2, hidden_size=32, depth=2, num_heads=2,
          cond_emb_num_classes=2)
B, H, W = 2, 8, 12
T_IN = np.array([3, 700], np.int32)
COND = np.array([0, 1], np.int32)
MASK = np.array([1.0, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dits(seed=31, h=H, w=W, **options):
    """(JAX DiT, its perturbed params, the port's DiT loaded with them)."""
    kw = dict(KW, **options)
    jd = JaxDiT(**kw)
    z = jnp.zeros((1, h, w, 2), jnp.float32)
    t = jnp.zeros((1,), jnp.int32)
    params = _randomize(jax.eval_shape(jd.init, jax.random.PRNGKey(0), z, t, t)["params"],
                        seed)
    dit = DiT(**kw)
    load_jax_params(dit, params, kind="dit")
    return jd, params, dit


def inputs(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, h, w, 2)).astype(np.float32),
            rng.standard_normal((B, h, w, 2)).astype(np.float32))


# name -> (DiT options, latent (h, w), call: condition, cond_mask, self_cond)
FORWARD_CASES = {
    "labels": ({}, (H, W), (True, False, False)),
    "cond_mask": ({}, (H, W), (True, True, False)),
    "no_condition": ({}, (H, W), (False, False, False)),
    "learn_sigma": (dict(learn_sigma=True), (H, W), (True, True, False)),
    "self_conditioning": (dict(use_self_conditioning=True), (H, W), (True, True, True)),
    "square": ({}, (8, 8), (True, True, False)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_dit_forward_matches_jax(case):
    options, (h, w), (use_cond, use_mask, use_sc) = FORWARD_CASES[case]
    jd, params, dit = dits(h=h, w=w, **options)
    x, sc = inputs(h=h, w=w)
    cond = COND if use_cond else None
    mask = MASK if use_mask else None
    ref, ver = jd.apply({"params": params}, x, T_IN, cond, sc if use_sc else None, mask)
    with torch.no_grad():
        out, tver = dit(nchw(x), torch.from_numpy(T_IN),
                        None if cond is None else torch.from_numpy(cond).long(),
                        None if mask is None else torch.from_numpy(mask),
                        self_cond=nchw(sc) if use_sc else None)
    assert ver == [] and tver == []
    assert np.abs(np.asarray(ref)).max() > 0.1  # the perturbation reached the output
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_dit_train_loss_and_gradients_match_jax():
    """One diffusion ``train_loss`` on the DiT (v objective, labels kept),
    the same draws on both sides: the loss and each gradient tensor."""
    jd, params, dit = dits(learn_sigma=False)
    jsched = JaxSchedule.create(timesteps=20, schedule_strategy="scaled_linear",
                                beta_start=0.002, beta_end=0.02)
    common = dict(estimator_objective="v", do_input_centering=False, clip_x0=False)
    jp = JaxPipeline(scheduler=jsched, noise_estimator=jd, **common)
    tp = DiffusionPipeline(scheduler=S.GaussianDiffusionSchedule.create(
        timesteps=20, schedule_strategy="scaled_linear", beta_start=0.002, beta_end=0.02),
        noise_estimator=dit, **common)
    jbatch, tbatch = _batch((B, H, W, 2))
    rng = jax.random.PRNGKey(3)
    _, k_t, k_noise, k_cfg, _ = jax.random.split(rng, 5)
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 20))),
             "x_T": torch.from_numpy(np.array(jax.random.normal(k_noise, (B, H, W, 2)))),
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
    ref = jax_dit_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    port = {k: q.grad for k, q in dit.named_parameters()}
    _close_tensors(port, ref, what="dit")


def test_dit_converter_transposes_every_dense_kernel():
    """Every 2-D kernel is transposed, the square ones (``attn_proj``,
    ``t_embedder.mlp_2``) included: left as they are they load under
    ``strict=True`` and the forward departs; the DiT-MoE's 3-D expert
    weights and the router load strictly too."""
    jd, params, dit = dits()
    sd = jax_dit_to_state_dict(params)
    blk = params["blocks_0"]
    np.testing.assert_array_equal(sd["blocks.0.attn_proj.weight"].numpy(),
                                  blk["attn_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["t_embedder.mlp_2.weight"].numpy(),
                                  params["t_embedder"]["mlp_2"]["kernel"].T)
    np.testing.assert_array_equal(sd["y_embedder.weight"].numpy(),
                                  params["y_embedder"]["embedding"])
    x, _ = inputs()
    ref = np.asarray(jd.apply({"params": params}, x, T_IN, COND)[0])
    wrong = dict(sd)
    for key in ("blocks.0.attn_proj.weight", "blocks.1.attn_proj.weight",
                "t_embedder.mlp_2.weight"):
        wrong[key] = wrong[key].t().contiguous()
    bad = DiT(**KW)
    bad.load_state_dict(wrong, strict=True)  # square: the shapes cannot tell
    with torch.no_grad():
        out = nhwc(bad(nchw(x), torch.from_numpy(T_IN), torch.from_numpy(COND).long())[0])
    assert np.abs(out - ref).max() > 1e-2
    _, moe_params, moe = dits(moe_experts=4, moe_every=1)
    assert set(moe.state_dict()) == set(jax_dit_to_state_dict(moe_params))
    assert moe.blocks[0].moe_mlp.w1.shape == (4, 32, 128)


def test_fresh_dit_is_zero_and_initialised_as_flax():
    """adaLN-Zero and the zero final layer: a fresh DiT outputs zero; the
    2-D Linears are xavier-uniform, the time MLP and the label table
    N(0, 0.02)."""
    torch.manual_seed(0)
    dit = DiT(in_ch=2, hidden_size=64, depth=2, num_heads=4, cond_emb_num_classes=2)
    x = torch.randn(2, 2, 8, 8)
    out, _ = dit(x, torch.tensor([1, 2]), torch.tensor([0, 1]))
    assert out.shape == x.shape and not out.any()
    for lin in (dit.final_layer.linear, dit.final_layer.adaLN_modulation,
                dit.blocks[0].adaLN_modulation):
        assert not lin.weight.any() and not lin.bias.any()
    w = dit.blocks[0].attn_qkv.weight
    bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    for w in (dit.t_embedder.mlp_0.weight, dit.y_embedder.weight):
        assert abs(w.std().item() - 0.02) < 2e-3


def test_sincos_pos_embed_matches_jax():
    for dim, h, w in ((32, 4, 6), (1024, 16, 16)):
        np.testing.assert_array_equal(sincos_2d_pos_embed(dim, h, w), jax_sincos(dim, h, w))
    with pytest.raises(ValueError, match="% 4"):
        sincos_2d_pos_embed(30, 2, 2)


@pytest.mark.parametrize("preset", sorted(presets.PRESETS))
def test_dit_sizing_matches_the_jax_cli(preset):
    jd = jax_presets.build_unet(jax_presets.PRESETS[preset], "dit")
    want = dict(in_ch=jd.in_ch, patch_size=jd.patch_size, hidden_size=jd.hidden_size,
                depth=jd.depth, num_heads=jd.num_heads,
                cond_emb_num_classes=jd.cond_emb_num_classes)
    assert presets.dit_sizing(presets.PRESETS[preset]) == want


def test_dit_refuses_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="divisible by num_heads"):
        DiT(in_ch=2, hidden_size=36, num_heads=5)
    with pytest.raises(ValueError, match="divisible by 4"):
        DiT(in_ch=2, hidden_size=18, num_heads=3)
    with pytest.raises(ValueError, match="not divisible by patch"):
        DiT(**KW)(torch.zeros(1, 2, 7, 8))
    # expert parallelism over a group of one rank: the same weights, the same
    # forward and aux loss bit for bit
    torch.manual_seed(0)
    dense = DiT(**KW, moe_experts=2)
    x = torch.randn(2, 2, 8, 8)
    t, c = torch.tensor([3, 5]), torch.tensor([0, 1])
    with one_rank_group() as group:
        ep = DiT(**KW, moe_experts=2, moe_expert_axis=group)
        ep.load_state_dict(dense.state_dict(), strict=True)
        want, got = dense(x, t, c, with_aux=True), ep(x, t, c, with_aux=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    for kw, why in ((dict(attention="spatial"), "fixes its own attention"),
                    (dict(attn_heads=4), "unet-family option")):
        with pytest.raises(ValueError, match=why):
            presets.build_unet(SMOKE, "dit", **kw)
    # the other families build (ported since), each with its own attention
    from medfusion_tpu_torch.models.unet_openai import UNetOpenAI

    assert isinstance(presets.build_unet(SMOKE, "openai"), UNetOpenAI)


def test_dit_cli_programs_run_on_cpu(tmp_path):
    """``--estimator dit`` through training (diffusion and flow), a resume,
    ``cli.sample --ckpt --ema``, ``cli.sample_dataset`` and ``cli.helpers
    img2img`` on the CPU; the run config records the estimator and the
    sampling CLI rebuilds the DiT from the checkpoint."""
    common = ["--preset", "smoke", "--device", "cpu", "--estimator", "dit"]
    run = tmp_path / "dit"
    state, losses, pipe = train_diffusion.main([*common, "--max-steps", "2", "--out",
                                                str(run), "--use-ema", "--ckpt-every", "1"])
    assert isinstance(pipe.noise_estimator, DiT) and np.isfinite(losses).all()
    state2, _, _ = train_diffusion.main([*common, "--max-steps", "3", "--out", str(run),
                                         "--use-ema", "--resume"])
    assert state2.step == 3
    with pytest.raises(SystemExit, match="estimator"):
        train_diffusion.main(["--preset", "smoke", "--device", "cpu", "--max-steps", "4",
                              "--out", str(run), "--use-ema", "--resume"])
    with pytest.raises(SystemExit, match="estimator"):
        sample.main(["--preset", "smoke", "--device", "cpu", "--estimator", "unet", "--ckpt",
                     str(run), "--out", str(tmp_path / "u")])
    # the family comes from the run's config without --estimator
    out = sample.main(["--preset", "smoke", "--device", "cpu", "--ckpt", str(run), "--ema",
                       "--dtype", "f32", "--steps", "2", "--n", "2", "--out",
                       str(tmp_path / "s")])
    assert all(v.shape == (2, 32, 32, 3) and np.isfinite(v).all() for v in out.values())
    dirs = sample_dataset.main([*common, "--ckpt", str(run), "--dtype", "f32", "--steps-list",
                                "2", "--n-samples", "2", "--chunk", "2", "--out",
                                str(tmp_path / "fake")])
    assert len(list(dirs[(2, 0)].glob("*.png"))) == 2
    flow_state, flow_losses, flow_pipe = train_diffusion.main(
        [*common, "--family", "flow", "--max-steps", "1", "--out", str(tmp_path / "flow")])
    assert np.isfinite(flow_losses).all()
    helpers.main(["img2img", "--device", "cpu", "--estimator", "dit", "--family", "flow",
                  "--ckpt", str(tmp_path / "flow"), "--steps", "2", "--out",
                  str(tmp_path / "h")])
    assert (tmp_path / "h" / "img2img.png").exists()


@pytest.mark.parametrize("cli,flags,why", [
    (train_diffusion, ["--estimator", "dit", "--attention", "linear"], "own attention"),
    (sample, ["--estimator", "dit", "--attention-heads", "4"], "unet-family option"),
    (sample_dataset, ["--estimator", "unet_legacy", "--dtype", "f32", "--steps-list", "2",
                      "--n-samples", "2", "--chunk", "2"], None),
    (train_diffusion, ["--estimator", "lucidrains", "--max-steps", "1"], None),
], ids=["train-attention", "sample-heads", "sample_dataset-legacy", "train-lucidrains"])
def test_estimator_refusals(capsys, tmp_path, cli, flags, why):
    """What the JAX package refuses is refused; a case without a reason (a
    family ported since) runs."""
    argv = ["--preset", "smoke", "--device", "cpu", *flags]
    if why is None:
        assert cli.main([*argv, "--out", str(tmp_path / "run")]) is not None
        return
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert why in capsys.readouterr().err


def test_dit_pipeline_moe_aux_is_zero_without_experts():
    jd, params, dit = dits()
    tp = DiffusionPipeline(scheduler=S.GaussianDiffusionSchedule.create(
        timesteps=20, schedule_strategy="scaled_linear"), noise_estimator=dit,
        do_input_centering=False)
    _, tbatch = _batch((B, H, W, 2))
    draws = tp.train_draws(B, (H, W, 2), generator=torch.Generator().manual_seed(0))
    loss, metrics = tp.train_loss(tbatch, draws)
    assert float(metrics["moe_aux"]) == 0.0 and torch.isfinite(loss)
