"""The sampling CLIs of the port on the CPU: ``cli.sample --sampler
dpmpp|edm``, ``--family flow`` and ``--classifier-ckpt`` (guided DDIM at
eta 0 and DPM++, a classifier ``.npz`` of JAX params) against the JAX
package's samplers on the same weights (the smoke preset, its flax params
written to an ``.npz``) and the same initial latent, the other sampler
flags and their refusals, and ``cli.sample_dataset``'s PNG tree and uint8
conversion against the JAX CLI's formula on the same images, also for the
flow family and under classifier guidance.

The CLI draws its initial latent from ``torch.Generator().manual_seed(seed)``
for every condition; the test draws the same and hands it to the JAX
sampler (DPM-Solver++ and EDM without churn take no other draw; the fast
sampler, deterministic at the JAX CLI's eta 0 on a linspace grid ending at
t = 0, where the ancestral variance is 0, reads its per-step draws
nowhere). Tolerance:
2e-4 of the decoded images' scale, as ``tests/test_torch_pipeline.py``
holds the decoded ``denoise``. The port runs on one CPU thread here.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.cli import presets as jax_presets
from medfusion_tpu.cli.train_classifier import build_classifier as jax_build_classifier
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.pipelines.diffusion import make_classifier_grad
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlow
from medfusion_tpu_torch.cli import presets, sample, sample_dataset
from medfusion_tpu_torch.data.png import read_png
from tests.test_torch_checkpoint import _flat
from tests.test_torch_models import _randomize
from tests.test_torch_pipeline import _assert_close

SMOKE = presets.PRESETS["smoke"]
N, STEPS, SEED = 2, 5, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_smoke(tmp_path_factory):
    """(JAX pipeline as the JAX sample CLI builds it, its perturbed params,
    those params as an .npz for --params)."""
    p = jax_presets.PRESETS["smoke"]
    unet, vae = jax_presets.build_unet(p), jax_presets.build_vae(p)
    key = jax.random.PRNGKey(0)
    z = jnp.zeros((1, *p.latent_shape))
    t = jnp.zeros((1,), jnp.int32)
    x = jnp.zeros((1, p.image_size, p.image_size, p.in_channels))
    params = {
        "noise_estimator": _randomize(jax.eval_shape(unet.init, key, z, t, t)["params"], 41),
        "latent_embedder": _randomize(jax.eval_shape(
            vae.init, {"params": key, "sample": key}, x)["params"], 42),
    }
    pipe = JaxPipeline(scheduler=jax_presets.build_scheduler(p), noise_estimator=unet,
                       latent_embedder=vae, do_input_centering=False, clip_x0=False)
    npz = tmp_path_factory.mktemp("params") / "smoke.npz"
    np.savez(npz, **_flat(params))
    return pipe, params, npz


def _argv(out, *flags):
    return ["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--n", str(N),
            "--steps", str(STEPS), "--seed", str(SEED), "--out", str(out), *flags]


SAMPLER_FLAGS = {"dpmpp": ["--sampler", "dpmpp"], "edm": ["--sampler", "edm"],
                 "fast": ["--encoder-key-every", "2"]}


@pytest.mark.parametrize("sampler", sorted(SAMPLER_FLAGS))
def test_sample_cli_sampler_matches_jax(tmp_path, jax_smoke, sampler):
    jp, params, npz = jax_smoke
    out = tmp_path / sampler
    results = sample.main(_argv(out, "--params", str(npz), *SAMPLER_FLAGS[sampler]))
    x_T = torch.randn((N, *SMOKE.latent_shape),
                      generator=torch.Generator().manual_seed(SEED)).numpy()
    for cond_val in (0, 1, None):
        cond = None if cond_val is None else jnp.full((N,), cond_val, jnp.int32)
        gs = 8.0 if cond_val is not None else 1.0
        if sampler == "fast":  # as the JAX CLI calls it: eta left at its 0
            run = functools.partial(jp.denoise_fast, rng=jax.random.PRNGKey(SEED),
                                    encoder_key_every=2)
        else:
            run = jp.denoise_dpmpp if sampler == "dpmpp" else jp.denoise_edm
        ref = np.asarray(run(params, jnp.asarray(x_T), condition=cond, steps=STEPS,
                             guidance_scale=gs))
        assert results[cond_val].shape == (N, 32, 32, 3)
        _assert_close(results[cond_val], ref, 2e-4)
        assert (out / f"sample_cond_{cond_val}.png").exists()
    assert (out / "sample_diff.png").exists()


def test_sample_cli_flow_matches_jax(tmp_path, jax_smoke):
    jp, params, npz = jax_smoke
    flow = JaxFlow(noise_estimator=jp.noise_estimator, latent_embedder=jp.latent_embedder,
                   do_input_centering=False, shift=2.0)
    steps = 25  # above the smoke preset's T = 20: the ODE grid is not capped
    results = sample.main(_argv(tmp_path, "--params", str(npz), "--family", "flow",
                                "--flow-shift", "2", "--steps", str(steps)))
    x_T = torch.randn((N, *SMOKE.latent_shape),
                      generator=torch.Generator().manual_seed(SEED)).numpy()
    for cond_val in (0, 1, None):
        cond = None if cond_val is None else jnp.full((N,), cond_val, jnp.int32)
        ref = np.asarray(flow.denoise(params, jnp.asarray(x_T), None, condition=cond,
                                      steps=steps, guidance_scale=8.0 if cond_val is not None
                                      else 1.0, shift=2.0))
        _assert_close(results[cond_val], ref, 2e-4)


@pytest.fixture(scope="module")
def classifier_npz(tmp_path_factory):
    """{pool: (JAX classifier, perturbed params, their .npz)} at model
    channels 32 (2 heads of 32 in the middle block and the attention pool)."""
    p = jax_presets.PRESETS["smoke"]
    out = {}
    for i, pool in enumerate(("adaptive", "attention")):
        clf = jax_build_classifier(p, 32, pool)
        shapes = jax.eval_shape(clf.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, *p.latent_shape)), jnp.zeros((1,), jnp.int32))
        params = _randomize(shapes["params"], 71 + i)
        path = tmp_path_factory.mktemp("clf") / f"{pool}.npz"
        np.savez(path, **_flat({"params": params}))
        out[pool] = clf, params, path
    return out


@pytest.mark.parametrize("sampler,pool", [("ddim", "attention"), ("dpmpp", "adaptive")])
def test_sample_cli_classifier_matches_jax(tmp_path, jax_smoke, classifier_npz, sampler,
                                           pool):
    jp, params, npz = jax_smoke
    clf, cparams, cnpz = classifier_npz[pool]
    flags = ["--eta", "0"] if sampler == "ddim" else ["--sampler", "dpmpp"]
    results = sample.main(_argv(tmp_path, "--params", str(npz), "--classifier-ckpt", str(cnpz),
                                "--classifier-model-channels", "32", "--classifier-pool",
                                pool, "--classifier-scale", "30", *flags))
    x_T = torch.randn((N, *SMOKE.latent_shape),
                      generator=torch.Generator().manual_seed(SEED)).numpy()
    for cond_val in (0, 1, None):
        kw = dict(steps=STEPS, guidance_scale=1.0)
        if cond_val is not None:
            cond = jnp.full((N,), cond_val, jnp.int32)
            kw.update(condition=cond, guidance_scale=8.0, classifier_scale=30.0,
                      classifier_grad=make_classifier_grad(
                          lambda x, t: clf.apply({"params": cparams}, x, t), cond))
        if sampler == "ddim":  # eta 0 on a linspace grid: no draw is read
            ref = jp.denoise(params, jnp.asarray(x_T), jax.random.PRNGKey(0), eta=0.0, **kw)
        else:
            ref = jp.denoise_dpmpp(params, jnp.asarray(x_T), **kw)
        _assert_close(results[cond_val], np.asarray(ref), 2e-4)


# flags -> None (runs) or the exception it raises
FLAG_CASES = {
    "fast-key2": (["--encoder-key-every", "2"], None),
    "edm-churn-rho": (["--sampler", "edm", "--edm-churn", "1.0", "--edm-rho", "3"], None),
    "zero_snr-v-ddim-rescale": (["--zero-terminal-snr", "--objective", "v",
                                 "--guidance-rescale", "0.7"], None),
    "zero_snr-v-dpmpp": (["--zero-terminal-snr", "--objective", "v", "--sampler", "dpmpp"],
                         None),
    "zero_snr-eps": (["--zero-terminal-snr"], ValueError),
    "zero_snr-edm": (["--zero-terminal-snr", "--objective", "v", "--sampler", "edm"],
                     ValueError),
    "fast-rescale": (["--encoder-key-every", "2", "--guidance-rescale", "0.5"], SystemExit),
    "fast-eta": (["--encoder-key-every", "2", "--eta", "1"], SystemExit),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_sample_cli_sampler_flags(tmp_path, jax_smoke, case):
    flags, raises = FLAG_CASES[case]
    flags = [*flags, "--params", str(jax_smoke[2])]
    if raises is not None:
        with pytest.raises(raises):
            sample.main(_argv(tmp_path, *flags))
        return
    results = sample.main(_argv(tmp_path, *flags))
    for cond_val in (0, 1, None):
        assert results[cond_val].shape == (N, 32, 32, 3)
        assert np.isfinite(results[cond_val]).all()
    assert not np.array_equal(results[0], results[1])


def test_sample_dataset_writes_the_tree_as_jax_converts_it(tmp_path, capsys):
    out = tmp_path / "fake"
    flags = ["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--n-samples", "3",
             "--chunk", "2", "--steps-list", "3", "30", "--sampler", "dpmpp",
             "--guidance", "2.0", "--out", str(out)]
    dirs = sample_dataset.main(flags)
    assert sorted(dirs) == [(3, 0), (3, 1), (20, 0), (20, 1)]  # steps capped at T=20
    for (steps, label), d in dirs.items():
        assert d == out / f"steps_{steps}" / f"label_{label}"
        assert sorted(f.name for f in d.iterdir()) == [f"fake_{i}.png" for i in range(3)]
    assert "steps=20 label=1: 3 samples" in capsys.readouterr().out

    # the same images again, chunk by chunk, converted by the JAX CLI's formula
    pipe = presets.build_pipeline(SMOKE, device="cpu", seed=0)
    args = argparse.Namespace(sampler="dpmpp", guidance_rescale=0.0,
                              timestep_spacing="linspace")
    for label in (0, 1):
        imgs = []
        for chunk_idx, n in enumerate((2, 1)):
            gen = sample_dataset.chunk_generator("cpu", 0, 3, label, chunk_idx)
            cond = torch.full((n,), label)
            imgs.append(sample.run_sampler(pipe, args, SMOKE, n, 3, cond, 2.0, gen,
                                           un_cond=1 - cond).numpy())
        ref = ((np.concatenate(imgs).clip(-1, 1) + 1) * 127.5).astype(np.uint8)
        got = np.stack([read_png(out / "steps_3" / f"label_{label}" / f"fake_{i}.png")
                        for i in range(3)])
        assert got.dtype == np.uint8 and got.shape == (3, 32, 32, 3)
        np.testing.assert_array_equal(got, ref)
    edge = np.asarray([-2.0, -1.0, -0.5, 0.0, 0.999, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(sample_dataset.to_uint8(edge),
                                  ((edge.clip(-1, 1) + 1) * 127.5).astype(np.uint8))
    # every (steps, label, chunk) has its own stream
    firsts = {torch.randn(1, generator=sample_dataset.chunk_generator("cpu", 0, *k)).item()
              for k in ((3, 0, 0), (3, 0, 1), (3, 1, 0), (20, 0, 0), (3, 2, 0))}
    assert len(firsts) == 5


def test_sample_dataset_flow_and_classifier_trees(tmp_path, classifier_npz):
    """``--family flow`` keeps a step count above T; ``--classifier-ckpt``
    guides each chunk toward its label: both trees hold what
    ``run_sampler`` gives for the same chunk draws."""
    cnpz = classifier_npz["attention"][2]
    clf = dict(classifier_ckpt=str(cnpz), classifier_model_channels=32,
               classifier_pool="attention", classifier_scale=30.0)
    cases = {"flow": (["--family", "flow"], 25, dict(family="flow", classifier_ckpt=None)),
             "classifier": (["--sampler", "dpmpp", "--classifier-ckpt", str(cnpz),
                             "--classifier-model-channels", "32", "--classifier-pool",
                             "attention", "--classifier-scale", "30"], 3,
                            dict(family="diffusion", **clf))}
    for name, (flags, steps, settings) in cases.items():
        out = tmp_path / name
        dirs = sample_dataset.main(["--preset", "smoke", "--device", "cpu", "--dtype", "f32",
                                    "--n-samples", "2", "--chunk", "2", "--steps-list",
                                    str(steps), "--guidance", "2.0", "--out", str(out),
                                    *flags])
        assert sorted(dirs) == [(steps, 0), (steps, 1)]
        args = argparse.Namespace(sampler="dpmpp", guidance_rescale=0.0,
                                  timestep_spacing="linspace", **settings)
        pipe = presets.build_pipeline(SMOKE, device="cpu", seed=0, family=args.family)
        classifier = sample.load_classifier_arg(args, SMOKE, "cpu")
        label = 1
        gen = sample_dataset.chunk_generator("cpu", 0, steps, label, 0)
        cond = torch.full((2,), label)
        imgs = sample.run_sampler(pipe, args, SMOKE, 2, steps, cond, 2.0, gen,
                                  un_cond=1 - cond, classifier=classifier).numpy()
        got = np.stack([read_png(out / f"steps_{steps}" / f"label_{label}" / f"fake_{i}.png")
                        for i in range(2)])
        np.testing.assert_array_equal(got, sample_dataset.to_uint8(imgs))
