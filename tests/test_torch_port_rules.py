"""Rules the PyTorch port keeps: it imports no JAX and nothing of the JAX
package, its entry points default to the card and raise without one, its
sampling CLI runs end to end on the CPU when asked to, and its CLIs refuse
what the JAX CLIs refuse with the flow family, classifier guidance and the
distillation family, and nothing of what is ported."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import medfusion_tpu_torch
from medfusion_tpu_torch.cli import (
    distill,
    evaluate_images,
    evaluate_latent_embedder,
    helpers,
    presets,
    sample,
    sample_dataset,
    train_autoencoder,
    train_classifier,
    train_diffusion,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "medfusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "medfusion_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]  # 'medfusion_tpu_torch' is not 'medfusion_tpu'
    return top in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_match_is_exact():
    assert _forbidden("medfusion_tpu.ops") and _forbidden("jax.numpy")
    assert not _forbidden("medfusion_tpu_torch.ops")


def _without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(monkeypatch):
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        medfusion_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        presets.build_pipeline(presets.PRESETS["smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample.main(["--preset", "smoke", "--steps", "2", "--n", "1"])
    assert medfusion_tpu_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("cli", [train_autoencoder, train_diffusion, sample, sample_dataset,
                                 evaluate_images, evaluate_latent_embedder, helpers,
                                 train_classifier, distill],
                         ids=["train_autoencoder", "train_diffusion", "sample",
                              "sample_dataset", "evaluate_images", "evaluate_latent_embedder",
                              "helpers", "train_classifier", "distill"])
def test_every_cli_defaults_to_the_card(monkeypatch, tmp_path, cli):
    """Each CLI's --device defaults to cuda and raises without a card."""
    _without_cuda(monkeypatch)
    argv = {sample: ["--preset", "smoke", "--steps", "1", "--n", "1"],
            sample_dataset: ["--preset", "smoke", "--steps-list", "1", "--n-samples", "1"],
            evaluate_images: ["--real", str(tmp_path), "--fake", str(tmp_path)],
            evaluate_latent_embedder: ["--preset", "smoke"],
            helpers: ["latent-stats", "--preset", "smoke"],
            distill: ["--preset", "smoke", "--iters-per-stage", "1"]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv.get(cli, ["--preset", "smoke", "--max-steps", "1"]))


def test_autoencoder_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    """The plain VAE and the diffusers family (ported since) run; --lpips
    without ingested VGG16 weights (an empty store here) is refused with a
    message that says why."""
    monkeypatch.setenv("MEDFUSION_WEIGHTS_DIR", str(tmp_path / "no_weights"))
    state, losses = train_autoencoder.main(["--preset", "smoke", "--device", "cpu",
                                            "--max-steps", "2"])
    assert state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    assert "done: 2 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--lpips"])
    assert "VGG16" in capsys.readouterr().err
    for model in ("diffusers_kl", "diffusers_vq"):
        state, losses = train_autoencoder.main(["--preset", "smoke", "--device", "cpu",
                                                "--model", model, "--max-steps", "1"])
        assert state.step == 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("flags", [["--gan"], ["--gan", "--disc", "patch"],
                                   ["--model", "vqvae"], ["--model", "vqvae", "--gan"]],
                         ids=["vaegan-conv", "vaegan-patch", "vqvae", "vqgan-conv"])
def test_autoencoder_cli_families_run_on_cpu(monkeypatch, capsys, flags):
    """--gan (either discriminator) and --model vqvae (with and without the
    GAN) on the smoke networks with one deep-supervision head, so two
    discriminators; one batch, the adversarial terms on from the start
    (--start-gan-step -1: optimizer steps 0 and 1)."""
    import dataclasses

    monkeypatch.setitem(presets.PRESETS, "smoke_ds",
                        dataclasses.replace(presets.PRESETS["smoke"], ae_deep_supervision=1))
    gan = "--gan" in flags
    state, losses = train_autoencoder.main(
        ["--preset", "smoke_ds", "--device", "cpu", "--max-steps", "1",
         "--start-gan-step", "-1", *flags])
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert "done: 1 steps" in capsys.readouterr().out
    if gan:
        assert state.step == 2 and state.gen.step == state.disc.step == 1
        assert len(state.disc.model) == 2
        moved = [state.disc.optimizer.state[p]["step"] for p in state.disc.model.parameters()]
        assert len(moved) == len(list(state.disc.model.parameters()))
        assert all(int(s) == 1 for s in moved)  # the discriminators took their step
    else:
        assert state.step == 1


def test_sample_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "samples"
    results = sample.main(["--preset", "smoke", "--device", "cpu", "--steps", "3",
                           "--n", "2", "--dtype", "f32", "--out", str(out)])
    for cond in (0, 1, None):
        arr = np.load(out / f"sample_cond_{cond}.npy")
        assert arr.shape == (2, 32, 32, 3) and np.isfinite(arr).all()
        np.testing.assert_array_equal(arr, results[cond])
        assert (out / f"sample_cond_{cond}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (out / "sample_diff.png").exists()


@pytest.mark.parametrize("attention", ["none", "spatial"])
def test_sample_cli_loads_npz_params(tmp_path, attention):
    """--params takes flax paths joined by '/', as the JAX package names them."""
    from medfusion_tpu_torch.utils.weights import flax_path_to_torch_key

    p = presets.PRESETS["smoke"]
    ref = presets.build_pipeline(p, device="cpu", seed=3, attention=attention)
    flat = {}
    for prefix, module, kind in (("noise_estimator", ref.noise_estimator, "unet"),
                                 ("latent_embedder", ref.latent_embedder, "vae")):
        by_key = {k: v.numpy() for k, v in module.state_dict().items()}
        # invert the export map on this module's own keys
        for path in _flax_paths(kind, attention):
            key = flax_path_to_torch_key(path, kind)
            if key in by_key:
                flat[f"{prefix}/{path}"] = _to_flax(path, by_key.pop(key))
        assert not by_key, f"unmapped {kind} keys: {sorted(by_key)[:3]}"
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    unet_params, vae_params = sample.load_npz_params(npz)
    pipe = presets.build_pipeline(p, device="cpu", seed=99, attention=attention,
                                  unet_params=unet_params, vae_params=vae_params)
    for a, b in ((pipe.noise_estimator, ref.noise_estimator),
                 (pipe.latent_embedder, ref.latent_embedder)):
        for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


def test_sample_cli_attention_options(tmp_path):
    """--attention spatial samples on the CPU; --attention-heads needs
    attention layers and must divide the attended widths."""
    out = tmp_path / "s"
    results = sample.main(["--preset", "smoke", "--device", "cpu", "--steps", "2",
                           "--n", "1", "--dtype", "f32", "--attention", "spatial",
                           "--attention-heads", "2", "--out", str(out)])
    assert all(r.shape == (1, 32, 32, 3) and np.isfinite(r).all()
               for r in results.values())
    with pytest.raises(SystemExit):
        sample.main(["--preset", "smoke", "--device", "cpu", "--attention-heads", "4"])
    with pytest.raises(ValueError, match="does not divide"):
        sample.main(["--preset", "smoke", "--device", "cpu", "--attention", "linear",
                     "--attention-heads", "3"])


def _flax_paths(kind, attention="none"):
    """The flax param paths of the smoke preset's modules."""
    import jax
    import jax.numpy as jnp

    from medfusion_tpu.cli.presets import PRESETS, build_unet, build_vae

    p = PRESETS["smoke"]
    key = jax.random.PRNGKey(0)
    if kind == "unet":
        z = jnp.zeros((1, *p.latent_shape))
        t = jnp.zeros((1,), jnp.int32)
        tree = jax.eval_shape(build_unet(p, attention=attention).init,
                              key, z, t, t)["params"]
    else:
        x = jnp.zeros((1, p.image_size, p.image_size, p.in_channels))
        tree = jax.eval_shape(build_vae(p).init, {"params": key, "sample": key}, x)["params"]
    return ["/".join(str(k.key) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _to_flax(path, arr):
    if path.endswith("conv/kernel"):
        return np.transpose(arr, (2, 3, 1, 0))
    if path.endswith("linear/kernel"):
        return arr.T
    return arr


# (CLI, flags, a phrase of the refusal): the JAX CLIs' refusals for the flow
# family and classifier guidance (medfusion_tpu/cli/sample.py,
# sample_dataset.py, train_diffusion.py)
REFUSALS = {
    "sample-flow-zero_snr": (sample, ["--family", "flow", "--zero-terminal-snr"], "no schedule"),
    "sample-flow-rescale": (sample, ["--family", "flow", "--guidance-rescale", "0.7"],
                            "no schedule"),
    "sample-flow-spacing": (sample, ["--family", "flow", "--timestep-spacing", "trailing"],
                            "--flow-shift"),
    "sample-flow-objective": (sample, ["--family", "flow", "--objective", "v"],
                              "velocity models"),
    "sample-flow-sampler": (sample, ["--family", "flow", "--sampler", "dpmpp"],
                            "own ODE sampler"),
    "sample-flow-classifier": (sample, ["--family", "flow", "--classifier-ckpt", "c.npz"],
                               "flow family"),
    "sample-flow-fast": (sample, ["--family", "flow", "--encoder-key-every", "2"],
                         "fast path"),
    "sample-classifier-fast": (sample, ["--classifier-ckpt", "c.npz", "--encoder-key-every",
                                        "2"], "encoder-propagation"),
    "sample-classifier-edm": (sample, ["--classifier-ckpt", "c.npz", "--sampler", "edm"],
                              "EDM sampler"),
    "sample_dataset-flow-sampler": (sample_dataset, ["--family", "flow", "--sampler", "edm"],
                                    "own ODE sampler"),
    "sample_dataset-classifier-edm": (sample_dataset, ["--classifier-ckpt", "c.npz",
                                                       "--sampler", "edm"], "EDM sampler"),
    "train_diffusion-flow-zero_snr": (train_diffusion, ["--family", "flow",
                                                        "--zero-terminal-snr"], "no schedule"),
    "train_diffusion-flow-objective": (train_diffusion, ["--family", "flow", "--objective",
                                                         "x_0"], "velocity objective"),
    # the distillation family's (medfusion_tpu/cli/sample.py, distill.py)
    "sample-consistency-classifier": (sample, ["--sampler", "consistency", "--classifier-ckpt",
                                               "c.npz"], "consistency sampling"),
    "sample-consistency-flow": (sample, ["--family", "flow", "--sampler", "consistency"],
                                "own ODE sampler"),
    "distill-ct-teacher": (distill, ["--method", "ct", "--teacher-ckpt", "runs/d"],
                           "teacher-free"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_flow_and_classifier_refusals(capsys, case):
    cli, flags, phrase = REFUSALS[case]
    with pytest.raises(SystemExit):
        cli.main(["--preset", "smoke", "--device", "cpu", *flags])
    assert phrase in capsys.readouterr().err


def test_no_cli_refuses_item_3():
    """Queue 1 item 3 (the flow family, classifier guidance) is ported: no
    CLI refuses anything naming it."""
    for path in sorted((ROOT / "medfusion_tpu_torch" / "cli").glob("*.py")):
        assert "item 3" not in path.read_text(), path.name


@pytest.mark.parametrize("item", [4, 5, 6])
def test_no_cli_refuses_items_4_to_6(item):
    """Queue 1 items 4-6 (the DiT, its mixture-of-experts blocks,
    distillation) are ported: no CLI and no pipeline refuses anything
    naming them."""
    paths = sorted((ROOT / "medfusion_tpu_torch").rglob("*.py"))
    for path in paths:
        assert f"item {item})" not in path.read_text(), path.name


@pytest.mark.parametrize("item", [7, 8])
def test_no_port_file_refuses_items_7_and_8(item):
    """Queue 1 items 7 (the diffusers block inventory with FIR resampling,
    the conditional diffusers UNet) and 8 (the grain order, the prefetch,
    the profiling layer, the last two datasets) are ported: no port file
    refuses anything naming them."""
    for path in PORT_FILES:
        assert f"item {item}" not in path.read_text(), path.name
