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
PORT_FILES = sorted((ROOT / "medfusion_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "multicard_smoke.py"]
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


# ---- the JAX package's surface has a counterpart in the port -----------------------
#
# Every public function, class and module constant of each ``medfusion_tpu/``
# file, and every constructor field of its classes (flax and dataclass fields,
# ``__init__`` parameters), has a counterpart in the port file of the same
# path: the same name, or the one COUNTERPARTS names. JAX_ONLY lists what has
# no counterpart to write, each with its reason.

JAX_ROOT = ROOT / "medfusion_tpu"
JAX_FILES = sorted(JAX_ROOT.rglob("*.py"))

_FLAX_INIT = "a flax initialiser; torch modules initialise themselves"
_REWRITE = ("an exact XLA rewrite of a plain conv (space-to-depth or fused 2x up); the port "
            "runs the conv")
_CONVERTER = ("a torch -> flax converter; the port's modules carry the torch checkpoints' "
              "own keys, so nothing is converted")
_PALLAS = "a Pallas block size; the CUDA kernels choose their own tiles"
_UNCALLED = "nothing in the JAX package calls it"
JAX_ONLY = {
    "nn/functional.py::torch_conv_kernel_init": _FLAX_INIT,
    "nn/functional.py::torch_linear_kernel_init": _FLAX_INIT,
    "nn/functional.py::make_torch_bias_init": _FLAX_INIT,
    "nn/functional.py::zeros_init": _FLAX_INIT,
    "nn/blocks.py::Dense": "flax Dense with torch's init; the port uses nn.Linear",
    "nn/blocks.py::_ConvParams": "flax's holder of a conv's params; torch's convs hold their own",
    "nn/blocks.py::ConvND.use_bias": _UNCALLED + " with False; every conv has its bias",
    "nn/functional.py::interpolate_nearest": _UNCALLED,
    "utils/profiling.py::StepTimer": _UNCALLED,
    "nn/blocks.py::ConvND.fused_up2x": _REWRITE,
    "models/unet_lucidrains.py::Conv": "flax Conv with torch's init; the port uses nn.Conv2d",
    "nn/functional.py::fused_up2x_conv": _REWRITE,
    "nn/functional.py::FUSED_UP_VARIANT": _REWRITE,
    "nn/functional.py::space_to_depth2": _REWRITE,
    "nn/functional.py::depth_to_space2": _REWRITE,
    "nn/functional.py::s2d_kernel_3x3": _REWRITE,
    "nn/functional.py::s2d_conv3x3": _REWRITE,
    "nn/functional.py::s2d_conv1x1": _REWRITE,
    "nn/functional.py::s2d_group_norm": _REWRITE,
    "nn/blocks.py::S2DGroupNorm": _REWRITE,
    "ops/flash_attention.py::DEFAULT_BLOCK_Q": _PALLAS,
    "ops/flash_attention.py::DEFAULT_BLOCK_K": _PALLAS,
    "ops/flash_attention.py::MIN_KV_TOKENS": "XLA's softmax below 256 tokens; on the card that "
                                             "would be the plain version, not a kernel",
    "ops/geglu.py::DEFAULT_BLOCK_M": _PALLAS,
    "ops/geglu.py::DEFAULT_BLOCK_F": _PALLAS,
    "metrics/inception.py::convert_torch_inception": _CONVERTER,
    "models/diffusers_blocks.py::convert_diffusers_block_state_dict": _CONVERTER,
    "models/latent_embedders_diffusers.py::convert_diffusers_vae_state_dict": _CONVERTER,
    "models/unet_diffusers.py::convert_diffusers_unet_state_dict": _CONVERTER,
    "models/unet_lucidrains.py::convert_lucidrains_state_dict": _CONVERTER,
    "models/unet_openai.py::convert_openai_state_dict": _CONVERTER,
    "utils/torch_compat.py::torch_key_to_flax_path": _CONVERTER,
    "utils/torch_compat.py::convert_state_dict": _CONVERTER,
    "utils/torch_compat.py::get_in_tree": _CONVERTER,
    "utils/torch_compat.py::set_in_tree": _CONVERTER,
    "utils/checkpoint.py::globalize_for_multihost": (
        "orbax's multi-host array gathering; the port's save_checkpoint gathers each placed "
        "tensor's pieces and rank 0 writes the whole state"),
    "utils/logging.py::MetricsWriter.use_tensorboard": (
        "needs tensorboardX, which the card's machine does not have"),
}

_SWITCH = "cli/kernels.py::resolve_kernel_flags"  # the kernels run on the card, always
COUNTERPARTS = {  # JAX entry -> the port's, where it has another name or file; a
    # class's counterpart is its fields' too, unless a field has its own entry
    "cli/ingest_weights.py::strip_fid_blocks": "metrics/inception.py::strip_fid_blocks",
    "cli/sample.py::load_pipeline": "cli/presets.py::build_pipeline",
    "cli/train_diffusion.py::load_vae_params": "cli/presets.py::load_vae",
    # the port may not import grain; its loader reproduces grain's order
    "data/grain_loader.py::make_grain_loader": "data/grain_loader.py::GrainDataModule",
    "metrics/inception.py::BasicConv2d.out_channels": "metrics/inception.py::BasicConv2d.out_ch",
    "models/diffusers_blocks.py::DDownsampleOp": "models/diffusers_blocks.py::DDownsample",
    "models/diffusers_blocks.py::DDownsampleOp.in_channels":
        "models/diffusers_blocks.py::DDownsample.channels",
    "models/unet_lucidrains.py::LucidUpsample": "models/unet_lucidrains.py::lucid_upsample",
    "models/unet_lucidrains.py::LucidUpsample.in_dim":
        "models/unet_lucidrains.py::lucid_upsample.dim",
    "models/unet_lucidrains.py::WSConv.in_features":
        "models/unet_lucidrains.py::WSConv.in_channels",
    "models/unet_lucidrains.py::WSConv.features": "models/unet_lucidrains.py::WSConv.out_channels",
    "models/unet_lucidrains.py::LucidBlock.in_dim": "models/unet_lucidrains.py::LucidBlock.dim",
    "models/unet_lucidrains.py::LucidResnetBlock.in_dim":
        "models/unet_lucidrains.py::LucidResnetBlock.dim",
    "models/unet_lucidrains.py::PreNorm.fn_kind": "models/unet_lucidrains.py::PreNorm.fn",
    "models/unet_lucidrains.py::Residual.fn_kind": "models/unet_lucidrains.py::Residual.fn",
    "models/unet_lucidrains.py::Residual.dim": "models/unet_lucidrains.py::Residual.fn",
    "nn/blocks.py::ConvND": "nn/blocks.py::conv_nd",
    "nn/blocks.py::FusedGroupNorm": "nn/blocks.py::Norm",
    "nn/blocks.py::FusedGroupNorm.epsilon": "nn/blocks.py::Norm.eps",
    "nn/blocks.py::FusedGroupNorm.affine": "nn/blocks.py::Norm.norm_name",
    "nn/blocks.py::FusedGroupNorm.apply_silu": "nn/blocks.py::Norm.fuse_silu",
    "ops/__init__.py::fused_group_norm_silu": "ops/group_norm.py::group_norm_silu",
    "ops/__init__.py::fused_geglu_mlp": "ops/geglu.py::fused_geglu_mlp",
    "ops/__init__.py::flash_attention_tokens": "ops/flash_attention.py::flash_attention_tokens",
    "ops/flash_attention.py::naive_attention": "ops/flash_attention.py::naive_attention_reference",
    "ops/group_norm.py::fused_group_norm_silu": "ops/group_norm.py::group_norm_silu",
    "ops/__init__.py::enable_flash_attention": _SWITCH,
    "ops/__init__.py::flash_attention_enabled": _SWITCH,
    "ops/__init__.py::enable_fused_geglu": _SWITCH,
    "ops/__init__.py::fused_geglu_enabled": _SWITCH,
    "ops/__init__.py::enable_fused_group_norm": _SWITCH,
    "ops/__init__.py::fused_group_norm_enabled": _SWITCH,
    "ops/__init__.py::enable_fused_up_conv": _SWITCH,
    "ops/__init__.py::fused_up_conv_enabled": _SWITCH,
    "ops/__init__.py::enable_s2d_decode_tail": _SWITCH,
    "ops/__init__.py::s2d_decode_tail_enabled": _SWITCH,
    "ops/flash_attention.py::HEAD_LAYOUT_MIN_TOKENS": "ops/__init__.py::HEAD_LAYOUT_MIN_TOKENS",
    "pipelines/diffusion/core.py::DiffusionPipeline.zero_terminal_snr":
        "core/schedules.py::GaussianDiffusionSchedule.zero_terminal_snr",
    "train/adversarial.py::init_discriminators": "cli/presets.py::build_discriminators",
    # the BatchNorm statistics are the discriminators' buffers
    "train/adversarial.py::GANTrainState.disc_stats": "train/adversarial.py::GANTrainState.disc",
    "train/adversarial.py::AdversarialTrainer.discriminator":
        "train/adversarial.py::AdversarialTrainer.discriminators",
    "train/adversarial.py::AdversarialTrainer.n_discriminators":
        "train/adversarial.py::AdversarialTrainer.discriminators",
    # flax's TrainState is a pytree of params, optimizer state and optax
    # transform; the port's holds the module, its AdamW and its EMA
    "train/state.py::TrainState.params": "train/state.py::TrainState.model",
    "train/state.py::TrainState.tx": "train/state.py::TrainState.optimizer",
    "train/state.py::TrainState.opt_state": "train/state.py::TrainState.optimizer",
    "train/state.py::TrainState.ema_params": "train/state.py::TrainState.use_ema",
    "train/state.py::TrainState.ema_kwargs": "train/state.py::TrainState.use_ema",
    "train/state.py::TrainState.step": "train/state.py::TrainState.step",
    "utils/torch_compat.py::flax_path_to_torch_key": "utils/weights.py::flax_path_to_torch_key",
    "utils/torch_compat.py::to_torch_state_dict": "utils/weights.py::jax_params_to_state_dict",
    "utils/torch_compat.py::load_torch_checkpoint": "utils/torch_compat.py::read_state_dict",
}


def _class_fields(node):
    """A class's constructor fields: annotated class attributes (flax and
    dataclass fields) and ``__init__`` parameters."""
    fields = []
    for item in node.body:
        if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            fields.append(item.target.id)
        elif isinstance(item, ast.FunctionDef) and item.name == "__init__":
            fields += [a.arg for a in item.args.args[1:] + item.args.kwonlyargs]
    return [f for f in fields if not f.startswith("_")]


def _jax_surface(path):
    """'name' for each public function, class and constant, and
    'Class.field' for each constructor field (of private classes too)."""
    out = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append(node.name)
        if isinstance(node, ast.ClassDef):
            out += [f"{node.name}.{f}" for f in _class_fields(node)]
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        out += [t.id for t in targets if isinstance(t, ast.Name) and not t.id.startswith("_")]
    return out


def _port_module(rel):
    import importlib

    parts = Path(rel).with_suffix("").parts
    parts = parts[:-1] if parts[-1] == "__init__" else parts
    return importlib.import_module(".".join(("medfusion_tpu_torch",) + parts))


def _port_has(entry):
    """Whether the port holds ``'file::name'`` or ``'file::Class.field'``:
    the field a constructor parameter (inherited ones too), a class
    attribute, or an attribute its ``__init__`` sets."""
    import inspect
    import re

    rel, name = entry.split("::")
    module = _port_module(rel)
    cls_name, _, field = name.partition(".")
    if not hasattr(module, cls_name):
        return False
    if not field:
        return True
    cls = getattr(module, cls_name)
    if field in inspect.signature(cls).parameters or hasattr(cls, field):
        return True
    return re.search(rf"self\.{field}\s*=", inspect.getsource(cls)) is not None


def _counterpart(entry):
    """The port entry that ``entry`` needs, or None for a JAX-only one."""
    owner, _, field = entry.rpartition("::")[2].partition(".")
    owner = f"{entry.split('::')[0]}::{owner}"
    if entry in JAX_ONLY or owner in JAX_ONLY:
        return None
    if entry in COUNTERPARTS:
        return COUNTERPARTS[entry]
    return f"{COUNTERPARTS[owner]}.{field}" if field and owner in COUNTERPARTS else entry


@pytest.mark.parametrize("path", JAX_FILES, ids=lambda p: str(p.relative_to(JAX_ROOT)))
def test_jax_surface_has_a_port_counterpart(path):
    rel = str(path.relative_to(JAX_ROOT))
    missing = []
    for name in _jax_surface(path):
        target = _counterpart(f"{rel}::{name}")
        if target is not None and not _port_has(target):
            missing.append(name)
    assert not missing, f"medfusion_tpu_torch/{rel} lacks {missing}"


def test_allow_list_and_counterparts_are_current():
    """Every JAX_ONLY and COUNTERPARTS entry names a current JAX entry, each
    JAX_ONLY entry has its reason, and no entry the port does hold under
    its own name sits on JAX_ONLY."""
    surface = {f"{p.relative_to(JAX_ROOT)}::{n}" for p in JAX_FILES for n in _jax_surface(p)}
    surface |= {e.rsplit(".", 1)[0] for e in surface if "." in e.split("::")[1]}
    # (a private class with fields)
    assert not (set(JAX_ONLY) | set(COUNTERPARTS)) - surface
    assert not set(JAX_ONLY) & set(COUNTERPARTS)
    assert all(JAX_ONLY.values())
    assert not [e for e in JAX_ONLY if _port_has(e)]


def test_chip_smoke_defines_each_name_once():
    """A second top-level definition in ``chip_smoke.py`` silently replaces
    the first, whose callers then reach the new one."""
    import collections

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(e.id for t in node.targets for e in ast.walk(t)
                         if isinstance(e, ast.Name))
    assert not [n for n, k in names.items() if k > 1]
