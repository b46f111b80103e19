"""Rules the PyTorch port keeps: it imports no JAX and nothing of the JAX
package, its entry points default to the card and raise without one, and its
sampling CLI runs end to end on the CPU when asked to."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import medfusion_tpu_torch
from medfusion_tpu_torch.cli import presets, sample

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "medfusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "medfusion_tpu")


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


def test_sample_cli_loads_npz_params(tmp_path):
    """--params takes flax paths joined by '/', as the JAX package names them."""
    from medfusion_tpu_torch.utils.weights import flax_path_to_torch_key

    p = presets.PRESETS["smoke"]
    ref = presets.build_pipeline(p, device="cpu", seed=3)
    flat = {}
    for prefix, module, kind in (("noise_estimator", ref.noise_estimator, "unet"),
                                 ("latent_embedder", ref.latent_embedder, "vae")):
        by_key = {k: v.numpy() for k, v in module.state_dict().items()}
        # invert the export map on this module's own keys
        for path in _flax_paths(kind):
            key = flax_path_to_torch_key(path, kind)
            if key in by_key:
                flat[f"{prefix}/{path}"] = _to_flax(path, by_key.pop(key))
        assert not by_key, f"unmapped {kind} keys: {sorted(by_key)[:3]}"
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    unet_params, vae_params = sample.load_npz_params(npz)
    pipe = presets.build_pipeline(p, device="cpu", seed=99,
                                  unet_params=unet_params, vae_params=vae_params)
    for a, b in ((pipe.noise_estimator, ref.noise_estimator),
                 (pipe.latent_embedder, ref.latent_embedder)):
        for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


def _flax_paths(kind):
    """The flax param paths of the smoke preset's modules."""
    import jax
    import jax.numpy as jnp

    from medfusion_tpu.cli.presets import PRESETS, build_unet, build_vae

    p = PRESETS["smoke"]
    key = jax.random.PRNGKey(0)
    if kind == "unet":
        z = jnp.zeros((1, *p.latent_shape))
        t = jnp.zeros((1,), jnp.int32)
        tree = jax.eval_shape(build_unet(p).init, key, z, t, t)["params"]
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
