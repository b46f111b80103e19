"""The port's evaluation CLIs and the weight ingest, on the CPU.

* ``cli.ingest_weights`` end to end into a temporary store
  (``MEDFUSION_WEIGHTS_DIR``): a torchvision VGG16 (``.pth`` with its
  classifier, and ``.npz``) and a pytorch-fid InceptionV3 (wrapper keys,
  the ``AuxLogits``/``fc`` heads, no ``num_batches_tracked``) are stored and
  read back equal, with the JAX CLI's JSON keys; a file whose hash no longer
  matches, a missing hash and a state dict with a wrong shape, a missing
  and an unexpected key are refused, each problem listed.
* ``cli.evaluate_images`` on two small PNG trees: the JSON file, the
  warning without weights, the ingested artifact and ``--inception-weights``
  picked up, and precision/recall equal to the metrics recomputed from
  ``featurize_folder``'s features; ``--size`` resizes by the PIL filter.
* ``evaluate_latent_embedder.roundtrip`` against the JAX CLI's roundtrip
  (the JAX VAE's draw fixed to the port's), on perturbed JAX params: LPIPS
  at 1e-4 relative, MS-SSIM at 1e-5, MSE at 1e-5 relative; the CLI on the
  smoke preset, from a port checkpoint and ``--vgg-weights``.
* ``cli.train_autoencoder --lpips`` trains with ingested VGG16 weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medfusion_tpu.models.latent_embedders as jax_le
from medfusion_tpu.losses import LPIPS as JaxLPIPS
from medfusion_tpu.losses import ms_ssim as jax_ms_ssim
from medfusion_tpu_torch.cli import (
    evaluate_images,
    evaluate_latent_embedder,
    ingest_weights,
    train_autoencoder,
)
from medfusion_tpu_torch.data.png import write_png
from medfusion_tpu_torch.losses.lpips import VGG16Features, frozen_lpips
from medfusion_tpu_torch.metrics import InceptionV3, precision_recall
from medfusion_tpu_torch.metrics.inception import _PYTORCH_FID_BLOCKS, fid_state_dict
from medfusion_tpu_torch.models.latent_embedders import VAE
from medfusion_tpu_torch.utils import pretrained as P
from medfusion_tpu_torch.utils.weights import jax_vgg16_to_state_dict, load_jax_params
from tests.test_torch_lpips import _lpips_params
from tests.test_torch_models import _randomize, nchw

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("MEDFUSION_WEIGHTS_DIR", str(tmp_path / "weights"))
    return tmp_path / "weights"


def _vgg_checkpoint(seed=0):
    torch.manual_seed(seed)
    sd = dict(VGG16Features().state_dict())
    sd["classifier.0.weight"] = torch.zeros(3, 5)
    return sd


def _inception_checkpoint():
    """A pytorch-fid wrapper's state dict: 'blocks.N.M.' keys, no
    ``num_batches_tracked``, the ``AuxLogits`` and ``fc`` heads."""
    names = {v: k for k, v in _PYTORCH_FID_BLOCKS.items()}
    torch.manual_seed(1)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        module, rest = k.split(".", 1)
        b, m = names[module]
        sd[f"blocks.{b}.{m}.{rest}"] = v
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    return sd


def test_ingest_stores_and_verifies(store, tmp_path, capsys):
    sd = _vgg_checkpoint()
    torch.save(sd, tmp_path / "vgg16.pth")
    result = ingest_weights.main(["vgg16", "--src", str(tmp_path / "vgg16.pth")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert set(result) == {"artifact", "name", "src_sha256", "params_sha256", "n_leaves"}
    assert result["name"] == P.VGG16 and result["n_leaves"] == 26
    assert result["src_sha256"] == P.file_sha256(tmp_path / "vgg16.pth")
    back = P.load_pretrained(P.VGG16)
    assert set(back) == {k for k in sd if k.startswith("features.")}
    assert all(torch.equal(back[k], sd[k]) for k in back)
    assert P.params_sha256(back) == result["params_sha256"]
    # an .npz export of the same state dict stores the same content
    np.savez(tmp_path / "vgg16.npz", **{k: v.numpy() for k, v in sd.items()})
    assert ingest_weights.main(["vgg16", "--src", str(tmp_path / "vgg16.npz")])[
        "params_sha256"] == result["params_sha256"]

    # a file whose content changed, then a missing hash: refused
    path = P.artifact_path(P.VGG16)
    back["features.0.bias"][0] += 1.0
    torch.save(back, path)
    with pytest.raises(ValueError, match="hash mismatch.*re-run"):
        P.load_pretrained(P.VGG16)
    path.with_suffix(".sha256").unlink()
    with pytest.raises(ValueError, match="no recorded content hash"):
        P.load_pretrained(P.VGG16)


def test_ingest_refuses_a_mismatched_state_dict(store, tmp_path):
    sd = _vgg_checkpoint()
    sd["features.2.weight"] = torch.zeros(64, 64, 5, 5)
    del sd["features.28.bias"]
    sd["features.31.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(ValueError) as err:
        ingest_weights.main(["vgg16", "--src", str(tmp_path / "bad.pth")])
    msg = str(err.value)
    assert "3 problems" in msg
    assert "missing from source: features.28.bias" in msg
    assert "unexpected in source: features.31.weight" in msg
    assert "shape mismatch: features.2.weight" in msg
    assert not P.artifact_path(P.VGG16).exists()


def _write_tree(root, n, side, channels, seed):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i in range(n):
        write_png(root / f"{i}.png", rng.integers(0, 256, (*side, channels), dtype=np.uint8))
    return root


def test_evaluate_images_cli(store, tmp_path, capsys, monkeypatch):
    feats = []
    featurize = evaluate_images.featurize_folder
    monkeypatch.setattr(evaluate_images, "featurize_folder",
                        lambda *a, **k: feats.append(featurize(*a, **k)) or feats[-1])
    real = _write_tree(tmp_path / "real", 4, (40, 36), 1, 0)
    fake = _write_tree(tmp_path / "fake" / "label_0", 4, (32, 32), 3, 1).parent
    argv = ["--real", str(real), "--fake", str(fake), "--batch-size", "3", "--device", "cpu",
            "--size", "24", "--out", str(tmp_path / "metrics")]
    result = evaluate_images.main(argv)
    out = capsys.readouterr().out
    assert "WARNING: no pretrained InceptionV3" in out
    written = json.loads(next((tmp_path / "metrics").glob("metrics_*.json")).read_text())
    assert written == result and (result["n_real"], result["n_fake"]) == (4, 4)
    assert {"FID", "precision", "recall", "time"} <= set(result)
    assert all(result[f"seconds_{k}"] >= 0 for k in ("read", "featurize", "compute"))
    # the same metrics from the CLI's features (the Fréchet distance itself
    # is held to the JAX package's in tests/test_torch_metrics.py)
    assert [f.shape for f in feats] == [(4, 2048)] * 2 and result["FID"] > 0
    assert [float(v) for v in precision_recall(*feats)] == [result["precision"],
                                                           result["recall"]]
    # an ingested featuriser is picked up
    ckpt = _inception_checkpoint()
    torch.save(ckpt, tmp_path / "pt_inception.pth")
    ingest_weights.main(["inception", "--src", str(tmp_path / "pt_inception.pth")])
    capsys.readouterr()
    net = evaluate_images.load_inception(torch.device("cpu"))
    assert "using ingested InceptionV3 weights" in capsys.readouterr().out
    want = ckpt["blocks.3.2.branch_pool.conv.weight"]
    assert torch.equal(net.Mixed_7c.branch_pool.conv.weight, want)
    # stored as the featuriser holds it, key by key (0-d counts stay 0-d)
    stored, converted = P.load_pretrained(P.INCEPTION), fid_state_dict(ckpt)
    assert set(stored) == set(converted)
    assert all(torch.equal(stored[k], converted[k]) for k in converted)
    # --inception-weights (an .npz of the same state dict) goes before the store
    np.savez(tmp_path / "inception.npz", **{k: v.numpy() for k, v in ckpt.items()})
    net = evaluate_images.load_inception(torch.device("cpu"), str(tmp_path / "inception.npz"))
    assert torch.equal(net.Mixed_7c.branch_pool.conv.weight, want)


VAE_KW = dict(in_channels=3, out_channels=3, emb_channels=2, hid_chs=(4, 8),
              kernel_sizes=(3, 3), strides=(1, 2), deep_supervision=1,
              norm_name=("GROUP", {"num_groups": 2, "affine": True}))


def test_roundtrip_matches_jax(monkeypatch):
    """The JAX CLI's roundtrip: encode (its draw fixed), decode, LPIPS,
    MS-SSIM of the clipped de-centred images, MSE."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)

    def diagonal_gaussian(h, key, sample=True):
        mean, logvar = jnp.split(h, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise), 0.0

    monkeypatch.setattr(jax_le, "diagonal_gaussian", diagonal_gaussian)
    jvae, lpips = jax_le.VAE(**VAE_KW), JaxLPIPS()
    params = _randomize(jax.eval_shape(jvae.init, {"params": KEY, "sample": KEY},
                                       jnp.zeros((1, 32, 32, 3)))["params"], 4)
    lpips_params = _lpips_params()

    @jax.jit
    def roundtrip(x):  # medfusion_tpu/cli/evaluate_latent_embedder.py's
        z = jvae.apply({"params": params}, x, method=jvae.encode, rngs={"sample": KEY})
        pred = jvae.apply({"params": params}, z, method=jvae.decode)
        lp = lpips.apply({"params": lpips_params}, pred, x).reshape(-1)
        ms = jax_ms_ssim(jnp.clip((pred + 1) / 2, 0, 1), (x + 1) / 2, size_average=False)
        return lp, ms, jnp.mean((pred - x) ** 2, axis=(1, 2, 3))

    want = [np.asarray(v) for v in roundtrip(jnp.asarray(x))]
    vae = VAE(**VAE_KW)
    load_jax_params(vae, params, kind="vae")
    port_lpips = frozen_lpips(jax_vgg16_to_state_dict(lpips_params), "cpu")
    got = [v.numpy() for v in evaluate_latent_embedder.roundtrip(
        vae.eval(), port_lpips, nchw(x), nchw(noise))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    assert want[1].max() > 0 and want[0].min() > 1e-3


def test_evaluate_latent_embedder_cli(store, tmp_path, capsys):
    train_autoencoder.main(["--preset", "smoke", "--device", "cpu", "--max-steps", "1",
                            "--out", str(tmp_path / "ae")])
    argv = ["--preset", "smoke", "--device", "cpu", "--batch-size", "4", "--max-batches", "2"]
    capsys.readouterr()
    result = evaluate_latent_embedder.main([*argv, "--vae-ckpt", str(tmp_path / "ae")])
    assert "WARNING: no pretrained VGG16" in capsys.readouterr().out
    assert set(result) == {"1-LPIPS_mean", "LPIPS_std", "MS-SSIM_mean", "MS-SSIM_std",
                           "MSE_mean", "MSE_std", "n"}
    assert result["n"] == 8 and all(np.isfinite(v) for v in result.values())
    flat = {f"{m}/{leaf}": v for m, d in _lpips_params()["vgg"].items()
            for leaf, v in d.items()}
    np.savez(tmp_path / "vgg.npz", **flat)
    again = evaluate_latent_embedder.main([*argv, "--vae-ckpt", str(tmp_path / "ae"),
                                           "--vgg-weights", str(tmp_path / "vgg.npz")])
    assert again["MSE_mean"] == result["MSE_mean"]  # same VAE, same draws
    assert again["1-LPIPS_mean"] != result["1-LPIPS_mean"]


def test_train_autoencoder_lpips_with_ingested_weights(store, tmp_path, capsys):
    torch.save(_vgg_checkpoint(), tmp_path / "vgg16.pth")
    ingest_weights.main(["vgg16", "--src", str(tmp_path / "vgg16.pth")])
    state, losses = train_autoencoder.main(["--preset", "smoke", "--device", "cpu",
                                            "--max-steps", "2", "--lpips"])
    assert "LPIPS perceptual loss on" in capsys.readouterr().out
    plain_state, plain = train_autoencoder.main(["--preset", "smoke", "--device", "cpu",
                                                 "--max-steps", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[0] > plain[0]  # the LPIPS term adds to the same first loss
