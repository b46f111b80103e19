"""The port's evaluation metrics against the JAX package, on the CPU, f32.

* InceptionV3 on the JAX params perturbed away from their init (kernels at
  He scale, BatchNorm statistics and affine moved, variances kept
  positive), carried across by ``utils/weights.py``: at 75x75 without the
  resize and at 2 images of 64^2 -> 299 with it, within 2e-4 x max|f|.
* The resize alone against ``jax.image.resize(..., "bilinear")``, within
  5e-3 on 0-255, at 64^2 -> 299 (growing) and 320x288 -> 299 (shrinking);
  without antialiasing the shrinking case departs by tens.
* The torch-checkpoint path: a torch-fidelity-layout state dict, with bare
  keys and with pytorch-fid's ``blocks.N.M.`` keys, plus the ``AuxLogits``
  and ``fc`` heads, loads strictly and gives the features of the JAX
  package's ``convert_torch_inception``.
* ``frechet_distance`` at 1e-4 relative; ``FrechetInceptionDistance`` and
  ``gaussian_stats``; improved precision/recall on the data of
  ``tests/test_metrics.py``, equal, chunked equal to unchunked.

The port runs on one CPU thread (``one_thread``); the JAX InceptionV3 is
compiled once for each input shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.cli.ingest_weights import strip_fid_blocks as jax_strip_fid_blocks
from medfusion_tpu.metrics import FrechetInceptionDistance as JaxFID
from medfusion_tpu.metrics import InceptionV3 as JaxInception
from medfusion_tpu.metrics import convert_torch_inception
from medfusion_tpu.metrics import fid as jax_fid
from medfusion_tpu.metrics import precision_recall as jax_precision_recall
from medfusion_tpu_torch.metrics import (
    FrechetInceptionDistance,
    ImprovedPrecisionRecall,
    InceptionV3,
    frechet_distance,
    precision_recall,
)
from medfusion_tpu_torch.metrics.fid import gaussian_stats
from medfusion_tpu_torch.metrics.inception import (
    _PYTORCH_FID_BLOCKS,
    fid_state_dict,
    resize_299,
    strip_fid_blocks,
)
from medfusion_tpu_torch.utils.weights import jax_inception_to_state_dict

KEY = jax.random.PRNGKey(0)
FEAT_TOL = 2e-4  # of max|f|


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(shapes, seed):
    """Kernels N(0, 2 / fan_in); BatchNorm scale 1 + N(0, 0.1^2), bias and
    mean N(0, 0.1^2), variance U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) * (2 / np.prod(s.shape[:-1])) ** 0.5
                    ).astype(np.float32)
        if name == "bn_var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        base = 1.0 if name == "bn_scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_inception(resize_input=True):
    net = JaxInception(resize_input=resize_input)
    return jax.jit(lambda p, x: net.apply({"params": p}, x))


@functools.lru_cache(maxsize=None)
def _params():
    shapes = jax.eval_shape(JaxInception().init, KEY, jnp.zeros((1, 75, 75, 3), jnp.uint8))
    return _perturb(shapes["params"], 0)


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _port(sd, resize_input=True):
    net = InceptionV3(resize_input=resize_input)
    net.load_state_dict(sd, strict=True)
    return net.eval()


def _features(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))).numpy()


def _close_features(got, want):
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * np.abs(want).max())
    assert np.abs(want).max() > 1e-2


@pytest.mark.parametrize("resize_input,shape", [(False, (2, 75, 75, 3)), (True, (2, 64, 64, 3))],
                         ids=["75-no-resize", "64-to-299"])
def test_inception_matches_jax(resize_input, shape):
    params = _params()
    x = _uint8(shape, 1)
    want = np.asarray(_jax_inception(resize_input)(params, x))
    net = _port(jax_inception_to_state_dict(params), resize_input)
    got = _features(net, x)
    _close_features(got, want)
    if resize_input:  # grey is repeated to RGB, as in the JAX package
        np.testing.assert_array_equal(_features(net, x[..., :1]),
                                      _features(net, x[..., :1].repeat(3, axis=-1)))


@pytest.mark.parametrize("side", [(64, 64), (320, 288)], ids=["64-grow", "320x288-shrink"])
def test_resize_matches_jax(side):
    x = np.random.default_rng(2).uniform(0, 255, (1, *side, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, 299, 299, 3), "bilinear"))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    got = np.moveaxis(resize_299(xt).numpy(), 1, -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    plain = torch.nn.functional.interpolate(xt, size=(299, 299), mode="bilinear",
                                            align_corners=False, antialias=False)
    departs = np.abs(np.moveaxis(plain.numpy(), 1, -1) - want).max()
    if side[0] > 299:  # shrinking: the antialiasing is what matches
        assert departs > 1.0, departs
    else:  # growing: no antialiasing to do
        assert departs < 5e-3, departs


def _torch_layout(params):
    """A torch-fidelity state dict (numpy) holding ``params``' values, with
    the ``AuxLogits`` and ``fc`` heads a checkpoint also carries."""
    sd = {k: v.numpy() for k, v in jax_inception_to_state_dict(params).items()}
    rng = np.random.default_rng(3)
    sd["AuxLogits.conv0.conv.weight"] = rng.standard_normal((128, 768, 1, 1)).astype(np.float32)
    sd["AuxLogits.conv0.bn.running_var"] = np.ones(128, np.float32)
    sd["fc.weight"] = rng.standard_normal((1008, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1008, np.float32)
    return sd


def _fid_wrapper_keys(sd):
    """The same state dict under pytorch-fid's wrapper keys."""
    names = {v: k for k, v in _PYTORCH_FID_BLOCKS.items()}
    out = {}
    for k, v in sd.items():
        module, rest = k.split(".", 1)
        if module in names:
            b, m = names[module]
            k = f"blocks.{b}.{m}.{rest}"
        out[k] = v
    return out


@pytest.mark.parametrize("keys", ["bare", "pytorch-fid"])
def test_torch_checkpoint_loads_and_matches_jax_converter(keys):
    base = _torch_layout(_params())
    sd = _fid_wrapper_keys(base) if keys == "pytorch-fid" else base
    if keys == "pytorch-fid":
        assert sum(k.startswith("blocks.") for k in sd) > 500
        assert set(strip_fid_blocks(sd)) == set(jax_strip_fid_blocks(sd)) == set(base)
    x = _uint8((2, 64, 64, 3), 4)
    template = jax.tree_util.tree_structure(_params())
    flax = convert_torch_inception(jax_strip_fid_blocks(sd))
    flax = {k: v for k, v in flax.items() if k in _params()}
    assert jax.tree_util.tree_structure(flax) == template
    want = np.asarray(_jax_inception()(flax, x))
    loaded = fid_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert not any(k.startswith(("AuxLogits", "fc")) for k in loaded)
    _close_features(_features(_port(loaded), x), want)


def test_fid_state_dict_fills_num_batches_tracked():
    sd = {k: v for k, v in jax_inception_to_state_dict(_params()).items()
          if not k.endswith("num_batches_tracked")}
    _port(fid_state_dict(sd))  # loads strictly
    with pytest.raises(ValueError, match="unrecognized pytorch-fid"):
        strip_fid_blocks({"blocks.9.0.conv.weight": 0})


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return (a @ a.T / n + 0.5 * np.eye(n)).astype(np.float32)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(5)
    n = 16
    mu1, mu2 = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)
    s1, s2 = _spd(rng, n), _spd(rng, n)
    want = float(jax_fid.frechet_distance(*map(jnp.asarray, (mu1, s1, mu2, s2))))
    got = float(frechet_distance(*map(torch.from_numpy, (mu1, s1, mu2, s2))))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    f = rng.standard_normal((50, n)).astype(np.float32)
    mu, sigma = gaussian_stats(torch.from_numpy(f))
    jmu, jsigma = jax_fid.gaussian_stats(jnp.asarray(f))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-5, atol=1e-6)


def test_fid_accumulator_matches_jax():
    rng = np.random.default_rng(6)
    real, fake = rng.standard_normal((120, 24)), rng.standard_normal((90, 24)) * 1.2 + 0.3
    ours, ref = FrechetInceptionDistance(), JaxFID()
    for acc in (ours, ref):
        acc.update(real[:70], real=True)
        acc.update(real[70:], real=True)
        acc.update(fake, real=False)
    ours.update(torch.zeros((0, 24)), real=False)  # tensors go through too
    np.testing.assert_allclose(ours.compute(), ref.compute(), rtol=1e-10, atol=0)
    ours.reset()
    assert not ours._real and not ours._fake


def _pr_data(seed, n_real, n_fake):
    """The data of ``tests/test_metrics.py``'s precision/recall tests."""
    rng = np.random.default_rng(seed)
    real = rng.standard_normal((n_real, 8)).astype(np.float32)
    scale, shift = (1.3, 0.3) if seed == 0 else (1.2, 0.2)
    fake = (rng.standard_normal((n_fake, 8)) * scale + shift).astype(np.float32)
    return real, fake


@pytest.mark.parametrize("seed,n_real,n_fake", [(0, 40, 30), (7, 53, 41)])
def test_precision_recall_matches_jax(seed, n_real, n_fake):
    real, fake = _pr_data(seed, n_real, n_fake)
    want = [float(v) for v in jax_precision_recall(jnp.asarray(real), jnp.asarray(fake))]
    assert 0 < want[0] < 1 and 0 < want[1] < 1
    r, f = torch.from_numpy(real), torch.from_numpy(fake)
    assert [float(v) for v in precision_recall(r, f)] == want
    for chunk in (7, 16, 53):
        assert [float(v) for v in precision_recall(r, f, row_chunk=chunk)] == want, chunk
    ipr = ImprovedPrecisionRecall(row_chunk=16)
    ipr.update(real[:20], real=True)
    ipr.update(r[20:], real=True)
    ipr.update(f, real=False)
    assert list(ipr.compute()) == want


def test_precision_recall_extremes():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((20, 4)).astype(np.float32))
    assert [float(v) for v in precision_recall(x, x)] == [1.0, 1.0]
    assert [float(v) for v in precision_recall(x, x + 1000.0)] == [0.0, 0.0]
