"""The port's GPipe pipeline (``medfusion_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``pipeline_apply``: the eight cases of
``tests/test_pipeline_parallel.py``, each on a mesh of the spawned ranks
(gloo on the CPU) and the JAX function on a mesh of its virtual devices of
the same shape, and the sequential composition of the stages.

One group of 4 ranks ((1, 4) and (2, 2) meshes) and one of 2 ((1, 2) and
(2, 1)) run every case once (``tests/torch_parallel_worker.py``). Each
rank reports the whole output and the gradient of the parameters it holds;
the parent puts the stages' gradients together. Tolerances are the JAX
tests': 1e-5 for outputs, rtol 1e-4 (atol 1e-5, or 1e-4 for the ZeRO
cases; 2e-5 / 2e-4 for the normalising stage) for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.parallel import make_mesh, pipeline_apply, shard_stage_params, stack_stage_params
from tests import torch_parallel_worker as W

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _tanh(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _rms(p, x):
    h = x @ p["w"]
    return h / jnp.sqrt(jnp.mean(h ** 2, axis=-1, keepdims=True))


def _gain(p, x):
    return jnp.tanh(x @ p["w"]) * p["gain"]


STAGE_FNS = {"tanh": _tanh, "rms": _rms, "gain": _gain}


def _stages(n, dim, seed, kind="tanh"):
    rng = np.random.default_rng(seed)
    if kind == "tanh":
        return [{"w": (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32),
                 "b": (rng.standard_normal((dim,)) * 0.1).astype(np.float32)}
                for _ in range(n)]
    if kind == "rms":
        return [{"w": (rng.standard_normal((dim, dim)) / 4.0).astype(np.float32)}
                for _ in range(n)]
    return [{"w": (rng.standard_normal((dim, dim)) / 4.0).astype(np.float32),
             "gain": np.float32(0.5 + i)} for i in range(n)]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# name -> (world, (n_data, n_model), stage kind, stages, x, pipeline_apply options, loss)
CASES = {
    "forward": (4, (1, 4), "tanh", _stages(4, 16, 0), _x((8, 16), 1), {}, None),
    "more_microbatches": (4, (1, 4), "tanh", _stages(4, 8, 2), _x((32, 8), 3),
                          {"n_microbatches": 16}, None),
    "gradients": (4, (1, 4), "tanh", _stages(4, 8, 4), _x((8, 8), 5), {}, "mean"),
    "dp": (4, (2, 2), "tanh", _stages(2, 16, 6), _x((16, 16), 7),
           {"n_microbatches": 4, "data_axis": "data"}, None),
    "bad_microbatching": (4, (1, 4), "tanh", _stages(4, 8, 8), np.zeros((6, 8), np.float32),
                          {}, None),
    "normalizing": (4, (2, 2), "rms", _stages(2, 16, 3, "rms"), _x((8, 16), 3),
                    {"data_axis": "data"}, "sum"),
    "zero": (4, (2, 2), "tanh", _stages(2, 16, 7), _x((8, 16), 8),
             {"data_axis": "data", "zero_axis": "data"}, "sum"),
    "zero_scalar": (4, (2, 2), "gain", _stages(2, 16, 11, "gain"), _x((8, 16), 12),
                    {"data_axis": "data", "zero_axis": "data"}, "sum"),
    "forward_2": (2, (1, 2), "tanh", _stages(2, 16, 13), _x((8, 16), 14),
                  {"n_microbatches": 4}, "mean"),
    "dp_2": (2, (2, 1), "tanh", _stages(1, 16, 15), _x((8, 16), 16),
             {"n_microbatches": 2, "data_axis": "data"}, "sum"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worker_spec(case):
    world, mesh, kind, stages, x, opts, loss = CASES[case]
    return {"mesh": mesh, "stage": kind, "x": torch.from_numpy(x), "loss": loss,
            "stages": [{k: torch.as_tensor(v) for k, v in st.items()} for st in stages],
            "shard": "zero_axis" in opts, **opts}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    specs = {w: {c: _worker_spec(c) for c in CASES if CASES[c][0] == w} for w in (2, 4)}
    waits = {w: W.spawn("pipeline", w, tmp) for w in (2, 4)}
    W.write_inputs(tmp, {"pipelines": specs})
    results = {}

    def get(case):
        world = CASES[case][0]
        if world not in results:
            results[world] = W.load_results(tmp, "pipelines", world, waits[world])
        return [r[case] for r in results[world]]

    yield get
    for wait in waits.values():
        wait()


def _jax(case):
    """JAX pipeline_apply's output and gradients on a mesh of the case's
    shape, and the sequential composition."""
    world, (n_data, n_model), kind, stages, x, opts, loss = CASES[case]
    mesh = make_mesh(n_data, n_model, devices=jax.devices()[:world])
    fn = STAGE_FNS[kind]
    stacked = stack_stage_params([jax.tree_util.tree_map(jnp.asarray, s) for s in stages])
    if "zero_axis" in opts:
        stacked = shard_stage_params(stacked, mesh, zero_axis=opts["zero_axis"])
    xj = jnp.asarray(x)

    def run(p):
        return pipeline_apply(fn, p, xj, mesh=mesh, axis="model", **opts)

    seq = xj
    for s in stages:
        seq = fn(jax.tree_util.tree_map(jnp.asarray, s), seq)
    if loss is None:
        return np.asarray(jax.jit(run)(stacked)), np.asarray(seq), None
    reduce = jnp.mean if loss == "mean" else jnp.sum

    def loss_fn(p):
        y = run(p)
        return reduce(y ** 2), y

    # one jit: eager shard_map traces and compiles every call
    (_, y), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(stacked)
    return np.asarray(y), np.asarray(seq), jax.tree_util.tree_map(np.asarray, grads)


def _stage_grads(res, n_stages, zero):
    """The stacked gradient [S, ...] put together from the ranks: each
    rank's stage row (of its ZeRO slice along dim 1)."""
    out = {}
    for k in res[0]["grads"]:
        rows = []
        for s in range(n_stages):
            mine = sorted((r for r in res if r["stage"] == s), key=lambda r: r["data"])
            g = [r["grads"][k] for r in mine]
            if zero and g[0].ndim >= 2:
                rows.append(torch.cat([t[0] for t in g], dim=0))
            elif g[0].shape[0] == 1:
                rows.append(g[0][0])
            else:
                rows.append(g[0][s])
        out[k] = torch.stack(rows).numpy()
    return out


def _check(ranks, case, y_tol=1e-5, g_tol=(1e-4, 1e-5)):
    y_ref, seq, g_ref = _jax(case)  # computes while the ranks run
    res = ranks(case)
    np.testing.assert_allclose(y_ref, seq, atol=1e-5, rtol=1e-5)
    for r in res:  # the whole output on every rank
        assert np.all(np.isfinite(r["y"].numpy()))
        np.testing.assert_allclose(r["y"].numpy(), y_ref, atol=y_tol, rtol=y_tol)
    if g_ref is not None:
        _, (_, n_model), *_, opts, _ = CASES[case]
        got = _stage_grads(res, n_model, "zero_axis" in opts)
        assert set(got) == set(g_ref)
        for k in g_ref:
            assert np.all(np.isfinite(got[k]))
            np.testing.assert_allclose(got[k], g_ref[k], rtol=g_tol[0], atol=g_tol[1],
                                       err_msg=k)


def test_pipeline_forward_matches_jax(ranks):
    _check(ranks, "forward")


def test_pipeline_more_microbatches_than_stages(ranks):
    _check(ranks, "more_microbatches")


def test_pipeline_gradients_match_jax(ranks):
    _check(ranks, "gradients")


def test_pipeline_composes_with_dp(ranks):
    _check(ranks, "dp")


def test_pipeline_rejects_bad_microbatching(ranks):
    for r in ranks("bad_microbatching"):
        assert "not divisible by 4 microbatches" in r["raised"]


def test_pipeline_normalizing_stage_no_nan_poisoning(ranks):
    _check(ranks, "normalizing", y_tol=2e-5, g_tol=(2e-4, 2e-5))


def test_pipeline_zero_sharded_stages_match_jax(ranks):
    _check(ranks, "zero", g_tol=(1e-4, 1e-4))


def test_pipeline_zero_sharding_handles_scalar_stage_params(ranks):
    _check(ranks, "zero_scalar", g_tol=(1e-4, 1e-4))


@pytest.mark.parametrize("case", ["forward_2", "dp_2"])
def test_pipeline_at_world_two_matches_jax(ranks, case):
    _check(ranks, case)
