"""The port's parallel layer (``medfusion_tpu_torch/parallel``) against the
JAX package's on the CPU: ranks are processes on gloo, the JAX side runs on
its 8 virtual devices (or a sub-mesh of them of the ranks' shape).

One group of 2 ranks runs every case of ``tests/torch_parallel_worker.py``
once for the module, and one group of 4 the 2-D mesh's and ring attention's
gradient; the parent writes their inputs, computes the JAX references while
they run, and compares:

* the placements (``model_partition_spec``, ``fsdp_partition_spec``,
  ``moe_partition_spec``) leaf for leaf against JAX's ``PartitionSpec``s,
  mapped through the key and layout map of ``utils/weights.py``;
* the data-parallel, FSDP and FSDP + tensor-parallel steps against the JAX
  step on the same converted params and draws: loss at rtol 1e-5, params at
  rtol 1e-4 / atol 1e-5 (``tests/test_parallel.py``'s);
* the dp step's ``parallel.sync_gradients`` span: its counters say one
  all-reduce of every f32 gradient's bytes;
* the sharded bulk sampler (ddim, dpmpp, edm, flow) against JAX's
  ``make_sharded_sampler`` fed the same noise, at 1e-4 of the scale
  (``tests/test_torch_samplers.py``), and world 2's generator draws against
  one process's at 1e-5;
* ring attention and its gradients (``jax.vjp``, worlds 2 and 4, a rank
  with a zero dO among them) against JAX's at 1e-5; in this process, its
  gradient at world 1 bit for bit against flash_attention's and the
  block-pair backward against the whole; expert-parallel MoE forward and
  gradients at ``tests/test_moe.py``'s rtol 1e-4 / atol 1e-5;
* ``cli.sample_dataset`` at world 2 against world 1, byte for byte.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from medfusion_tpu import parallel as jpar
from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.dit import DiT as JaxDiT
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.parallel.moe import MoEMLP as JaxMoE
from medfusion_tpu.parallel.moe import moe_aux_loss
from medfusion_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlow
from medfusion_tpu.train import TrainState as JaxTrainState
from medfusion_tpu.train import make_diffusion_train_step as jax_make_step
from medfusion_tpu_torch.cli import sample_dataset
from medfusion_tpu_torch.ops import flash_attention as FA
from medfusion_tpu_torch.parallel import make_mesh, ring_attention
from medfusion_tpu_torch.parallel.ring_attention import (
    attention_blocks_backward,
    merge_attention_blocks,
)
from medfusion_tpu_torch.utils.weights import (
    flax_path_to_torch_key,
    jax_dit_to_state_dict,
    jax_params_to_state_dict,
)
from tests import torch_parallel_worker as W
from tests.test_torch_models import _randomize
from tests.test_torch_pipeline import _assert_close

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

KEY = jax.random.PRNGKey(0)
STEP_RNG = jax.random.PRNGKey(1)
SAMPLE_RNG = jax.random.PRNGKey(3)
COND = np.arange(W.SAMPLE_N, dtype=np.int32) % 2
UN_COND = 1 - COND
SAMPLERS = {  # name -> (JAX make_sharded_sampler settings, steps)
    "ddim": dict(sampler="ddim", guidance_scale=2.0, steps=4),
    "dpmpp": dict(sampler="dpmpp", guidance_scale=1.0, steps=5),
    "edm": dict(sampler="edm", guidance_scale=2.0, steps=5),
    "flow": dict(sampler="flow", guidance_scale=2.0, steps=4),
}
STEP_LABELS = np.arange(8, dtype=np.int32) % 2
DIT_T, DIT_C = np.asarray([3, 7, 1, 9], np.int32), np.asarray([0, 1, 1, 0], np.int32)
RING_SHAPE = (2, 4, 64, 16)
RING_W = np.random.default_rng(8).normal(size=RING_SHAPE).astype(np.float32)
SD_ARGV = ["--preset", "smoke", "--device", "cpu", "--dtype", "f32", "--steps-list", "3",
           "--n-samples", "4", "--chunk", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_mesh(n_data, n_model):
    return jpar.make_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])


_JAX = {}


def jax_side():
    """The JAX models, their randomized params and the inputs, made once."""
    if not _JAX:
        x = np.random.default_rng(0).uniform(-1, 1, (8, 8, 8, 1)).astype(np.float32)
        z, t0 = jnp.zeros((1, 8, 8, 1)), jnp.zeros((1,), jnp.int32)
        unet = JaxUNet(**W.UNET_KW)
        params = _randomize(jax.eval_shape(unet.init, KEY, z, t0, t0)["params"], 71)
        unet_s = JaxUNet(**W.UNET_SPATIAL_KW)
        params_s = _randomize(jax.eval_shape(unet_s.init, KEY, z, t0, t0)["params"], 75)
        dit = JaxDiT(**W.DIT_KW)
        zd = jnp.zeros((1, 8, 8, 2))
        params_d = _randomize(jax.eval_shape(dit.init, KEY, zd, t0, t0)["params"], 73)
        moe = JaxMoE(**W.MOE_KW)
        params_m = _randomize(jax.eval_shape(moe.init, KEY, jnp.zeros((1, 8, 16)))["params"],
                              74)
        x_dit = np.random.default_rng(5).standard_normal((4, 8, 8, 2)).astype(np.float32)
        x_moe = np.random.default_rng(6).standard_normal((4, 8, 16)).astype(np.float32)
        _JAX.update(x=x, unet=unet, params=params, unet_s=unet_s, params_s=params_s,
                    dit=dit, params_d=params_d, moe=moe, params_m=params_m, x_moe=x_moe,
                    x_dit=x_dit, **_np(_draws()))
    return _JAX


@jax.jit
def _draws():
    """The JAX step's draws (its key split as the train step splits it) and
    the sharded sampler's (x_T, then DDIM's two draws a step), in one jit."""
    _, k_t, k_noise, k_cfg, _ = jax.random.split(STEP_RNG, 5)
    k_init, k_loop = jax.random.split(SAMPLE_RNG)
    shape = (W.SAMPLE_N, *W.SAMPLE_SHAPE)
    loop = [jax.random.split(k, 2) for k in jax.random.split(k_loop, SAMPLERS["ddim"]["steps"])]
    return {"step_t": jax.random.randint(k_t, (8,), 0, W.T, dtype=jnp.int32),
            "step_x_T": jax.random.normal(k_noise, (8, 8, 8, 1), jnp.float32),
            "step_drop": jax.random.uniform(k_cfg, ()) < 0.5,
            "x_T": jax.random.normal(k_init, shape),
            "noise": jnp.stack([jnp.stack([jax.random.normal(k, shape) for k in ks])
                                for ks in loop])}


def _inputs(tmp):
    j = jax_side()
    cases = {}
    for name, kw in SAMPLERS.items():
        cases[name] = dict(kw, x_T=_t(j["x_T"]),
                           **({"noise": _t(j["noise"])} if name == "ddim" else {}))
    rng = np.random.default_rng(4)
    qkv = [torch.from_numpy(rng.normal(size=RING_SHAPE).astype(np.float32))
           for _ in range(3)]
    moe_sd = {"router.weight": _t(j["params_m"]["router"]["kernel"].T.copy()),
              **{k: _t(j["params_m"][k]) for k in ("w1", "b1", "w2", "b2")}}
    return {
        "unet": jax_params_to_state_dict(_np(j["params"]), "unet"),
        "unet_spatial": jax_params_to_state_dict(_np(j["params_s"]), "unet"),
        "dit": jax_dit_to_state_dict(_np(j["params_d"])),
        "batch": {"source": _t(j["x"]), "target": _t(STEP_LABELS).long()},
        "draws": {"t": _t(j["step_t"]).long(), "x_T": _t(j["step_x_T"]),
                  "drop": torch.tensor(bool(j["step_drop"]))},
        "sampler_cases": cases, "cond": _t(COND).long(), "un_cond": _t(UN_COND).long(),
        "qkv": qkv, "qkv_scale": 16 ** -0.25, "ring_w": _t(RING_W),
        "moe": moe_sd, "moe_x": _t(j["x_moe"]),
        "dit_x": _t(np.moveaxis(j["x_dit"], -1, 1)), "dit_t": _t(DIT_T).long(),
        "dit_c": _t(DIT_C).long(),
        "sample_dataset_argv": SD_ARGV, "sample_dataset_out": str(tmp / "sd_world2"),
    }


class Ranks:
    """The spawned groups' results: ``ranks(case, world)`` is a list, one
    entry a rank; ``tmp`` the directory they write in."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.waits = {w: W.spawn("parallel", w, tmp) for w in (2, 4)}
        W.write_inputs(tmp, _inputs(tmp))

    def __call__(self, case, world=2):
        return W.load_results(self.tmp, case, world, self.waits[world])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("parallel"))
    yield r
    for wait in r.waits.values():
        wait()


# ---- train steps ---------------------------------------------------------------------


_STEP = {}


def jax_step():
    if not _STEP:
        j = jax_side()
        sched = JaxSchedule.create(timesteps=W.T, schedule_strategy="linear")
        pipe = JaxPipeline(scheduler=sched, noise_estimator=j["unet"], do_input_centering=False)
        state = JaxTrainState.create(j["params"], optax.adamw(W.LR))
        batch = {"source": jnp.asarray(j["x"]), "target": jnp.asarray(STEP_LABELS)}
        state, metrics = jax_make_step(pipe, donate=False)(state, None, batch, STEP_RNG)
        _STEP.update(loss=float(metrics["loss"]),
                     params=jax_params_to_state_dict(_np(state.params), "unet"))
    return _STEP


def _check_step(ranks, case, world=2):
    ref = jax_step()  # compiles while the ranks run
    results = ranks(case, world)
    for r in results:
        np.testing.assert_allclose(float(r["loss"]), ref["loss"], rtol=1e-5)
    params = results[0]["params"]
    assert set(params) == set(ref["params"])
    for k, want in ref["params"].items():
        for r in results:  # every rank holds the same whole params
            np.testing.assert_allclose(r["params"][k].numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_data_parallel_step_matches_jax(ranks):
    _check_step(ranks, "train_dp")


def test_sync_gradients_counts_the_bytes_it_all_reduces(ranks):
    """At world 2 the dp step's ``parallel.sync_gradients`` span, inside
    ``train.step``, counts one all-reduce of every f32 gradient."""
    for r in ranks("sync_counters"):
        names = [name for name, *_ in r["spans"]]
        (sync,) = [s for s in r["spans"] if s[0] == "parallel.sync_gradients"]
        assert r["spans"][sync[1]][0] == "train.step" and sync[2] == 0
        assert sync[3] == {"allreduce_bytes": r["grad_bytes"], "collectives": 1}
        assert names.count("train.step") == 1


def test_fsdp_step_matches_jax(ranks):
    _check_step(ranks, "train_fsdp")


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_and_tensor_parallel_step_matches_jax(ranks, world):
    _check_step(ranks, "train_fsdp_tp", world)


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_forward_matches_jax(ranks, world):
    j = jax_side()
    y_ref, _ = jax.jit(j["unet"].apply)({"params": j["params"]}, jnp.asarray(j["x"]),
                                        jnp.zeros((8,), jnp.int32))
    res = ranks("train_fsdp_tp", world)
    n_data = world // 2
    rows = [np.moveaxis(res[r]["tp_forward"].numpy(), 1, -1) for r in range(0, world, 2)]
    assert len(rows) == n_data
    np.testing.assert_allclose(np.concatenate(rows), np.asarray(y_ref), rtol=1e-4, atol=1e-5)
    for r in range(1, world, 2):  # the model ranks of one data rank agree
        np.testing.assert_array_equal(res[r]["tp_forward"].numpy(),
                                      res[r - 1]["tp_forward"].numpy())


def test_tensor_parallel_spatial_attention_forward_matches_jax(ranks):
    """The attention UNet under tensor parallelism (min_shard_dim 16, 2
    model ranks): the q/k/v/out projections and the GEGLU MLP's two
    matrices are sharded; the forward as JAX's at rtol 1e-4 / atol 1e-5."""
    j = jax_side()
    y_ref, _ = jax.jit(j["unet_s"].apply)({"params": j["params_s"]}, jnp.asarray(j["x"]),
                                          jnp.asarray(j["step_t"]), jnp.asarray(STEP_LABELS))
    res = ranks("tp_spatial")
    assert any("proj_out.0.proj.weight" in k for k in res[0]["sharded"])
    assert any("proj_out.2.weight" in k for k in res[0]["sharded"])
    assert any("to_q.weight" in k for k in res[0]["sharded"])
    for r in res:
        np.testing.assert_allclose(np.moveaxis(r["y"].numpy(), 1, -1), np.asarray(y_ref),
                                   rtol=1e-4, atol=1e-5)


# ---- placements --------------------------------------------------------------------


def _unet_key_perm(path, ndim):
    key = flax_path_to_torch_key(path, "unet")
    if path.endswith("linear/kernel"):
        return key, (1, 0)
    if path.endswith("conv/kernel"):
        n = ndim - 2
        return key, (n + 1, n, *range(n))
    return key, tuple(range(ndim))


def _dit_key_perm(path, ndim):
    stem, _, leaf = path.rpartition("/")
    key = re.sub(r"(^|/)blocks_(\d+)(/|$)", r"\1blocks.\2\3", stem).replace("/", ".")
    prefix = f"{key}." if key else ""
    if leaf == "kernel" and ndim == 2:
        return f"{prefix}weight", (1, 0)
    return prefix + ("weight" if leaf in ("kernel", "embedding") else leaf), tuple(range(ndim))


def jax_placements(params, specs, key_perm, dims=("data", "model")):
    """JAX PartitionSpecs -> {torch key: (('S', torch dim) | ('R',)) a mesh
    dim}, through the key map and the layout permutation of each leaf."""
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(s, P))
    out = {}
    for (path, leaf), spec in zip(flat_p, flat_s):
        name = "/".join(k.key for k in path)
        key, perm = key_perm(name, np.ndim(leaf))
        place = [("R",)] * len(dims)
        for jdim, axis in enumerate(spec):
            if axis is not None:
                place[dims.index(axis)] = ("S", perm.index(jdim))
        out[key] = tuple(place)
    return out


def test_fsdp_placements_match_jax(ranks):
    j = jax_side()
    want = jax_placements(j["params"], jpar.fsdp_partition_spec(
        j["params"], _jax_mesh(2, 1), min_size=16), _unet_key_perm)
    got = ranks("train_fsdp")[0]["specs"]
    assert got == want
    assert any(("S", 0) == p[0] for p in got.values())  # some leaf sharded on its out dim


def test_tensor_parallel_placements_match_jax(ranks):
    j = jax_side()
    mesh = _jax_mesh(2, 2)
    tp = jpar.model_partition_spec(j["params"], mesh, min_shard_dim=16)
    both = jpar.fsdp_partition_spec(j["params"], mesh, min_size=16, tp_specs=tp)
    got = ranks("train_fsdp_tp", 4)[0]
    assert got["tp_specs"] == jax_placements(j["params"], tp, _unet_key_perm)
    assert got["specs"] == jax_placements(j["params"], both, _unet_key_perm)
    assert any(p[0][0] == "S" and p[1][0] == "S" for p in got["specs"].values())


def test_dit_moe_placements_match_jax(ranks):
    j = jax_side()
    params = j["params_d"]
    got = ranks("dit_specs")[0]
    for shape, specs in got.items():
        mesh = _jax_mesh(*shape)
        assert specs["tp"] == jax_placements(
            params, jpar.model_partition_spec(params, mesh, min_shard_dim=16), _dit_key_perm)
        assert specs["fsdp"] == jax_placements(
            params, jpar.fsdp_partition_spec(params, mesh, min_size=16), _dit_key_perm)
        for i, moe_specs in specs["moe"].items():
            sub = params[f"blocks_{i}"]["moe_mlp"]
            want = jax_placements(sub, jpar.moe_partition_spec(sub, mesh), _dit_key_perm)
            assert moe_specs == want
        if shape[1] == 2:  # experts sharded, the router never
            assert specs["moe"][0]["w1"][1] == ("S", 0)
            assert specs["moe"][0]["router.weight"] == (("R",), ("R",))


# ---- the sharded sampler ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sharded_sampler_matches_jax(ranks, name):
    j = jax_side()
    kw = dict(SAMPLERS[name])
    sched = JaxSchedule.create(timesteps=W.T, schedule_strategy="linear")
    pipe = (JaxFlow(noise_estimator=j["unet"]) if name == "flow" else
            JaxPipeline(scheduler=sched, noise_estimator=j["unet"],
                        do_input_centering=False))
    fn = jpar.make_sharded_sampler(pipe, _jax_mesh(8, 1), W.SAMPLE_SHAPE, decode=False, **kw)
    ref = fn({"noise_estimator": j["params"]}, SAMPLE_RNG, W.SAMPLE_N, jnp.asarray(COND),
             jnp.asarray(UN_COND))
    res = ranks("sampler")
    out = np.concatenate([r[name].numpy() for r in res])
    _assert_close(out, np.asarray(ref), 1e-4)


def test_sharded_sampler_rows_are_one_process_rows(ranks):
    """Every rank draws the whole chunk's noise and keeps its rows: world 2's
    rows are the unsharded sampler's (1e-5: the batch's split may move the
    last bits of a conv)."""
    res = ranks("sampler")
    sd = jax_params_to_state_dict(_np(jax_side()["params"]), "unet")
    pipe = W._pipeline(W._unet(W.UNET_KW, sd).eval())
    shape = (W.SAMPLE_N, *W.SAMPLE_SHAPE)
    for name, cond in (("generator", True), ("no_condition", False)):
        gen = torch.Generator().manual_seed(5)
        x_T = torch.randn(shape, generator=gen)
        kw = dict(condition=_t(COND).long(), un_cond=_t(UN_COND).long()) if cond else {}
        want = pipe.denoise(x_T, steps=4, guidance_scale=2.0, decode=False, generator=gen, **kw)
        got = torch.cat([r[name] for r in res])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ---- ring attention, expert parallelism ------------------------------------------------


def _ring_qkv():
    rng = np.random.default_rng(4)  # _inputs' q, k, v
    return [rng.normal(size=RING_SHAPE).astype(np.float32) for _ in range(3)]


def test_ring_attention_matches_jax(ranks):
    q, k, v = (jnp.asarray(t) for t in _ring_qkv())
    ref = jax_ring_attention(q, k, v, _jax_mesh(8, 1), scale=16 ** -0.25, axis="data")
    out = torch.cat([r["out"] for r in ranks("ring_attention")], dim=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


_RING_VJP = {}


def jax_ring_grads(cotangent):
    """jax.vjp of the JAX ring attention (8 devices) at _inputs' q, k, v."""
    if not _RING_VJP:
        _, _RING_VJP["vjp"] = jax.vjp(
            lambda q, k, v: jax_ring_attention(q, k, v, _jax_mesh(8, 1), scale=16 ** -0.25,
                                               axis="data"),
            *(jnp.asarray(t) for t in _ring_qkv()))
    return [np.asarray(g) for g in _RING_VJP["vjp"](jnp.asarray(cotangent))]


@pytest.mark.parametrize("cotangent", ["random", "zero_on_rank_0"])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_grad_matches_jax(ranks, world, cotangent):
    """Each rank's dq, dk, dv of sum(o * w), its token blocks concatenated,
    against jax.vjp of the JAX ring attention; with rank 0's dO all zero
    too (every rank still runs the backward's exchanges)."""
    w = RING_W.copy()
    if cotangent == "zero_on_rank_0":
        w[:, :, :RING_SHAPE[2] // world] = 0.0
    want = jax_ring_grads(w)
    res = ranks("ring_attention_grad", world)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([r[cotangent][name] for r in res], dim=2)
        np.testing.assert_allclose(got.numpy(), want[i], rtol=1e-5, atol=1e-5, err_msg=name)


def _ring_case(d, dtype, seed=11):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, w = (torch.randn((2, 3, 16, d), generator=gen).to(dtype) for _ in range(4))
    return q, k, v, w, d ** -0.25


def _flash_grads(q, k, v, w, scale):
    """o and the gradients of sum(o * w) through flash_attention's autograd."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, _ = FA.flash_attention(*leaves, scale)
    return o.detach(), torch.autograd.grad((o * w).sum(), leaves)


@pytest.mark.parametrize("d", [16, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_attention_world_one_is_flash_attention(d, dtype):
    """A group of one: o and every gradient equal flash_attention's (and its
    autograd's) bit for bit, at a head dim off multiples of 8 too."""
    q, k, v, w, scale = _ring_case(d, dtype)
    want_o, want = _flash_grads(q, k, v, w, scale)
    with W.one_rank_group():
        mesh = make_mesh(n_data=1, n_model=1, device="cpu")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = ring_attention(*leaves, mesh, scale=scale)
        got = torch.autograd.grad((o * w).sum(), leaves)
    assert torch.equal(o, want_o)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.equal(a, b), name


def test_ring_attention_grad_of_q_alone():
    """Only q requires grad: the backward gives k and v None, and q the
    gradient it has when all three require it."""
    q, k, v, w, scale = _ring_case(16, torch.float32)
    with W.one_rank_group():
        mesh = make_mesh(n_data=1, n_model=1, device="cpu")
        o = ring_attention(q.clone().requires_grad_(True), k, v, mesh, scale=scale)
        dq, dk, dv = o.grad_fn.apply(w)[:3]
    assert dk is None and dv is None
    assert torch.equal(dq, _flash_grads(q, k, v, w, scale)[1][0])


@pytest.mark.parametrize("d", [16, 12])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_attention_blocks_backward_matches_whole(parts, d):
    """The block-pair backward over 1, 2 and 4 K/V blocks with the merged o
    and lse: f32 dQ and each block's dK/dV, concatenated, against the plain
    backward on the whole sequence (f32, 1e-5)."""
    q, k, v, do, scale = _ring_case(d, torch.float32, seed=12)
    k, v = (torch.cat([t, 2.0 * t], dim=2) for t in (k, v))  # 32 keys, unequal blocks
    blocks = list(zip(k.chunk(parts, dim=2), v.chunk(parts, dim=2)))
    o, lse = merge_attention_blocks(*zip(*(
        FA.naive_attention_reference(q, kb, vb, scale) for kb, vb in blocks)))
    whole_o, whole_lse = FA.naive_attention_reference(q, k, v, scale)
    np.testing.assert_allclose(o.numpy(), whole_o.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(), rtol=1e-5, atol=1e-5)
    dq, dkv = attention_blocks_backward(q, blocks, o, lse, do, scale)
    assert dq.dtype == torch.float32 and len(dkv) == parts
    want = FA.flash_attention_backward_reference(q, k, v, whole_o, whole_lse, do, scale)
    got = (dq, torch.cat([g for g, _ in dkv], dim=2), torch.cat([g for _, g in dkv], dim=2))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_expert_parallel_moe_matches_jax(ranks):
    """Experts split over 2 ranks, each rank its 2 of 4 rows: the forward,
    the aux loss and every gradient of sum(y^2) as the JAX layer's."""
    j = jax_side()
    m, params, x = j["moe"], j["params_m"], jnp.asarray(j["x_moe"])

    def loss(p):
        y, inter = m.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.sum(y ** 2), (y, moe_aux_loss(inter))

    (l_ref, (y_ref, aux_ref)), g_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    res = ranks("moe")
    np.testing.assert_allclose(np.concatenate([r["y"].numpy() for r in res]),
                               np.asarray(y_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.mean([float(r["loss"]) for r in res]), float(l_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(np.mean([float(r["aux"]) for r in res]), float(aux_ref),
                               rtol=1e-5)
    g_ref = _np(g_ref)
    for r in res:  # the router is replicated: the same mean on every rank
        np.testing.assert_allclose(r["grads"]["router.weight"].numpy().T,
                                   g_ref["router"]["kernel"], rtol=1e-4, atol=1e-5)
    for k in ("w1", "b1", "w2", "b2"):  # each rank its experts
        got = np.concatenate([r["grads"][k].numpy() for r in res])
        np.testing.assert_allclose(got, g_ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_expert_parallel_dit_matches_jax(ranks):
    j = jax_side()
    apply = jax.jit(lambda p, x, t, c: j["dit"].apply({"params": p}, x, t, c,
                                                      mutable=["intermediates"]))
    (y, _), inter = apply(j["params_d"], jnp.asarray(j["x_dit"]), jnp.asarray(DIT_T),
                          jnp.asarray(DIT_C))
    res = ranks("dit_moe")
    got = np.concatenate([np.moveaxis(r["y"].numpy(), 1, -1) for r in res])
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.mean([float(r["aux"]) for r in res]),
                               float(moe_aux_loss(inter)), rtol=1e-5)


# ---- the data path and the bulk-sampling CLI ----------------------------------------


def test_prefetch_yields_each_rank_its_rows(ranks):
    for rank, r in enumerate(ranks("prefetch")):
        assert len(r["batches"]) == 3
        for i, batch in enumerate(r["batches"]):
            want = (torch.arange(8.0).reshape(4, 2) + 10 * i)[2 * rank:2 * rank + 2]
            assert torch.equal(batch["x"], want)


def test_sample_dataset_world_two_writes_world_one_bytes(ranks, tmp_path):
    ranks("sample_dataset")
    out1 = tmp_path / "world1"
    sample_dataset.main(SD_ARGV + ["--out", str(out1)])
    files1 = sorted(p.relative_to(out1) for p in out1.rglob("*.png"))
    assert len(files1) == 8  # 2 labels x 4
    root2 = ranks.tmp / "sd_world2"
    files2 = sorted(p.relative_to(root2) for p in root2.rglob("*.png"))
    assert files1 == files2
    for f in files1:
        assert (out1 / f).read_bytes() == (root2 / f).read_bytes(), f
