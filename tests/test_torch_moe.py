"""The port's mixture-of-experts MLP (``medfusion_tpu_torch/parallel/moe.py``)
against the JAX package's ``MoEMLP``, and the ``moe_aux`` metric of both
pipelines' ``train_loss``, float32 on the CPU.

* Routing: with every expert MLP made to output its own one-hot row (w1
  and b1 zero, so gelu(0) = 0, and b2[e] = e_e), the JAX layer's output
  holds, token by token, the gate each expert kept for it (0 where the
  token was not routed there, or fell past the expert's capacity). The
  port's ``route`` on the JAX router's logits gives the same kept pattern
  exactly, and the same gates to float32 rounding; the capacity case
  drops tokens on both sides.
* The output at k = 1 and k = 2 within rtol 1e-4 / atol 1e-5 and the aux
  loss within rtol 1e-5 on perturbed params; at k = 1 the router's
  gradient of a task loss (the aux loss left out) is non-zero and matches
  the JAX one; ``w1`` is drawn within flax's fan_avg bound
  sqrt(6 / (E (d + m))).
* ``train_loss`` of the diffusion and the flow pipeline on a dense UNet
  and on a tiny DiT-MoE, JAX draws fed to the port: the same metric keys,
  ``moe_aux`` and ``loss`` within rtol 1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.core.schedules import GaussianDiffusionSchedule as JaxSchedule
from medfusion_tpu.models.dit import DiT as JaxDiT
from medfusion_tpu.models.unet import UNet as JaxUNet
from medfusion_tpu.parallel.moe import MoEMLP as JaxMoE
from medfusion_tpu.parallel.moe import moe_aux_loss
from medfusion_tpu.pipelines.diffusion import DiffusionPipeline as JaxPipeline
from medfusion_tpu.pipelines.flow import FlowMatchingPipeline as JaxFlow
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.models.dit import DiT
from medfusion_tpu_torch.models.unet import UNet
from medfusion_tpu_torch.parallel.moe import MoEMLP, moe_capacity
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_models import _randomize
from tests.test_torch_train import _batch
from tests.torch_parallel_worker import one_rank_group

D, M, E, N = 16, 32, 4, 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_pair(k, cf=1.25, seed=51):
    """(JAX MoEMLP, its perturbed params, the port's layer loaded)."""
    jm = JaxMoE(D, M, E, num_selected=k, capacity_factor=cf)
    x0 = jnp.zeros((1, N, D), jnp.float32)
    params = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0)["params"], seed)
    params["router"]["kernel"] = params["router"]["kernel"] * 8.0  # decisive routing
    tm = MoEMLP(D, M, E, num_selected=k, capacity_factor=cf)
    tm.load_state_dict({"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
                        **{n: torch.from_numpy(np.array(params[n])) for n in
                           ("w1", "b1", "w2", "b2")}}, strict=True)
    return jm, params, tm


def tokens(seed=0, b=2, shift=0.0):
    x = np.random.default_rng(seed).standard_normal((b, N, D)).astype(np.float32)
    return x + shift


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5)],
                         ids=["top1", "top2", "top2-overflow"])
def test_routing_equals_jax(k, cf):
    jm, params, tm = moe_pair(k, cf)
    probe = {**params, "w1": np.zeros_like(params["w1"]), "b1": np.zeros_like(params["b1"]),
             "w2": np.zeros_like(params["w2"]),
             "b2": np.eye(E, D, dtype=np.float32)}  # expert e outputs e_e
    # a shared offset makes most tokens prefer the same expert: capacity binds
    x = tokens(shift=1.5 if cf < 1 else 0.0)
    y, inter = jm.apply({"params": probe}, x, capture_intermediates=True,
                        mutable=["intermediates"])
    gates_jax = np.asarray(y)[..., :E]  # [B, N, E]: the kept gate per expert
    logits = inter["intermediates"]["router"]["__call__"][0]
    _, combine, _ = tm.route(torch.from_numpy(np.array(logits)))
    gates = combine.sum(-1).numpy()
    np.testing.assert_array_equal(gates > 0, gates_jax > 0)
    np.testing.assert_allclose(gates, gates_jax, rtol=1e-6, atol=1e-7)
    kept, wanted = int((gates > 0).sum()), 2 * N * k
    cap = moe_capacity(cf, k, N, E)
    assert combine.shape == (2, N, E, cap)
    if cf < 1:  # at most cap tokens an expert: the overflow is dropped
        assert kept <= E * cap * 2 < wanted, (kept, wanted)
    # every kept (token, expert) pair holds exactly one slot, no slot twice
    assert combine.gt(0).sum(-1).max() <= 1 and combine.gt(0).sum(1).max() <= 1


@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
def test_output_and_aux_match_jax(k):
    jm, params, tm = moe_pair(k, seed=52 + k)
    x = tokens(1)
    y, inter = jm.apply({"params": params}, x, mutable=["intermediates"])
    ty, taux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(moe_aux_loss(inter)), rtol=1e-5)
    assert float(taux) > 0


def test_top1_router_reaches_the_task_gradient():
    """Switch routing scales by the raw router probability, so a task loss
    (here sum(y * r), the aux loss left out) reaches the router."""
    jm, params, tm = moe_pair(1, seed=55)
    x = tokens(2)
    r = np.random.default_rng(3).standard_normal((2, N, D)).astype(np.float32)

    def task(p):
        y, _ = jm.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.sum(y * r)

    g = jax.jit(jax.grad(task))(params)["router"]["kernel"]
    ty, _ = tm(torch.from_numpy(x))
    (ty * torch.from_numpy(r)).sum().backward()
    tg = tm.router.weight.grad.numpy().T
    assert np.abs(tg).max() > 1e-3
    np.testing.assert_allclose(tg, np.asarray(g), rtol=1e-4, atol=1e-5 * np.abs(g).max())


def test_expert_weights_use_flax_fan_avg_bound():
    torch.manual_seed(0)
    tm = MoEMLP(64, 256, 8)
    bound = (6.0 / (8 * (64 + 256))) ** 0.5  # fan_in d*E, fan_out m*E
    for w in (tm.w1, tm.w2):
        assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    # the initializer JaxMoE's w1 and w2 take (medfusion_tpu/parallel/moe.py)
    jw = nn.initializers.variance_scaling(1.0, "fan_avg", "uniform")(
        jax.random.PRNGKey(0), (8, 64, 256))
    assert np.abs(np.asarray(jw)).max() <= bound and np.abs(np.asarray(jw)).max() > 0.99 * bound
    assert not tm.b1.any() and not tm.b2.any()
    assert abs(tm.router.weight.std().item() - 0.02) < 2e-3
    # an expert-parallel layer holds its share of the experts at the bound of all E
    with one_rank_group() as group:
        torch.manual_seed(0)
        ep = MoEMLP(64, 256, 8, expert_axis=group)
        assert ep.expert_group is group and ep.w1.shape == tm.w1.shape
        for a, b in zip(ep.parameters(), tm.parameters()):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="process group"):
        MoEMLP(8, 16, 2, expert_axis="model")


SHAPE = (2, 8, 8, 2)
UNET_KW = dict(in_ch=2, out_ch=2, hid_chs=(8, 16), kernel_sizes=(3, 3), strides=(1, 2),
               time_emb_dim=16, cond_emb_num_classes=2,
               norm_name=("GROUP", {"num_groups": 4, "affine": True}))
DIT_KW = dict(in_ch=2, patch_size=2, hidden_size=32, depth=2, num_heads=2,
              cond_emb_num_classes=2, moe_experts=4, moe_every=1, moe_num_selected=2)


def estimators(kind):
    z = jnp.zeros((1,) + SHAPE[1:], jnp.float32)
    t = jnp.zeros((1,), jnp.int32)
    if kind == "unet":
        jm, tm, conv = JaxUNet(**UNET_KW), UNet(**UNET_KW), "unet"
    else:
        jm, tm, conv = JaxDiT(**DIT_KW), DiT(**DIT_KW), "dit"
    params = _randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, t, t)["params"], 61)
    if kind == "dit":
        for i in range(DIT_KW["depth"]):
            r = params[f"blocks_{i}"]["moe_mlp"]["router"]
            r["kernel"] = r["kernel"] * 8.0  # a z-loss and a load imbalance worth testing
    load_jax_params(tm, params, kind=conv)
    return jm, params, tm


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("family,kind", [("diffusion", "unet"), ("diffusion", "dit_moe"),
                                         ("flow", "unet"), ("flow", "dit_moe")])
def test_train_loss_metrics_and_moe_aux_match_jax(family, kind):
    """The same metric keys on both sides; ``moe_aux`` (0 for the dense
    UNet) and ``loss`` (which includes it) within rtol 1e-5."""
    jm, params, tm = estimators(kind)
    jbatch, tbatch = _batch(SHAPE)
    rng = jax.random.PRNGKey(9)
    b = SHAPE[0]
    if family == "diffusion":
        sched = dict(timesteps=20, schedule_strategy="scaled_linear", beta_start=0.002,
                     beta_end=0.02)
        jp = JaxPipeline(scheduler=JaxSchedule.create(**sched), noise_estimator=jm,
                         do_input_centering=False)
        tp = DiffusionPipeline(scheduler=S.GaussianDiffusionSchedule.create(**sched),
                               noise_estimator=tm, do_input_centering=False)
        _, k_t, k_noise, k_cfg, _ = jax.random.split(rng, 5)
        draws = {"t": _t(jax.random.randint(k_t, (b,), 0, 20)),
                 "x_T": _t(jax.random.normal(k_noise, SHAPE))}
    else:
        jp = JaxFlow(noise_estimator=jm, do_input_centering=False)
        tp = FlowMatchingPipeline(noise_estimator=tm, do_input_centering=False)
        _, k_t, k_noise, k_cfg = jax.random.split(rng, 4)
        draws = {"t_draw": _t(jax.random.normal(k_t, (b,))),
                 "eps": _t(jax.random.normal(k_noise, SHAPE))}
    draws["drop"] = torch.tensor(bool(jax.random.uniform(k_cfg, ()) < 0.5))
    loss, metrics = jax.jit(lambda p: jp.train_loss({"noise_estimator": p}, jbatch, rng))(
        params)
    with torch.no_grad():
        tloss, tmetrics = tp.train_loss(tbatch, draws)
    assert set(tmetrics) == set(metrics) and "moe_aux" in tmetrics
    aux = float(metrics["moe_aux"])
    assert (aux > 0) == (kind == "dit_moe")
    np.testing.assert_allclose(float(tmetrics["moe_aux"]), aux, rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["loss"]), float(metrics["loss"]), rtol=1e-5)


def test_moe_aux_is_per_call():
    """The aux loss is returned by each forward, not kept in the module: a
    second call on other tokens gives its own value, and functional_call
    on other parameters does not change the module's."""
    _, _, tm = moe_pair(2, seed=57)
    _, a1 = tm(torch.from_numpy(tokens(4)))
    _, a2 = tm(torch.from_numpy(tokens(5)))
    _, a1_again = tm(torch.from_numpy(tokens(4)))
    assert float(a1) != float(a2) and float(a1) == float(a1_again)
