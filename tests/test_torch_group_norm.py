"""The port's GroupNorm(+SiLU) plain version against the JAX package's
reference and its Pallas kernel (interpret mode on the CPU).

Tolerance: atol = rtol = 1e-5 in float32 (the statistics are summed in
another order by each implementation). The CUDA kernel itself is compared
with the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_kernels_cuda.py``; its launch plan (``launch_plan``,
plain Python) is checked here at every path shape and at ragged ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.ops.group_norm import fused_group_norm_silu as jax_fused
from medfusion_tpu.ops.group_norm import group_norm_silu_reference as jax_reference
from medfusion_tpu_torch.ops import group_norm as G


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed=0, mean=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 8, 8, c)) + mean).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, groups, silu):
    """Run the port on the NCHW form of channels-last ``x``; back to NHWC."""
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    y = G.group_norm_silu(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                          groups, apply_silu=silu)
    return np.moveaxis(y.numpy(), 1, -1)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "plain"])
@pytest.mark.parametrize("c,groups", [(64, 8), (256, 8), (256, 32), (64, 32)])
def test_plain_version_matches_jax_reference_and_pallas(c, groups, silu):
    x, scale, bias = _inputs(c, seed=c + groups, mean=3.0)
    ours = _port(x, scale, bias, groups, silu)
    ref = np.asarray(jax_reference(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias), groups, apply_silu=silu))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    if c % np.lcm(c // groups, 128) == 0:  # the JAX wrapper's kernel gate
        pallas = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), groups,
                                      apply_silu=silu, interpret=True))
        np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the CUDA launcher or the launch count."""
    def no_launch(*a, **k):
        raise AssertionError("the CUDA launcher was called for a CPU tensor")

    monkeypatch.setattr(G, "group_norm_silu_cuda", no_launch)
    before = G.LAUNCHES
    x = torch.randn(2, 64, 4, 4)
    y = G.group_norm_silu(x, torch.ones(64), torch.zeros(64), 8)
    torch.testing.assert_close(
        y, G.group_norm_silu_reference(x, torch.ones(64), torch.zeros(64), 8),
        rtol=0, atol=0)
    assert G.LAUNCHES == before


def test_launcher_refuses_a_cpu_tensor_and_bad_shapes():
    x = torch.randn(2, 64, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        G.group_norm_silu_cuda(x, torch.ones(64), torch.zeros(64), 8)
    with pytest.raises(ValueError, match="divisible"):
        G.group_norm_silu_cuda(x, torch.ones(64), torch.zeros(64), 6)
    with pytest.raises(ValueError, match="contiguous"):
        G.group_norm_silu_cuda(x.transpose(2, 3), torch.ones(64), torch.zeros(64), 8)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        G.group_norm_silu_cuda(x.double(), torch.ones(64).double(),
                               torch.zeros(64).double(), 8)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "plain"])
def test_gradient_matches_jax_autodiff(silu):
    x, scale, bias = _inputs(64, seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def loss(x_, s_, b_):
        return jnp.sum(jax_reference(x_, s_, b_, 8, apply_silu=silu) * g)

    jgx, jgs, jgb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    gt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 1)))
    (G.group_norm_silu(xt, st, bt, 8, apply_silu=silu) * gt).sum().backward()
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), np.asarray(jgx),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgs), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), atol=1e-5, rtol=1e-5)


# (B, C, S, G): the chest path's nine shapes (UNet at B=64, VAE at B=32),
# ragged spatial sizes (S = 49, 15) and group widths (C/G = 1, 3, 5, 12), a
# ragged run past the block budget, and a group past 16 blocks' shared
# memory
PLAN_SHAPES = [(64, 256, 1024, 32), (64, 512, 256, 32), (64, 1024, 64, 32),
               (64, 512, 64, 32), (64, 256, 256, 32), (32, 512, 1024, 8),
               (32, 256, 4096, 8), (32, 128, 16384, 8), (32, 64, 65536, 8),
               (2, 48, 49, 4), (2, 32, 15, 32), (2, 96, 15, 32), (2, 40, 10000, 8),
               (2, 24, 16900, 8), (1, 64, 262144, 8)]


def _check_plan(plan, b, c, s, g, dtype):
    es = torch.finfo(dtype).bits // 8
    vec = 16 // es
    n = (c // g) * s
    assert plan["n"] == n and plan["groups"] == b * g
    assert plan["vector"] == (n % vec == 0)
    assert plan["route"] == ("cluster" if n > G.BLOCK_BUDGET else "block")
    assert 32 <= plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    if plan["route"] == "block":
        assert plan["threads"] <= G.BLOCK_MAX_THREADS  # the kernel's launch bound
    if plan["route"] == "block":
        gt, units = plan["group_threads"], plan["units"]
        assert gt % 32 == 0 and gt * plan["groups_per_block"] == plan["threads"]
        assert units in ((1, 2, 4, 8) if es == 4 else (1, 2, 4))
        assert units * vec <= G.BLOCK_MAX_VALUES_PER_THREAD  # registers a thread
        # the fewest threads (up to 512) at the aimed values a thread, then
        # the fewest vectors that cover the run
        assert gt == 32 or gt * G.BLOCK_VALUES_PER_THREAD < 2 * n or gt == 512
        assert gt * units * vec >= n and (units == 1 or gt * units * vec < 2 * n)
        assert plan["blocks"] * plan["groups_per_block"] >= b * g
        assert plan["smem_bytes"] == 0
        return
    cs, slice_, res = plan["cluster"], plan["slice"], plan["resident"]
    assert cs in (2, 4, 8, 16) and plan["blocks"] == b * g * cs
    assert slice_ % vec == 0 and 0 < res <= slice_ and res % vec == 0
    covered = np.zeros(n, np.int8)  # each rank's [r*slice, (r+1)*slice) cut at n
    for r in range(cs):
        covered[r * slice_:(r + 1) * slice_] += 1
        assert r * slice_ < n  # no rank without work
    assert (covered == 1).all()
    assert plan["smem_bytes"] == res * es
    assert plan["smem_bytes"] + G.CLUSTER_STATIC_SMEM <= 227 * 1024
    # the resident part is the whole slice wherever it fits
    assert (res == slice_) == (slice_ * es + G.CLUSTER_STATIC_SMEM <= 227 * 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,s,g", PLAN_SHAPES)
def test_launch_plan_covers_each_run_within_the_cards_limits(b, c, s, g, dtype):
    _check_plan(G.launch_plan(b, c, s, g, dtype), b, c, s, g, dtype)


def test_launch_plan_at_the_chest_path():
    """The routes the path takes: every UNet shape in registers, every VAE
    shape on a cluster (bf16 256^2 x 64, a 1 MB group: 16 blocks of 64 KB);
    f32 there is a 2 MB group, resident on 16 blocks of 128 KB, or under a
    cluster of 8 partly resident."""
    for b, c, s, g in PLAN_SHAPES[:5]:
        assert G.launch_plan(b, c, s, g, torch.bfloat16)["route"] == "block"
    assert G.launch_plan(64, 512, 64, 32, torch.bfloat16)["groups_per_block"] == 4
    warp = G.launch_plan(2, 256, 64, 32, torch.bfloat16)  # n = 512: a group a warp
    assert (warp["group_threads"], warp["groups_per_block"]) == (32, 8)
    for b, c, s, g in PLAN_SHAPES[5:9]:
        assert G.launch_plan(b, c, s, g, torch.bfloat16)["route"] == "cluster"
    top = G.launch_plan(32, 64, 65536, 8, torch.bfloat16)
    assert (top["cluster"], top["smem_bytes"]) == (16, 65536)
    f32 = G.launch_plan(32, 64, 65536, 8, torch.float32)
    assert (f32["cluster"], f32["resident"], f32["smem_bytes"]) == (16, 32768, 131072)
    f32_8 = G.launch_plan(32, 64, 65536, 8, torch.float32, max_cluster=8)
    assert f32_8["cluster"] == 8 and f32_8["resident"] < f32_8["slice"]
    _check_plan(f32_8, 32, 64, 65536, 8, torch.float32)
    assert not G.launch_plan(2, 48, 49, 4, torch.bfloat16)["vector"]  # n = 588


def test_card_plan_halves_a_cluster_the_card_cannot_hold(monkeypatch):
    """The wrapper's plan asks the card (an occupancy query, not a failed
    launch) and halves a cluster that cannot be resident."""
    asked = []

    def occupancy(plan, dtype):
        asked.append(plan["cluster"])
        return 0 if plan["cluster"] > 8 else 3

    monkeypatch.setattr(G, "max_active_clusters", occupancy)
    monkeypatch.setattr(G, "_PLANS", {})
    plan = G._plan_for(32, 64, 65536, 8, torch.bfloat16, True)
    assert asked == [16, 8] and plan["cluster"] == 8 and plan["smem_bytes"] == 131072
    assert G._plan_for(32, 64, 65536, 8, torch.bfloat16, True) is plan  # cached
    assert G._plan_for(64, 256, 1024, 32, torch.bfloat16, True)["route"] == "block"
    assert asked == [16, 8]  # no query for the block route
    assert not G._plan_for(2, 40, 10000, 8, torch.bfloat16, False)["vector"]
