"""The port's GroupNorm(+SiLU) plain version against the JAX package's
reference and its Pallas kernel (interpret mode on the CPU).

Tolerance: atol = rtol = 1e-5 in float32 (the statistics are summed in
another order by each implementation). The CUDA kernel itself is compared
with the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.ops.group_norm import fused_group_norm_silu as jax_fused
from medfusion_tpu.ops.group_norm import group_norm_silu_reference as jax_reference
from medfusion_tpu_torch.ops import group_norm as G


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
