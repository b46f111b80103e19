"""The port's fused GEGLU MLP plain version against the JAX package's
reference and its Pallas kernel (interpret mode on the CPU), in float32.

The Pallas kernel is reached with C = 128, F = 512 and ``block_f=128``, so
that its streamed accumulation over F runs four steps (the JAX wrapper
falls back to XLA unless C % 128 == 0). Tolerance: rtol = atol = 1e-5
against the JAX reference (the same f32 products summed in another order);
atol = rtol = 2e-5 against the Pallas kernel, whose A&S 7.1.26 erf is off
by up to 1.5e-7 of the gate and whose accumulation over F runs in four
blocks. The CUDA kernel is held to the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.ops.geglu import fused_geglu_mlp as jax_fused
from medfusion_tpu.ops.geglu import geglu_mlp_reference as jax_reference
from medfusion_tpu_torch.ops import geglu as G


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, c, f, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, c)) * 2.0 + 0.5).astype(np.float32)
    lns = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 2 * f)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * f)).astype(np.float32)
    w2 = (rng.standard_normal((f, c)) * f ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, lns, lnb, w1, b1, w2, b2


def _port(args):
    return G.fused_geglu_mlp(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("m", [64, 40], ids=["m64", "m40"])
def test_plain_version_matches_jax_reference_and_pallas(m):
    args = _inputs(m, 128, 512, seed=m)
    ours = _port(args)
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(ours, np.asarray(jax_reference(*jargs)), atol=1e-5, rtol=1e-5)
    if m % 8 == 0:  # the JAX wrapper's kernel gate
        pallas = jax_fused(*jargs, block_f=128, interpret=True)
        np.testing.assert_allclose(ours, np.asarray(pallas), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("c,f", [(16, 64), (48, 192)])
def test_plain_version_matches_jax_reference_at_narrow_widths(c, f):
    args = _inputs(10, c, f, seed=c)
    x3 = args[0].reshape(2, 5, c)  # [B, N, C] rows
    ours = _port((x3,) + args[1:])
    ref = np.asarray(jax_reference(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(ours.reshape(10, c), ref, atol=1e-5, rtol=1e-5)


def test_layer_norm_clamps_negative_variance():
    """E[x^2] - mean^2 can round below zero for a constant row; the clamp
    keeps the row finite (it normalises to the bias)."""
    x = torch.full((2, 32), 3.0)
    out = G.layer_norm_f32(x, torch.ones(32), torch.full((32,), 0.25))
    torch.testing.assert_close(out, torch.full((2, 32), 0.25))


def test_launch_shape_splits_f_only_when_row_blocks_cannot_fill_the_card():
    """bf16: 128 rows an up-projection block for 256 < C <= 512, else 64
    (two blocks an SM at C <= 256, one above); each block takes all of F's
    128-column n-tiles unless its row tiles are fewer than the blocks the
    card holds, then the run of n-tiles with the fewest waves x (run + half
    a tile of LayerNorm); down-projection tiles of 128 x 128; a g [M, F]
    workspace between them. float32: one kernel, no workspace."""
    bf, sms = torch.bfloat16, 132
    # 1,024 row tiles of 64: no split
    assert G.launch_shape(65536, 256, 1024, bf, sms) == (
        64, 8, (1, 1024), (2, 512), (65536, 1024))
    # 128 row tiles of 128 rows: one run of 16 tiles fills 128 SMs in one wave
    assert G.launch_shape(16384, 512, 2048, bf, sms) == (
        128, 16, (1, 128), (4, 128), (16384, 2048))
    # 64 row tiles of 64 rows (C = 1,024): two runs of 16 (one wave of 128
    # blocks) beat three of 11 (192 blocks, two waves)
    assert G.launch_shape(4096, 1024, 4096, bf, sms) == (
        64, 16, (2, 64), (8, 32), (4096, 4096))
    # the sampling batch's 8^2 level: 16 row tiles, runs of 4 n-tiles
    assert G.launch_shape(1024, 1024, 4096, bf, sms) == (
        64, 4, (8, 16), (8, 8), (1024, 4096))
    # 64 row tiles at C = 256: 256 blocks in the card's 264 slots
    assert G.launch_shape(4096, 256, 1024, bf, sms).up_grid == (4, 64)
    assert G.launch_shape(1024, 512, 2048, bf, sms).tiles_per_block == 1
    assert G.launch_shape(100, 16, 64, bf, sms) == (64, 1, (1, 2), (1, 1), (100, 64))
    assert G.launch_shape(4096, 1024, 4096, torch.float32, sms) == (
        8, 1, (512, 1), None, None)


def test_cpu_wrapper_takes_the_plain_version(monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("the CUDA launcher was called for a CPU tensor")

    monkeypatch.setattr(G, "geglu_mlp_cuda", no_launch)
    before = G.LAUNCHES
    args = [torch.from_numpy(a) for a in _inputs(8, 32, 128)]
    torch.testing.assert_close(G.fused_geglu_mlp(*args), G.geglu_mlp_reference(*args),
                               rtol=0, atol=0)
    assert G.LAUNCHES == before


def test_gradient_flows_through_the_plain_version():
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs(6, 16, 64)]
    G.fused_geglu_mlp(*args).square().sum().backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in args)


def test_launcher_refuses_cpu_tensors_and_bad_shapes():
    ok = [torch.from_numpy(a) for a in _inputs(4, 32, 128)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        G.geglu_mlp_cuda(*ok)
    for c, f in ((24, 96), (32, 40), (1040, 4160)):
        bad = [torch.from_numpy(a) for a in _inputs(2, c, f)]
        with pytest.raises(ValueError, match="multiples of 16"):
            G.geglu_mlp_cuda(*bad)
    with pytest.raises(ValueError, match="do not match"):
        G.geglu_mlp_cuda(ok[0], *ok[1:3], ok[3][:, :-16], *ok[4:])
    with pytest.raises(TypeError, match="one dtype"):
        G.geglu_mlp_cuda(ok[0].double(), *ok[1:])
