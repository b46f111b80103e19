"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode; their plain versions are held against the JAX package by the other
``tests/test_torch_*.py`` files). This file imports no JAX, so it also runs
on a machine that has none; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: float32 atol = rtol = 2e-5 (the statistics are summed in another
order); bfloat16 atol = rtol = 1e-2 (both sides round an f32 result to bf16,
so they may differ by one bf16 ulp).
"""

import pytest
import torch

from medfusion_tpu_torch.ops import group_norm as G

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, c, side, dtype, mean=3.0):
    x = torch.randn((b, c, side, side), generator=gen, device="cuda") + mean
    scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    return x.to(dtype), scale.to(dtype), bias.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,g,side", [(256, 32, 32), (1024, 32, 8), (64, 8, 256),
                                      (48, 4, 7), (40, 8, 100)])
def test_group_norm_silu_matches_plain_version(cuda, dtype, c, g, side):
    before = G.LAUNCHES
    for silu in (True, False):
        x, scale, bias = _inputs(cuda, 2, c, side, dtype)
        out = G.group_norm_silu(x, scale, bias, g, apply_silu=silu)
        ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.device.type == "cuda"
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    assert G.LAUNCHES == before + 2


@pytest.mark.cuda
def test_group_norm_silu_gradient_recomputes_through_plain_version(cuda):
    x, scale, bias = _inputs(cuda, 2, 64, 16, torch.float32)
    grad = torch.randn(x.shape, generator=cuda, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    (G.group_norm_silu(*leaves, 8) * grad).sum().backward()
    ref = [t.clone().requires_grad_() for t in (x, scale, bias)]
    (G.group_norm_silu_reference(*ref, 8) * grad).sum().backward()
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_launch_on_a_side_stream(cuda):
    x, scale, bias = _inputs(cuda, 2, 256, 16, torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = G.group_norm_silu(x, scale, bias, 32)
    stream.synchronize()
    ref = G.group_norm_silu_reference(x, scale, bias, 32)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
