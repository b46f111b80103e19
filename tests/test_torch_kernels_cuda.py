"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode; their plain versions are held against the JAX package by the other
``tests/test_torch_*.py`` files). This file imports no JAX, so it also runs
on a machine that has none; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances:

* GroupNorm: float32 atol = rtol = 2e-5 (the statistics are summed in
  another order); bfloat16 atol = rtol = 1e-2 (both sides round an f32
  result to bf16, so they may differ by one bf16 ulp).
* Flash attention, o: float32 atol = rtol = 2e-5 (the same products summed
  in another order: the kernel's split-TF32 products, f32-accurate, against
  f32 FMA, no single-pass TF32); bfloat16 atol = two
  bf16 ulps of max|o_ref|, rtol = 0: both sides round q*s, k*s and o to
  bf16, and p to bf16 against the running row max (kernel) or the final one
  (plain version); the f32 values rounded to o differ by well under an ulp,
  so o differs by at most one ulp of its own magnitude. lse: 2e-5 in
  float32, 1e-4 in bfloat16 (f32 sums of the same bf16 products).
* GEGLU: float32 atol = rtol = 1e-4 (sums over C and over F = 4C in another
  order); bfloat16 atol = rtol = 3e-2: the kernel rounds h and gate once,
  the plain version (the module path) after the product and again after the
  bias, and an ulp flip in g moves the F-long down-projection sum by about
  an ulp of the output.
* Flash attention backward, dq/dk/dv against the plain backward on the
  kernels' o and lse: float32 atol = rtol = 2e-5 (as the forward's o);
  bfloat16 atol = two bf16 ulps of the
  largest |gradient|, rtol = 0: both sides round ds and p to bf16 at the
  same points and the gradients once at the end, from f32 sums taken in
  another order, so an element of ds, and so of the gradient, may land one
  ulp apart. Ring attention's block-pair backward: each block's dk and dv
  so; dq, an f32 sum of the blocks' partials, within the sum of their
  tolerances.

GEGLU is held at the rows of two UNet rows, of the sampling batch's 16 (8
samples under CFG) and of the flagship's 64, since its launch plan depends
on the row count.

The chest-spatial UNet at other head counts: its f32 forward on the card
against the same weights' forward on the CPU (the plain versions),
atol = rtol = 1e-3 of max|ref| (f32 convs, projections and kernels summed
in another order through some 40 layers, no TF32).

The samplers (DPM-Solver++, EDM, the encoder-propagation sampler) on the
smoke preset, f32, card against CPU from the same weights and draws: the
decoded images within 1e-4 x max(1, max|ref|), rtol 1e-4 (the smoke
tolerance of ``chip_smoke.py``).

A ``remat`` training step against the plain step on the card (the same
weights, draws and kernels, the blocks' forward run again in the
backward): the loss equal, each gradient within 1e-6 of its tensor's max.
"""

import copy
import math
import threading

import pytest
import torch

from medfusion_tpu_torch import ops
from medfusion_tpu_torch.ops import flash_attention as FA
from medfusion_tpu_torch.ops import geglu as GL
from medfusion_tpu_torch.ops import group_norm as G

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ATTN_LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
GEGLU_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _attn_o_tol(ref):
    """(atol, rtol) of attention's o against the plain version's ``ref``."""
    if ref.dtype != torch.bfloat16:
        return 2e-5, 2e-5
    return 2.0 * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7), 0.0


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


# (C, G, side, max_cluster): one of each route and plan at B=2: blocks of
# eight one-warp groups and of four two-warp groups; clusters of 2, 4, 8
# and 16 blocks (bf16; f32 doubles the cluster up to 16); a 2 MB f32 group
# on 8 blocks, partly resident; a ragged run (n = 50,700, no 16-byte
# vectors in bf16) on a cluster
ROUTE_CASES = [(256, 32, 8, 16), (512, 32, 8, 16), (512, 8, 32, 16), (256, 8, 64, 16),
               (128, 8, 128, 16), (64, 8, 256, 16), (64, 8, 256, 8), (24, 8, 130, 16)]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("c,g,side,max_cluster", ROUTE_CASES)
def test_group_norm_silu_each_route_matches_plain_version(cuda, dtype, c, g, side,
                                                          max_cluster):
    """Every route of the launch plan, SiLU on and off, against the plain
    version; one launch a call; two launches give the same bits."""
    plan = G.launch_plan(2, c, side * side, g, dtype, max_cluster=max_cluster)
    if plan["route"] == "cluster":
        assert G.max_active_clusters(plan, dtype) > 0
    for silu in (True, False):
        x, scale, bias = _inputs(cuda, 2, c, side, dtype)
        before = G.LAUNCHES
        out = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu, plan=plan)
        again = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu, plan=plan)
        ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
        torch.cuda.synchronize()
        assert G.LAUNCHES == before + 2
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert torch.equal(out, again)


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


# (tokens N, KV tokens M, width H*D, heads): the chest-spatial path's shape
# classes (1024 tokens d=32, 256 d=64 and d=32, 64 d=128 and d=64), the
# smoke preset's d=16, and N and M off the bf16 kernel's 64-row query blocks
# and 64-key tiles at head dims 16 to 128
ATTN_CASES = [(1024, 1024, 256, 8), (256, 256, 512, 8), (256, 256, 256, 8),
              (64, 64, 1024, 8), (64, 64, 512, 8), (100, 100, 32, 2),
              (77, 45, 256, 4), (77, 45, 128, 4), (45, 77, 64, 4), (45, 77, 512, 8),
              (1000, 1024, 256, 8), (129, 127, 512, 4), (1, 64, 64, 4), (64, 3, 512, 4)]


def _attn_inputs(gen, b, n, m, c, dtype):
    return [torch.randn((b, r, c), generator=gen, device="cuda").to(dtype)
            for r in (n, m, m)]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("n,m,c,heads", ATTN_CASES)
def test_flash_attention_both_layouts_match_plain_version(cuda, dtype, n, m, c, heads):
    q, k, v = _attn_inputs(cuda, 2, n, m, c, dtype)
    scale = (c // heads) ** -0.25
    qh, kh, vh = (FA._heads(t, heads) for t in (q, k, v))
    ro, rlse = FA.naive_attention_reference(qh, kh, vh, scale)
    before = ops.launch_counts()
    o, lse = FA.flash_attention_tokens(q, k, v, heads, scale)
    oh, lseh = FA.flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(), scale)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_tokens"] == before["flash_attention_tokens"] + 1
    atol, rtol = _attn_o_tol(ro)
    ltol = ATTN_LSE_TOL[dtype]
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert o.shape == q.shape and lse.shape == (2, n, heads)
    for out, lo in ((FA._heads(o, heads), lse.transpose(1, 2)), (oh, lseh)):
        torch.testing.assert_close(out.float(), ro.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lo, rlse, atol=ltol, rtol=ltol)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("layout", ["head", "tokens"])
def test_flash_attention_takes_an_expanded_operand(cuda, dtype, layout):
    """A k with a zero stride (one key broadcast over M) is read as it is in
    float32 and copied for the bfloat16 kernel's TMA loads; either way o and
    lse match the plain version."""
    q, v = _attn_inputs(cuda, 2, 96, 80, 256, dtype)[::2]
    k = torch.randn((2, 1, 256), generator=cuda, device="cuda").to(dtype).expand(2, 80, 256)
    qh, kh, vh = (FA._heads(t, 8) for t in (q, k, v))
    ro, rlse = FA.naive_attention_reference(qh, kh, vh, 0.5)
    if layout == "head":
        o, lse = FA.flash_attention(qh, kh, vh, 0.5)
    else:
        o, lse = FA.flash_attention_tokens(q, k, v, 8, 0.5)
        o, lse = FA._heads(o, 8), lse.transpose(1, 2)
    atol, rtol = _attn_o_tol(ro)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, rlse, atol=ATTN_LSE_TOL[dtype], rtol=ATTN_LSE_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["head", "tokens"])
def test_flash_attention_is_deterministic(cuda, layout):
    """No atomics: two bf16 runs at 1,024 tokens d=32 (the head layout's
    path shape) give the same bits, o and lse."""
    q, k, v = _attn_inputs(cuda, 2, 1024, 1024, 256, torch.bfloat16)
    if layout == "head":
        run = lambda: FA.flash_attention_cuda(*(FA._heads(t, 8) for t in (q, k, v)), 0.5)  # noqa: E731
    else:
        run = lambda: FA.flash_attention_tokens_cuda(q, k, v, 8, 0.5)  # noqa: E731
    first, second = run(), run()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_takes_strided_head_views(cuda):
    """The head entry on [B, H, N, D] views of token-layout tensors (as the
    attention dispatch passes them) writes o with q's strides."""
    q, k, v = _attn_inputs(cuda, 2, 1024, 1024, 256, torch.bfloat16)
    qh, kh, vh = (FA._heads(t, 8) for t in (q, k, v))
    o, _ = FA.flash_attention(qh, kh, vh, 0.5)
    assert o.stride() == qh.stride()
    ref, _ = FA.naive_attention_reference(qh, kh, vh, 0.5)
    atol, rtol = _attn_o_tol(ref)
    torch.testing.assert_close(o.float(), ref.float(), atol=atol, rtol=rtol)


# head widths off the compiled 16/32/64/128 (zero-filled columns) and
# above 128 (128-column chunks; at d = 136 the last chunk's second half
# lies wholly past d and is not loaded), at N and M off the 64-row blocks
WIDE_CASES = [(n, m, d) for d in (8, 24, 136, 256, 512, 1024)
              for n, m in ((77, 45), (129, 127))]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("n,m,d", WIDE_CASES)
def test_flash_attention_any_head_width_matches_plain_version(cuda, dtype, n, m, d):
    """Both layouts, two heads of width d."""
    q, k, v = _attn_inputs(cuda, 2, n, m, 2 * d, dtype)
    scale = d ** -0.25
    qh, kh, vh = (FA._heads(t, 2) for t in (q, k, v))
    ro, rlse = FA.naive_attention_reference(qh, kh, vh, scale)
    o, lse = FA.flash_attention_tokens(q, k, v, 2, scale)
    oh, lseh = FA.flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(), scale)
    torch.cuda.synchronize()
    atol, rtol = _attn_o_tol(ro)
    ltol = ATTN_LSE_TOL[dtype]
    for out, lo in ((FA._heads(o, 2), lse.transpose(1, 2)), (oh, lseh)):
        torch.testing.assert_close(out.float(), ro.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lo, rlse, atol=ltol, rtol=ltol)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("d", [4, 12, 20])
@pytest.mark.parametrize("layout", ["head", "tokens"])
def test_flash_attention_head_width_off_8_matches_plain_version(cuda, dtype, d, layout):
    """d % 8 != 0: the kernels on zero-padded copies, forward (o, lse) and
    backward (dq, dk, dv through autograd), two heads, N and M off the
    blocks, against the plain versions at d."""
    q, k, v = _attn_inputs(cuda, 2, 77, 45, 2 * d, dtype)
    do = torch.randn((2, 77, 2 * d), generator=cuda, device="cuda").to(dtype)
    scale = d ** -0.25
    ro, rlse = FA.naive_attention_reference(*(FA._heads(t, 2) for t in (q, k, v)), scale)
    before = ops.launch_counts()
    grads, refs = _attention_grads(q, k, v, do, 2, layout)
    if layout == "head":
        o, lse = FA.flash_attention(*(FA._heads(t, 2) for t in (q, k, v)), scale)
    else:
        o, lse = FA.flash_attention_tokens(q, k, v, 2, scale)
        o, lse = FA._heads(o, 2), lse.transpose(1, 2)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    entry = "flash_attention" if layout == "head" else "flash_attention_tokens"
    assert after[entry] == before[entry] + 2
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert o.shape == ro.shape and lse.shape == rlse.shape
    torch.testing.assert_close(o.float(), ro.float(), atol=_attn_o_tol(ro)[0],
                               rtol=_attn_o_tol(ro)[1])
    torch.testing.assert_close(lse, rlse, atol=ATTN_LSE_TOL[dtype], rtol=ATTN_LSE_TOL[dtype])
    for gr, r in zip(grads, refs):
        assert gr.shape == r.shape
        torch.testing.assert_close(gr.float(), r.float(), atol=_bwd_tol(r)[0],
                                   rtol=_bwd_tol(r)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048])
def test_flash_attention_refuses_unsupported_head_dims(cuda, d):
    x = torch.randn((1, 2, 16, d), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(x, x, x, 0.5)


def _bwd_tol(ref):
    """(atol, rtol) of a backward kernel's gradient against the plain
    backward's ``ref``."""
    if ref.dtype != torch.bfloat16:
        return 2e-5, 2e-5
    return 2.0 * 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7), 0.0


def _attention_grads(q, k, v, do, heads, layout):
    """dq, dk, dv through the entry of ``layout`` (token-layout tensors in
    and out), the kernels' o and lse, and the plain backward's gradients on
    that o and lse."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    scale = (q.shape[2] // heads) ** -0.25
    if layout == "head":
        o, lse = FA.flash_attention(*(FA._heads(t, heads) for t in leaves), scale)
        o.backward(FA._heads(do, heads))
        oh = o.detach()
    else:
        o, lse = FA.flash_attention_tokens(*leaves, heads, scale)
        o.backward(do)
        oh, lse = FA._heads(o.detach(), heads), lse.transpose(1, 2)
    ref = FA.flash_attention_backward_reference(
        *(FA._heads(t, heads) for t in (q, k, v)), oh, lse, FA._heads(do, heads), scale)
    return [t.grad for t in leaves], [r.transpose(1, 2).flatten(2) for r in ref]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("layout", ["head", "tokens"])
@pytest.mark.parametrize("n,m,c,heads", [
    (1024, 1024, 256, 8), (256, 256, 512, 8), (256, 256, 256, 8), (64, 64, 1024, 8),
    (64, 64, 512, 8),  # the chest-spatial training path's shapes
    (77, 45, 64, 4), (77, 45, 128, 4), (45, 77, 256, 4), (77, 45, 512, 4),  # d 16..128
    # N and M off the bf16 kernels' 64-row blocks and 64- or 32-row tiles
    (1000, 1024, 256, 8), (129, 127, 512, 4), (1, 64, 64, 4), (64, 3, 512, 4),
])
def test_flash_attention_backward_matches_plain_version(cuda, dtype, layout, n, m, c,
                                                        heads):
    """A CUDA tensor that needs a gradient runs the forward kernel and both
    backward kernels, in either layout, and matches the plain backward."""
    q = torch.randn((2, n, c), generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn((2, m, c), generator=cuda, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((2, n, c), generator=cuda, device="cuda").to(dtype)
    before = ops.launch_counts()
    grads, refs = _attention_grads(q, k, v, do, heads, layout)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    fwd = "flash_attention" if layout == "head" else "flash_attention_tokens"
    for name in (fwd, "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    for what, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape
        atol, rtol = _bwd_tol(r)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol,
                                   msg=lambda msg, w=what: f"{w}: {msg}")


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("layout", ["head", "tokens"])
@pytest.mark.parametrize("n,m,d", WIDE_CASES)
def test_flash_attention_backward_any_head_width_matches_plain_version(cuda, dtype, layout,
                                                                      n, m, d):
    """The forward and both backward kernels at two heads of width d."""
    q = torch.randn((2, n, 2 * d), generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn((2, m, 2 * d), generator=cuda, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((2, n, 2 * d), generator=cuda, device="cuda").to(dtype)
    grads, refs = _attention_grads(q, k, v, do, 2, layout)
    torch.cuda.synchronize()
    for what, g, r in zip(("dq", "dk", "dv"), grads, refs):
        atol, rtol = _bwd_tol(r)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol,
                                   msg=lambda msg, w=what: f"{w}: {msg}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,c,heads,layout", [
    *(pytest.param(dtype, n, 256, 8, layout, id=f"{n}-{layout}-{name}")
      for n, layout in ((256, "tokens"), (1024, "head"))
      for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))),
    pytest.param(torch.float32, 256, 128, 1, "tokens", id="256-tokens-f32-1x128"),
    pytest.param(torch.float32, 257, 128, 4, "tokens", id="257-tokens-f32-4x32")])
def test_flash_attention_backward_is_deterministic(cuda, dtype, n, c, heads, layout):
    """No atomics: two runs give the same bits (d = 32, as at the 32^2 and
    16^2 levels of the training path; in f32 also the classifier's one head
    of 128 and its attention pool's 257 tokens, 4 heads of 32)."""
    q, k, v, do = (torch.randn((2, n, c), generator=cuda, device="cuda").to(dtype)
                   for _ in range(4))
    first = _attention_grads(q, k, v, do, heads, layout)[0]
    second = _attention_grads(q, k, v, do, heads, layout)[0]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@DTYPES
def test_flash_attention_backward_takes_a_strided_gradient(cuda, dtype):
    """An incoming gradient whose rows break the 16-byte rule is copied,
    not refused; an expanded one (zero strides) is read as it is in float32
    and copied for the bfloat16 kernels' TMA loads."""
    q, k, v = (torch.randn((1, 64, 64), generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    for do in (torch.randn((1, 64, 72), generator=cuda, device="cuda").to(dtype)[..., 3:67],
               torch.randn((1, 1, 64), generator=cuda, device="cuda").to(dtype).expand(
                   1, 64, 64)):
        grads, refs = _attention_grads(q, k, v, do, 2, "tokens")
        for g, r in zip(grads, refs):
            torch.testing.assert_close(g.float(), r.float(), atol=_bwd_tol(r)[0],
                                       rtol=_bwd_tol(r)[1])


def _side_stream_group_norm(gen):
    x, scale, bias = _inputs(gen, 2, 256, 16, torch.bfloat16)
    return (lambda: [G.group_norm_silu(x, scale, bias, 32)],
            lambda: [G.group_norm_silu_reference(x, scale, bias, 32)],
            lambda r: (1e-2, 1e-2))


def _side_stream_attention(gen):
    """The forward kernel (bf16) in both layouts: o and lse of each."""
    q, k, v = (torch.randn((2, 256, 256), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    qh, kh, vh = (FA._heads(t, 8) for t in (q, k, v))

    def kernels():
        o, lse = FA.flash_attention_tokens_cuda(q, k, v, 8, 0.5)
        return [FA._heads(o, 8), lse.transpose(1, 2), *FA.flash_attention_cuda(qh, kh, vh, 0.5)]

    def plain():
        return 2 * list(FA.naive_attention_reference(qh, kh, vh, 0.5))

    return kernels, plain, lambda r: (_attn_o_tol(r) if r.dtype == torch.bfloat16
                                      else (ATTN_LSE_TOL[torch.bfloat16],) * 2)


def _side_stream_geglu(gen):
    """Both bf16 GEGLU kernels (up- and down-projection, g between them)."""
    args = _geglu_inputs(gen, 4096, 512, torch.bfloat16)
    return (lambda: [GL.geglu_mlp_cuda(*args)], lambda: [GL.geglu_mlp_reference(*args)],
            lambda r: (GEGLU_TOL[torch.bfloat16],) * 2)


def _side_stream_attention_backward(gen):
    """Both backward kernels (bf16, token layout) on their operands."""
    q, k, v, do = (torch.randn((2, 256, 256), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    qh, kh, vh, doh = (FA._heads(t, 8) for t in (q, k, v, do))
    o, lse = FA.flash_attention_tokens_cuda(q, k, v, 8, 0.5)
    torch.cuda.synchronize()
    oh, lseh = FA._heads(o, 8), lse.transpose(1, 2)

    def kernels():
        return list(FA.flash_attention_backward_cuda(qh, kh, vh, oh, lseh, doh, 0.5))

    return (kernels,
            lambda: list(FA.flash_attention_backward_reference(qh, kh, vh, oh, lseh, doh,
                                                                0.5)),
            _bwd_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["group_norm_silu", "flash_attention",
                                    "flash_attention_backward", "geglu_mlp"])
def test_launch_on_a_side_stream(cuda, kernel):
    """A launch goes on the caller's current stream, not the default one."""
    make = {"group_norm_silu": _side_stream_group_norm,
            "flash_attention": _side_stream_attention,
            "flash_attention_backward": _side_stream_attention_backward,
            "geglu_mlp": _side_stream_geglu}[kernel]
    run, plain, tol = make(cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        outs = run()
    stream.synchronize()
    for out, ref in zip(outs, plain()):
        atol, rtol = tol(ref)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("parts,d", [(2, 32), (4, 32), (4, 12)])
def test_attention_blocks_backward_matches_plain_version(cuda, dtype, parts, d):
    """Ring attention's block-pair backward on one card: both kernels once
    a K/V block with the blocks' merged o and lse; each block's dk, dv and
    the f32 sum of the blocks' dq against the same sums of the plain
    backward's pairs (dq: the pairs' tolerances added)."""
    from medfusion_tpu_torch.parallel.ring_attention import (
        attention_blocks_backward,
        merge_attention_blocks,
    )

    q, k, v, do = (torch.randn((2, 4, 256, d), generator=cuda, device="cuda").to(dtype)
                   for _ in range(4))
    scale = d ** -0.25
    blocks = list(zip(k.chunk(parts, dim=2), v.chunk(parts, dim=2)))
    o, lse = merge_attention_blocks(*zip(*(FA.flash_attention(q, kb, vb, scale)
                                           for kb, vb in blocks)))
    before = ops.launch_counts()
    dq, dkv = attention_blocks_backward(q, blocks, o, lse, do, scale)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for kernel in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[kernel] == before[kernel] + parts
    plain = [FA.flash_attention_backward_reference(q, kb, vb, o, lse, do, scale)
             for kb, vb in blocks]
    assert dq.dtype == torch.float32
    torch.testing.assert_close(dq, sum(g[0].float() for g in plain),
                               atol=sum(_bwd_tol(g[0])[0] for g in plain),
                               rtol=_bwd_tol(plain[0][0])[1])
    for (dk, dv), (_, rk, rv) in zip(dkv, plain):
        for g, r in ((dk, rk), (dv, rv)):
            assert g.dtype == dtype and g.shape == r.shape
            torch.testing.assert_close(g.float(), r.float(), atol=_bwd_tol(r)[0],
                                       rtol=_bwd_tol(r)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_backward",
                                    "geglu_mlp"])
def test_launch_first_on_a_fresh_thread(cuda, kernel):
    """A bf16 launch from a thread that has made no CUDA call yet, its
    outputs from the allocator's cache (as autograd's device thread running
    an attention backward as its first CUDA work): the TMA maps are encoded
    in the device's primary context."""
    make = {"flash_attention": _side_stream_attention,
            "flash_attention_backward": _side_stream_attention_backward,
            "geglu_mlp": _side_stream_geglu}[kernel]
    run, plain, tol = make(cuda)
    run()  # the outputs' blocks go to the allocator's cache
    torch.cuda.synchronize()
    result = {}

    def work():
        try:
            result["outs"] = run()
            torch.cuda.synchronize()
        except RuntimeError as e:
            result["error"] = str(e)

    thread = threading.Thread(target=work)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive() and "error" not in result, result.get("error")
    for out, ref in zip(result["outs"], plain()):
        atol, rtol = tol(ref)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def _geglu_inputs(gen, rows, c, dtype):
    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    f = 4 * c
    return [rnd(rows, c, std=2.0, mean=0.5), rnd(c, std=0.1, mean=1.0), rnd(c, std=0.1),
            rnd(2 * f, c, std=c ** -0.5).t(), rnd(2 * f, std=0.1),
            rnd(c, f, std=f ** -0.5).t(), rnd(c, std=0.1)]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("rows,c", [
    (2048, 256), (512, 512), (512, 256), (128, 1024), (128, 512),  # 2 UNet rows
    (16384, 256), (4096, 512), (4096, 256), (1024, 1024), (1024, 512),  # 16 (B=8)
    (65536, 256), (16384, 512), (4096, 1024),  # 64 (B=64; 16384 x 256, 4096 x 512 above)
    (77, 256), (130, 16), (1000, 1024), (1000, 512), (130, 1024), (33, 48)])
def test_geglu_mlp_matches_plain_version(cuda, dtype, rows, c):
    args = _geglu_inputs(cuda, rows, c, dtype)
    before = GL.LAUNCHES
    out = GL.fused_geglu_mlp(*args)
    ref = GL.geglu_mlp_reference(*args)
    torch.cuda.synchronize()
    assert GL.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == (rows, c)
    tol = GEGLU_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(16384, 256), (1000, 1024)])
def test_geglu_mlp_is_deterministic(cuda, rows, c):
    """No atomics: two bf16 launches give the same bits."""
    args = _geglu_inputs(cuda, rows, c, torch.bfloat16)
    assert torch.equal(GL.geglu_mlp_cuda(*args), GL.geglu_mlp_cuda(*args))


def _unet_card_vs_cpu(cpu, shape, entries):
    """An f32 forward of 2 rows of ``cpu``'s UNet on the card (every kernel)
    against the CPU's (every plain version), same weights, perturbed away
    from the zero-initialised heads; the attention ``entries`` were
    launched."""
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.add_(0.02 * torch.randn(prm.shape))
    card = copy.deepcopy(cpu).cuda()
    x = torch.randn((2, *shape))
    t = torch.tensor([999, 10])
    c = torch.tensor([0, 1])
    before = ops.launch_counts()
    with torch.no_grad():
        ref, _ = cpu(x, t, c)
        out, _ = card(x.cuda(), t.cuda(), c.cuda())
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for entry in entries:
        assert after[entry] > before[entry]
    tol = 1e-3 * ref.abs().max().item()
    torch.testing.assert_close(out.cpu(), ref, atol=tol, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads", [((32, 32, 64), 32)])
def test_narrow_spatial_unet_at_head_widths_off_8_matches_the_cpu(cuda, hid, heads):
    """A narrow spatial UNet (the ``heads`` configuration of
    tests/test_torch_attention_unet.py: widths 32 and 64, 4 groups, 16x16
    input, so 256 and 64 tokens: the token-layout entry) at 32 heads: head
    widths 1 and 2, on zero-padded copies."""
    from medfusion_tpu_torch.models.unet import UNet

    torch.manual_seed(heads)
    n = len(hid)
    cpu = UNet(in_ch=2, out_ch=2, hid_chs=hid, kernel_sizes=(3,) * n,
               strides=(1,) + (2,) * (n - 1), time_emb_dim=32, cond_emb_num_classes=2,
               norm_name=("GROUP", {"num_groups": 4, "affine": True}), deep_supervision=0,
               use_attention="spatial", attn_heads=heads).eval()
    _unet_card_vs_cpu(cpu, (2, 16, 16), ("flash_attention_tokens",))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 2, 4, 32, 64])
def test_chest_spatial_unet_at_other_head_counts_matches_the_cpu(cuda, heads):
    """The chest UNet with spatial attention at ``attn_heads`` 1, 2, 4, 32
    and 64 (head widths up to 1,024, down to 4, which runs on zero-padded
    copies): an f32 forward of 2 rows on the card (every kernel) against
    the CPU's (every plain version), same weights; and the attention
    entries were launched."""
    from medfusion_tpu_torch.cli.presets import PRESETS, build_unet

    torch.manual_seed(heads)
    cpu = build_unet(PRESETS["chest"], attention="spatial", attn_heads=heads).eval()
    _unet_card_vs_cpu(cpu, (8, 32, 32), ("flash_attention", "flash_attention_tokens"))


@pytest.mark.cuda
def test_geglu_mlp_gradient_recomputes_through_plain_version(cuda):
    args = _geglu_inputs(cuda, 40, 32, torch.float32)
    grad = torch.randn((40, 32), generator=cuda, device="cuda")
    leaves = [t.detach().clone().requires_grad_() for t in args]
    (GL.fused_geglu_mlp(*leaves) * grad).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in args]
    (GL.geglu_mlp_reference(*ref) * grad).sum().backward()
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_geglu_mlp_refuses_unsupported_widths(cuda):
    args = _geglu_inputs(cuda, 8, 1040, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        GL.fused_geglu_mlp(*args)


# the conv discriminator's GroupNorm shapes (C, side) at the chest preset's
# two pyramid levels (256^2 and 128^2 inputs), G=32: 1 to 16 channels a
# group; 128^2 x 32 is a group of exactly the block route's budget
DISC_GN_SHAPES = [(32, 256), (64, 128), (128, 64), (256, 32), (512, 16),
                  (32, 128), (64, 64), (128, 32), (256, 16), (512, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,side", DISC_GN_SHAPES)
def test_group_norm_silu_at_the_discriminator_shapes(cuda, c, side):
    """Kernel 1 at each f32 shape of the conv discriminator (B=2), SiLU on
    and off, with the plan the card runs there, against the plain version;
    two launches give the same bits."""
    g = 32
    plan = G._plan_for(2, c, side * side, g, torch.float32, True)
    assert plan["route"] == ("block" if c // g * side * side <= G.BLOCK_BUDGET else "cluster")
    for silu in (True, False):
        x, scale, bias = _inputs(cuda, 2, c, side, torch.float32)
        out = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu)
        again = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu)
        ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=TOL[torch.float32], rtol=TOL[torch.float32])
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("disc", ["conv", "patch"])
def test_smoke_adversarial_step_matches_the_cpu(cuda, disc):
    """Two adversarial steps of the smoke autoencoder with one
    deep-supervision head (so two discriminators), both players on from the
    first batch, f32, on the card and on the CPU from the same perturbed
    weights, batches and draws: every metric of both steps (losses, lambdas,
    discriminator losses) within rtol 1e-4, and the first step's gradients
    of each player within 1e-4 of its largest |g| (f32 convs summed in
    another order, no TF32); the conv discriminator's GroupNorms ran on the
    kernel."""
    import dataclasses

    from medfusion_tpu_torch.cli.presets import PRESETS, build_discriminators, build_vae
    from medfusion_tpu_torch.nn.blocks import Norm
    from medfusion_tpu_torch.train import GANTrainState
    from medfusion_tpu_torch.train.adversarial import (
        AdversarialTrainer,
        make_adversarial_train_step,
    )
    from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer

    p = dataclasses.replace(PRESETS["smoke"], ae_deep_supervision=1)
    torch.manual_seed(0)
    vae, discs = build_vae(p), build_discriminators(p, disc)
    with torch.no_grad():
        for prm in [*vae.parameters(), *discs.parameters()]:
            prm.add_(0.02 * torch.randn(prm.shape))
    b, side = p.ae_batch_size, p.image_size
    batches = [torch.rand((b, side, side, 3)) * 2 - 1 for _ in range(2)]
    noises = [torch.randn((b, *p.latent_shape)) for _ in range(2)]
    results = {}
    for dev in ("cpu", "cuda"):
        v, d = copy.deepcopy(vae).to(dev), copy.deepcopy(discs).to(dev)
        state = GANTrainState(v, d, lr=1e-4)
        step = make_adversarial_train_step(AdversarialTrainer(
            AutoencoderTrainer(v, pixel_loss=p.ae_loss,
                               embedding_loss_weight=p.ae_embedding_loss_weight),
            d, start_gan_train_step=-1))
        before = G.LAUNCHES
        metrics, grads = [], None
        for x, noise in zip(batches, noises):
            m = step(state, {"source": x.to(dev)}, noise.to(dev))
            metrics.append({k: float(val) for k, val in m.items()})
            if grads is None:
                grads = [{k: q.grad.detach().cpu().clone() for k, q in mod.named_parameters()}
                         for mod in (v, d)]
        launches = G.LAUNCHES - before
        results[dev] = metrics, grads
    # a step: the autoencoder's forward, then D(pred), D(real) and D(fake)
    # at both levels
    norms = [sum(isinstance(m, Norm) for m in mod.modules()) for mod in (vae, discs[0])]
    assert launches == 2 * (norms[0] + 3 * 2 * norms[1]) and norms[1] == (5 if disc == "conv" else 0)
    (m_ref, g_ref), (m_out, g_out) = results["cpu"], results["cuda"]
    for ref, out in zip(m_ref, m_out):
        assert set(ref) == set(out) and ref["lambda_0"] > 0 and ref["loss_1"] > 0
        for k in ref:
            torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=1e-6, msg=k)
    for ref, out in zip(g_ref, g_out):
        top = max(g.abs().max().item() for g in ref.values())
        for k in ref:
            torch.testing.assert_close(out[k], ref[k], atol=1e-4 * top, rtol=0, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler,attention", [("dpmpp", "none"), ("edm", "none"),
                                               ("fast", "none"), ("dpmpp", "spatial"),
                                               ("edm", "spatial")])
def test_smoke_samplers_match_the_cpu(cuda, sampler, attention):
    """DPM-Solver++ (10 steps), EDM (6 steps, Heun, churn 1 on injected
    draws; its t is fractional) and the fast sampler (10 steps, encoder
    every 3, eta 1) on the smoke preset, CFG 3 with ``un_cond``, f32, card
    against CPU, same perturbed weights and draws; with spatial attention
    (one head: d = 16 and 32) the attention and GEGLU kernels launched."""
    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

    p = PRESETS["smoke"]
    kw = dict(attention=attention, attn_heads=1 if attention == "spatial" else 8, seed=0)
    cpu, card = (build_pipeline(p, device=d, **kw) for d in ("cpu", "cuda"))
    torch.manual_seed(0)
    for part in ("noise_estimator", "latent_embedder"):
        with torch.no_grad():
            for prm in getattr(cpu, part).parameters():
                prm.add_(0.02 * torch.randn(prm.shape))
        getattr(card, part).load_state_dict(getattr(cpu, part).state_dict())
    b, lat = 4, p.latent_shape
    draws = {"x_T": torch.randn((b, *lat)), "churn": torch.randn((6, b, *lat)),
             "fast": torch.randn((10, b, *lat)), "cond": torch.tensor([0, 1, 0, 1])}

    def run(pipe, d):
        common = dict(condition=d["cond"], un_cond=1 - d["cond"], guidance_scale=3.0)
        if sampler == "dpmpp":
            return pipe.denoise_dpmpp(d["x_T"], steps=10, **common)
        if sampler == "edm":
            return pipe.denoise_edm(d["x_T"], steps=6, s_churn=1.0, churn_noise=d["churn"],
                                    **common)
        return pipe.denoise_fast(d["x_T"], steps=10, encoder_key_every=3, eta=1.0,
                                 noise=d["fast"], **common)

    ref = run(cpu, draws)
    before = ops.launch_counts()
    out = run(card, {k: v.cuda() for k, v in draws.items()}).cpu()
    after = ops.launch_counts()
    kernels = ["group_norm_silu"] + (["flash_attention_tokens", "geglu_mlp"]
                                     if attention == "spatial" else [])
    assert all(after[k] > before[k] for k in kernels)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, atol=1e-4 * scale, rtol=1e-4)


# the noisy-latent classifier's attentions (classifier guidance), f32, token
# layout: its middle block at 16^2 = 256 tokens of width 128, one head of 128
# or four of 32, and its attention pool at 257 tokens (the mean token
# prepended), four heads of 32
CLASSIFIER_ATTN_CASES = [(256, 128, 1), (256, 128, 4), (257, 128, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,heads", CLASSIFIER_ATTN_CASES)
def test_classifier_attention_shapes_match_plain_version(cuda, n, c, heads):
    """The forward (o, lse) and both backward kernels in float32 at the
    classifier's shapes, B=8 (the guided sampler's batch)."""
    q, k, v = _attn_inputs(cuda, 8, n, n, c, torch.float32)
    scale = (c // heads) ** -0.25
    ro, rlse = FA.naive_attention_reference(*(FA._heads(t, heads) for t in (q, k, v)), scale)
    o, lse = FA.flash_attention_tokens(q, k, v, heads, scale)
    torch.testing.assert_close(FA._heads(o, heads), ro, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse.transpose(1, 2), rlse, atol=2e-5, rtol=2e-5)
    do = torch.randn((8, n, c), generator=cuda, device="cuda")
    before = ops.launch_counts()
    grads, refs = _attention_grads(q, k, v, do, heads, "tokens")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attention_tokens", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    for what, g, r in zip(("dq", "dk", "dv"), grads, refs):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-5,
                                   msg=lambda msg, w=what: f"{w}: {msg}")


def _f32_forward_both_layouts(q, k, v, heads, scale):
    """The f32 forward kernel in the token and the head layout, each as
    [B, H, N, D] o and [B, H, N] lse."""
    o, lse = FA.flash_attention_tokens_cuda(q, k, v, heads, scale)
    oh, lseh = FA.flash_attention_cuda(*(FA._heads(t, heads) for t in (q, k, v)), scale)
    return [(FA._heads(o, heads), lse.transpose(1, 2)), (oh, lseh)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,heads", CLASSIFIER_ATTN_CASES)
def test_flash_attention_f32_is_deterministic(cuda, n, c, heads):
    """The f32 forward merges its warps' partial sums in warp order, with no
    atomics: two launches give the same bits, o and lse, in both layouts."""
    q, k, v = _attn_inputs(cuda, 8, n, n, c, torch.float32)
    scale = (c // heads) ** -0.25
    first = _f32_forward_both_layouts(q, k, v, heads, scale)
    second = _f32_forward_both_layouts(q, k, v, heads, scale)
    for (o1, l1), (o2, l2) in zip(first, second):
        assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("c,heads", [(128, 1), (128, 4)])
def test_flash_attention_f32_with_fewer_keys_than_warps_matches_plain_version(cuda, m, c,
                                                                               heads):
    """M < 8 W: one key tile, so all but the first warp of a block (8 at d =
    128, 4 at d = 32) get no tile and must add nothing to the merge."""
    q, k, v = _attn_inputs(cuda, 2, 77, m, c, torch.float32)
    scale = (c // heads) ** -0.25
    ro, rlse = FA.naive_attention_reference(*(FA._heads(t, heads) for t in (q, k, v)), scale)
    for o, lse in _f32_forward_both_layouts(q, k, v, heads, scale):
        torch.testing.assert_close(o, ro, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 512, 1024])
def test_flash_attention_f32_wide_heads_over_1024_tokens_match_plain_version(cuda, d):
    """d > 128 in 128-column chunks over 1,024 queries and keys: the longest
    chains of score and p v products the f32 forward runs."""
    q, k, v = _attn_inputs(cuda, 2, 1024, 1024, d, torch.float32)
    scale = d ** -0.25
    ro, rlse = FA.naive_attention_reference(*(FA._heads(t, 1) for t in (q, k, v)), scale)
    for o, lse in _f32_forward_both_layouts(q, k, v, 1, scale):
        torch.testing.assert_close(o, ro, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["adaptive", "attention"])
def test_classifier_gradient_matches_the_cpu(cuda, pool):
    """The chest classifier's input gradient (classifier guidance), f32,
    card against CPU on the same perturbed weights, within 1e-4 of max|g|;
    each of its attentions launches one forward, one dQ and one dK/dV."""
    from medfusion_tpu_torch.cli.presets import PRESETS
    from medfusion_tpu_torch.cli.train_classifier import build_classifier
    from medfusion_tpu_torch.pipelines.diffusion import make_classifier_grad

    torch.manual_seed(0)
    cpu = build_classifier(PRESETS["chest"], 64, pool).eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.add_(0.02 * torch.randn(prm.shape))
    card = copy.deepcopy(cpu).cuda()
    x, t, label = torch.randn((2, 8, 32, 32)), torch.tensor([3, 900]), torch.tensor([1, 0])
    ref = make_classifier_grad(cpu, label)(x, t)
    before = ops.launch_counts()
    out = make_classifier_grad(card, label.cuda())(x.cuda(), t.cuda()).cpu()
    after = ops.launch_counts()
    attentions = 1 if pool == "adaptive" else 2
    for name in ("flash_attention_tokens", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + attentions, name
    torch.testing.assert_close(out, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dit_attention_on_strided_slices_matches_plain_version(cuda, dtype):
    """The chest DiT's attention (256 tokens, 16 heads of 64) on q, k and v
    sliced from one [B, N, 3C] projection (row stride 3C), B=2: the forward
    reads the slices in place, and the projection's gradient through the
    kernels matches the plain backward's."""
    qkv = torch.randn((2, 256, 3072), generator=cuda, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    scale = 64 ** -0.25
    ops_ = FA.flash_attention_forward_operands(q, k, v, 16)
    assert [t.data_ptr() for t in ops_[:3]] == [t.data_ptr() for t in (q, k, v)]
    heads = [FA._heads(t, 16) for t in (q, k, v)]
    ro, rlse = FA.naive_attention_reference(*heads, scale)
    leaf = qkv.detach().requires_grad_()
    o, lse = FA.flash_attention_tokens(*leaf.chunk(3, dim=-1), 16, scale)
    torch.testing.assert_close(FA._heads(o.detach(), 16), ro, atol=_attn_o_tol(ro)[0],
                               rtol=_attn_o_tol(ro)[1])
    torch.testing.assert_close(lse.transpose(1, 2), rlse, atol=ATTN_LSE_TOL[dtype],
                               rtol=ATTN_LSE_TOL[dtype])
    do = torch.randn((2, 256, 1024), generator=cuda, device="cuda").to(dtype)
    (g,) = torch.autograd.grad(o, leaf, do)
    refs = FA.flash_attention_backward_reference(*heads, FA._heads(o.detach(), 16),
                                                 lse.transpose(1, 2), FA._heads(do, 16), scale)
    for what, gi, r in zip("qkv", g.chunk(3, dim=-1), refs):
        atol, rtol = _bwd_tol(r)
        torch.testing.assert_close(FA._heads(gi, 16), r, atol=atol, rtol=rtol,
                                   msg=lambda msg, w=what: f"d{w}: {msg}")


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_smoke_dit_train_loss_matches_the_cpu(cuda, moe):
    """The smoke preset's DiT (and a DiT-MoE of 4 experts), f32: the
    training loss with its ``moe_aux`` and the gradients on the card
    against the CPU from the same perturbed weights and draws, within
    rtol 1e-4 and 1e-4 of max|g|; each block launches one token-layout
    forward, dQ and dK/dV."""
    import dataclasses

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline, build_unet

    p = PRESETS["smoke"]
    torch.manual_seed(0)
    cpu = build_train_pipeline(p, device="cpu", estimator="dit", seed=0)
    cpu = dataclasses.replace(cpu, noise_estimator=build_unet(
        p, "dit", **(dict(moe_experts=4) if moe else {})))
    with torch.no_grad():
        for prm in cpu.noise_estimator.parameters():
            prm.add_(0.05 * torch.randn(prm.shape))
    card = dataclasses.replace(  # the card's pipeline (its schedule on the card too)
        build_train_pipeline(p, device="cuda", estimator="dit", seed=0),
        noise_estimator=copy.deepcopy(cpu.noise_estimator).cuda(),
        latent_embedder=copy.deepcopy(cpu.latent_embedder).cuda())
    batch = {"source": torch.rand((4, 32, 32, 3)) * 2 - 1, "target": torch.arange(4) % 2}
    draws = dict(cpu.train_draws(4, p.latent_shape, generator=torch.Generator().manual_seed(1)),
                 drop=torch.tensor(False))
    results = []
    for pipe, dev in ((cpu, "cpu"), (card, "cuda")):
        before = ops.launch_counts()
        loss, metrics = pipe.train_loss({k: v.to(dev) for k, v in batch.items()},
                                        {k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        after = ops.launch_counts()
        results.append((torch.stack([loss.detach(), metrics["moe_aux"].detach()]).cpu(),
                        {k: q.grad.cpu() for k, q in pipe.noise_estimator.named_parameters()
                         if q.grad is not None}))
    depth = len(card.noise_estimator.blocks)
    for name in ("flash_attention_tokens", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + depth, name
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=0)
    top = max(g.abs().max().item() for g in g0.values())
    assert set(g1) == set(g0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-4 * top, rtol=0, msg=k)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("new_order", [True, False], ids=["new_order", "legacy_order"])
def test_openai_middle_attention_matches_plain_version(cuda, dtype, new_order):
    """The chest OpenAI UNet's middle-block attention (16 tokens, 8 heads of
    128), B=2, with q, k and v from one [B, N, 3C] projection in either
    channel order (``models/unet_openai.py::_split_qkv``): the forward and
    the projection's gradient through the kernels against the plain
    versions."""
    from medfusion_tpu_torch.models.unet_openai import _split_qkv

    n, c, heads = 16, 1024, 8
    scale = (c // heads) ** -0.25
    qkv = torch.randn((2, n, 3 * c), generator=cuda, device="cuda").to(dtype)
    leaf = qkv.detach().requires_grad_()
    o, lse = FA.flash_attention_tokens(*_split_qkv(leaf, heads, new_order), heads, scale)
    hs = [FA._heads(t, heads) for t in _split_qkv(qkv, heads, new_order)]
    ro, rlse = FA.naive_attention_reference(*hs, scale)
    torch.testing.assert_close(FA._heads(o.detach(), heads), ro, atol=_attn_o_tol(ro)[0],
                               rtol=_attn_o_tol(ro)[1])
    torch.testing.assert_close(lse.transpose(1, 2), rlse, atol=ATTN_LSE_TOL[dtype],
                               rtol=ATTN_LSE_TOL[dtype])
    do = torch.randn((2, n, c), generator=cuda, device="cuda").to(dtype)
    (g,) = torch.autograd.grad(o, leaf, do)
    refs = FA.flash_attention_backward_reference(*hs, FA._heads(o.detach(), heads),
                                                 lse.transpose(1, 2), FA._heads(do, heads),
                                                 scale)
    for what, gi, r in zip("qkv", _split_qkv(g, heads, new_order), refs):
        atol, rtol = _bwd_tol(r)
        torch.testing.assert_close(FA._heads(gi, heads), r, atol=atol, rtol=rtol,
                                   msg=lambda msg, w=what: f"d{w}: {msg}")


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["unet", "openai"])
def test_remat_step_on_the_card_equals_the_plain_step(cuda, estimator):
    """The smoke UNet and OpenAI UNet (attention at 2x downsampling) with
    ``remat``, bf16 on perturbed f32 masters: the loss equal and the
    gradients within 1e-6 of each tensor's max of the plain step's on the
    same weights and draws; the recompute launches each checkpointed
    block's kernels again (the UNet's GroupNorms, the OpenAI attention's
    forward)."""
    import dataclasses

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline, build_unet, seeded
    from medfusion_tpu_torch.nn.blocks import Norm
    from medfusion_tpu_torch.train.diffusion import estimator_params, with_compute_dtype

    p = PRESETS["smoke"]
    options = {"attention_resolutions": (2,)} if estimator == "openai" else {}
    gen = torch.Generator().manual_seed(3)
    batch = {"source": (torch.rand((4, 32, 32, 3), generator=gen) * 2 - 1).cuda(),
             "target": torch.arange(4, device="cuda") % 2}
    base = build_train_pipeline(p, device="cuda", estimator=estimator, seed=0)
    draws = base.train_draws(4, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(1))
    weights, out = None, {}
    for remat in (False, True):
        with seeded(torch.device("cuda"), 0):
            model = build_unet(p, estimator, remat=remat, **options)
        if weights is None:
            with torch.no_grad():
                for prm in model.parameters():
                    prm.add_(0.05 * torch.randn(prm.shape, generator=gen).cuda())
            weights = model.state_dict()
        model.load_state_dict(weights)
        pipe = with_compute_dtype(dataclasses.replace(base, noise_estimator=model),
                                  torch.bfloat16)
        before = ops.launch_counts()
        loss, _ = pipe.train_loss(batch, draws,
                                  estimator_params=estimator_params(model, torch.bfloat16))
        loss.backward()
        after = ops.launch_counts()
        out[remat] = (loss.detach(), {k: q.grad for k, q in model.named_parameters()},
                      {k: after[k] - before[k] for k in after})
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l1, l0)
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, rtol=0, atol=1e-6 * g.abs().max().item(),
                                   msg=lambda msg, k=k: f"{k}: {msg}")
    if estimator == "openai":
        assert n1["flash_attention_tokens"] == 2 * n0["flash_attention_tokens"] > 0
        assert n1["flash_attention_bwd_dq"] == n0["flash_attention_bwd_dq"] > 0
    else:
        norms = sum(isinstance(m, Norm) for m in model.modules())
        assert n1["group_norm_silu"] == n0["group_norm_silu"] + norms > norms


@pytest.mark.cuda
@pytest.mark.parametrize("spatial_dims", [2, 3])
def test_group_norm_silu_takes_the_channels_last_output_of_a_one_channel_conv(
        cuda, spatial_dims):
    """A one-channel input reads as channels-last, and cuDNN answers its
    conv in that layout; the wrapper copies it to contiguous NCHW (NCDHW)
    before the kernel, forward and backward."""
    from medfusion_tpu_torch.nn.blocks import BasicBlock

    side = (8, 16, 16) if spatial_dims == 3 else (32, 32)
    block = BasicBlock(spatial_dims, 1, 16, 3, 1, ("GROUP", {"num_groups": 4}),
                       ("SWISH", {})).cuda()
    x = torch.randn((2, 1, *side), generator=cuda, device="cuda").requires_grad_()
    out = block(x)
    h = block.conv(x).contiguous()
    ref = G.group_norm_silu_reference(h, block.norm.weight, block.norm.bias, 4)
    torch.testing.assert_close(out, ref, atol=TOL[torch.float32], rtol=TOL[torch.float32])
    out.sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


# the constructor options no CLI reaches: the chest legacy UNet without
# learnable interpolation concatenates decoder 1's resized input and its skip
# (512 + 256 channels at 16^2, B=32) and normalises the concatenation in its
# spatial transformer (32 groups: C/G 24), beside the 256-channel attention of
# its encoder; the 3-D classifier attends over 8 x 8 x 8 = 512 tokens, 128
# wide, 4 heads of 32, f32, at B=2
CONCAT_GN_CASES = [(768, 32, 16), (256, 32, 16)]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("c,g,side", CONCAT_GN_CASES)
def test_group_norm_silu_at_the_concatenated_skip_widths(cuda, dtype, c, g, side):
    before = G.LAUNCHES
    for silu in (True, False):
        x, scale, bias = _inputs(cuda, 32, c, side, dtype)
        out = G.group_norm_silu(x, scale, bias, g, apply_silu=silu)
        ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    assert G.LAUNCHES == before + 2


@pytest.mark.cuda
def test_classifier_3d_attention_shape_matches_plain_version(cuda):
    """Kernel 5 forward (o, lse) and kernels 3 and 4 at the 3-D classifier's
    token count, f32, one launch each."""
    n, c, heads = 512, 128, 4
    q, k, v = _attn_inputs(cuda, 2, n, n, c, torch.float32)
    scale = (c // heads) ** -0.25
    ro, rlse = FA.naive_attention_reference(*(FA._heads(t, heads) for t in (q, k, v)), scale)
    o, lse = FA.flash_attention_tokens(q, k, v, heads, scale)
    torch.testing.assert_close(FA._heads(o, heads), ro, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse.transpose(1, 2), rlse, atol=2e-5, rtol=2e-5)
    do = torch.randn((2, n, c), generator=cuda, device="cuda")
    before = ops.launch_counts()
    grads, refs = _attention_grads(q, k, v, do, heads, "tokens")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attention_tokens", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    for what, g, r in zip(("dq", "dk", "dv"), grads, refs):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-5,
                                   msg=lambda msg, w=what: f"{w}: {msg}")


@pytest.mark.cuda
def test_classifier_3d_and_concatenating_legacy_unet_match_the_cpu(cuda):
    """A narrow 3-D classifier's logits and input gradient, and a narrow
    legacy UNet with concatenated skips and spatial attention on them
    (forward), f32, card against CPU on the same perturbed weights, within
    1e-4 of max|ref|."""
    import torch.nn.functional as F

    from medfusion_tpu_torch.models.unet_legacy import UNetLegacy
    from medfusion_tpu_torch.models.unet_openai import EncoderUNetOpenAI

    torch.manual_seed(0)
    cpu = EncoderUNetOpenAI(image_size=8, in_channels=2, model_channels=16, out_channels=2,
                            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                            spatial_dims=3, num_head_channels=8, norm_groups=8)
    legacy = UNetLegacy(in_ch=2, out_ch=2, hid_chs=(16, 32), kernel_sizes=(3, 3),
                        strides=(1, 2), time_emb_dim=32, cond_emb_num_classes=2,
                        norm_name=("GROUP", {"num_groups": 8, "affine": True}),
                        use_attention=["spatial", "none"], learnable_interpolation=False)
    with torch.no_grad():
        for prm in (*cpu.parameters(), *legacy.parameters()):
            prm.add_(0.05 * torch.randn(prm.shape))
    x, t, label = torch.randn((2, 2, 4, 8, 8)), torch.tensor([3, 900]), torch.tensor([1, 0])
    out = {}
    for dev, clf in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        xd = x.detach().to(dev).requires_grad_()
        logits = clf(xd, t.to(dev))
        F.cross_entropy(logits, label.to(dev)).backward()
        out[dev] = (logits.detach().cpu(), xd.grad.cpu())
    for got, ref in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=1e-4)
    z = torch.randn((2, 2, 8, 8))
    with torch.no_grad():
        ref, _ = legacy(z, t, label)
        got, _ = copy.deepcopy(legacy).cuda()(z.cuda(), t.cuda(), label.cuda())
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4 * ref.abs().max().item(), rtol=1e-4)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a kernel's attributes are set on each card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(2)]


def _on(dev, gen, *shape, dtype=torch.float32, std=1.0, mean=0.0):
    """A seeded CPU draw moved to ``dev``: both cards get the same numbers."""
    return (torch.randn(shape, generator=gen) * std + mean).to(dev, dtype)


def _card_group_norm(dev, gen, dtype, c, g, side):
    """Kernel 1 on ``launch_plan``'s route for [2, C, side, side]; with a
    cluster route, a cluster of more than 8 blocks (the non-portable sizes
    a kernel opts into) and more than 48 KB of shared memory a block."""
    plan = G.launch_plan(2, c, side * side, g, dtype)
    x = _on(dev, gen, 2, c, side, side, dtype=dtype, std=2.0, mean=1.0)
    scale = _on(dev, gen, c, dtype=dtype, std=0.1, mean=1.0)
    bias = _on(dev, gen, c, dtype=dtype, std=0.1)
    out = G.group_norm_silu_cuda(x, scale, bias, g, plan=plan)
    ref = G.group_norm_silu_reference(x, scale, bias, g)
    return [(out, ref, (TOL[dtype], TOL[dtype]))], {"group_norm_silu": 1}, plan


def _card_attention(dev, gen, dtype, d, heads=4, n=130, m=96):
    """Kernels 2 and 5 (both layouts) and 3 and 4 (the head layout's
    gradient) at head width ``d``, against the plain forward and backward."""
    c = heads * d
    q, k, v, do = (_on(dev, gen, 2, r, c, dtype=dtype) for r in (n, m, m, n))
    scale = d ** -0.25
    qh, kh, vh, doh = (FA._heads(t, heads) for t in (q, k, v, do))
    ro, _ = FA.naive_attention_reference(qh, kh, vh, scale)
    ot, _ = FA.flash_attention_tokens(q, k, v, heads, scale)
    leaves = [t.contiguous().requires_grad_() for t in (qh, kh, vh)]
    oh, lse = FA.flash_attention(*leaves, scale)
    oh.backward(doh)
    rg = FA.flash_attention_backward_reference(qh, kh, vh, oh.detach(), lse, doh, scale)
    pairs = [(FA._heads(ot, heads), ro, _attn_o_tol(ro)), (oh, ro, _attn_o_tol(ro))]
    pairs += [(t.grad, r, _bwd_tol(r)) for t, r in zip(leaves, rg)]
    return pairs, {"flash_attention": 1, "flash_attention_tokens": 1,
                   "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1}, None


def _card_geglu(dev, gen, dtype, rows=1000, c=512):
    f = 4 * c
    args = [_on(dev, gen, rows, c, dtype=dtype, std=2.0, mean=0.5),
            _on(dev, gen, c, dtype=dtype, std=0.1, mean=1.0), _on(dev, gen, c, dtype=dtype, std=0.1),
            _on(dev, gen, 2 * f, c, dtype=dtype, std=c ** -0.5).t(),
            _on(dev, gen, 2 * f, dtype=dtype, std=0.1),
            _on(dev, gen, c, f, dtype=dtype, std=f ** -0.5).t(), _on(dev, gen, c, dtype=dtype, std=0.1)]
    out = GL.geglu_mlp_cuda(*args)
    ref = GL.geglu_mlp_reference(*args)
    return [(out, ref, (GEGLU_TOL[dtype], GEGLU_TOL[dtype]))], {"geglu_mlp": 1}, None


# (id, launcher, dtype, arguments): kernel 1's block route and its cluster
# route at 16 blocks (f32: 128 KB of shared memory a block); kernels 2-5 in
# bf16 at d 32 and 128 and on the wide route (d 256, 128-column chunks), and
# on the f32 split-TF32 routes at the same widths; kernel 6 in both dtypes
TWO_CARD_ROUTES = [
    ("group_norm-block-bf16", _card_group_norm, torch.bfloat16, (256, 32, 32)),
    ("group_norm-cluster16-f32", _card_group_norm, torch.float32, (64, 8, 256)),
    ("group_norm-cluster16-bf16", _card_group_norm, torch.bfloat16, (64, 8, 256)),
    ("attention-bf16-d32", _card_attention, torch.bfloat16, (32,)),
    ("attention-bf16-d128", _card_attention, torch.bfloat16, (128,)),
    ("attention-bf16-d256", _card_attention, torch.bfloat16, (256,)),
    ("attention-f32-d32", _card_attention, torch.float32, (32,)),
    ("attention-f32-d128", _card_attention, torch.float32, (128,)),
    ("attention-f32-d256", _card_attention, torch.float32, (256,)),
    ("geglu-bf16", _card_geglu, torch.bfloat16, ()),
    ("geglu-f32", _card_geglu, torch.float32, ()),
]


@pytest.mark.cuda
@pytest.mark.parametrize("route,launch,dtype,args", TWO_CARD_ROUTES,
                         ids=[r[0] for r in TWO_CARD_ROUTES])
def test_kernels_on_two_cards_in_one_process(two_cards, route, launch, dtype, args):
    """One process launches each kernel route on card 0 and then on card 1,
    each launch held to its plain version on its own card: a kernel's
    function attributes (its shared memory above 48 KB, a non-portable
    cluster size) belong to each card's context and are set on each. The
    same inputs give the same bits on both cards (printed, not held)."""
    outs = []
    for dev in two_cards:
        gen = torch.Generator().manual_seed(22)
        with torch.cuda.device(dev):
            before = ops.launch_counts()
            pairs, launches, plan = launch(dev, gen, dtype, *args)
            torch.cuda.synchronize(dev)
            after = ops.launch_counts()
        for name, n in launches.items():
            assert after[name] == before[name] + n, (route, dev, name)
        if plan is not None and plan["route"] == "cluster" and "cluster16" in route:
            assert plan["cluster"] == 16 and plan["smem_bytes"] > 48 * 1024, plan
        errs = []
        for out, ref, (atol, rtol) in pairs:
            assert out.device == dev
            torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                                       msg=lambda msg, d=dev: f"{route} on {d}: {msg}")
            errs.append((out.float() - ref.float()).abs().max().item())
        outs.append([out.detach().cpu() for out, _, _ in pairs])
        print(f"{route} on {dev}: max|d| {max(errs):.3e}")
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"{route}: card 1 {'bit-equal to' if same else 'differs from'} card 0")
