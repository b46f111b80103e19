"""The port's flash-attention backward against the JAX package, on the CPU.

* ``flash_attention_backward_reference`` (the plain version of the two
  backward kernels) against JAX ``_flash_bwd`` (head layout) and
  ``_flash_mha_bwd`` (token layout) run in interpret mode on the same q, k,
  v, o, lse and dO, with 32-wide blocks so that each kernel loops over
  several blocks, for N = M and N != M, and at the classifier's f32
  shapes; and against ``jax.grad`` of ``naive_attention``.
* Autograd through the port's ``flash_attention`` and
  ``flash_attention_tokens`` on the CPU (the plain forward, then the plain
  backward) against ``jax.grad`` of the JAX entries in interpret mode,
  which reach ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (a spy counts
  them).

Tolerances. float32: atol = rtol = 2e-5 (the same f32 products summed in
another order; ``naive_attention`` also rounds q*s and k*s where the
backward multiplies q k^T by s^2 once). bfloat16: both sides round ds and p
to bf16 at the same points, and dq, dk, dv once at the end; the f32 sums
before those roundings differ in order, so an element of ds or of the
output may land one bf16 ulp apart, and atol is one bf16 ulp of the
largest |gradient| (2^(floor(log2 max) - 7)), rtol 0. Where the forward
runs too (the autograd tests), o itself may differ by an ulp between the
Pallas forward and the plain one, which moves D = rowsum(dO * o).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu_torch import ops
from medfusion_tpu_torch.ops import flash_attention as FA


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the package re-binds the name ``flash_attention`` to its wrapper function
jax_fa = importlib.import_module("medfusion_tpu.ops.flash_attention")

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tol(ref, name):
    """(atol, rtol) of a gradient against ``ref`` (numpy f32)."""
    if name == "f32":
        return 2e-5, 2e-5
    return 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7), 0.0


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(x, name):
    """The same values as a torch tensor and a JAX array of dtype ``name``
    (both round the f32 array to nearest even)."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, name, what):
    atol, rtol = _tol(_np(ref), name)
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=rtol, err_msg=what)


@pytest.fixture
def bwd_spy(monkeypatch):
    """Counts the JAX backward kernels' traces (their bodies are looked up
    when ``_flash_bwd`` builds its ``pallas_call``s) and calls of
    ``_flash_bwd`` itself, by name."""
    calls = []
    for name in ("_bwd_dq_kernel", "_bwd_dkv_kernel", "_flash_bwd"):
        real = getattr(jax_fa, name)

        def spy(*args, _n=name, _r=real, **kwargs):
            calls.append(_n)
            return _r(*args, **kwargs)

        monkeypatch.setattr(jax_fa, name, spy)
    return calls


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("n,m,d", [(64, 64, 16), (64, 96, 32), (96, 64, 64)])
def test_plain_backward_matches_jax_head_layout(name, n, m, d, bwd_spy):
    bh, scale = 4, d ** -0.25
    q, k, v, do = _arrays([(bh, n, d), (bh, m, d), (bh, m, d), (bh, n, d)], n + m + d)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_pair(a, name) for a in (q, k, v, do))
    jo, jlse = jax_fa._fwd_call(jq, jk, jv, scale, 32, 32, True)
    jdq, jdk, jdv = jax_fa._flash_bwd(scale, 32, 32, True, (jq, jk, jv, jo, jlse), jdo)
    assert {"_bwd_dq_kernel", "_bwd_dkv_kernel"} <= set(bwd_spy)
    to, tlse = _pair(_np(jo), name)[0], torch.from_numpy(_np(jlse)[..., 0])
    grads = FA.flash_attention_backward_reference(
        *(t[None] for t in (tq, tk, tv, to, tlse, tdo)), scale)
    for what, g, r in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        assert g.dtype == tq.dtype
        _close(g[0], r, name, what)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("n,m", [(64, 64), (64, 96)])
def test_plain_backward_matches_jax_token_layout(name, n, m, bwd_spy):
    b, h, d = 2, 4, 32  # h * d = 128, the Pallas token kernel's lane width
    scale = d ** -0.25
    q, k, v, do = _arrays([(b, n, h * d), (b, m, h * d), (b, m, h * d), (b, n, h * d)],
                          7 * n + m)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_pair(a, name) for a in (q, k, v, do))
    jo, jlse = jax_fa._fwd_mha_call(jq, jk, jv, h, scale, 32, 32, True)
    jdq, jdk, jdv = jax_fa._flash_mha_bwd(h, scale, 32, 32, True, (jq, jk, jv, jo, jlse),
                                          jdo)
    assert "_flash_bwd" in bwd_spy
    to = _pair(_np(jo), name)[0]
    tlse = torch.from_numpy(_np(jlse))  # [B, N, H]
    heads = [FA._heads(t, h) for t in (tq, tk, tv, to, tdo)]
    grads = FA.flash_attention_backward_reference(*heads[:4], tlse.transpose(1, 2),
                                                  heads[4], scale)
    for what, g, r in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        _close(g.transpose(1, 2).flatten(2), r, name, what)


# The classifier's attention (EncoderUNetOpenAI, model channels 64, f32): 16^2
# = 256 tokens of width 128 as one head of 128 (adaptive pool) or 4 heads of
# 32, and its attention pool over 257 tokens (the mean token prepended), 4
# heads of 32; with the Pallas blocks (the grid takes N in whole blocks:
# 257 is one block).
CLASSIFIER_SHAPES = [(256, 1, 64), (256, 4, 64), (257, 4, 257)]


@pytest.mark.parametrize("n,h,block", CLASSIFIER_SHAPES)
def test_plain_backward_matches_jax_at_the_classifier_shapes(n, h, block, bwd_spy):
    """f32, B=1, token layout: the plain backward (what the f32 kernels are
    held to on the card) against interpret-mode ``_flash_mha_bwd`` on its
    own forward's o and lse, atol = rtol = 2e-5 (the same f32 products
    summed in another order)."""
    b, c = 1, 128
    scale = (c // h) ** -0.25
    q, k, v, do = _arrays([(b, n, c)] * 4, 13 * n + h)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_pair(a, "f32") for a in (q, k, v, do))
    jo, jlse = jax_fa._fwd_mha_call(jq, jk, jv, h, scale, block, block, True)
    jdq, jdk, jdv = jax_fa._flash_mha_bwd(h, scale, block, block, True,
                                          (jq, jk, jv, jo, jlse), jdo)
    assert {"_bwd_dq_kernel", "_bwd_dkv_kernel"} <= set(bwd_spy)
    to, tlse = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jlse))
    heads = [FA._heads(t, h) for t in (tq, tk, tv, to, tdo)]
    grads = FA.flash_attention_backward_reference(*heads[:4], tlse.transpose(1, 2),
                                                  heads[4], scale)
    for what, g, r in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        _close(g.transpose(1, 2).flatten(2), r, "f32", what)


@pytest.mark.parametrize("n,m", [(48, 48), (40, 72)])
def test_plain_backward_matches_grad_of_naive_attention(n, m):
    b, h, d = 2, 3, 16
    scale = d ** -0.25
    q, k, v, do = _arrays([(b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d)], n * m)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))

    def loss(q_, k_, v_):
        return jnp.sum(jax_fa.naive_attention(q_, k_, v_, scale) * jdo)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = FA.naive_attention_reference(tq, tk, tv, scale)
    grads = FA.flash_attention_backward_reference(tq, tk, tv, o, lse, tdo, scale)
    for what, g, r in zip(("dq", "dk", "dv"), grads, ref):
        _close(g, r, "f32", what)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 48, 256, 512])
def test_plain_backward_matches_jax_at_the_kernels_head_widths(name, d, bwd_spy):
    """Head widths the CUDA kernels reach only by zero-filled columns (8,
    48) or by 128-column chunks (256, 512): the plain backward against the
    interpret-mode ``_flash_bwd`` on its own forward's o and lse, and (f32)
    against ``jax.grad`` of ``naive_attention``."""
    bh, n, m = 2, 64, 96
    scale = d ** -0.25
    q, k, v, do = _arrays([(bh, n, d), (bh, m, d), (bh, m, d), (bh, n, d)], 5 * d)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_pair(a, name) for a in (q, k, v, do))
    jo, jlse = jax_fa._fwd_call(jq, jk, jv, scale, 32, 32, True)
    jdq, jdk, jdv = jax_fa._flash_bwd(scale, 32, 32, True, (jq, jk, jv, jo, jlse), jdo)
    assert {"_bwd_dq_kernel", "_bwd_dkv_kernel"} <= set(bwd_spy)
    to, tlse = _pair(_np(jo), name)[0], torch.from_numpy(_np(jlse)[..., 0])
    grads = FA.flash_attention_backward_reference(
        *(t[None] for t in (tq, tk, tv, to, tlse, tdo)), scale)
    for what, g, r in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        _close(g[0], r, name, what)
    if name == "f32":
        def loss(q_, k_, v_):
            return jnp.sum(jax_fa.naive_attention(q_, k_, v_, scale) * jdo)

        ref = jax.grad(loss, argnums=(0, 1, 2))(jq[None], jk[None], jv[None])
        o, lse = FA.naive_attention_reference(*(t[None] for t in (tq, tk, tv)), scale)
        grads = FA.flash_attention_backward_reference(
            *(t[None] for t in (tq, tk, tv)), o, lse, tdo[None], scale)
        for what, g, r in zip(("dq", "dk", "dv"), grads, ref):
            _close(g, r, name, what)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_autograd_head_entry_matches_jax_grad(name, bwd_spy):
    b, h, n, m, d = 2, 2, 64, 96, 32
    scale = d ** -0.25
    q, k, v, do = _arrays([(b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d)], 11)
    pairs = [_pair(a, name) for a in (q, k, v, do)]
    jq, jk, jv, jdo = (p[1] for p in pairs)

    def loss(q_, k_, v_):
        o = jax_fa.flash_attention(q_, k_, v_, scale, block_q=32, block_k=32,
                                   interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    assert {"_bwd_dq_kernel", "_bwd_dkv_kernel"} <= set(bwd_spy)
    leaves = [p[0].clone().requires_grad_() for p in pairs[:3]]
    before = ops.launch_counts()
    o, lse = FA.flash_attention(*leaves, scale)
    assert not lse.requires_grad
    o.backward(pairs[3][0])
    assert ops.launch_counts() == before  # CPU tensors: the plain versions
    for what, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, r, name, what)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_autograd_token_entry_matches_jax_grad(name, bwd_spy):
    b, h, n, m, d = 2, 8, 64, 32, 16
    scale = d ** -0.25
    q, k, v, do = _arrays([(b, n, h * d), (b, m, h * d), (b, m, h * d), (b, n, h * d)], 12)
    pairs = [_pair(a, name) for a in (q, k, v, do)]
    jq, jk, jv, jdo = (p[1] for p in pairs)

    def loss(q_, k_, v_):
        o = jax_fa.flash_attention_tokens(q_, k_, v_, h, scale, block_q=32, block_k=32,
                                          interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    assert "_flash_bwd" in bwd_spy  # through _flash_mha_bwd
    leaves = [p[0].clone().requires_grad_() for p in pairs[:3]]
    o, _ = FA.flash_attention_tokens(*leaves, h, scale)
    o.backward(pairs[3][0])
    for what, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        assert leaf.grad.shape == leaf.shape
        _close(leaf.grad, r, name, what)


def test_attention_dispatch_is_differentiable_in_both_layouts(monkeypatch):
    """ops.attention's gradient is the same through either entry."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32))
                   for _ in range(4))
    grads = []
    for threshold in (64, 65):  # head layout, then token layout
        monkeypatch.setattr(ops, "HEAD_LAYOUT_MIN_TOKENS", threshold)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.attention(*leaves, 2, 0.5).backward(do)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_backward_launchers_refuse_cpu_tensors_and_bad_operands():
    q = torch.randn(1, 2, 8, 32)
    o, lse = FA.naive_attention_reference(q, q, q, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention_backward_cuda(q, q, q, o, lse, q, 0.5)
    with pytest.raises(ValueError, match="lse must be"):
        FA.flash_attention_backward_operands(q, q, q, o, lse[..., None], q)
    with pytest.raises(ValueError, match="do "):
        FA.flash_attention_backward_operands(q, q, q, o, lse, q[..., :16])
    with pytest.raises(ValueError, match="do "):
        FA.flash_attention_backward_operands(q, q, q, o, lse, q.bfloat16())
    x = torch.randn(1, 2, 8, 12)  # not a multiple of 8
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_backward_operands(x, x, x, x, lse, x)
    # a misaligned do is copied, not refused
    do = torch.randn(1, 2, 8, 40)[..., 1:33]
    ops_ = FA.flash_attention_backward_operands(q, q, q, o, lse, do)
    assert ops_[4].is_contiguous() and torch.equal(ops_[4], do)
