"""The precision argument of the f32 attention kernels, on the CPU.

The kernels (``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
f32 route) run every product on the tf32 tensor cores in split-TF32
(``flash_attention_common.cuh``): an f32 x is split into big = tf32(x),
rounded to nearest (``cvt.rna``), and small = x - big, of which the tensor
core reads the top 19 bits; a product is small * big' + big * small' +
big * big', summed in f32. Here that arithmetic is emulated in torch on the
CPU at the classifier's three attention shapes:

* the backward's own math (``_backward`` below, as
  ``flash_attention_backward_reference`` computes it, every product through
  the emulated one), held to the plain f32 backward;
* the forward kernel's algorithm (``_forward`` below): tiles of 8 keys dealt
  to W warps in turn, each warp's own online softmax, the warps' (m, l,
  acc) merged in warp order, held to ``naive_attention_reference`` at W =
  1, 4 and 8, at M = 3 keys (W = 8 leaves warps with no tile) and at d =
  1,024 with 1,024 keys;

the three-term split keeps dQ, dK and dV, and o and lse, within atol = rtol
= 2e-5 of the plain versions, the tolerance the kernels meet on the card;
single-pass TF32 (both operands rounded to tf32, one product) does not.

The emulation sums in f32 on the CPU, rounding to nearest, where the tensor
cores truncate; the kernels sum each 16 columns of the scores on a fresh
accumulator to keep that bias small (the card tests hold the kernels
themselves to the plain backward).
"""

import numpy as np
import pytest
import torch

from medfusion_tpu_torch.ops import flash_attention as FA

TOL = 2e-5
# (tokens N, heads, head dim): the classifier's one head of 128 (adaptive
# pool) and 4 heads of 32 at 16^2 tokens, and its attention pool's 257
CLASSIFIER_SHAPES = [(256, 1, 128), (256, 4, 32), (257, 4, 32)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32_rna(x):
    """x rounded to tf32 (10 mantissa bits), to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does (finite x)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x):
    """What the tensor core reads of an f32 register given as tf32: its top
    19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b):
    """a @ b in split-TF32, the small terms first."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_read(a - ab), _tf32_read(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _tf32_mm(a, b):
    """a @ b in single-pass TF32."""
    return _tf32_rna(a) @ _tf32_rna(b)


def _backward(q, k, v, o, lse, do, scale, mm):
    """The f32 backward with every product through ``mm``."""
    sc2 = scale * scale
    p = torch.exp(sc2 * mm(q, k.transpose(-1, -2)) - lse[..., None])
    delta = (do * o).sum(dim=-1)
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None])
    return (sc2 * mm(ds, k), sc2 * mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _forward(q, k, v, scale, warps, mm):
    """The f32 forward kernel's algorithm with every product through ``mm``:
    q * s and k * s in f32; key tiles of 8, warp w taking tiles w, w + W,
    ...; each warp's running max m_w and sum l_w, its acc_w rescaled by
    e^(m_old - m_new) as each tile's p v is added; then m = max m_w, l =
    sum l_w e^(m_w - m), o = (sum acc_w e^(m_w - m)) / l in warp order over
    the warps that got a tile; lse = m + log(l). Returns (o, lse)."""
    s = torch.tensor(scale, dtype=q.dtype)
    qs, ks = q * s, k * s
    tiles = -(-k.shape[-2] // 8)
    parts = []
    for w in range(min(warps, tiles)):
        m = torch.full(q.shape[:-1] + (1,), -torch.inf)
        l, acc = torch.zeros_like(m), torch.zeros_like(q)
        for t in range(w, tiles, warps):
            sc = mm(qs, ks[..., 8 * t:8 * t + 8, :].transpose(-1, -2))
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + mm(p, v[..., 8 * t:8 * t + 8, :])
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l, acc = torch.zeros_like(m), torch.zeros_like(q)
    for m_w, l_w, acc_w in parts:
        e = torch.exp(m_w - m)
        l, acc = l + l_w * e, acc + acc_w * e
    return acc / l, (m + torch.log(l)).squeeze(-1)


def _inputs(n, m, h, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, r, d)).astype(np.float32))
            for r in (n, m, m)]


def _case(n, h, d):
    rng = np.random.default_rng(17 * n + h)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, h, n, d)).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.25
    o, lse = FA.naive_attention_reference(q, k, v, scale)
    return (q, k, v, o, lse, do, scale), FA.flash_attention_backward_reference(
        q, k, v, o, lse, do, scale)


def _excess(grads, refs):
    """The largest |g - ref| - (TOL + TOL |ref|) over dq, dk and dv."""
    return max((g - r).abs().sub(TOL + TOL * r.abs()).max().item()
               for g, r in zip(grads, refs))


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0])
    torch.testing.assert_close(_tf32_rna(x), torch.tensor(
        [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]),
        rtol=0, atol=0)
    y = torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -20])
    assert _tf32_read(y).item() == 1.0
    assert _tf32_read(y - _tf32_rna(y)).item() == -(2.0 ** -11) + 2.0 ** -20


@pytest.mark.parametrize("n,h,d", CLASSIFIER_SHAPES)
def test_split_tf32_backward_holds_the_f32_tolerance(n, h, d):
    args, refs = _case(n, h, d)
    grads = _backward(*args, _split_mm)
    for what, g, r in zip(("dq", "dk", "dv"), grads, refs):
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL, msg=lambda m, w=what: f"{w}: {m}")
    assert _excess(grads, refs) < -TOL / 2  # with room to spare


@pytest.mark.parametrize("n,h,d", CLASSIFIER_SHAPES)
def test_single_pass_tf32_backward_misses_the_f32_tolerance(n, h, d):
    args, refs = _case(n, h, d)
    assert _excess(_backward(*args, _tf32_mm), refs) > 0


# (N, M, heads, head dim): the classifier's shapes; 3 keys, one tile (W = 8
# leaves seven warps without one); the widest head over 1,024 keys
FORWARD_SHAPES = [(n, n, h, d) for n, h, d in CLASSIFIER_SHAPES] + [
    (45, 3, 2, 32), (32, 1024, 1, 1024)]


@pytest.mark.parametrize("warps", [1, 4, 8])
@pytest.mark.parametrize("n,m,h,d", FORWARD_SHAPES)
def test_split_tf32_forward_holds_the_f32_tolerance(n, m, h, d, warps):
    q, k, v = _inputs(n, m, h, d, 31 * n + m + d)
    scale = d ** -0.25
    ro, rlse = FA.naive_attention_reference(q, k, v, scale)
    o, lse = _forward(q, k, v, scale, warps, _split_mm)
    torch.testing.assert_close(o, ro, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, rlse, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,h,d", CLASSIFIER_SHAPES)
def test_single_pass_tf32_forward_misses_the_f32_tolerance(n, h, d):
    q, k, v = _inputs(n, n, h, d, 31 * n + n + d)
    scale = d ** -0.25
    refs = FA.naive_attention_reference(q, k, v, scale)
    assert _excess(_forward(q, k, v, scale, 4, _tf32_mm), refs) > 0
