"""The port's attention against the JAX package, on the CPU in float32.

* ``naive_attention_reference`` (the flash kernel's plain version) against
  JAX ``naive_attention`` and against the Pallas forwards run in interpret
  mode: ``_fwd_call`` (head layout) through ``flash_attention`` and directly
  for its lse, ``_fwd_mha_call`` (token layout) through
  ``flash_attention_tokens`` and directly for its lse, with 32-wide blocks
  and N, M of 64-128, so that the online recurrence loops over several KV
  blocks. Tolerance 1e-5 (the same f32 products summed in another order).
* ``LinearTransformer``, ``GEGLU`` (its parameters through
  ``geglu_reference``), ``BasicTransformerBlock`` and
  ``SpatialTransformer`` against the flax modules on the same weights
  (rtol 3e-5 / atol 3e-6: float32 projections and GroupNorm statistics
  summed in another order). The UNet with attention is held to the JAX
  UNet in ``tests/test_torch_attention_unet.py``.

Flax params are perturbed away from their init (zero-init output
projections would make the comparison vacuous), as in
``tests/test_torch_models.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medfusion_tpu.nn import attention as jax_attn
from medfusion_tpu_torch import ops
from medfusion_tpu_torch.nn import attention as A
from medfusion_tpu_torch.ops import flash_attention as FA
from medfusion_tpu_torch.ops.geglu import geglu_reference
from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict
from tests.test_torch_models import _randomize, nchw, nhwc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the package re-binds the name ``flash_attention`` to its wrapper function
jax_fa = importlib.import_module("medfusion_tpu.ops.flash_attention")
KEY = jax.random.PRNGKey(0)
GROUPS4 = ("GROUP", {"num_groups": 4, "affine": True})


def _qkv(b, h, n, m, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, h, m, d)).astype(np.float32)
    v = rng.standard_normal((b, h, m, d)).astype(np.float32)
    return q, k, v


def _port_heads(q, k, v, scale):
    o, lse = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("n,m,d", [(64, 128, 16), (128, 96, 32), (96, 64, 64)])
def test_plain_version_matches_jax_head_layout(n, m, d):
    q, k, v = _qkv(2, 2, n, m, d, seed=n + m + d)
    scale = d ** -0.25
    o, lse = _port_heads(q, k, v, scale)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(o, np.asarray(jax_fa.naive_attention(jq, jk, jv, scale)),
                               atol=1e-5, rtol=1e-5)
    pallas = jax_fa.flash_attention(jq, jk, jv, scale, block_q=32, block_k=32,
                                    interpret=True)
    np.testing.assert_allclose(o, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    flat = [a.reshape(4, -1, d) for a in (jq, jk, jv)]
    po, plse = jax_fa._fwd_call(*flat, scale, 32, 32, True)
    np.testing.assert_allclose(o.reshape(4, n, d), np.asarray(po), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.reshape(4, n), np.asarray(plse)[..., 0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,m,d", [(64, 128, 16), (128, 64, 32), (96, 96, 32)])
def test_plain_version_matches_jax_token_layout(n, m, d):
    h = 128 // d  # hd = 128, the Pallas token kernel's lane width
    q, k, v = _qkv(2, h, n, m, d, seed=3 * n + m + d)
    tok = [np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(2, a.shape[2], h * d))
           for a in (q, k, v)]
    scale = d ** -0.25
    o, lse = FA.flash_attention_tokens(*(torch.from_numpy(a) for a in tok), h, scale)
    o, lse = o.numpy(), lse.numpy()
    assert o.shape == (2, n, 128) and lse.shape == (2, n, h)
    jt = [jnp.asarray(a) for a in tok]
    pallas = jax_fa.flash_attention_tokens(*jt, h, scale, block_q=32, block_k=32,
                                           interpret=True)
    np.testing.assert_allclose(o, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    po, plse = jax_fa._fwd_mha_call(*jt, h, scale, 32, 32, True)
    np.testing.assert_allclose(o, np.asarray(po), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse, np.asarray(plse), atol=1e-5, rtol=1e-5)
    naive = jax_fa.naive_attention(*(jnp.asarray(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(o, np.asarray(naive).transpose(0, 2, 1, 3).reshape(2, n, -1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [8, 48, 256, 512])
def test_plain_version_matches_jax_at_the_kernels_head_widths(d):
    """Head widths the CUDA kernels reach only by zero-filled columns (8,
    48) or by 128-column chunks (256, 512): the plain forward against JAX
    ``naive_attention`` and the interpret-mode ``_fwd_call`` (f32, 2e-5:
    sums over up to 512 products in another order), and in bfloat16 against
    ``_fwd_call`` on the same bf16 inputs, which rounds at the same points
    (o within one bf16 ulp of max|o|, lse within 1e-4)."""
    n, m = 64, 96
    q, k, v = _qkv(1, 2, n, m, d, seed=d)
    scale = d ** -0.25
    o, lse = _port_heads(q, k, v, scale)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(o, np.asarray(jax_fa.naive_attention(jq, jk, jv, scale)),
                               atol=2e-5, rtol=2e-5)
    flat = [a.reshape(2, -1, d) for a in (jq, jk, jv)]
    po, plse = jax_fa._fwd_call(*flat, scale, 32, 32, True)
    np.testing.assert_allclose(o.reshape(2, n, d), np.asarray(po), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.reshape(2, n), np.asarray(plse)[..., 0], atol=2e-5,
                               rtol=2e-5)
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    ob, lseb = FA.flash_attention(*tb, scale)
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16).reshape(2, -1, d) for t in tb]
    pob, plseb = jax_fa._fwd_call(*jb, scale, 32, 32, True)
    pob = np.asarray(pob.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(pob).max())) - 7)
    np.testing.assert_allclose(ob.float().numpy().reshape(2, n, d), pob, atol=ulp, rtol=0)
    np.testing.assert_allclose(lseb.numpy().reshape(2, n), np.asarray(plseb)[..., 0],
                               atol=1e-4, rtol=1e-4)


def test_plain_version_takes_ragged_and_odd_shapes():
    """Any N, M >= 1 and any head dim on the CPU (the kernel's ragged tiles
    are masked; its head dims are checked at launch)."""
    q, k, v = _qkv(1, 3, 77, 1, 8, seed=5)
    o, _ = _port_heads(q, k, v, 0.5)
    np.testing.assert_allclose(o, np.broadcast_to(v, o.shape), atol=1e-6)  # one key
    q, k, v = _qkv(2, 1, 77, 45, 16, seed=6)
    o, _ = _port_heads(q, k, v, 0.5)
    ref = jax_fa.naive_attention(*(jnp.asarray(a) for a in (q, k, v)), 0.5)
    np.testing.assert_allclose(o, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_dispatch_splits_layouts_at_the_head_layout_threshold(monkeypatch):
    """KV >= HEAD_LAYOUT_MIN_TOKENS takes the head-layout entry, shorter KV
    the token-layout entry; both give the same attention."""
    seen = []
    for name in ("flash_attention", "flash_attention_tokens"):
        real = getattr(FA, name)
        monkeypatch.setattr(FA, name, lambda *a, _n=name, _r=real: (seen.append(_n), _r(*a))[1])
    monkeypatch.setattr(ops, "HEAD_LAYOUT_MIN_TOKENS", 64)
    rng = np.random.default_rng(0)
    for m in (32, 64):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, m, 32)).astype(np.float32))
                   for _ in range(3))
        out = ops.attention(q, k, v, 2, 0.5)
        ref, _ = FA.naive_attention_reference(*(FA._heads(t, 2) for t in (q, k, v)), 0.5)
        torch.testing.assert_close(out, ref.transpose(1, 2).flatten(2), rtol=1e-6, atol=1e-6)
    assert seen == ["flash_attention_tokens", "flash_attention"]


def test_cpu_wrappers_take_the_plain_version(monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("a CUDA launcher was called for a CPU tensor")

    monkeypatch.setattr(FA, "flash_attention_cuda", no_launch)
    monkeypatch.setattr(FA, "flash_attention_tokens_cuda", no_launch)
    before = ops.launch_counts()
    q = torch.randn(2, 16, 64)
    FA.flash_attention_tokens(q, q, q, 4, 0.5)
    qh = FA._heads(q, 4)
    FA.flash_attention(qh, qh, qh, 0.5)
    assert ops.launch_counts() == before


def test_launchers_refuse_cpu_tensors_and_unsupported_head_dims():
    q = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention_cuda(q, q, q, 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention_tokens_cuda(torch.randn(1, 8, 64), torch.randn(1, 8, 64),
                                       torch.randn(1, 8, 64), 2, 0.5)
    x = torch.randn(1, 2, 8, 2048)  # wider than 1,024
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_cuda(x, x, x, 0.5)
    for d in (4, 12):  # not a multiple of 8: padded (pad_head_dim), then the device check
        x = torch.randn(1, 2, 8, d)
        with pytest.raises(ValueError, match="CUDA tensor"):
            FA.flash_attention_cuda(x, x, x, 0.5)
        with pytest.raises(ValueError, match="CUDA tensor"):
            FA.flash_attention_tokens_cuda(*(torch.randn(1, 8, 2 * d) for _ in "qkv"), 2, 0.5)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        FA.flash_attention_cuda(q.double(), q.double(), q.double(), 0.5)
    with pytest.raises(ValueError, match="divisible"):
        FA.flash_attention_tokens_cuda(torch.randn(1, 8, 60), torch.randn(1, 8, 60),
                                       torch.randn(1, 8, 60), 8, 0.5)


@pytest.mark.parametrize("d", [1, 4, 12, 20, 8, 16])
def test_pad_head_dim_copies_with_zero_columns(d):
    """A head dim that is not a multiple of 8 becomes a fresh contiguous
    [B, H, N|M, d'] copy (d' the next multiple of 8) whose added columns are
    zero; any other tensor is passed through as it is."""
    q = FA._heads(torch.randn(2, 5, 3 * d), 3)  # a strided [B, H, N, d] view
    k = torch.randn(2, 3, 7, d)
    pq, pk = FA.pad_head_dim(q, k)
    if d % 8 == 0:
        assert pq is q and pk is k
        return
    dp = -(-d // 8) * 8
    for t, p, n in ((q, pq, 5), (k, pk, 7)):
        assert p.shape == (2, 3, n, dp) and p.dtype == t.dtype
        assert p.stride() == (3 * n * dp, n * dp, dp, 1)
        assert p.data_ptr() != t.data_ptr()
        assert torch.equal(p[..., :d], t)
        assert not p[..., d:].any()
    wide = torch.randn(1, 1, 2, 1030)  # past MAX_HEAD_DIM: left for _check to refuse
    assert FA.pad_head_dim(wide)[0] is wide


@pytest.mark.parametrize("d", [1, 4, 12, 20])
def test_padded_head_dim_gives_the_same_function(d):
    """What the CUDA entries do at d % 8 != 0, run through the plain
    versions on the CPU (float32): attention and its backward on the
    zero-padded copies, sliced back to d columns, equal attention at d (o,
    lse, dq, dk, dv within 1e-6: the zero columns add exact zeros, the sums
    may be blocked differently); the padded columns of o and of the
    gradients are zero."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, d)).astype(np.float32))
               for n in (24, 40, 40))
    do = torch.from_numpy(rng.standard_normal((2, 3, 24, d)).astype(np.float32))
    scale = d ** -0.25
    o, lse = FA.naive_attention_reference(q, k, v, scale)
    grads = FA.flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    qp, kp, vp, dop = FA.pad_head_dim(q, k, v, do)
    op, lsep = FA.naive_attention_reference(qp, kp, vp, scale)
    (pop,) = FA.pad_head_dim(op[..., :d])
    gradsp = FA.flash_attention_backward_reference(qp, kp, vp, pop, lsep, dop, scale)
    torch.testing.assert_close(lsep, lse, atol=1e-6, rtol=1e-6)
    for out, ref in zip((op, *gradsp), (o, *grads)):
        torch.testing.assert_close(out[..., :d], ref, atol=1e-6, rtol=1e-6)
        assert not out[..., d:].any()


# ---- modules against flax -------------------------------------------------


def _flax_pair(flax_module, x_nhwc, *args, seed=1):
    shapes = jax.eval_shape(flax_module.init, KEY, jnp.asarray(x_nhwc), *args)["params"]
    params = _randomize(shapes, seed)
    y = flax_module.apply({"params": params}, jnp.asarray(x_nhwc), *args)
    return params, np.asarray(y)


def _load(module, tree, strip):
    """Carry a flax param ``tree`` through the port's key map and load the
    keys under ``strip`` into ``module``."""
    sd = jax_params_to_state_dict(tree)
    module.load_state_dict({k[len(strip):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _inputs(shape, emb_dim, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    emb = rng.standard_normal((shape[0], emb_dim)).astype(np.float32)
    return x, emb


@pytest.mark.parametrize("emb", [False, True], ids=["self", "cross_one_token"])
def test_linear_transformer_matches_flax(emb):
    x, e = _inputs((2, 6, 5, 16), 24)
    jm = jax_attn.LinearTransformer(2, 16, 2, 8, GROUPS4, None, 24 if emb else None)
    args = (jnp.asarray(e),) if emb else ()
    params, y = _flax_pair(jm, x, *args)
    tm = _load(A.LinearTransformer(2, 16, 2, 8, GROUPS4, None, 24 if emb else None),
               {"attention": params}, "attention.")
    with torch.no_grad():
        ty = tm(nchw(x), torch.from_numpy(e) if emb else None)
    assert np.abs(y - x).max() > 1e-2  # the attention term is not zero
    np.testing.assert_allclose(nhwc(ty), y, rtol=3e-5, atol=3e-6)


def test_linear_transformer_cross_attends_to_several_tokens():
    x, _ = _inputs((2, 4, 4, 16), 8)
    toks = np.random.default_rng(3).standard_normal((2, 5, 24)).astype(np.float32)
    jm = jax_attn.LinearTransformer(2, 16, 2, 8, GROUPS4, None, 24)
    params, y = _flax_pair(jm, x, jnp.asarray(toks))
    tm = _load(A.LinearTransformer(2, 16, 2, 8, GROUPS4, None, 24),
               {"attention": params}, "attention.")
    with torch.no_grad():
        ty = tm(nchw(x), torch.from_numpy(toks))
    np.testing.assert_allclose(nhwc(ty), y, rtol=3e-5, atol=3e-6)


def test_geglu_matches_flax():
    x = np.random.default_rng(4).standard_normal((3, 7, 16)).astype(np.float32)
    jm = jax_attn.GEGLU(64)
    params, y = _flax_pair(jm, x)
    tm = _load(A.GEGLU(16, 64), {"attention": {"block_0": {"geglu": params}}},
               "attention.transformer_blocks.0.proj_out.0.")
    with torch.no_grad():
        ty = geglu_reference(torch.from_numpy(x), tm.norm.weight, tm.norm.bias,
                             tm.proj.weight.t(), tm.proj.bias)
    np.testing.assert_allclose(ty.numpy(), y, rtol=1e-5, atol=1e-6)


def test_basic_transformer_block_matches_flax():
    x, e = _inputs((2, 6, 6, 16), 24)
    jm = jax_attn.BasicTransformerBlock(2, 16, 2, 8, GROUPS4, None, 24)
    params, y = _flax_pair(jm, x, jnp.asarray(e))
    tm = _load(A.BasicTransformerBlock(2, 16, 2, 8, GROUPS4, None, 24),
               {"attention": {"block_0": params}}, "attention.transformer_blocks.0.")
    with torch.no_grad():
        ty = tm(nchw(x), torch.from_numpy(e))
    np.testing.assert_allclose(nhwc(ty), y, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer_matches_flax(depth):
    x, e = _inputs((2, 6, 6, 16), 24)
    jm = jax_attn.SpatialTransformer(2, 16, 2, 8, GROUPS4, None, 24, depth)
    params, y = _flax_pair(jm, x, jnp.asarray(e))
    tm = _load(A.SpatialTransformer(2, 16, 2, 8, GROUPS4, None, 24, depth),
               {"attention": params}, "attention.")
    with torch.no_grad():
        ty = tm(nchw(x), torch.from_numpy(e))
    assert np.abs(y - x).max() > 1e-2
    np.testing.assert_allclose(nhwc(ty), y, rtol=3e-5, atol=3e-6)


def test_attention_dispatcher_rejects_unknown_type_and_dropout():
    """An unknown type is refused; dropout (ported since) builds, and in
    eval mode the block is the one without it on the same weights."""
    with pytest.raises(ValueError, match="unknown attention type"):
        A.Attention(2, 16, 2, 8, GROUPS4, attention_type="flash")
    torch.manual_seed(0)
    dropped = A.Attention(2, 16, 2, 8, GROUPS4, dropout=0.1, emb_dim=24,
                          attention_type="spatial").eval()
    plain = A.Attention(2, 16, 2, 8, GROUPS4, emb_dim=24, attention_type="spatial")
    plain.load_state_dict(dropped.state_dict(), strict=True)
    xe, e = torch.randn(2, 16, 3, 3), torch.randn(2, 24)
    with torch.no_grad():
        torch.testing.assert_close(dropped(xe, e), plain(xe, e))
    x = torch.randn(1, 16, 2, 2)
    assert A.Attention(2, 16, attention_type="none")(x) is x


# ---- the forward kernel's operands ----------------------------------------


def _expanded(shape, dim, dtype):
    """A tensor of ``shape`` whose ``dim`` has stride 0."""
    one = list(shape)
    one[dim] = 1
    return torch.randn(one).to(dtype).expand(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("expanded", [None, "q", "k", "v"])
@pytest.mark.parametrize("layout", ["head", "tokens"])
def test_forward_operands(layout, expanded, dtype):
    """Which operands the forward copies (in bfloat16, one with a zero
    stride, since the kernel reads q, k and v through TMA; in float32
    none) and which strides o and lse get: the head layout's o takes a
    dense q's strides and lse is packed [B, H, N]; the token layout's o and
    lse are [B, H, N, D] and [B, H, N] views of packed [B, N, H*D] and
    [B, N, H] tensors."""
    b, n, m, h, d = 2, 24, 40, 4, 16
    if layout == "head":
        shapes = {"q": (b, h, n, d), "k": (b, h, m, d), "v": (b, h, m, d)}
        # q as the [B, H, N, D] view of a token-layout tensor, as the
        # attention dispatch passes it
        made = {"q": FA._heads(torch.randn(b, n, h * d).to(dtype), h),
                "k": torch.randn(shapes["k"]).to(dtype),
                "v": torch.randn(shapes["v"]).to(dtype)}
        if expanded:
            made[expanded] = _expanded(shapes[expanded], 2, dtype)
    else:
        shapes = {"q": (b, n, h * d), "k": (b, m, h * d), "v": (b, m, h * d)}
        made = {name: torch.randn(shape).to(dtype) for name, shape in shapes.items()}
        if expanded:
            made[expanded] = _expanded(shapes[expanded], 1, dtype)
    heads = None if layout == "head" else h
    q, k, v, o, lse = FA.flash_attention_forward_operands(
        made["q"], made["k"], made["v"], heads)
    views = dict(zip("qkv", (q, k, v)))
    for name, t in made.items():
        given = t if layout == "head" else FA._heads(t, h)
        copied = views[name].data_ptr() != t.data_ptr()
        assert copied == (dtype == torch.bfloat16 and name == expanded), name
        assert torch.equal(views[name], given)
        assert FA._no_zero_stride(views[name]) or dtype == torch.float32
    assert o.shape == (b, h, n, d) and o.dtype == dtype
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    if layout == "head":
        q_dense = expanded != "q" or dtype == torch.bfloat16
        assert o.stride() == (q.stride() if q_dense else (h * n * d, n * d, d, 1))
        assert lse.stride() == (h * n, n, 1)
    else:
        assert o.stride() == (n * h * d, d, h * d, 1)
        assert lse.stride() == (n * h, 1, h)
