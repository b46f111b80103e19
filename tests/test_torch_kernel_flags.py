"""The port's kernel switches (``medfusion_tpu_torch/cli/kernels.py``)
against the JAX package's ``medfusion_tpu/cli/kernels.py``, on the CPU.

* ``resolve_kernel_flags`` gives the JAX tuple or the JAX ``ValueError`` for
  every argument set of a grid (attention, estimator, heads and the four
  switches), on ``--device cpu``; the JAX side's global switches are
  restored afterwards.
* On a CUDA device an explicit ``--no-flash`` or ``--no-fused-geglu`` is
  refused; the auto defaults and ``--flash`` are not.
* Every sampling and training CLI and ``demo.server`` registers the flags:
  a bogus ``--attention`` exits 2 (as ``tests/test_kernel_cli_wiring.py``
  checks for the JAX CLIs).
"""

import argparse
import itertools

import pytest
import torch

import medfusion_tpu.ops as jax_ops
from medfusion_tpu.cli import kernels as jax_kernels
from medfusion_tpu_torch.cli import kernels

ESTIMATORS = ("unet", "unet_legacy", "openai", "lucidrains", "dit")
SWITCHES = list(itertools.product((8, 2), (None, True, False), (None, True, False),
                                  (None, False), (None, True)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = (jax_ops.flash_attention_enabled(), jax_ops.fused_geglu_enabled(),
             jax_ops.fused_up_conv_enabled(), jax_ops.s2d_decode_tail_enabled())
    yield
    for setter, on in zip((jax_ops.enable_flash_attention, jax_ops.enable_fused_geglu,
                           jax_ops.enable_fused_up_conv, jax_ops.enable_s2d_decode_tail),
                          saved):
        setter(on)
    torch.set_num_threads(n)


def _args(device="cpu", **kw):
    base = dict(attention="none", estimator="unet", attention_heads=8, flash=None,
                fused_geglu=None, fused_up=None, s2d_tail=None, device=device)
    return argparse.Namespace(**{**base, **kw})


def _outcome(fn, args):
    try:
        return ("ok", fn(args))
    except ValueError as e:
        return ("refused", str(e))


@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("attention", ("none", "linear", "spatial"))
def test_resolve_kernel_flags_matches_jax(attention, estimator):
    for heads, flash, geglu, up, s2d in SWITCHES:
        kw = dict(attention=attention, estimator=estimator, attention_heads=heads,
                  flash=flash, fused_geglu=geglu, fused_up=up, s2d_tail=s2d)
        want = _outcome(jax_kernels.resolve_kernel_flags, _args(**kw))
        got = _outcome(kernels.resolve_kernel_flags, _args(**kw))
        assert got == want, kw


def test_parsers_match_jax():
    """The same flags, choices and defaults."""
    def actions(mod):
        ap = argparse.ArgumentParser()
        mod.add_kernel_args(ap)
        return {a.dest: (a.option_strings, a.choices, a.default, a.type)
                for a in ap._actions if a.dest != "help"}

    assert actions(kernels) == actions(jax_kernels)
    ap = argparse.ArgumentParser()
    kernels.add_kernel_args(ap, attention=False)
    assert {a.dest for a in ap._actions} == {"help", "flash", "fused_geglu", "fused_up",
                                              "s2d_tail"}


@pytest.mark.parametrize("flag,kw", [
    ("--no-flash", dict(attention="spatial", flash=False)),
    ("--no-fused-geglu", dict(attention="spatial", fused_geglu=False)),
    ("--no-flash", dict(estimator="dit", flash=False)),
])
def test_card_refuses_the_plain_routes(flag, kw):
    """The plain versions are the kernels' oracles, not a path on the card;
    on the CPU the same flags run them."""
    for device in ("cuda", "cuda:0", None):
        with pytest.raises(ValueError, match=flag):
            kernels.resolve_kernel_flags(_args(device=device, **kw))
    assert kernels.resolve_kernel_flags(_args(**kw)) == jax_kernels.resolve_kernel_flags(
        _args(**kw))
    # the auto defaults, --flash and the two exact-rewrite switches pass on the card
    assert kernels.resolve_kernel_flags(_args("cuda", attention="spatial", flash=True,
                                              fused_up=False, s2d_tail=False)) == (
        True, True, False, False)


@pytest.mark.parametrize("cli,argv", [
    ("sample", []), ("sample_dataset", []), ("train_diffusion", []), ("distill", []),
    ("helpers", ["img2img"]), ("helpers", ["export-images"]), ("server", []),
])
def test_clis_register_the_kernel_flags(cli, argv):
    import importlib

    mod = importlib.import_module("medfusion_tpu_torch.demo.server" if cli == "server"
                                  else f"medfusion_tpu_torch.cli.{cli}")
    main = mod.parse_args if cli == "server" else mod.main
    for bad in (["--attention", "bogus"], ["--fused-up", "--no-flash"]):
        with pytest.raises(SystemExit) as e:
            main([*argv, *bad, "--device", "cuda"])
        assert e.value.code == 2
