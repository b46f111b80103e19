"""Carry JAX (flax) parameters into the port's modules.

The port's own copy of the export direction of
``medfusion_tpu/utils/torch_compat.py`` (``flax_path_to_torch_key``,
``_to_torch_leaf``, ``to_torch_state_dict``), with the rules of the modules
ported so far (UNet with its attention blocks, VAE and VQVAE with theirs, the
two discriminators, and the legacy UNet by the VAE's rules; the DiT by its
own rule, :func:`jax_dit_to_state_dict`):
a nested dict of numpy arrays, keyed as the flax param
tree, becomes a state dict with the reference's torch key names, with conv
kernels moved from [*k, in, out] to [out, in, *k] (HWIO to OIHW, or
[kd, kh, kw, in, out] to [out, in, kd, kh, kw] in 3-D) and dense kernels to
[out, in]. A BatchNorm's
flax ``batch_stats`` (mean, var) become ``running_mean``/``running_var``,
with a ``num_batches_tracked`` of 0: flax keeps no count, and torch reads it
only with ``momentum=None``, which the port never sets. The flax tree is
flattened by plain recursion. The OpenAI family (the noisy-latent
classifier and ``UNetOpenAI``, :func:`jax_classifier_to_state_dict`), the
lucidrains UNet, the diffusers autoencoders, blocks and conditional UNet go
the other way: each key of
the port module's state dict is mapped to its flax path by the rule of the
JAX package's ``convert_*_state_dict`` (torch -> flax), and every flax leaf
must be read.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def flax_path_to_torch_key(path: str, kind: str = "unet") -> str:
    """flax 'a/b/c' param path -> reference torch state-dict key."""
    k = path
    k = re.sub(r"^time_embedder/linear_0/linear/", "time_embedder.time_emb.1.", k)
    k = re.sub(r"^time_embedder/linear_1/linear/", "time_embedder.time_emb.3.", k)
    k = re.sub(r"^time_embedder/pos_embedder/weights$", "time_embedder.time_emb.0.weights", k)
    k = re.sub(r"^cond_embedder/embedding/embedding$", "cond_embedder.embedding.weight", k)
    k = re.sub(r"^in_blocks_(\d+)_1/down_conv/conv/", r"in_blocks.\1.down_op.", k)
    k = re.sub(r"^in_blocks_(\d+)_1/", r"in_blocks.\1.0.", k)
    k = re.sub(r"^in_blocks_(\d+)_2/", r"in_blocks.\1.1.", k)
    k = re.sub(r"^middle_conv_1/", "middle_block.0.", k)
    k = re.sub(r"^middle_attn/", "middle_block.1.", k)
    k = re.sub(r"^middle_conv_2/", "middle_block.2.", k)
    k = re.sub(r"^out_blocks_(\d+)_0/", r"out_blocks.\1.0.", k)
    k = re.sub(r"^out_blocks_(\d+)_1/", r"out_blocks.\1.1.", k)
    k = re.sub(r"^out_blocks_(\d+)_2/up_conv/conv/", r"out_blocks.\1.2.up_op.", k)
    if kind == "unet":
        k = re.sub(r"^outc/conv/conv/", "outc.conv.conv.", k)
        k = re.sub(r"^outc_ver_(\d+)/conv/conv/", r"outc_ver.\1.conv.conv.", k)
    else:  # VAE: outc is a BasicBlock
        k = re.sub(r"^outc/conv/conv/", "outc.conv.", k)
        k = re.sub(r"^outc_ver_(\d+)/conv/conv/", r"outc_ver.\1.conv.", k)
    k = re.sub(r"^encoders_(\d+)/", r"encoders.\1.", k)
    k = re.sub(r"^decoders_(\d+)/", r"decoders.\1.", k)
    k = re.sub(r"^out_enc_0/", "out_enc.0.", k)
    k = re.sub(r"^out_enc_1/", "out_enc.1.", k)
    k = re.sub(r"^quantizer/codebook$", "quantizer.embedder.weight", k)
    k = re.sub(r"^encoder_(\d+)/", r"encoder.\1.", k)  # a discriminator's stack
    # attention-scoped rules before the generic block_i rule: block_i inside
    # a SpatialTransformer ('attention/block_i/') is a transformer block, in
    # a UNet conv block it is block_seq.i
    k = re.sub(r"attention/block_(\d+)/geglu/norm/",
               r"attention.transformer_blocks.\1.proj_out.0.norm.", k)
    k = re.sub(r"attention/block_(\d+)/geglu/proj/linear/",
               r"attention.transformer_blocks.\1.proj_out.0.proj.", k)
    k = re.sub(r"attention/block_(\d+)/proj_out/linear/",
               r"attention.transformer_blocks.\1.proj_out.2.", k)
    k = re.sub(r"attention/block_(\d+)/", r"attention.transformer_blocks.\1.", k)
    k = re.sub(r"attention/proj_in/linear/", "attention.proj_in.", k)
    k = re.sub(r"attention/proj_out/linear/", "attention.proj_out.", k)
    # block internals
    k = re.sub(r"block_(\d+)/", r"block_seq.\1.", k)
    k = re.sub(r"local_embedder/linear/", "local_embedder.1.", k)
    k = re.sub(r"down_op/down_conv/conv/", "down_op.down_op.", k)
    k = re.sub(r"up_op/up_conv/conv/", "up_op.up_op.", k)
    k = re.sub(r"(^|/)down_conv/conv/", r"\1down_op.", k)
    k = re.sub(r"(^|/)up_conv/conv/", r"\1up_op.", k)
    k = re.sub(r"norm_x/norm/", "norm_x.", k)
    k = re.sub(r"to_(q|k|v)/linear/", r"to_\1.", k)
    k = re.sub(r"to_out/linear/", "to_out.0.", k)
    k = re.sub(r"self_atn/", "self_atn.", k)
    k = re.sub(r"cros_atn/", "cros_atn.", k)
    k = re.sub(r"conv_res/conv/", "conv_res.", k)
    k = re.sub(r"norm/norm/", "norm.", k)
    k = re.sub(r"conv/conv/", "conv.", k)
    k = k.replace("/", ".")
    k = re.sub(r"\.kernel$", ".weight", k)
    k = re.sub(r"\.scale$", ".weight", k)
    return k


def _to_torch_leaf(path: str, arr: np.ndarray) -> np.ndarray:
    """flax leaf -> torch layout: conv [*k, I, O] -> [O, I, *k]; dense
    [I, O] -> [O, I] (every dense layer ported so far is an nn.Linear)."""
    if path.endswith("linear/kernel"):
        return np.ascontiguousarray(arr.T)
    if path.endswith("conv/kernel"):
        n = arr.ndim - 2
        return np.ascontiguousarray(np.transpose(arr, (n + 1, n, *range(n))))
    return np.asarray(arr)


def _flatten(tree: Mapping, prefix: str = ""):
    for name, val in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def jax_dit_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``DiT``'s flax params -> the port's ``models/dit.py`` state
    dict. The port keeps the flax module names, so a path maps by
    ``blocks_i`` -> ``blocks.i`` and '/' -> '.'; every 2-D ``kernel`` (the
    Dense layers, the router among them) is transposed to [out, in] and
    named ``weight``, as is the label table's ``embedding``; the experts'
    3-D ``w1``/``w2`` and their ``b1``/``b2`` carry over as they are."""
    out = {}
    for path, val in _flatten(params):
        arr = np.array(val, dtype=np.float32)
        stem, leaf = path.rsplit("/", 1)
        key = re.sub(r"(^|/)blocks_(\d+)(/|$)", r"\1blocks.\2\3", stem).replace("/", ".")
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"DiT kernel {path} has {arr.ndim} dims, expected 2")
            arr, leaf = np.ascontiguousarray(arr.T), "weight"
        elif leaf == "embedding":
            leaf = "weight"
        out[f"{key}.{leaf}"] = torch.from_numpy(arr)
    return out


def jax_params_to_state_dict(params: Mapping, kind: str = "unet") -> Dict[str, torch.Tensor]:
    """Nested flax param dict (numpy leaves) -> the port's state dict;
    ``kind`` 'unet' or 'vae' ('unet_legacy' is the VAE's) by the
    reference's key rules, 'dit' by :func:`jax_dit_to_state_dict`."""
    if kind == "dit":
        return jax_dit_to_state_dict(params)
    if kind == "unet_legacy":
        kind = "vae"  # a BasicBlock outc, the VAE's encoders/decoders
    out = {}
    for path, val in _flatten(params):
        tkey = flax_path_to_torch_key(path, kind=kind)
        leaf = _to_torch_leaf(path, np.asarray(val))
        out[tkey] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def jax_variables_to_state_dict(variables: Mapping, kind: str = "vae") -> Dict[str, torch.Tensor]:
    """A flax variable dict ({"params": .., ["batch_stats": ..]}) -> the
    port's state dict, the BatchNorms' buffers included: each
    ``.../norm/norm/{mean,var}`` becomes ``running_{mean,var}``, with a
    ``num_batches_tracked`` of 0."""
    sd = jax_params_to_state_dict(variables["params"], kind)
    for path, val in _flatten(variables.get("batch_stats", {})):
        stem, leaf = flax_path_to_torch_key(path, kind=kind).rsplit(".", 1)
        sd[f"{stem}.running_{leaf}"] = torch.from_numpy(np.array(val, dtype=np.float32))
        sd[f"{stem}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def jax_gan_to_state_dicts(gen_params: Mapping, disc_params: Mapping,
                           disc_stats: Optional[Mapping] = None) -> Tuple[Dict, Dict]:
    """A JAX ``GANTrainState``'s trees -> (the generator's state dict, the
    discriminators' as one ``nn.ModuleList``'s): ``disc_params`` and
    ``disc_stats`` are keyed ``disc_{i}``, as ``init_discriminators`` makes
    them."""
    disc_sd = {}
    for name, params in disc_params.items():
        i = int(name.rsplit("_", 1)[1])
        level = {"params": params, "batch_stats": (disc_stats or {}).get(name, {})}
        disc_sd.update({f"{i}.{k}": v for k, v in
                        jax_variables_to_state_dict(level, kind="vae").items()})
    return jax_params_to_state_dict(gen_params, kind="vae"), disc_sd


def load_jax_params(module: torch.nn.Module, params: Mapping,
                    kind: str = "unet") -> torch.nn.Module:
    """Load flax params into ``module`` with ``strict=True``, keeping the
    module's device and dtype. ``kind``: 'unet', 'vae', 'unet_legacy' or
    'dit' (:func:`jax_params_to_state_dict`), 'openai' (the UNet or the
    classifier), 'lucidrains', 'diffusers' (the KL or VQ autoencoder),
    'diffusers_blocks' (a block of ``models/diffusers_blocks.py`` or a FIR
    resampler) or 'diffusers_unet' (``UNet2DConditionDiffusers``)."""
    by_model = {"openai": jax_classifier_to_state_dict,
                "lucidrains": jax_lucidrains_to_state_dict,
                "diffusers": jax_diffusers_vae_to_state_dict,
                "diffusers_blocks": jax_diffusers_blocks_to_state_dict,
                "diffusers_unet": jax_diffusers_unet_to_state_dict}
    if kind in by_model:
        sd = by_model[kind](params, module)
    else:
        sd = jax_params_to_state_dict(params, kind)
    module.load_state_dict(sd, strict=True)
    return module


def unflatten_npz(flat: Mapping[str, np.ndarray]) -> Dict:
    """{'a/b/c': array} (an .npz of flax paths joined by '/') -> nested dict."""
    tree: Dict = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


# The evaluation networks (port of ``metrics/inception.py::convert_torch_inception``
# and ``losses/lpips.py::convert_torch_vgg16``, in the other direction): the
# port's modules carry the torch checkpoints' own key names (torchvision's
# InceptionV3 and VGG16 ``features``), so a torch checkpoint loads with no
# converter and the JAX package's flax params are what gets converted.
_INCEPTION_BN = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
                 "bn_var": "running_var"}


def jax_inception_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``InceptionV3``'s flax params (``Mixed_5b/branch1x1/conv/kernel``,
    ``.../bn_scale|bn_bias|bn_mean|bn_var``) -> the port's state dict
    (``Mixed_5b.branch1x1.conv.weight``, ``.bn.{weight,bias,running_mean,
    running_var,num_batches_tracked}``)."""
    out = {}
    for path, val in _flatten(params):
        stem, leaf = path.rsplit("/", 1)
        arr = np.asarray(val, np.float32)
        if leaf == "kernel":  # '<module>/conv/kernel', HWIO
            out[stem.replace("/", ".") + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1))))
        else:
            bn = stem.replace("/", ".") + ".bn"
            out[f"{bn}.{_INCEPTION_BN[leaf]}"] = torch.from_numpy(arr.copy())
            out[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def jax_vgg16_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX LPIPS backbone's flax params (``conv_{idx}/kernel|bias``, under
    ``vgg`` or bare) -> torchvision's ``features.{idx}.weight|bias``."""
    params = params.get("vgg", params)
    out = {}
    for path, val in _flatten(params):
        name, leaf = path.split("/")
        idx = int(name.split("_")[1])
        arr = np.asarray(val, np.float32)
        if leaf == "kernel":
            arr = np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1)))
        kind = "weight" if leaf == "kernel" else "bias"
        out[f"features.{idx}.{kind}"] = torch.from_numpy(arr.copy())
    return out


def _by_model_keys(params: Mapping, model: torch.nn.Module, key_to_path,
                   what: str) -> Dict[str, torch.Tensor]:
    """Each of ``model``'s state-dict keys -> its flax path by
    ``key_to_path(key, ndim)``; conv kernels [*k, I, O] -> [O, I, *k] (2-D
    or 3-D), dense kernels
    [I, O] -> [O, I], a lucidrains ``g`` [C] -> [1, C, 1, 1]. Raises on a
    key without a flax leaf and on a flax leaf that no key reads."""
    flat = {path: np.array(val, np.float32) for path, val in _flatten(params)}
    out = {}
    for key, ref in model.state_dict().items():
        path = key_to_path(key, ref.ndim)
        if path not in flat:
            raise ValueError(f"no flax leaf {path} for the {what}'s {key}")
        arr = flat.pop(path)
        if path.endswith("/kernel"):
            n = arr.ndim - 2
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (n + 1, n, *range(n)))
        elif path.endswith("/g"):
            arr = arr.reshape(ref.shape)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if flat:
        raise ValueError(f"flax leaves the {what} does not hold: {sorted(flat)[:5]}")
    return out


def jax_classifier_to_state_dict(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The flax params of the JAX OpenAI family (``EncoderUNetOpenAI`` or
    ``UNetOpenAI``) -> the state dict of the port's ``model``
    (``models/unet_openai.py``), each key by ``openai_key_to_path``."""
    from medfusion_tpu_torch.models.unet_openai import openai_key_to_path

    return _by_model_keys(params, model, openai_key_to_path, "OpenAI model")


def lucidrains_key_to_path(key: str, ndim: Optional[int] = None) -> str:
    """A torch key of the lucidrains UNet -> its flax path (the rule of the
    JAX package's ``convert_lucidrains_state_dict``)."""
    k = re.sub(r"\.(\d+)", r"_\1", key).replace(".", "/")
    k = k.replace("time_mlp_0/weights", "time_mlp_0_weights")
    k = re.sub(r"(ups_\d+_3)_1/", r"\1/conv_1/", k)  # an upsample's conv
    if k.endswith("/weight"):
        k = k[: -len("weight")] + ("scale" if k.endswith("norm/weight") else "kernel")
    return k


def jax_lucidrains_to_state_dict(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``UNetLucidrains``'s flax params -> the port's state dict."""
    return _by_model_keys(params, model, lucidrains_key_to_path, "lucidrains UNet")


_DIFFUSERS_NORM = re.compile(r"(norm1|norm2|group_norm|conv_norm_out)/weight$")


def diffusers_key_to_path(key: str, ndim: Optional[int] = None) -> str:
    """A torch key of the diffusers autoencoders -> its flax path (the rule
    of the JAX package's ``convert_diffusers_vae_state_dict``; the port's
    codebook ``quantize.embedder.weight`` is ``quantize/codebook``)."""
    k = re.sub(r"\.(\d+)", r"_\1", key).replace(".", "/")
    if k in ("quantize/embedding/weight", "quantize/embedder/weight"):
        return "quantize/codebook"
    if _DIFFUSERS_NORM.search(k):
        return k[: -len("weight")] + "scale"
    if k.endswith("/weight"):
        return k[: -len("weight")] + "kernel"
    return k


def jax_diffusers_vae_to_state_dict(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``AutoencoderKLDiffusers``'s or ``VQModelDiffusers``'s flax
    params -> the port's state dict."""
    return _by_model_keys(params, model, diffusers_key_to_path, "diffusers autoencoder")


_BLOCK_NORM = re.compile(r"(norm\d*|group_norm|skip_norm|conv_norm_out)/weight$")


def diffusers_block_key_to_path(key: str, ndim: Optional[int] = None) -> str:
    """A torch key of a diffusers block -> its flax path (the rule of the JAX
    package's ``convert_diffusers_block_state_dict``: a norm's weight is its
    ``scale``, any other weight a ``kernel``)."""
    k = re.sub(r"\.(\d+)", r"_\1", key).replace(".", "/")
    if _BLOCK_NORM.search(k):
        return k[: -len("weight")] + "scale"
    if k.endswith("/weight"):
        return k[: -len("weight")] + "kernel"
    return k


def diffusers_unet_key_to_path(key: str, ndim: Optional[int] = None) -> str:
    """A torch key of the conditional diffusers UNet -> its flax path (the
    rule of ``convert_diffusers_unet_state_dict``: the label table's weight
    is ``emb/embedding``, a 1-D weight a ``scale``, any other a ``kernel``)."""
    k = re.sub(r"\.(\d+)", r"_\1", key).replace(".", "/")
    k = k.replace("time_embedding/linear_", "time_embedding_linear_")
    if k == "emb/weight":
        return "emb/embedding"
    if k.endswith("/weight"):
        return k[: -len("weight")] + ("scale" if ndim == 1 else "kernel")
    return k


def jax_diffusers_blocks_to_state_dict(params: Mapping,
                                       model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The flax params of a JAX diffusers block (``diffusers_blocks.py``) ->
    the port's state dict."""
    return _by_model_keys(params, model, diffusers_block_key_to_path, "diffusers block")


def jax_diffusers_unet_to_state_dict(params: Mapping,
                                     model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``UNet2DConditionDiffusers``'s flax params -> the port's state
    dict."""
    return _by_model_keys(params, model, diffusers_unet_key_to_path, "diffusers UNet")
