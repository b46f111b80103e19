"""Carry JAX (flax) parameters into the port's modules.

The port's own copy of the export direction of
``medfusion_tpu/utils/torch_compat.py`` (``flax_path_to_torch_key``,
``_to_torch_leaf``, ``to_torch_state_dict``), with the rules of the modules
ported so far (UNet with its attention blocks, VAE and VQVAE with theirs, the
two discriminators): a nested dict of numpy arrays, keyed as the flax param
tree, becomes a state dict with the reference's torch key names, with conv
kernels moved from HWIO to OIHW and dense kernels to [out, in]. A BatchNorm's
flax ``batch_stats`` (mean, var) become ``running_mean``/``running_var``,
with a ``num_batches_tracked`` of 0: flax keeps no count, and torch reads it
only with ``momentum=None``, which the port never sets. The flax tree is
flattened by plain recursion.
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


def jax_params_to_state_dict(params: Mapping, kind: str = "unet") -> Dict[str, torch.Tensor]:
    """Nested flax param dict (numpy leaves) -> the port's state dict."""
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
    module's device and dtype."""
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
