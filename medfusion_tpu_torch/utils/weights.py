"""Carry JAX (flax) parameters into the port's modules.

The port's own copy of the export direction of
``medfusion_tpu/utils/torch_compat.py`` (``flax_path_to_torch_key``,
``_to_torch_leaf``, ``to_torch_state_dict``), with the rules of the modules
ported so far (UNet and VAE without attention): a nested dict of numpy
arrays, keyed as the flax param tree, becomes a state dict with the
reference's torch key names, with conv kernels moved from HWIO to OIHW and
dense kernels to [out, in]. The flax tree is flattened by plain recursion.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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
    k = re.sub(r"^middle_conv_1/", "middle_block.0.", k)
    k = re.sub(r"^middle_conv_2/", "middle_block.2.", k)
    k = re.sub(r"^out_blocks_(\d+)_0/", r"out_blocks.\1.0.", k)
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
    # block internals
    k = re.sub(r"block_(\d+)/", r"block_seq.\1.", k)
    k = re.sub(r"local_embedder/linear/", "local_embedder.1.", k)
    k = re.sub(r"down_op/down_conv/conv/", "down_op.down_op.", k)
    k = re.sub(r"up_op/up_conv/conv/", "up_op.up_op.", k)
    k = re.sub(r"(^|/)down_conv/conv/", r"\1down_op.", k)
    k = re.sub(r"(^|/)up_conv/conv/", r"\1up_op.", k)
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
