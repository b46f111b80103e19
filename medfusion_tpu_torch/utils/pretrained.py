"""Pretrained-weight store of the evaluation networks (port of
``medfusion_tpu/utils/pretrained.py``).

The FID / precision-recall featuriser (torch-fidelity's InceptionV3) and the
perceptual loss (lpips' VGG16) need pretrained torch weights, which this
repository does not hold and nothing downloads. A user who has the files
converts them once:

    python -m medfusion_tpu_torch.cli.ingest_weights inception --src pt_inception-2015-12-05-6726825d.pth
    python -m medfusion_tpu_torch.cli.ingest_weights vgg16 --src vgg16-397923af.pth

and ``cli.evaluate_images``, ``cli.evaluate_latent_embedder`` and
``cli.train_autoencoder --lpips`` pick them up. Each network is one file of
tensors (``<name>.pt``, read back with ``torch.load(weights_only=True)``)
with its content hash beside it (``<name>.sha256``), re-verified on every
load. The directory is ``MEDFUSION_WEIGHTS_DIR`` (default
``~/.cache/medfusion_tpu/weights``), which the JAX package may share: its
orbax directories are ``inception_v3_fid/`` and ``vgg16_lpips/``, and the
port's names end in ``_torch``.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

INCEPTION = "inception_v3_fid_torch"
VGG16 = "vgg16_lpips_torch"


def weights_dir() -> Path:
    env = os.environ.get("MEDFUSION_WEIGHTS_DIR")
    return Path(env) if env else Path.home() / ".cache" / "medfusion_tpu" / "weights"


def artifact_path(name: str) -> Path:
    return weights_dir() / f"{name}.pt"


def _array(v) -> np.ndarray:
    return np.ascontiguousarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                else np.asarray(v))


def params_sha256(state: Mapping) -> str:
    """Content hash over the sorted keys, each with its shape, dtype and
    little-endian bytes (the JAX package's ``params_sha256``)."""
    h = hashlib.sha256()
    for key in sorted(state):
        arr = _array(state[key])
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(np.dtype(arr.dtype).str.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_pretrained(name: str, state: Mapping) -> Path:
    """Write ``state`` (name -> tensor) as ``<name>.pt`` with its hash in
    ``<name>.sha256``; returns the file."""
    path = artifact_path(name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    # each tensor keeps its own shape (the hash, as JAX's, reads a 0-d
    # count as 1-d)
    torch.save({k: v.detach().cpu().contiguous() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v)) for k, v in state.items()}, tmp)
    os.replace(tmp, path)
    path.with_suffix(".sha256").write_text(params_sha256(state) + "\n")
    return path


def load_pretrained(name: str) -> Optional[Dict[str, torch.Tensor]]:
    """The ingested state dict of ``name`` on the CPU, or None when there is
    none. A hash that is missing or does not match raises: a corrupted or
    hand-edited file must not degrade the metrics quietly."""
    path = artifact_path(name)
    if not path.exists():
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    recorded = path.with_suffix(".sha256")
    rerun = "re-run python -m medfusion_tpu_torch.cli.ingest_weights"
    if not recorded.exists():
        raise ValueError(f"pretrained artifact {path} has no recorded content hash — {rerun}")
    want, got = recorded.read_text().strip(), params_sha256(state)
    if want != got:
        raise ValueError(f"pretrained artifact {path} content hash mismatch (recorded "
                         f"{want[:12]}…, read {got[:12]}…) — {rerun}")
    return state


def validate_against_template(converted: Mapping, template: Mapping, what: str) -> None:
    """Every key of ``template`` (a module's state dict) must be in
    ``converted`` with the same shape, and nothing else may be; raises
    ValueError listing every missing, unexpected or mis-shaped key (never
    merges quietly)."""
    conv = {k: tuple(np.shape(v)) for k, v in converted.items()}
    temp = {k: tuple(v.shape) for k, v in template.items()}
    problems = [f"missing from source: {k} {temp[k]}" for k in sorted(set(temp) - set(conv))]
    problems += [f"unexpected in source: {k} {conv[k]}" for k in sorted(set(conv) - set(temp))]
    problems += [f"shape mismatch: {k} source {conv[k]} != model {temp[k]}"
                 for k in sorted(set(conv) & set(temp)) if conv[k] != temp[k]]
    if problems:
        head = "\n  ".join(problems[:20])
        more = f"\n  … and {len(problems) - 20} more" if len(problems) > 20 else ""
        raise ValueError(f"{what}: the weights do not match the model "
                         f"({len(problems)} problems):\n  {head}{more}")
