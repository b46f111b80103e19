"""Checkpoints of the training CLIs: torch files, a best pointer, and the
autoencoder loader of the diffusion stage (port of
``medfusion_tpu/utils/checkpoint.py``, which saves with Orbax).

Layout of a checkpoint directory::

    step_<n>.pt             one a saved step: {"step", "state", "extra"}
    config.json             the run's configuration
    best_checkpoint.json    {"step", "metric", "minimize"}
  <dir>_best/step_<n>.pt    the best step's own copy (a sibling store)

``state`` is :meth:`TrainState.state_dict` (model, optimizer, schedule, EMA
and step), or :meth:`GANTrainState.state_dict` (the step and a
:class:`TrainState`'s for each player, ``gen`` and ``disc``); ``extra``
holds what the CLI needs to continue its data stream.
Each file is written to a temporary name and moved into place with
``os.replace``, so a crash during a save leaves no half file that
:func:`latest_step` would pick. Every file loads with
``torch.load(weights_only=True)``: tensors, dicts, lists, numbers, strings.
``keep_top_k`` keeps the latest k steps (Orbax's ``max_to_keep``); the
sibling store keeps the best step after the main directory has let it go,
so the best pointer never dangles.

Several processes (a state placed on a mesh, ``parallel/mesh.py``): every
rank calls :func:`save_checkpoint`; the pieces of each placed tensor are
gathered, rank 0 writes the whole state as above, and all ranks wait at a
barrier, so the file is there when any of them returns.
:func:`restore_checkpoint` reads the whole state on every rank and gives
each rank its own pieces again.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

BEST_FILE = "best_checkpoint.json"
CONFIG_FILE = "config.json"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _steps(ckpt_dir: Path):
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                  if (m := _STEP_FILE.match(p.name)))


def step_file(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{int(step)}.pt"


def save_checkpoint(ckpt_dir, state, step: int, config: Optional[Dict] = None,
                    keep_top_k: Optional[int] = None, extra: Optional[Dict] = None) -> Path:
    """Save ``state`` (a :class:`TrainState`) as step ``step``, then drop all
    but the latest ``keep_top_k`` steps. Returns the file. With several
    processes every rank calls it and rank 0 writes the whole state."""
    from medfusion_tpu_torch.parallel.mesh import whole_state_dict

    ckpt_dir = Path(ckpt_dir)
    path = step_file(ckpt_dir, step)
    ranks = dist.is_initialized() and dist.get_world_size() > 1
    sd = whole_state_dict(state, state.state_dict())
    if not ranks or dist.get_rank() == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        payload = {"step": int(step), "state": sd, "extra": extra or {}}
        _atomic_write(path, lambda tmp: torch.save(payload, tmp))
        if config is not None:
            text = json.dumps(config, indent=2, default=str)
            _atomic_write(ckpt_dir / CONFIG_FILE, lambda tmp: tmp.write_text(text))
        if keep_top_k is not None:
            for old in _steps(ckpt_dir)[:-keep_top_k]:
                step_file(ckpt_dir, old).unlink()
    if ranks:
        dist.barrier()
    return path


def latest_step(ckpt_dir) -> Optional[int]:
    steps = _steps(Path(ckpt_dir))
    return steps[-1] if steps else None


def load_payload(ckpt_dir, step: Optional[int] = None) -> Dict[str, Any]:
    """The saved dict of ``step`` (default: the latest), on the CPU."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = step_file(ckpt_dir, step)
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint of step {step} under {ckpt_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir, state, step: Optional[int] = None) -> Dict:
    """Load step ``step`` (default: the latest) into ``state`` in place,
    each rank's pieces of a placed state; returns the checkpoint's
    ``extra``."""
    from medfusion_tpu_torch.parallel.mesh import local_state_dict

    payload = load_payload(ckpt_dir, step)
    state.load_state_dict(local_state_dict(state, payload["state"]))
    return payload["extra"]


def _best_dir(ckpt_dir) -> Path:
    """The sibling directory holding the best step's own copy (outside the
    step directory, so that ``keep_top_k`` there never removes it)."""
    p = Path(ckpt_dir)
    return p.with_name(p.name + "_best")


def save_best_checkpoint(ckpt_dir, step: int, metric: float, minimize: bool = True,
                         state=None) -> bool:
    """Move the best pointer to ``step`` when ``metric`` improves on it, and
    then also save ``state`` into the sibling store (keep 1). Returns True
    when the pointer moved."""
    path = Path(ckpt_dir) / BEST_FILE
    best = json.loads(path.read_text()) if path.exists() else None
    improved = (best is None or (minimize and metric < best["metric"])
                or (not minimize and metric > best["metric"]))
    if improved:
        if state is not None:
            save_checkpoint(_best_dir(ckpt_dir), state, step, keep_top_k=1)
        text = json.dumps({"step": int(step), "metric": float(metric), "minimize": minimize})
        Path(ckpt_dir).mkdir(parents=True, exist_ok=True)
        _atomic_write(path, lambda tmp: tmp.write_text(text))
    return improved


def load_best_checkpoint(ckpt_dir, state) -> Dict:
    """Restore the step the best pointer names, from the step directory or,
    once ``keep_top_k`` has dropped it there, from the sibling store."""
    pointer = json.loads((Path(ckpt_dir) / BEST_FILE).read_text())
    step = pointer["step"]
    src = ckpt_dir if step_file(ckpt_dir, step).exists() else _best_dir(ckpt_dir)
    return restore_checkpoint(src, state, step=step)


def check_config(ckpt_dir, values: Dict[str, Any], context: str) -> None:
    """Raise SystemExit when the run's ``config.json`` holds another value
    for one of ``values``' keys: a checkpoint trained with other options
    would load into the wrong model or train on with the wrong EMA."""
    cfg_file = Path(ckpt_dir) / CONFIG_FILE
    saved = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    for k, now in values.items():
        if k in saved and saved[k] != now:
            raise SystemExit(f"{context}: the run was trained with {k}={saved[k]!r}, "
                             f"this invocation has {now!r}")


def ckpt_dir_of(path: Path) -> Path:
    """A run directory (``<out>``) or its ``checkpoints`` directory."""
    if _steps(path):
        return path
    if _steps(path / "checkpoints"):
        return path / "checkpoints"
    raise FileNotFoundError(f"no checkpoint under {path} or {path / 'checkpoints'}")


def restore_ae_params(path, vae: torch.nn.Module, step: Optional[int] = None) -> Path:
    """Load autoencoder weights into ``vae`` with ``strict=True``: from a port
    autoencoder run, plain or adversarial (its directory or its
    ``checkpoints`` directory; the latest step, or ``step``; a GAN run's
    generator), from an ``.npz`` of the JAX VAE's flax params (paths
    joined by '/', bare, under ``latent_embedder/`` or a GAN state's
    ``gen/params/``), or from a reference Lightning ``.ckpt``
    (``utils/torch_compat.py::autoencoder_state``). Raises
    ValueError on any missing, unexpected or misshapen tensor: a silent
    fallback would train diffusion on a random VAE's latents. Returns the
    file it loaded."""
    from medfusion_tpu_torch.utils.weights import jax_params_to_state_dict, unflatten_npz

    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as f:
            tree = unflatten_npz({k: f[k] for k in f.files})
        tree = tree["gen"]["params"] if "gen" in tree else tree.get("latent_embedder", tree)
        sd, src = jax_params_to_state_dict(tree, kind="vae"), path
    elif path.suffix == ".ckpt":
        from medfusion_tpu_torch.utils.torch_compat import autoencoder_state, fit_layout

        sd, src = fit_layout(vae, autoencoder_state(path)), path
    else:
        ckpt_dir = ckpt_dir_of(path)
        step = latest_step(ckpt_dir) if step is None else step
        state = load_payload(ckpt_dir, step)["state"]
        sd = (state["gen"] if "gen" in state else state)["model"]
        src = step_file(ckpt_dir, step)
    want = vae.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    shapes = [f"{k} {tuple(sd[k].shape)} vs {tuple(v.shape)}" for k, v in want.items()
              if k in sd and tuple(sd[k].shape) != tuple(v.shape)]
    if missing or unexpected or shapes:
        raise ValueError(
            f"the autoencoder weights in {src} do not match the model: "
            f"missing {missing[:3]}, unexpected {unexpected[:3]}, shapes {shapes[:3]} "
            f"({len(missing)}, {len(unexpected)} and {len(shapes)} in all) — wrong "
            f"preset or wrong run directory?")
    vae.load_state_dict(sd, strict=True)
    return src


def filter_weights(source: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor],
                   path_regex: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Partial weight transfer between state dicts: each of ``target``'s
    entries is ``source``'s of the same key when that key matches
    ``path_regex`` (``re.search``; every key if None) and the two shapes
    agree, else ``target``'s own. The result has ``target``'s keys, in its
    order."""
    pat = re.compile(path_regex) if path_regex else None

    def pick(key, tgt):
        src = source.get(key)
        if src is None or tuple(src.shape) != tuple(tgt.shape):
            return tgt
        if pat is not None and not pat.search(key):
            return tgt
        return src

    return {key: pick(key, tgt) for key, tgt in target.items()}
