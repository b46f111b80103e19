"""What the two training CLIs share around their steps: the per-step
generator, the batch stream that a resumed run continues, the data
stream's state in a checkpoint, and the host-side check of the labels.

A run that stops after step s and resumes equals one that did not stop:
step s's draws come from a generator seeded by (seed, s), the stream
restarts at batch s of the epoch order (epoch s // batches-per-epoch, the
batches before s skipped unread), and the dataset's flip generator is
restored from the checkpoint.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

import numpy as np
import torch


# the key of the sample grids' draws: (seed, SAMPLE_KEY, step)
SAMPLE_KEY = 1_000_003


def step_generator(device, seed: int, *keys: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by (seed, *keys)."""
    state = np.random.SeedSequence([seed, *keys]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def batch_stream(dm, step: int) -> Iterator[Dict[str, np.ndarray]]:
    """The batches of steps ``step``, ``step`` + 1, ... of an endless run over
    ``dm``'s epochs."""
    per_epoch = dm.batches_per_epoch()
    if per_epoch == 0:
        raise ValueError(f"the dataset has {len(dm.ds_train)} items, fewer than one batch "
                         f"of {dm.batch_size}")
    epoch, skip = divmod(step, per_epoch)
    while True:
        yield from dm.train_dataloader(epoch=epoch, start_batch=skip)
        epoch, skip = epoch + 1, 0


def data_state(ds) -> Dict[str, str]:
    """The dataset's flip generator, as a checkpoint's ``extra``."""
    rng = getattr(ds, "rng", None)
    return {} if rng is None else {"data_rng": json.dumps(rng.bit_generator.state)}


def restore_data_state(ds, extra: Dict[str, str]) -> None:
    if "data_rng" in extra:
        ds.rng.bit_generator.state = json.loads(extra["data_rng"])


def check_labels(target: np.ndarray, num_classes: Optional[int]) -> None:
    """Raise on a label outside [0, num_classes) before it reaches the label
    embedding, where the card would stop on a device-side assert."""
    if num_classes is None:
        return
    bad = target[(target < 0) | (target >= num_classes)]
    if bad.size:
        raise ValueError(
            f"batch labels {sorted(set(bad.tolist()))} are outside [0, {num_classes}): the "
            f"preset has {num_classes} classes (CheXpert_2 marks an uncertain or missing "
            f"Cardiomegaly as 2; keep only labels the model was built for)")
