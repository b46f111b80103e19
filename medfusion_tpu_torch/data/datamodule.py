"""Shuffled, batched numpy iteration (the part of
``medfusion_tpu/data/datamodule.py::SimpleDataModule`` that the training CLI
uses without sample weights): epoch ``e`` visits the items in the order of
``np.random.default_rng((seed, e)).permutation(n)``, in full batches
(``drop_last``), each stacked key by key into one array."""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def _stack(items: List[Dict]) -> Dict[str, np.ndarray]:
    return {key: np.asarray([it[key] for it in items]) if isinstance(items[0][key], str)
            else np.stack([np.asarray(it[key]) for it in items])
            for key in items[0]}


class SimpleDataModule:
    def __init__(self, ds_train, batch_size: int = 1, seed: int = 0):
        self.ds_train = ds_train
        self.batch_size = batch_size
        self.seed = seed

    def train_dataloader(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.ds_train))
        bs = self.batch_size
        for b in range(len(order) // bs):
            yield _stack([self.ds_train[i] for i in order[b * bs:(b + 1) * bs]])
