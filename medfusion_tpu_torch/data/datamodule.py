"""Batched numpy iteration (port of
``medfusion_tpu/data/datamodule.py::SimpleDataModule``).

Epoch ``e`` of the train loader draws from ``np.random.default_rng((seed,
e))``: with ``weights``, ``choice(n, n, replace=True, p)`` (the reference's
WeightedRandomSampler with replacement), else a permutation; full batches
only (``drop_last``). The val and test loaders run in order and keep the
last partial batch. Each batch is stacked key by key into one array.

``num_workers == 0`` loads the items in order in this process, so the
dataset's one flip generator makes the same draws as the JAX package's
loader with one worker. With ``num_workers > 0`` a ``torch.utils.data``
loader spreads the batches over worker processes (spawned, in order), and
batch ``b`` of epoch ``e`` draws its flips from ``default_rng((seed, e,
b))``, so the batches do not depend on the number of workers.

``start_batch`` skips the first batches of an epoch without reading them:
a resumed run continues the epoch where it stopped.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _stack(items: List[Dict]) -> Dict[str, np.ndarray]:
    return {key: np.asarray([it[key] for it in items]) if isinstance(items[0][key], str)
            else np.stack([np.asarray(it[key]) for it in items])
            for key in items[0]}


def _identity(batch):
    return batch


class _Batches:
    """Map-style dataset of whole batches for a worker process: batch ``i``
    is ``batches[i]``, its flips drawn from ``default_rng((seed, epoch,
    first + i))``."""

    def __init__(self, ds, batches: Sequence[np.ndarray], seed: int, epoch: int, first: int):
        self.ds, self.batches = ds, batches
        self.seed, self.epoch, self.first = seed, epoch, first

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        if hasattr(self.ds, "rng"):
            self.ds.rng = np.random.default_rng((self.seed, self.epoch, self.first + i))
        return _stack([self.ds[int(j)] for j in self.batches[i]])


def load_batches(source: _Batches, num_workers: int) -> Iterator[Dict[str, np.ndarray]]:
    """``source``'s batches in order: in this process, or spread over
    ``num_workers`` spawned worker processes."""
    if num_workers == 0:
        for i in range(len(source)):
            yield source[i]
        return
    from torch.utils.data import DataLoader

    loader = DataLoader(source, batch_size=None, shuffle=False, num_workers=num_workers,
                        collate_fn=_identity, multiprocessing_context="spawn")
    it = iter(loader)
    try:
        yield from it
    finally:
        # stop the workers also when the caller leaves mid-epoch
        it._shutdown_workers()


class SimpleDataModule:
    def __init__(self, ds_train, ds_val=None, ds_test=None, batch_size: int = 1,
                 seed: int = 0, weights: Optional[List[float]] = None,
                 num_workers: int = 0):
        self.ds_train = ds_train
        self.ds_val = ds_val
        self.ds_test = ds_test
        self.batch_size = batch_size
        self.seed = seed
        self.weights = weights
        self.num_workers = num_workers

    def batches_per_epoch(self) -> int:
        return len(self.ds_train) // self.batch_size

    def batches(self, ds, order: Sequence[int], drop_last: bool = True, epoch: int = 0,
                start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The items of ``ds`` in ``order``, batched, from batch
        ``start_batch``; with workers, ``epoch`` and the batch's index seed
        its flips."""
        bs = self.batch_size
        n_batches = len(order) // bs if drop_last else -(-len(order) // bs)
        batches = [order[b * bs:(b + 1) * bs] for b in range(start_batch, n_batches)]
        if self.num_workers == 0:
            for idx in batches:
                yield _stack([ds[int(i)] for i in idx])
            return
        yield from load_batches(_Batches(ds, batches, self.seed, epoch, start_batch),
                                self.num_workers)

    def train_dataloader(self, epoch: int = 0,
                         start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        n = len(self.ds_train)
        if self.weights is not None:
            p = np.asarray(self.weights, np.float64)
            p = p / p.sum()
            order = rng.choice(n, size=n, replace=True, p=p)
        else:
            order = rng.permutation(n)
        return self.batches(self.ds_train, order, drop_last=True, epoch=epoch,
                            start_batch=start_batch)

    def val_dataloader(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.ds_val is None:
            raise ValueError("A validation set was not initialized.")
        return self.batches(self.ds_val, np.arange(len(self.ds_val)), drop_last=False)

    def test_dataloader(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.ds_test is None:
            raise ValueError("A test set was not initialized.")
        return self.batches(self.ds_test, np.arange(len(self.ds_test)), drop_last=False)
