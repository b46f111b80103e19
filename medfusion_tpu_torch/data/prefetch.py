"""Keep batches in flight to the card while the step runs (port of
``medfusion_tpu/data/prefetch.py::prefetch_to_device``).

``size`` batches are pulled from the iterator before the first is yielded,
and one more each time one is yielded, so the batches come out in the
iterator's order and an iterator shorter than ``size`` ends cleanly. A
batch is a dict, list or tuple of numpy arrays or tensors (nested);
anything else in it (a string array of uids) passes through as it is.

On a CUDA device each tensor is copied from pinned host memory with
``non_blocking=True`` on a side stream, and an event is recorded after the
batch's copies. When the batch is yielded, the current stream waits on
that event (the consumer's kernels start after the copy, without the host
waiting), and each tensor is marked with ``record_stream`` for the current
stream: the caching allocator gave its memory out on the side stream, and
without the mark it could hand that memory to a later batch's copy while
the consumer's kernels still read it. On the CPU the batch is converted to
tensors and nothing overlaps.

With ``mesh`` (``parallel/mesh.py``) each batch is cut to this rank's rows
over 'data' (``shard_batch``) before it is copied, so only those rows go to
this rank's device, as the JAX package puts a batch with its data sharding.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _tensors(batch):
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _tensors(v)
    elif isinstance(batch, torch.Tensor):
        yield batch


def _as_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, np.ndarray) and leaf.dtype.kind in "biuf":
        return torch.from_numpy(leaf)
    return leaf


def prefetch_to_device(iterator: Iterable, size: int = 2, device="cuda",
                       mesh=None) -> Iterator:
    """Yield ``iterator``'s batches on ``device``, ``size`` batches ahead;
    with ``mesh``, this rank's rows of each."""
    device = torch.device(device)
    queue = collections.deque()
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        copy_stream = torch.cuda.Stream(device)

    def copy(t):
        if not isinstance(t, torch.Tensor) or t.device == device:
            return t
        if not cuda:
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def put(batch):
        batch = _map(_as_tensor, batch)
        if mesh is not None:
            from medfusion_tpu_torch.parallel.mesh import shard_batch

            batch = shard_batch(batch, mesh)
        if not cuda:
            return _map(copy, batch), None
        with torch.cuda.stream(copy_stream):
            out = _map(copy, batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(item):
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in _tensors(batch):
                t.record_stream(consumer)
        return batch

    it = iter(iterator)
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield take(out)
