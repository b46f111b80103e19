"""grain's epoch order without grain (port of
``medfusion_tpu/data/grain_loader.py::make_grain_loader``).

The JAX package's ``--grain`` loader is a ``grain.IndexSampler`` shuffled by
``seed + epoch`` over one epoch, the ``uid`` key dropped and the remainder
dropped. ``import grain.python`` loads JAX, so the port computes the same
order itself: ``IndexSampler`` takes record ``i`` of an epoch over ``n``
records from ``index_shuffle(i, n - 1, seed, rounds=4)`` of grain's
compiled ``index_shuffle`` module, a SIMON-style Feistel cipher on a block
of ``W`` bits with cycle walking:

* ``W`` is the smallest even number >= 16 with ``2**W >= max_index``, and a
  half word has ``W // 2`` bits;
* the round keys are C++'s ``std::seed_seq{seed}.generate`` of ``rounds``
  32-bit words, each cut to a half word;
* a round maps the halves ``(x, y)`` (the low and the high half) to
  ``(y ^ f(x) ^ key, x)``, ``f(x) = (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)``
  on a half word;
* the value is encrypted again while it exceeds ``max_index`` (a domain of
  up to 2**22 values is encrypted whole and each walk resolved by pointer
  doubling, which gives the same values).

The halves are cut from the value with a mask, so where ``max_index`` is a
power of two (``2**W == max_index``) the value ``max_index`` encrypts as 0
does and the order holds record ``index_shuffle(0, ...)`` twice and never
``max_index``: grain does this, and the port copies it.

:class:`GrainDataModule` has :class:`SimpleDataModule`'s surface
(``batches_per_epoch``, ``train_dataloader(epoch, start_batch)``), so
``train/loop.py::batch_stream`` runs it and a resumed run continues the
epoch where it stopped (the JAX CLI's resume replays the epoch). The
dataset's ``get_weights`` is ignored, as grain ignores it. Batch ``b`` of
epoch ``e`` draws its flips from ``default_rng((seed, e, b))``, as the
port's worker processes do, in this process or in ``num_workers`` of them.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from medfusion_tpu_torch.data.datamodule import SimpleDataModule, _Batches, load_batches

_M32 = 0xFFFFFFFF


def seed_seq_words(seed: int, n: int) -> List[int]:
    """C++'s ``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the
    algorithm of the standard's [rand.util.seedseq])."""
    v = [seed & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        x &= _M32
        return x ^ (x >> 27)

    for k in range(m):
        r1 = 1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]) & _M32
        r2 = (r1 + (s if k == 0 else k % n + (v[k - 1] if k <= s else 0))) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = 1566083941 * mix(b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _cipher(max_index: int, seed: int, rounds: int):
    """(the encryption of a uint64 array, the size of its domain)."""
    w = 16
    while (1 << w) < max_index:
        w += 2
    half = w // 2
    mask = np.uint64((1 << half) - 1)
    keys = [np.uint64(k) & mask for k in seed_seq_words(seed, rounds)]
    h = np.uint64(half)

    def rotl(x, r):
        r = np.uint64(r)
        return ((x << r) | (x >> (h - r))) & mask

    def encrypt(v):
        x, y = v & mask, (v >> h) & mask
        for k in keys:
            x, y = y ^ ((rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)) ^ k, x
        return x | (y << h)

    return encrypt, 1 << w


# the largest domain whose every value is encrypted at once (32 MiB)
_WHOLE_DOMAIN = 1 << 22


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4):
    """The position ``index`` (an int or an integer array) of grain's
    permutation of ``[0, max_index]``."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed}: grain takes seeds in [0, 2**32)")
    encrypt, size = _cipher(max_index, seed, rounds)
    out = np.atleast_1d(encrypt(np.asarray(index, np.uint64)))
    if size <= _WHOLE_DOMAIN:
        # A few records in a 2**16 domain walk thousands of steps each. So
        # every value of the domain is encrypted once, and each value past
        # max_index is pointed at the first value in range that the walk
        # from it reaches: log2(size) pointer doublings cover a walk of up
        # to size steps (a cycle with no value in range is never entered).
        domain = np.arange(size, dtype=np.uint64)
        first = np.where(domain <= max_index, domain, encrypt(domain))
        for _ in range(size.bit_length()):
            first = first[first]
        out = first[out]
    else:
        out = out.copy()
        walk = out > max_index
        while walk.any():
            out[walk] = encrypt(out[walk])
            walk = out > max_index
    return int(out[0]) if np.ndim(index) == 0 else out.reshape(np.shape(index)).astype(np.int64)


def grain_order(num_records: int, seed: int) -> np.ndarray:
    """One epoch of ``grain.IndexSampler(num_records, shuffle=True, seed=seed,
    num_epochs=1)``'s record keys, in order."""
    return index_shuffle(np.arange(num_records), num_records - 1, seed)


class GrainDataModule(SimpleDataModule):
    """Epoch ``e`` in :func:`grain_order` of ``seed + e``, full batches only,
    without the ``uid`` key."""

    def __init__(self, ds_train, batch_size: int = 1, seed: int = 0, num_workers: int = 0):
        super().__init__(ds_train, batch_size=batch_size, seed=seed, num_workers=num_workers)

    def train_dataloader(self, epoch: int = 0,
                         start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = grain_order(len(self.ds_train), self.seed + epoch)
        bs = self.batch_size
        batches = [order[b * bs:(b + 1) * bs]
                   for b in range(start_batch, len(order) // bs)]
        source = _Batches(self.ds_train, batches, self.seed, epoch, start_batch)
        for batch in load_batches(source, self.num_workers):
            batch.pop("uid", None)
            yield batch
