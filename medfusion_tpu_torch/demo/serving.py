"""Serving: single-image requests coalesced into fixed-shape batches (port
of ``medfusion_tpu/demo/serving.py``).

* :func:`make_sample_batch_fn` builds ``batch_fn(seeds [B], conds [B]) ->
  images [B, H, W, C]`` from a pipeline: DDIM at eta 0 (or the flow
  family's Heun ODE) over one fixed batch. Slot i's initial latent is drawn
  from a generator seeded from ``(base_seed, seeds[i])`` alone, so a
  request's image depends only on its ``(seed, cond)``, not on the batch it
  lands in. torch cannot replay the JAX package's ``fold_in`` keys, so
  ``init_noise(seeds) -> x_T`` may supply the initial latents instead.
* :class:`MicroBatcher` drains a queue of requests into batches of
  ``batch_size``: it waits up to ``max_wait_s`` for a batch to fill, pads
  the rest with the last request, runs ``batch_fn`` once, and hands each
  request its row; an exception reaches every waiting future.

Every batch runs on the batcher's worker thread. Gradient mode is a
thread's own setting, so the batch function enters
``torch.inference_mode`` itself: a caller's ``no_grad`` on another thread
does not reach it.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline


def slot_seed(base_seed: int, seed: int) -> int:
    """The generator seed of a request's slot, from ``(base_seed, seed)``."""
    mask = 2**64 - 1
    return int(np.random.SeedSequence([base_seed & mask, seed & mask])
               .generate_state(1, np.uint64)[0])


def slot_noise(latent_shape, seeds, base_seed: int, device) -> torch.Tensor:
    """[B, *latent_shape] standard normals, row i from its own generator
    seeded by :func:`slot_seed` (``base_seed``, ``seeds[i]``)."""
    rows = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(slot_seed(base_seed, int(s)))
        rows.append(torch.randn(tuple(latent_shape), generator=gen, device=device))
    return torch.stack(rows)


def make_sample_batch_fn(pipe, latent_shape, steps: int = 50, guidance_scale: float = 1.0,
                         conditional: bool = True, family: str = "diffusion",
                         base_seed: int = 0, init_noise: Optional[Callable] = None):
    """``batch_fn(seeds, conds) -> images [B, H, W, C]`` (float32, on the
    pipeline's device) for channels-last ``latent_shape``: DDIM at eta 0 for
    ``family`` 'diffusion', the Heun ODE for 'flow'; classifier-free
    guidance at ``guidance_scale`` on ``conds`` when ``conditional``.
    ``init_noise(seeds) -> x_T`` replaces :func:`slot_noise`."""
    if family not in ("diffusion", "flow"):
        raise ValueError(f"unknown family {family!r}")
    if (family == "flow") != isinstance(pipe, FlowMatchingPipeline):
        raise ValueError(f"family {family!r} does not match the pipeline "
                         f"{type(pipe).__name__}")
    dev = pipe.device

    def batch_fn(seeds, conds):
        with torch.inference_mode():
            seeds = [int(s) for s in seeds]
            x_T = (slot_noise(latent_shape, seeds, base_seed, dev) if init_noise is None
                   else init_noise(seeds).to(dev, torch.float32))
            cond = torch.as_tensor(conds, dtype=torch.long).to(dev) if conditional else None
            gs = guidance_scale if conditional else 1.0
            if family == "flow":
                out = pipe.denoise(x_T, condition=cond, steps=steps, guidance_scale=gs)
            else:
                # eta 0: the ancestral and DDIM draws are scaled by zero
                gen = torch.Generator(device=dev).manual_seed(base_seed)
                out = pipe.denoise(x_T, condition=cond, steps=steps, use_ddim=True, eta=0.0,
                                   guidance_scale=gs, generator=gen)
            return out.float()

    return batch_fn


class MicroBatcher:
    """Coalesce concurrent single-image requests into fixed-size batches.

    ``submit(seed, cond)`` returns a ``concurrent.futures.Future`` of that
    request's image (a CPU tensor). A worker thread drains the queue: it
    waits up to ``max_wait_s`` for a full batch, pads by repeating the last
    request, runs ``batch_fn`` once, copies the result to the host and
    hands out the rows. An exception goes to every waiting future."""

    def __init__(self, batch_fn: Callable, batch_size: int, max_wait_s: float = 0.05):
        self.batch_fn = batch_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        self._queue: List[Tuple[int, int, Future]] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self.batches_run = 0  # observability (tested)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, seed: int, cond: int = 0) -> Future:
        fut: Future = Future()
        with self._wake:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append((int(seed), int(cond), fut))
            self._wake.notify()
        return fut

    def close(self, timeout: Optional[float] = 5.0):
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=timeout)

    def _take_batch(self):
        """Wait for at least one request, then up to ``max_wait_s`` for a
        full batch."""
        with self._wake:
            while not self._queue and not self._closed:
                self._wake.wait(timeout=0.5)
            if not self._queue:
                return None  # closed and drained
            end = time.monotonic() + self.max_wait_s
            while len(self._queue) < self.batch_size and not self._closed:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(timeout=remaining)
            batch = self._queue[: self.batch_size]
            del self._queue[: len(batch)]
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            seeds = [s for s, _, _ in batch]
            conds = [c for _, c, _ in batch]
            pad = self.batch_size - len(batch)
            seeds = seeds + [seeds[-1]] * pad
            conds = conds + [conds[-1]] * pad
            try:
                out = self.batch_fn(torch.tensor(seeds), torch.tensor(conds)).cpu()
                self.batches_run += 1
                for i, (_, _, fut) in enumerate(batch):
                    fut.set_result(out[i])
            except Exception as e:  # noqa: BLE001 - propagate to callers
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
