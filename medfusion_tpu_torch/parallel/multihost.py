"""Process-group initialisation (port of
``medfusion_tpu/parallel/multihost.py``).

One process drives one device: a card under ``torchrun`` (one process per
card, ``LOCAL_RANK`` naming its card), or the CPU. The backend follows the
explicit ``device``, never what is available: NCCL for ``cuda``, gloo for
``cpu``. The group's address comes from the arguments (``tcp://``), else
from torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``); a process with neither makes a group of one on a free
localhost port, so that one code path runs at every world size. A caller
that wants the group gone when it is done checks ``dist.is_initialized()``
first and destroys only a group its own call made.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from medfusion_tpu_torch import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# a rank that waits longer than this in a collective raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device) -> str:
    """The backend of ``device``'s type (raises for ``cuda`` without CUDA)."""
    kind = resolve_device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}; "
                         f"expected one of {sorted(BACKENDS)}")
    return BACKENDS[kind]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> dict:
    """``dist.init_process_group`` on ``device``'s backend; a no-op when a
    group exists already. ``coordinator_address`` is ``host:port`` (or
    ``tcp://host:port``) with ``num_processes`` and ``process_id``; without
    it, torchrun's environment; without either, a group of one process.
    On a card, the process's card is ``LOCAL_RANK`` (0 by default).

    Returns {process_index, process_count, local_device_count,
    global_device_count}: one device a process, as the port runs."""
    if not dist.is_initialized():
        backend = backend_for(device)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if coordinator_address is not None:
            addr = coordinator_address
            if not addr.startswith("tcp://"):
                addr = f"tcp://{addr}"
            dist.init_process_group(backend, init_method=addr,
                                    world_size=num_processes or 1, rank=process_id or 0,
                                    timeout=TIMEOUT)
        elif _torchrun_env():
            dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                    world_size=1, rank=0, timeout=TIMEOUT)
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_device_count": 1, "global_device_count": world}


def per_host_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows of the global batch (all of them
    without a process group)."""
    world, rank = ((dist.get_world_size(), dist.get_rank()) if dist.is_initialized()
                   else (1, 0))
    per_host = global_batch // world
    start = rank * per_host
    return slice(start, start + per_host)
