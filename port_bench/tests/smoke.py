"""A cell at a size that a CPU test holds: the chest configuration's
structure (three UNet levels, a down and an up block, a three-level VAE
with one deep-supervision head) at tiny widths, with the traffic mixes'
own keys at small counts."""

from __future__ import annotations

import copy
import json

from port_bench.harness import spec

SMOKE = {
    "image_size": 32, "image_channels": 3, "latent_size": 8, "latent_channels": 2,
    "timesteps": 20,
    "unet": {"hid_chs": [16, 16, 32], "strides": [1, 2, 2], "time_emb_dim": 32,
             "norm_groups": 8},
    "vae": {"hid_chs": [8, 16, 32], "strides": [1, 2, 2], "emb_channels": 2,
            "norm_groups": 8, "deep_supervision": 1},
}
TRAFFIC = {"sample": {"rows": 4, "steps": 5, "check_rows": 8, "check_block_rows": 4},
           "train": {"rows_per_rank": 4, "pool_batches": 4, "check_block_rows": 2}}


def config(name: str = "chest-spatial", attention=None) -> dict:
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())
    for k, v in SMOKE.items():
        if isinstance(v, dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    if attention is not None:
        cfg["unet"]["attention"] = attention
    return cfg


def cell(kind: str, config_name: str = "chest-spatial", chips: int = 1,
         limits=None) -> spec.Cell:
    traffic_name = {"sample": "sample.b32", "train": "train.b32"}[kind]
    traffic = json.loads((spec.BENCH_DIR / "traffic" / f"{traffic_name}.json").read_text())
    traffic.update(TRAFFIC[kind])
    return spec.Cell(name=f"smoke.{kind}", chips=chips, config=config(config_name),
                     traffic=traffic, limits=copy.deepcopy(limits or {}), end_to_end=[],
                     per_layer=[])


def f32(c: spec.Cell) -> spec.Cell:
    """The cell with the program in float32, where it agrees with the
    reference to round-off on the CPU."""
    c.config["compute_dtype"] = "float32"
    return c


def run(c: spec.Cell, seed: int = 5, faults=(), seconds: float = 0.5, traced: bool = False,
        rank: int = 0, port=None):
    """One run of ``c`` on the CPU through the harness, past its look for a
    card, with ``faults`` (names of ``harness/faults.py``) planted."""
    import time

    import torch

    from port_bench.harness import faults as F
    from port_bench.harness import runner

    torch.set_num_threads(2)
    return runner.run_rank(c, seed, seconds, traced, time.perf_counter(), rank=rank, port=port,
                           device=torch.device("cpu"), faults=[F.FAULTS[f] for f in faults])


def run_world(c: spec.Cell, seed: int = 5, faults=()):
    """``run`` on ``c.chips`` CPU processes over gloo; this one is rank 0."""
    import multiprocessing

    from port_bench.harness import runner

    port = runner._free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(c, seed, faults), kwargs=dict(rank=r, port=port))
             for r in range(1, c.chips)]
    for p in procs:
        p.start()
    try:
        return run(c, seed, faults, rank=0, port=port)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join()
