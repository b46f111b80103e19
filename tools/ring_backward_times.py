#!/usr/bin/env python3
"""Ring attention's gradient on one CUDA card, alone: where its time goes.

Builds the kernels, makes the NCCL group of one, runs ``chip_smoke.py``'s
phase 18e (``phase_ring_attention``: the forward's checks and times, then
``ring_backward_checks``: the ring's backward at world 1 bit-equal to
kernels 3 and 4 on the whole, the block-pair backward over 2 and 4 K/V
blocks against the plain backward's pairs, eager and graph-replayed times)
``--repeat`` times for the spread, then splits each backward call's device
time by kernel (``torch.profiler`` over a few eager calls, after a warm-up)
and gives each call's host time (the enqueue of 20 calls after a
synchronize, divided by 20), beside ``torch.autograd.grad`` through
``flash_attention``'s own backward node on the same inputs. The 32^2 level
of chest-spatial: B=32, 8 heads x 32, 1,024 tokens, bf16. Run from the
repository root:

    python3 tools/ring_backward_times.py [--repeat 2]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_ms(fn, calls=5):
    """Device ms a call of ``fn`` by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in CS.device_kernels(prof)}


def host_ms(fn, calls=20):
    """Host ms a call of ``fn``: the enqueue of ``calls`` calls after a
    synchronize (no wait on the device inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeat", type=int, default=2)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ring_backward_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.ops import build
    from medfusion_tpu_torch.ops import flash_attention as FA
    from medfusion_tpu_torch.parallel import ring_attention
    from medfusion_tpu_torch.parallel.ring_attention import (
        attention_blocks_backward,
        merge_attention_blocks,
    )

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    CS.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {CS.card_line()}")
    build.build_all()
    mesh = CS.phase_parallel_init()
    for _ in range(args.repeat):
        CS.phase_ring_attention(ops, FA, mesh)

    gen = torch.Generator(device="cuda").manual_seed(20)
    b, h, n, d = CS.RING_BWD_BATCH, 8, 1024, 32
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    scale = d ** -0.25
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ring_attention(*leaves, mesh, scale=scale, axis="data")
    flash_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_o, _ = FA.flash_attention(*flash_leaves, scale)
    with torch.no_grad():
        whole_o, whole_lse = FA.flash_attention(q, k, v, scale)
    calls = {"ring backward, world 1": lambda: torch.autograd.grad(o, leaves, do,
                                                                   retain_graph=True),
             "flash_attention's own backward node": lambda: torch.autograd.grad(
                 flash_o, flash_leaves, do, retain_graph=True),
             "kernels 3 + 4 on the whole": functools.partial(
                 FA.flash_attention_backward_cuda, q, k, v, whole_o, whole_lse, do, scale)}
    for parts in CS.RING_SPLITS:
        blocks = list(zip(k.chunk(parts, dim=2), v.chunk(parts, dim=2)))
        bo, blse = merge_attention_blocks(*zip(*[FA.flash_attention(q, kb, vb, scale)
                                                 for kb, vb in blocks]))
        calls[f"block-pair backward over {parts} blocks"] = functools.partial(
            attention_blocks_backward, q, blocks, bo, blse, do, scale)
    for name, fn in calls.items():
        by_kernel = kernel_ms(fn)
        slowest = sorted(by_kernel.items(), key=lambda kv: -kv[1])
        CS.log(f"  {name}: host {host_ms(fn):.4f} ms a call; device "
               f"{sum(by_kernel.values()):.4f} ms: "
               + ", ".join(f"{key[:60]} {ms:.4f}" for key, ms in slowest))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
