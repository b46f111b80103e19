#!/usr/bin/env python3
"""Compare builds of the flash-attention backward kernels on one CUDA card.

Each variant is a directory holding a ``flash_attention_bwd.cu`` and its
headers (a copy of ``medfusion_tpu_torch/csrc`` with a change), plus
optional ``-D`` macros. Every variant is built with the package's nvcc flags
(its ptxas registers and spills printed), checked against the plain
backward at ragged and path shapes (bf16, two bf16 ulps of the largest
gradient, as ``chip_smoke.py``), and timed at the training path's five
shapes (B=32) in turns, A B ... B A, the faster of each variant's two turns
kept. Run from the repository root:

    python3 tools/compare_bwd_builds.py \\
        now=medfusion_tpu_torch/csrc other=path/to/copy:MACRO=1,OTHER
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKS = [(1024, 1024, 256, 8, "head"), (256, 256, 512, 8, "tokens"),
          (64, 64, 1024, 8, "tokens"), (77, 45, 256, 4, "tokens"),
          (45, 77, 64, 4, "head"), (1000, 1024, 256, 8, "head"),
          (129, 127, 512, 4, "tokens"), (300, 200, 128, 4, "head")]


def build(variants, out_dir):
    """{name: (dq, dkv) entry points}; prints each build's bf16 ptxas lines."""
    from medfusion_tpu_torch.ops import build as B
    from medfusion_tpu_torch.ops import flash_attention as FA

    procs = {}
    for name, (src, macros) in variants.items():
        lib = out_dir / f"{name}.so"
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(src), *[f"-D{m}" for m in macros],
               "-o", str(lib), str(src / "flash_attention_bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print(f"== {name}")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "bf16" in line else None
            elif kernel and ("registers" in line or "spill" in line):
                print(f"   {kernel[-60:]}: {line.strip()}")
        cdll = ctypes.CDLL(str(lib))
        fns[name] = []
        for which in ("dq", "dkv"):
            fn = getattr(cdll, f"mf_flash_attention_bwd_{which}")
            fn.argtypes, fn.restype = FA._BWD_ARGTYPES, ctypes.c_int
            fns[name].append(fn)
    return fns


def launch(fn, ops, scale):
    import torch

    q, k = ops[0], ops[1]
    b, h, n, d = q.shape
    ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in ops])
    strides = (ctypes.c_longlong * 30)(*[s for t in ops for s in t.stride()[:3]])
    err = fn(1, ctypes.cast(ptrs, ctypes.c_void_p), b, h, n, k.shape[2], d,
             ctypes.cast(strides, ctypes.c_void_p), float(scale * scale),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")


def operands(CS, FA, b, n, m, c, heads, layout, gen):
    import torch

    q, k, v = CS.attn_inputs(b, n, m, c, torch.bfloat16, gen)
    do = torch.randn((b, n, c), generator=gen, device="cuda").bfloat16()
    return CS.bwd_operands(FA, q, k, v, heads, layout, do)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="+", help="name=dir[:MACRO,MACRO=1]")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_bwd_builds: no CUDA device")
    import chip_smoke as CS
    from medfusion_tpu_torch.ops import flash_attention as FA

    variants = {}
    for spec in args.variants:
        name, rest = spec.split("=", 1)
        src, _, macros = rest.partition(":")
        variants[name] = (Path(src).resolve(), [m for m in macros.split(",") if m])
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(variants, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for n, m, c, heads, layout in CHECKS:
            ops, scale = operands(CS, FA, 2, n, m, c, heads, layout, gen)
            refs = FA.flash_attention_backward_reference(*ops[:4], ops[8], ops[4], scale)
            line = []
            for name, (dq, dkv) in fns.items():
                for t in ops[5:8]:
                    t.fill_(float("nan"))
                launch(dq, ops, scale)
                launch(dkv, ops, scale)
                errs = [((o.float() - r.float()).abs().max().item(), CS.attn_bwd_tol(r)[0])
                        for o, r in zip(ops[5:8], refs)]
                ok = all(e <= tol for e, tol in errs)
                line.append(f"{name} {'ok' if ok else 'FAIL'} {max(e for e, _ in errs):.2e}")
            print(f"check N={n} M={m} C={c} H={heads} {layout}: " + "; ".join(line))
        totals = {name: [0.0, 0.0] for name in fns}
        for n, c, heads, _, layout in CS.ATTN_SHAPES:
            ops, scale = operands(CS, FA, CS.TRAIN_BATCH, n, n, c, heads, layout, gen)
            best = {}
            for name in list(fns) + list(fns)[::-1]:
                times = [CS.graph_ms(lambda f=f: launch(f, ops, scale), 20) for f in fns[name]]
                best[name] = [min(a, b) for a, b in zip(best.get(name, times), times)]
            for name, (t_dq, t_dkv) in best.items():
                totals[name][0] += t_dq
                totals[name][1] += t_dkv
            print(f"ms dQ/dKV N={n} d={c // heads} {layout}: " + "; ".join(
                f"{name} {t[0]:.4f}/{t[1]:.4f}" for name, t in best.items()))
    print("sums dQ/dKV/both: " + "; ".join(
        f"{name} {a:.4f}/{b:.4f}/{a + b:.4f}" for name, (a, b) in totals.items()))
    print(CS.card_line())


if __name__ == "__main__":
    main()
