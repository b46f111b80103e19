#!/usr/bin/env python3
"""Compare builds of the flash-attention, GEGLU or GroupNorm kernels on one
CUDA card.

Each variant is a directory holding the kernel's source
(``flash_attention.cu`` for the forward, ``flash_attention_bwd.cu`` for the
backward, ``geglu_mlp.cu`` for GEGLU, ``group_norm_silu.cu`` for GroupNorm)
and its headers (a copy of ``medfusion_tpu_torch/csrc`` with a change, or
the package's own), plus optional ``-D`` macros (upper-case names) and, for
GroupNorm, launch-plan settings (lower-case ``key=value``, the keyword
arguments of ``ops/group_norm.py::launch_plan``: ``max_cluster``,
``values_per_thread``, ``block_threads``, ``cluster_threads``,
``slice_bytes``). Every variant is built with the package's nvcc
flags (its ptxas registers, spills and warnings printed), checked against
the plain version at ragged and path shapes in bf16 (the forward's o within
two bf16 ulps of max|o| and its lse within 1e-4, the backward's gradients
within two ulps of the largest, GEGLU within 3e-2, as ``chip_smoke.py``),
and timed at the path's five shapes in turns, A B ... B A, the faster of
each variant's two turns kept: the forward at the flagship sampling batch
(B=64 UNet rows) beside ``F.scaled_dot_product_attention`` on the same
inputs, the backward at the training batch (B=32), GEGLU at B=64 and at
the sampling batch (16 UNet rows), with each variant's device time split
by kernel (up- and down-projection, from a profile of a few eager calls)
and the sum per CFG UNet forward at B=64. With ``--dtype float32`` the
attention kernels' f32 routes are checked instead (within 2e-5 absolute
and relative of the plain version, the classifier's shapes and wide heads
among the checks, two launches bit-equal) and timed at the classifier's
three shapes (``chip_smoke.CLF_ATTN_SHAPES``, B=8, token layout) beside
SDPA's forward or backward on the same inputs. Each check also says whether
a variant's outputs are bit-equal to the first variant's. GroupNorm is checked in f32 and
bf16 (2e-5 and 1e-2, SiLU on and off, bit for bit across two launches) at
the path's shapes and ``chip_smoke.GN_ROUTE_CASES`` at B=2, and timed in
bf16 with SiLU at the path's nine shapes at the flagship batch (B=64 UNet,
B=32 VAE) beside ``F.group_norm`` + ``F.silu``, each variant's plan (route,
cluster, threads) and the card's resident clusters printed, with the sums
per CFG UNet forward and per decode. Run from the repository root:

    python3 tools/compare_attn_builds.py --kernel fwd \\
        now=medfusion_tpu_torch/csrc other=path/to/copy:MACRO=1,OTHER
    python3 tools/compare_attn_builds.py --kernel bwd --dtype float32 \\
        parent=_chip/parent/medfusion_tpu_torch/csrc now=medfusion_tpu_torch/csrc
    python3 tools/compare_attn_builds.py --kernel gn \\
        c16=medfusion_tpu_torch/csrc c8=medfusion_tpu_torch/csrc:max_cluster=8
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
          (129, 127, 512, 4, "tokens"), (300, 200, 128, 4, "head"),
          (1, 64, 64, 4, "tokens"), (64, 3, 512, 4, "head")]
SOURCES = {"fwd": ("flash_attention.cu", ["mf_flash_attention_fwd"]),
           "bwd": ("flash_attention_bwd.cu",
                   ["mf_flash_attention_bwd_dq", "mf_flash_attention_bwd_dkv"]),
           "geglu": ("geglu_mlp.cu", ["mf_geglu_mlp"]),
           "gn": ("group_norm_silu.cu", ["mf_group_norm_silu",
                                         "mf_group_norm_silu_max_clusters"])}
GN_PLAN_KEYS = ("max_cluster", "values_per_thread", "block_threads", "cluster_threads",
                "slice_bytes")
# GEGLU (rows, C): path shapes at 2, 16 and 64 UNet rows, ragged rows, and
# the narrow widths
# f32 attention checks beyond CHECKS: the classifier's shapes, wide heads
F32_CHECKS = [(256, 256, 128, 1, "tokens"), (257, 257, 128, 4, "tokens"),
              (77, 45, 272, 2, "tokens"), (129, 127, 2048, 2, "head"),
              (77, 1, 256, 8, "tokens"), (1024, 1024, 1024, 1, "head")]
GEGLU_CHECKS = [(2048, 256), (16384, 256), (4096, 512), (1024, 1024), (4096, 1024),
                (77, 256), (1000, 1024), (130, 16), (33, 48)]


def build(kernel, variants, out_dir, dtype="bfloat16"):
    """{name: [entry points]}; prints each build's ptxas lines for the
    kernels of ``dtype``."""
    from medfusion_tpu_torch.ops import build as B
    from medfusion_tpu_torch.ops import flash_attention as FA
    from medfusion_tpu_torch.ops import geglu as GL
    from medfusion_tpu_torch.ops import group_norm as G

    source, symbols = SOURCES[kernel]
    argtypes = {"fwd": [FA._ARGTYPES], "bwd": [FA._BWD_ARGTYPES] * 2,
                "geglu": [GL._ARGTYPES], "gn": [G._ARGTYPES, [ctypes.c_int] * 5]}[kernel]
    procs = {}
    for name, (src, macros) in variants.items():
        lib = out_dir / f"{name}.so"
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(src), *[f"-D{m}" for m in macros],
               "-o", str(lib), str(src / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print(f"== {name}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                tags = ("f32",) if dtype == "float32" else ("bf16", "bfloat16")
                entry = line.split("'")[1] if any(t in line for t in tags) else None
                entry = entry and entry.split("_GLOBAL__N__")[-1]
            elif entry and ("registers" in line or "spill" in line):
                print(f"   {entry[-60:]}: {line.strip()}")
            elif "warning" in line.lower():
                print(f"   {line.strip()}")
        cdll = ctypes.CDLL(str(lib))
        fns[name] = []
        for symbol, types in zip(symbols, argtypes):
            fn = getattr(cdll, symbol)
            fn.argtypes, fn.restype = types, ctypes.c_int
            fns[name].append(fn)
    return fns


def launch_fwd(fn, ops, scale):
    import torch

    q, k, v, o, lse = ops
    is_bf16 = int(q.dtype == torch.bfloat16)
    b, h, n, d = q.shape
    strides = (ctypes.c_longlong * 15)(*[s for t in (q, o, k, v) for s in t.stride()[:3]],
                                       *lse.stride())
    err = fn(is_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             b, h, n, k.shape[2], d, ctypes.cast(strides, ctypes.c_void_p), float(scale),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")


def launch_bwd(fn, ops, scale):
    import torch

    q, k = ops[0], ops[1]
    b, h, n, d = q.shape
    ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in ops])
    strides = (ctypes.c_longlong * 30)(*[s for t in ops for s in t.stride()[:3]])
    err = fn(int(q.dtype == torch.bfloat16), ctypes.cast(ptrs, ctypes.c_void_p), b, h, n,
             k.shape[2], d,
             ctypes.cast(strides, ctypes.c_void_p), float(scale * scale),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")


def fwd_operands(CS, FA, b, n, m, c, heads, layout, gen, dtype):
    """The forward kernel's operands (q, k, v, o, lse views) and scale."""
    q, k, v = CS.attn_inputs(b, n, m, c, dtype, gen)
    if layout == "head":
        ops = FA.flash_attention_forward_operands(*(FA._heads(t, heads) for t in (q, k, v)))
    else:
        ops = FA.flash_attention_forward_operands(q, k, v, heads)
    return ops, (c // heads) ** -0.25


def bwd_operands(CS, FA, b, n, m, c, heads, layout, gen, dtype):
    import torch

    q, k, v = CS.attn_inputs(b, n, m, c, dtype, gen)
    do = torch.randn((b, n, c), generator=gen, device="cuda").to(dtype)
    return CS.bwd_operands(FA, q, k, v, heads, layout, do)


def check_geglu(CS, fns, gen):
    """Each GEGLU variant against the plain version at GEGLU_CHECKS."""
    from medfusion_tpu_torch.ops import geglu as GL

    import torch

    ok_all = True
    tol = CS.GEGLU_TOL["bfloat16"]
    for rows, c in GEGLU_CHECKS:
        args = CS.geglu_inputs(rows, c, torch.bfloat16, gen)
        ref = GL.geglu_mlp_reference(*args)
        for name, (fn,) in fns.items():
            out = GL.launch(fn, *args)
            again = GL.launch(fn, *args)
            err = (out.float() - ref.float()).abs()
            ok = bool((err <= tol + tol * ref.float().abs()).all()) and torch.equal(out, again)
            ok_all &= ok
            print(f"check geglu M={rows} C={c}: {name} {'ok' if ok else 'FAIL'} "
                  f"{err.max().item():.2e}", flush=True)
    return ok_all


def geglu_split(fn_run):
    """Device ms of the up- and down-projection kernels per call (a profile
    of five eager calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn_run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn_run()
        torch.cuda.synchronize()
    split = {"up": 0.0, "down": 0.0}
    for e in prof.key_averages():
        for part in split:
            if f"geglu_{part}" in e.key:
                split[part] += e.self_device_time_total / 1e3 / 5
    return split


def times_geglu(CS, fns, gen):
    """Each GEGLU variant at the path's shapes, B=64 and the sampling
    batch, in turns, beside the plain version."""
    import torch

    from medfusion_tpu_torch.ops import geglu as GL

    per_fwd = dict.fromkeys(fns, 0.0)
    for rows_per_image in (CS.TIMING_BATCH["unet"], 2 * CS.N_SAMPLES):
        for n, c, _, launches, _ in CS.ATTN_SHAPES:
            rows = rows_per_image * n
            args = CS.geglu_inputs(rows, c, torch.bfloat16, gen)
            best = {}
            for name in list(fns) + list(fns)[::-1]:
                t = CS.graph_ms(lambda f=fns[name][0]: GL.launch(f, *args), 10)
                best[name] = min(best.get(name, t), t)
            plain = CS.graph_ms(lambda: GL.geglu_mlp_reference(*args), 3)
            bound = 6 * rows * c * 4 * c / CS.BF16_FLOPS_PER_S * 1e3
            splits = {name: geglu_split(lambda f=fns[name][0]: GL.launch(f, *args))
                      for name in fns}
            if rows_per_image == CS.TIMING_BATCH["unet"]:
                for name, t in best.items():
                    per_fwd[name] += launches * t
            print(f"ms geglu M={rows} C={c}: " + "; ".join(
                f"{name} {t:.4f} ({bound / t:.1%} of bound; up {splits[name]['up']:.4f}, "
                f"down {splits[name]['down']:.4f})" for name, t in best.items())
                + f"; plain {plain:.4f}; bound {bound:.4f}", flush=True)
            del args
    print("per CFG UNet forward (B=64): " + "; ".join(
        f"{name} {t:.4f}" for name, t in per_fwd.items()))


def gn_plan(G, plans, name, b, c, s, g, dtype, max_cluster=None):
    """Variant ``name``'s launch plan: ``launch_plan`` with its settings
    (a case's own ``max_cluster`` unless the variant sets one)."""
    kw = dict(plans[name])
    if max_cluster is not None:
        kw.setdefault("max_cluster", max_cluster)
    return G.launch_plan(b, c, s, g, dtype, **kw)


def gn_plan_text(G, plan, occupancy, dtype):
    if plan["route"] == "block":
        return (f"block {plan['group_threads']}x{plan['groups_per_block']} "
                f"u{plan['units']}")
    got = occupancy(G._IS_BF16[dtype], int(plan["vector"]), plan["threads"],
                    plan["cluster"], plan["smem_bytes"])
    return (f"cluster {plan['cluster']} x {plan['threads']} thr, {plan['smem_bytes']} B, "
            f"{got} resident")


def check_gn(CS, fns, plans, gen):
    """Each GroupNorm variant against the plain version at the path's
    shapes and GN_ROUTE_CASES (B=2), f32 and bf16, SiLU on and off, and bit
    for bit across two launches. A variant whose launch fails is reported
    and dropped from ``fns``."""
    import torch

    from medfusion_tpu_torch.ops import group_norm as G

    cases = ([(c, g, int(round(s ** 0.5)), None) for _, s, c, g, _ in CS.GN_SHAPES]
             + list(CS.GN_ROUTE_CASES))
    ok_all = True
    for dtype in (torch.float32, torch.bfloat16):
        tol = CS.TOL[str(dtype).split(".")[-1]]
        for c, g, side, max_cluster in cases:
            s = side * side
            x, scale, bias = CS.gn_inputs(2, s, c, dtype, gen)
            for name, (fn, occupancy) in list(fns.items()):
                plan = gn_plan(G, plans, name, 2, c, s, g, dtype, max_cluster)
                ok, worst = True, 0.0
                for silu in (True, False):
                    try:
                        out = G.launch(fn, x, scale, bias, g, 1e-5, silu, plan)
                        again = G.launch(fn, x, scale, bias, g, 1e-5, silu, plan)
                    except RuntimeError as err:
                        print(f"check gn C={c} G={g} S={s} {dtype}: {name} FAIL ({err}; "
                              f"plan {plan}): dropped", flush=True)
                        del fns[name]
                        ok_all = False
                        break
                    ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
                    err = (out.float() - ref.float()).abs()
                    worst = max(worst, err.max().item())
                    ok &= bool((err <= tol + tol * ref.float().abs()).all())
                    ok &= torch.equal(out, again)
                if name not in fns:
                    continue
                ok_all &= ok
                print(f"check gn C={c} G={g} S={s} {dtype}: {name} "
                      f"({gn_plan_text(G, plan, occupancy, dtype)}) "
                      f"{'ok' if ok else 'FAIL'} {worst:.2e}", flush=True)
    return ok_all


def times_gn(CS, fns, plans, gen):
    """Each GroupNorm variant at the path's nine shapes (bf16, SiLU, B=64
    UNet / B=32 VAE), in turns, beside F.group_norm + F.silu; sums per CFG
    UNet forward and per decode."""
    import torch
    import torch.nn.functional as F

    from medfusion_tpu_torch.ops import group_norm as G

    per = {where: dict.fromkeys(fns, 0.0) for where in ("unet", "vae")}
    for where, s, c, g, per_call in CS.GN_SHAPES:
        b = CS.TIMING_BATCH[where]
        x, scale, bias = CS.gn_inputs(b, s, c, torch.bfloat16, gen)
        reps = 20 if x.numel() < 2**26 else 5
        plan = {name: gn_plan(G, plans, name, b, c, s, g, torch.bfloat16) for name in fns}
        best = {}
        for name in list(fns) + list(fns)[::-1]:
            t = CS.graph_ms(lambda f=fns[name][0], p=plan[name]: G.launch(
                f, x, scale, bias, g, 1e-5, True, p), reps)
            best[name] = min(best.get(name, t), t)
        lib = CS.graph_ms(lambda: F.silu(F.group_norm(x, g, scale, bias, 1e-5)), reps)
        bound = CS.bounds(0, 2 * x.numel() * 2 + 2 * c * 2)["bound_ms"]
        for name, t in best.items():
            per[where][name] += per_call * t
        print(f"ms gn {where} B={b} S={s} C={c} G={g}: " + "; ".join(
            f"{name} {t:.4f} ({bound / t:.1%} of bound; "
            f"{gn_plan_text(G, plan[name], fns[name][1], torch.bfloat16)})"
            for name, t in best.items())
            + f"; library {lib:.4f}; bound {bound:.4f}", flush=True)
        del x
    print("per CFG UNet forward (B=64): " + "; ".join(
        f"{name} {t:.4f}" for name, t in per["unet"].items())
        + "; per decode (B=32): " + "; ".join(
        f"{name} {t:.4f}" for name, t in per["vae"].items()))


def check(kernel, CS, FA, fns, gen, plans=None, dtype=None):
    """Each variant against the plain version at CHECKS (float32: also
    F32_CHECKS, and two launches bit-equal); returns False if any fails."""
    import torch

    if kernel == "geglu":
        return check_geglu(CS, fns, gen)
    if kernel == "gn":
        return check_gn(CS, fns, plans, gen)
    ok_all = True
    f32 = dtype == torch.float32
    for n, m, c, heads, layout in CHECKS + (F32_CHECKS if f32 else []):
        if kernel == "fwd":
            ops, scale = fwd_operands(CS, FA, 2, n, m, c, heads, layout, gen, dtype)
            ro, rlse = FA.naive_attention_reference(*ops[:3], scale)
            ltol = CS.ATTN_LSE_TOL[str(dtype).split(".")[-1]]
            refs = [(ops[3], ro, CS.attn_o_tol(ro)), (ops[4], rlse, (ltol, ltol))]
        else:
            ops, scale = bwd_operands(CS, FA, 2, n, m, c, heads, layout, gen, dtype)
            grads = FA.flash_attention_backward_reference(*ops[:4], ops[8], ops[4], scale)
            refs = [(out, r, CS.attn_bwd_tol(r)) for out, r in zip(ops[5:8], grads)]
        first = None  # the first variant's outputs, name
        for name, entries in fns.items():
            outs = []
            for _ in range(2 if f32 else 1):
                for out, _, _ in refs:
                    out.fill_(float("nan"))
                for fn in entries:
                    (launch_fwd if kernel == "fwd" else launch_bwd)(fn, ops, scale)
                torch.cuda.synchronize()
                outs.append([out.clone() for out, _, _ in refs])
            errs = [(out.float() - r.float()).abs() for out, r, _ in refs]
            # NaN fails
            ok = all(bool((e <= atol + rtol * r.float().abs()).all())
                     for e, (_, r, (atol, rtol)) in zip(errs, refs))
            ok &= all(torch.equal(a, b) for a, b in zip(outs[0], outs[-1]))
            errs = [e.max().item() for e in errs]
            ok_all &= ok
            same = ""
            if first is None:
                first = (outs[0], name)
            else:
                equal = all(torch.equal(a, b) for a, b in zip(outs[0], first[0]))
                same = f"; bit-equal to {first[1]}: {equal}"
            print(f"check N={n} M={m} C={c} H={heads} {layout}: {name} "
                  f"{'ok' if ok else 'FAIL'} " + "/".join(f"{e:.2e}" for e in errs) + same,
                  flush=True)
    return ok_all


def times(kernel, CS, FA, fns, gen, plans=None, dtype=None):
    """Each variant's time at the path's shapes, in turns; the forward also
    beside SDPA on the same inputs."""
    import torch
    import torch.nn.functional as F

    if kernel == "geglu":
        return times_geglu(CS, fns, gen)
    if kernel == "gn":
        return times_gn(CS, fns, plans, gen)
    if dtype == torch.float32:
        return times_f32(kernel, CS, FA, fns, gen)
    totals = {name: [0.0] * len(entries) for name, entries in fns.items()}
    sdpa_total = 0.0
    for n, c, heads, _, layout in CS.ATTN_SHAPES:
        if kernel == "fwd":
            b = CS.TIMING_BATCH["unet"]
            ops, scale = fwd_operands(CS, FA, b, n, n, c, heads, layout, gen, dtype)
            go = launch_fwd
        else:
            b = CS.TRAIN_BATCH
            ops, scale = bwd_operands(CS, FA, b, n, n, c, heads, layout, gen, dtype)
            go = launch_bwd
        best = {}
        for name in list(fns) + list(fns)[::-1]:
            ts = [CS.graph_ms(lambda f=f: go(f, ops, scale), 20) for f in fns[name]]
            best[name] = [min(a, b) for a, b in zip(best.get(name, ts), ts)]
        for name, ts in best.items():
            totals[name] = [a + t for a, t in zip(totals[name], ts)]
        extra = ""
        if kernel == "fwd":
            sc = torch.tensor(scale, dtype=torch.bfloat16)
            qh, kh, vh = ops[:3]
            t_l = CS.graph_ms(lambda: F.scaled_dot_product_attention(
                qh * sc, kh * sc, vh, scale=1.0), 20)
            sdpa_total += t_l
            extra = f"; sdpa {t_l:.4f}"
        print(f"ms N={n} d={c // heads} {layout} B={b}: " + "; ".join(
            f"{name} " + "/".join(f"{t:.4f}" for t in ts) for name, ts in best.items())
            + extra, flush=True)
    print("sums: " + "; ".join(f"{name} " + "/".join(f"{t:.4f}" for t in ts)
                               for name, ts in totals.items())
          + (f"; sdpa {sdpa_total:.4f}" if kernel == "fwd" else ""))


def times_f32(kernel, CS, FA, fns, gen):
    """Each variant's f32 time at the classifier's shapes (B=8, token
    layout), in turns, the faster of each variant's two turns kept, beside
    SDPA's forward or backward on the same inputs; the backward prints each
    kernel's time and the pair's."""
    import torch
    import torch.nn.functional as F

    b = CS.N_SAMPLES
    for n, c, heads in CS.CLF_ATTN_SHAPES:
        if kernel == "fwd":
            ops, scale = fwd_operands(CS, FA, b, n, n, c, heads, "tokens", gen, torch.float32)
            go = launch_fwd
        else:
            ops, scale = bwd_operands(CS, FA, b, n, n, c, heads, "tokens", gen,
                                      torch.float32)
            go = launch_bwd
        best = {}
        for name in list(fns) + list(fns)[::-1]:
            ts = [CS.graph_ms(lambda f=f: go(f, ops, scale), 20) for f in fns[name]]
            best[name] = [min(a, b) for a, b in zip(best.get(name, ts), ts)]
        sc = torch.tensor(scale)
        leaves = [(t * sc).detach().requires_grad_() for t in ops[:2]] + [
            ops[2].detach().requires_grad_()]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, scale=1.0)

        lib = CS.graph_ms(sdpa, 20)
        what = "sdpa"
        if kernel == "bwd":
            lib = CS.graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, ops[4]), 20) - lib
            what = "sdpa backward"
        print(f"ms f32 N={n} H={heads} d={c // heads} tokens B={b}: " + "; ".join(
            f"{name} " + "/".join(f"{t:.4f}" for t in ts)
            + (f" (pair {sum(ts):.4f})" if len(ts) > 1 else "") for name, ts in best.items())
            + f"; {what} {lib:.4f}", flush=True)
        del ops, leaves


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="fwd")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="the attention kernels' route to check and time")
    parser.add_argument("variants", nargs="+",
                        help="name=dir[:MACRO,MACRO=1,plan_key=value]")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_attn_builds: no CUDA device")
    import chip_smoke as CS
    from medfusion_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32

    variants, plans = {}, {}
    for spec in args.variants:
        name, rest = spec.split("=", 1)
        src, _, macros = rest.partition(":")
        items = [m for m in macros.split(",") if m]
        plans[name] = {k: int(v) for k, _, v in (m.partition("=") for m in items)
                       if k in GN_PLAN_KEYS}
        variants[name] = (Path(src).resolve(),
                          [m for m in items if m.partition("=")[0] not in GN_PLAN_KEYS])
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(args.kernel, variants, Path(tmp), args.dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        dtype = getattr(torch, args.dtype)
        ok = check(args.kernel, CS, FA, fns, gen, plans, dtype)
        times(args.kernel, CS, FA, fns, gen, plans, dtype)
    print(CS.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
