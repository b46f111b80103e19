#!/usr/bin/env python3
"""Drive the PyTorch port (``medfusion_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. environment: torch, CUDA, the card's name and power limit;
2. build every kernel under ``medfusion_tpu_torch/csrc/`` from source;
3. each kernel against its plain PyTorch version on the card, at every shape
   of the main path, in float32 and bfloat16;
4. kernel times at the main path's batch (kernel, plain version, one
   PyTorch library call, and the card's bound for the same bytes);
5. the small ``smoke`` preset sampled on the card and on the CPU from the
   same latent and noise, float32;
6. the main path: the ``chest`` preset at full width, bfloat16, 8 samples,
   150 DDIM steps, eta 1, guidance 8, VAE decode, with the kernel launches
   counted;
7. a breakdown of that path: one CFG UNet step and one decode timed with
   CUDA events, and a profiled 5-step sample with its device time by kind.

The last three lines are the kernels' JSON, the card's name and power limit
as ``nvidia-smi`` gives them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peak device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12

# The GroupNorm(+SiLU) shapes of the chest path: (where, S, C, G, launches
# per UNet forward or per decode).
GN_SHAPES = (
    ("unet", 32 * 32, 256, 32, 10),
    ("unet", 16 * 16, 512, 32, 8),
    ("unet", 8 * 8, 1024, 32, 12),
    ("unet", 8 * 8, 512, 32, 2),
    ("unet", 16 * 16, 256, 32, 2),
    ("vae", 32 * 32, 512, 8, 2),
    ("vae", 64 * 64, 256, 8, 2),
    ("vae", 128 * 128, 128, 8, 2),
    ("vae", 256 * 256, 64, 8, 2),
)
STEPS, N_SAMPLES, GUIDANCE = 150, 8, 8.0
UNET_GN_PER_FORWARD = sum(s[4] for s in GN_SHAPES if s[0] == "unet")  # 34
VAE_GN_PER_DECODE = sum(s[4] for s in GN_SHAPES if s[0] == "vae")  # 8
TIMING_BATCH = {"unet": 64, "vae": 32}  # B=32 with CFG doubling the UNet rows
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gn_inputs(b, s, c, dtype, gen):
    import torch

    side = int(round(s ** 0.5))
    x = torch.randn((b, c, side, side), generator=gen, device="cuda") * 2.0 + 1.0
    scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    return x.to(dtype), scale.to(dtype), bias.to(dtype)


def phase_kernel_checks(G):
    """Phase 3: kernel vs plain version at every path shape, B=2."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        for where, s, c, g, _ in GN_SHAPES:
            for silu in (True, False):
                x, scale, bias = gn_inputs(2, s, c, dtype, gen)
                out = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu)
                ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
                worst[name] = max(worst.get(name, 0.0), err)
                log(f"  gn {where} S={s} C={c} G={g} {name} silu={silu}: "
                    f"max|d|={err:.3e} (atol=rtol={tol})")
    return worst


def phase_kernel_times(G):
    """Phase 4: times at the path's batch, bf16 with SiLU."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for where, s, c, g, per_call in GN_SHAPES:
        b = TIMING_BATCH[where]
        x, scale, bias = gn_inputs(b, s, c, torch.bfloat16, gen)
        reps = 20 if x.numel() < 2**26 else 5
        k = cuda_ms(lambda: G.group_norm_silu_cuda(x, scale, bias, g), reps)
        p = cuda_ms(lambda: G.group_norm_silu_reference(x, scale, bias, g), reps)
        lib = cuda_ms(lambda: F.silu(F.group_norm(x, g, scale, bias, 1e-5)), reps)
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * x.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(where=where, B=b, S=s, C=c, G=g, launches_per_call=per_call,
                         ms=k, plain_ms=p, library_ms=lib, bound_ms=bound))
        log(f"  gn {where} B={b} S={s} C={c} G={g}: kernel {k:.4f} ms, plain "
            f"{p:.4f} ms, library {lib:.4f} ms, bound {bound:.4f} ms "
            f"({bound / k:.1%} of bound)")
        del x
    return rows


def perturb_(module, gen):
    """Move a seeded model away from its zero-initialised output convs and
    its unit/zero norm affines, so that every comparison is non-vacuous."""
    import torch

    from medfusion_tpu_torch.nn.blocks import Norm

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d) and not m.weight.any():
                bound = (m.weight[0].numel()) ** -0.5
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen, device=p.device)
                             * 2 - 1) * bound)
            elif isinstance(m, Norm):
                for p, base in ((m.weight, 1.0), (m.bias, 0.0)):
                    p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen,
                                                     device=p.device))


def phase_smoke_vs_cpu():
    """Phase 5: smoke preset, f32, 10 steps, guidance 3, card vs CPU."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

    p = PRESETS["smoke"]
    cpu = build_pipeline(p, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    perturb_(cpu.noise_estimator, gen)
    perturb_(cpu.latent_embedder, gen)
    card = build_pipeline(p, device="cuda", seed=0)
    card.noise_estimator.load_state_dict(cpu.noise_estimator.state_dict())
    card.latent_embedder.load_state_dict(cpu.latent_embedder.state_dict())
    b, steps = 4, 10
    x_T = torch.randn((b, *p.latent_shape), generator=gen)
    noise = torch.randn((steps, 2, b, *p.latent_shape), generator=gen)
    cond = torch.tensor([0, 1, 0, 1])
    kw = dict(steps=steps, guidance_scale=3.0, eta=1.0)
    ref = cpu.denoise(x_T, condition=cond, noise=noise, **kw)
    out = card.denoise(x_T.cuda(), condition=cond.cuda(), noise=noise.cuda(), **kw)
    out = out.cpu()
    scale = max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    tol = 1e-4 * scale
    log(f"  smoke card vs cpu: images {tuple(out.shape)}, max|d|={err:.3e} "
        f"(tol 1e-4 x max(1, max|ref|) = {tol:.3e})")
    torch.testing.assert_close(out, ref, atol=tol, rtol=1e-4)


def phase_main_path(ops):
    """Phase 6: chest, bf16, B=8, 150 steps, CFG 8, decode."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

    p = PRESETS["chest"]
    t0 = time.perf_counter()
    f32 = build_pipeline(p, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perturb_(f32.noise_estimator, gen)
    perturb_(f32.latent_embedder, gen)
    pipe = build_pipeline(p, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    pipe.noise_estimator.load_state_dict(f32.noise_estimator.state_dict())
    pipe.latent_embedder.load_state_dict(f32.latent_embedder.state_dict())
    torch.cuda.synchronize()
    n_params = sum(q.numel() for q in pipe.noise_estimator.parameters())
    log(f"  built chest UNet ({n_params / 1e6:.1f} M params) + VAE in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, m in (("unet", pipe.noise_estimator), ("vae", pipe.latent_embedder)):
        bad = [k for k, q in m.state_dict().items() if q.device.type != "cuda"]
        if bad:
            raise RuntimeError(f"{name} tensors off the card: {bad[:3]}")

    # one UNet forward at full width: bf16 (kernel) against f32 (kernel),
    # f32 convs without TF32
    x = torch.randn((2, 8, 32, 32), generator=gen, device="cuda")
    t = torch.tensor([999, 500], device="cuda")
    c = torch.tensor([0, 1], device="cuda")
    with torch.no_grad():
        y32, _ = f32.noise_estimator(x, t, c)
        y16, _ = pipe.noise_estimator(x.bfloat16(), t, c)
    rel = ((y16.float() - y32).abs().max() / y32.abs().max()).item()
    log(f"  chest UNet forward bf16 vs f32: max|d|/max|ref| = {rel:.3e} (limit 5e-2)")
    if not rel < 5e-2:
        raise RuntimeError(f"bf16 UNet departs from f32 by {rel:.3e}")
    del f32, y32, y16
    torch.cuda.empty_cache()

    cond = torch.arange(N_SAMPLES, device="cuda") % 2
    sgen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    imgs = pipe.sample(N_SAMPLES, p.latent_shape, condition=cond, generator=sgen,
                       steps=STEPS, guidance_scale=GUIDANCE, eta=1.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    expected = UNET_GN_PER_FORWARD * STEPS + VAE_GN_PER_DECODE
    log(f"  chest sample: {tuple(imgs.shape)} in {seconds:.3f} s = "
        f"{N_SAMPLES / seconds:.3f} samples/s; launches {launches} "
        f"(expected group_norm_silu {expected})")
    if tuple(imgs.shape) != (N_SAMPLES, 256, 256, 3):
        raise RuntimeError(f"images have shape {tuple(imgs.shape)}")
    if not torch.isfinite(imgs).all():
        raise RuntimeError("non-finite images")
    amax = imgs.abs().max().item()
    log(f"  image range [{imgs.min().item():.3f}, {imgs.max().item():.3f}]")
    if not 0 < amax < 1e4:
        raise RuntimeError(f"image magnitude {amax} out of range")
    if launches["group_norm_silu"] != expected:
        raise RuntimeError(f"group_norm_silu launched {launches['group_norm_silu']} "
                           f"times, expected {expected}")
    return launches, seconds, pipe


def phase_breakdown(pipe):
    """Phase 7: where a chest step's device time goes (B=8, CFG 8)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((N_SAMPLES, 8, 32, 32), generator=gen, device="cuda")
    t = torch.full((N_SAMPLES,), 500, device="cuda")
    cond = torch.arange(N_SAMPLES, device="cuda") % 2
    with torch.no_grad():
        step_ms = cuda_ms(lambda: pipe._guided_pred(x, t, cond, guidance_scale=GUIDANCE), 10)
        decode_ms = cuda_ms(lambda: pipe.decode_latent(x), 5)
        steps = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.denoise(x.movedim(1, -1), condition=cond, steps=steps,
                         guidance_scale=GUIDANCE, generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"group_norm_silu": 0.0, "conv": 0.0, "other": 0.0}
    # kernel rows only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:90]}")
    for e in kernels:
        us = e.self_device_time_total
        name = e.key.lower()
        if "gn_stats_kernel" in name or "gn_apply_kernel" in name:
            kind = "group_norm_silu"
        elif any(k in name for k in ("conv", "xmma", "cudnn", "implicit", "wgrad",
                                     "dgrad", "fprop", "nchwtonhwc", "nhwctonchw")):
            kind = "conv"
        else:
            kind = "other"
        by_kind[kind] += us / 1e3
    busy = sum(by_kind.values())
    log(f"  UNet step (CFG, B={2 * N_SAMPLES}): {step_ms:.3f} ms; decode "
        f"(B={N_SAMPLES}): {decode_ms:.3f} ms (CUDA events)")
    log(f"  profiled {steps}-step sample + decode: wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms ({busy / wall_ms:.1%}); "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in by_kind.items()))



def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "medfusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.ops import build
    from medfusion_tpu_torch.ops import group_norm as G

    t_all = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for stem, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {stem}: {line.strip()}")

    log("[3] kernels against their plain versions (B=2)")
    worst = phase_kernel_checks(G)

    log("[4] kernel times (bf16, SiLU on; CUDA events)")
    rows = phase_kernel_times(G)

    log("[5] smoke preset: card against CPU (float32)")
    phase_smoke_vs_cpu()

    log("[6] main path: chest, bf16")
    launches, seconds, pipe = phase_main_path(ops)

    log("[7] where a chest step's device time goes")
    phase_breakdown(pipe)
    del pipe

    per_fwd = sum(r["ms"] * r["launches_per_call"] for r in rows if r["where"] == "unet")
    per_dec = sum(r["ms"] * r["launches_per_call"] for r in rows if r["where"] == "vae")
    log(f"  group_norm_silu per UNet forward (B=64): {per_fwd:.4f} ms; "
        f"per decode (B=32): {per_dec:.4f} ms")

    kernels = [{
        "name": "group_norm_silu",
        "route": "cuda",
        "source": "medfusion_tpu_torch/csrc/group_norm_silu.cu",
        "replaces": "medfusion_tpu/ops/group_norm.py:25",
        "launches": launches["group_norm_silu"],
        "max_abs_err": worst["bfloat16"],
        # one launch at each of the 9 path shapes, at the path's batch
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
    }]
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
