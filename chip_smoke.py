#!/usr/bin/env python3
"""Drive the PyTorch port (``medfusion_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. environment: torch, CUDA, the card's name and power limit;
2. build every kernel under ``medfusion_tpu_torch/csrc/`` from source (each
   library's seconds, ptxas registers and spills);
3. each kernel against its plain PyTorch version on the card, at every shape
   of the main paths (GroupNorm also at every route of its launch plan:
   registers of a block, clusters of 2 to 16 blocks, a partly resident
   group, ragged runs, each bit for bit across two launches; flash
   attention in both layouts, with its lse, and its two backward kernels,
   also at head widths off 16/32/64/128, above 128 and off multiples of 8
   (4 and 12, on zero-padded copies); GEGLU also at the sampling batch,
   whose launch plan differs), in float32 and bfloat16;
4. kernel times at the flagship batch (kernel, plain version, one PyTorch
   library call where one computes the same function, and the card's bound
   for the same work; GroupNorm with its route, cluster size and the card's
   resident clusters), each timed launch also held to its plain version;
   the attention kernels (forward at the flagship batch, backward at the
   training batch) with the tensor rate each reaches and the SFU time of its
   exponentials, which their bounds include; the attention forward at the
   wide heads of ``attn_heads`` 4, 2 and 1 beside SDPA; GEGLU beside the two
   cuBLAS products of its matrix work (the library's floor for them);
5. the small ``smoke`` preset on the card and on the CPU from the same
   weights and draws, float32: sampled without attention and with spatial
   attention (one head, so head dims 16 and 32), and trained for two steps
   with spatial attention;
6. the sampling paths: the ``chest`` preset at full width, bfloat16, 8
   samples, 150 DDIM steps, eta 1, guidance 8, VAE decode, first without
   attention (slice 1), then with spatial attention (slice 2), then with
   spatial attention at 2 heads (head widths 128 to 512), each with the
   kernel launches counted from zero and checked against the counts derived
   here;
7. a breakdown of the spatial sampling path: one CFG UNet step and one
   decode timed with CUDA events, and a profiled 5-step sample with its
   device time by kind;
8. the training path (slice 3): the ``chest`` preset with spatial attention,
   bf16 compute with f32 masters, batch 32, AdamW + EMA steps on synthetic
   data, with the launches counted from zero and checked, a bf16 step's
   gradients against an f32 step's (and the same check shown to flag
   planted faults in the backward kernels), ms per step and samples/s, and
   a profiled step with its device time by kind;
9. the two-stage program (slice 8): first the smoke autoencoder's two
   training steps on the card against the CPU (f32); then through its
   CLIs, chest preset at full width, on a CheXpert_2 tree of grey PNGs
   written here: GroupNorm at the
   autoencoder's four f32 shapes at B=8 against its plain version, with the
   plan that runs there; ``cli.train_autoencoder`` (B=8, f32, 3 steps,
   checkpoints at 2 and 3, a reconstruction grid), a resume from step 2
   (restored state bit-equal, step-3 loss held); the autoencoder step's
   ms, peak memory, breakdown and GroupNorm backward recompute;
   ``cli.train_diffusion --vae-ckpt`` (B=32, bf16, EMA, 3 steps; its VAE
   bit-equal to the checkpoint); ``cli.sample --ckpt --ema`` (150 DDIM
   steps, CFG 8) bit-equal to a direct call; each CLI's launches counted
   from zero and checked; the loader's ms an image and a batch, in this
   process and in worker processes;
10. adversarial autoencoder training and the VQVAE (slice 9) through the
    autoencoder CLI on phase 9's tree, with the smoke adversarial steps card
    against CPU and GroupNorm at the conv discriminator's shapes;
11. the diffusion family's options (slice 10): every new sampler and option
    on the smoke preset card against CPU (SMOKE_TOL); at the chest preset's
    full width, ``cli.sample`` with DPM++ 25, EDM 18 Heun, the fast sampler
    (150 steps, encoder every 3) and DPM++ 25 with spatial attention, and
    ``cli.sample_dataset`` at B=32 with its PNG tree read back and its
    samples/s, each run's launches held to the counts derived from the
    module structure; one full-option training step (v, zero-terminal-SNR,
    Min-SNR 5, self-conditioning, learned variance, deep supervision) with
    its bf16 gradients against f32 and its ms beside the plain step's;
12. evaluation (slice 11), f32: InceptionV3, LPIPS (and its gradient,
    with two planted faults the check must flag), MS-SSIM and
    precision/recall on the card against the CPU; ``cli.evaluate_images``
    between a tree of grey 320x288 PNGs and a tree of chest samples from
    ``cli.sample_dataset``, and between that tree and one that overlaps it
    by half (its seconds, images/s, FID and precision/recall, and the same
    metrics from the CPU's features); the stored networks held to their
    sources key by key; precision/recall at 10k + 10k x 2048, chunked and not;
    ``cli.ingest_weights`` of seeded torchvision-layout files,
    ``cli.train_autoencoder --lpips`` plain and ``--gan`` (launches, ms a
    step, peak memory), ``cli.evaluate_latent_embedder`` and ``cli.helpers
    latent-stats`` on its checkpoint.

The last three lines are the kernels' JSON, the card's name and power limit
as ``nvidia-smi`` gives them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense), for the bounds.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

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
# The spatial transformers of the chest UNet with use_attention='spatial':
# (tokens N, width C, heads, transformers per UNet forward, attention entry).
# Levels 1-3 attend at 32^2, 16^2 and 8^2 (the middle at 8^2); each level
# has 2 encoder and 3 decoder stages, and the decoder's first stage of level
# i runs at the width of level i - 1. N >= 1024 takes the head layout.
ATTN_SHAPES = (
    (32 * 32, 256, 8, 5, "head"),
    (16 * 16, 512, 8, 4, "tokens"),
    (16 * 16, 256, 8, 1, "tokens"),
    (8 * 8, 1024, 8, 5, "tokens"),
    (8 * 8, 512, 8, 1, "tokens"),
)
TRANSFORMERS = sum(s[3] for s in ATTN_SHAPES)  # 16
STEPS, N_SAMPLES, GUIDANCE = 150, 8, 8.0
UNET_GN_PER_FORWARD = sum(s[4] for s in GN_SHAPES if s[0] == "unet")  # 34
VAE_GN_PER_DECODE = sum(s[4] for s in GN_SHAPES if s[0] == "vae")  # 8
# each spatial transformer adds two GroupNorms without SiLU (its own norm
# and its self-attention's norm_x), one attention and one GEGLU MLP; the
# cross-attention against the one embedding token launches nothing
EXPECTED = {
    "none": {"group_norm_silu": UNET_GN_PER_FORWARD * STEPS + VAE_GN_PER_DECODE},
    "spatial": {
        "group_norm_silu": (UNET_GN_PER_FORWARD + 2 * TRANSFORMERS) * STEPS
        + VAE_GN_PER_DECODE,
        "flash_attention": STEPS * sum(s[3] for s in ATTN_SHAPES if s[4] == "head"),
        "flash_attention_tokens": STEPS * sum(s[3] for s in ATTN_SHAPES
                                              if s[4] == "tokens"),
        "geglu_mlp": STEPS * TRANSFORMERS,
    },
}
TIMING_BATCH = {"unet": 64, "vae": 32}  # B=32 with CFG doubling the UNet rows
# The training path: chest, spatial attention, batch 32 (the JAX package's
# diffusion_batch_size), bf16 compute. The frozen VAE encoder runs the
# decoder's GroupNorm shapes (2 norms at each of 256^2x64, 128^2x128,
# 64^2x256, 32^2x512); the GroupNorm and GEGLU backward recompute through
# their plain versions and launch nothing; each self-attention launches its
# forward, then the dQ and the dK/dV kernel once.
TRAIN_BATCH, TRAIN_STEPS = 32, 5
VAE_GN_PER_ENCODE = VAE_GN_PER_DECODE
TRAIN_EXPECTED_PER_STEP = {
    "group_norm_silu": UNET_GN_PER_FORWARD + 2 * TRANSFORMERS + VAE_GN_PER_ENCODE,
    "flash_attention": EXPECTED["spatial"]["flash_attention"] // STEPS,
    "flash_attention_tokens": EXPECTED["spatial"]["flash_attention_tokens"] // STEPS,
    "flash_attention_bwd_dq": TRANSFORMERS,
    "flash_attention_bwd_dkv": TRANSFORMERS,
    "geglu_mlp": TRANSFORMERS,
}
# head widths the attention kernels reach by zero-padded copies (4, 12:
# not multiples of 8), by zero-filled columns (8, 24) or by 128-column
# chunks (136 and up; at 136 the last chunk is one half), held to the plain
# versions in phase 3
WIDE_HEAD_DIMS = (4, 12, 8, 24, 136, 256, 512, 1024)
# GroupNorm plans beyond the path's shapes, held to the plain version in
# phase 3 at B=2: (C, G, side, max_cluster): eight one-warp groups a block
# and four two-warp groups a block; clusters of 2, 4, 8 and 16 blocks
# (bf16; f32 doubles the cluster up to 16); a 2 MB f32 group on 8 blocks,
# partly resident; ragged runs on a block (n = 588) and on a cluster (n =
# 50,700)
GN_ROUTE_CASES = ((256, 32, 8, 16), (512, 32, 8, 16), (512, 8, 32, 16), (256, 8, 64, 16),
                  (128, 8, 128, 16), (64, 8, 256, 16), (64, 8, 256, 8), (48, 4, 7, 16),
                  (24, 8, 130, 16))
# the flagship batch's attention shapes at attn_heads 4, 2 and 1 (tokens N,
# width C, heads), timed in phase 4 beside SDPA, recorded and not judged
WIDE_ATTN_SHAPES = ((64, 1024, 4), (256, 512, 2), (64, 1024, 2), (1024, 256, 1),
                    (256, 512, 1), (64, 1024, 1))
# the sampling run at attn_heads 2 (head widths 128 at 32^2, 256 and 128 at
# 16^2, 512 and 256 at 8^2): same launches as at 8 heads
WIDE_SAMPLE_HEADS = 2
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# The two-stage program (phase 9): the CLIs on a CheXpert_2 tree of PNGs at
# the chest preset's full width. The autoencoder trains at B=8 in f32; each
# step's forward launches the encoder's and the decoder's GroupNorms (the
# backward recomputes through the plain version and launches nothing), and
# so does the reconstruction grid at step AE_STEPS. The diffusion stage
# trains at B=32 in bf16 from the autoencoder's checkpoint (UNet forward +
# frozen encoder a step), then cli.sample draws --n 4 per condition (0, 1,
# unconditioned): 150 DDIM steps, CFG 8 on the labelled ones, one decode
# each.
TWO_STAGE_IMAGES, TWO_STAGE_SIDE = 48, (320, 288)  # H, W: resized and cropped
AE_BATCH, AE_STEPS, AE_CKPT_EVERY = 8, 3, 2
AE_GN_PER_STEP = VAE_GN_PER_ENCODE + VAE_GN_PER_DECODE  # 16
DIFF_STEPS, SAMPLE_N = 3, 4
# the four GroupNorm shapes of the autoencoder (C, side), G=8, f32, B=8
AE_GN_SHAPES = ((64, 256), (128, 128), (256, 64), (512, 32))
# the resumed autoencoder run's step-3 loss against the uninterrupted one:
# the same restored weights, batch and draws; cuDNN's forward is
# deterministic for one algorithm, its backward is not, so the weights
# after the step are compared and reported, and the loss is held to f32
# rounding
AE_RESUME_LOSS_RTOL = 1e-6
LOADER_WORKERS = (4, 7)  # the card host has 8 cores
# The adversarial autoencoder (phase 10): the CLI on phase 9's tree, chest at
# full width, B=8, f32, one discriminator per pyramid level (2). Each of the
# conv discriminator's 5 BasicBlocks launches one GroupNorm+SiLU (G=32, 1
# to 16 channels a group); a step with the GAN on runs D(pred) in the
# generator's step and D(real), D(fake) in the discriminator's, at both
# levels; the PatchGAN has BatchNorm and launches none. The VQVAE has the
# VAE's GroupNorms.
DISC_GN_PER_FORWARD = 5
GAN_GN_PER_STEP = {"off": AE_GN_PER_STEP,  # 16
                   "conv": AE_GN_PER_STEP + 2 * 3 * DISC_GN_PER_FORWARD,  # 46
                   "patch": AE_GN_PER_STEP}  # 16
# the conv discriminator's GroupNorm shapes (C, side), G=32, f32: level 0
# (256^2 input), then level 1 (128^2); 128^2 x 32 is a group of exactly the
# block route's budget (16,384)
DISC_GN_SHAPES = ((32, 256), (64, 128), (128, 64), (256, 32), (512, 16),
                  (32, 128), (64, 64), (128, 32), (256, 16), (512, 8))
# the VAEGAN run: 3 batches with --start-gan-step 1, so the generator's
# (optimizer steps 2 and 4) and the discriminator's terms (3 and 5) are on
# in batches 2 and 3; checkpoints at 2 and 3, a resume from 2
GAN_STEPS, GAN_START = 3, 1
# the smoke adversarial step, card against CPU: both steps' metrics at rtol
# 1e-4, the first step's gradients of each player within 1e-4 of its
# largest |g| (f32 convs summed in another order, no TF32)
GAN_SMOKE_RTOL = 1e-4
# attention lse: f32 sums of the same products in another order (bfloat16:
# of the same bf16 q*s and k*s); o's tolerance is attn_o_tol's
ATTN_LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
# GEGLU: float32 sums over C and F in another order; bfloat16 rounds h and
# gate once (the kernel) or after the product and again after the bias (the
# module path), and an ulp flip of g moves the F-long down-projection sum
GEGLU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# bf16 training step against the f32 step on the same weights and draws:
# each parameter tensor's gradient held against its own f32 gradient,
# |g16 - g32|_2 / |g32|_2, the worst of the 721 tensors against the limit.
# bf16 keeps 8 significant bits (2^-8 = 3.9e-3 a rounding) and the backward
# rounds at every layer. The same check then runs on each planted fault (a
# backward kernel's output zeroed after its launch, at one head dim, on the
# heads given) and must flag every one, so a fault confined to a few
# attention layers cannot hide under the larger gradients elsewhere. On an
# H100 the sound step reads 2.1e-2 (an 8² attention's to_q) and the four
# faults 0.38-1.0; the limit sits between, a factor of ~4 from each.
TRAIN_GRAD_REL_LIMIT = 1e-1
# (label, wrapper, operand of flash_attention_backward_operands: 5 dq, 6 dk,
# 7 dv, head dim, heads)
PLANTED_FAULTS = (
    ("dq zeroed at d=32, every head", "flash_attention_bwd_dq", 5, 32, slice(None)),
    ("dq zeroed at d=128, head 0", "flash_attention_bwd_dq", 5, 128, 0),
    ("dk zeroed at d=64, head 0", "flash_attention_bwd_dkv", 6, 64, 0),
    ("dv zeroed at d=64, head 0", "flash_attention_bwd_dkv", 7, 64, 0),
)
# The diffusion family's options (phase 11). Smoke card-vs-CPU comparisons
# at the smoke sampling check's tolerance (phase 5): 1e-4 x max(1, max|ref|), rtol 1e-4.
SMOKE_TOL = 1e-4
# cli.sample at the chest preset: (name, flags, UNet forwards a sampling;
# None for the fast sampler, whose key steps run the whole UNet and whose
# other steps the middle and decoder alone). EDM's Heun skips its
# correction on the last transition: 2 x 18 - 1 forwards.
FAST_STEPS, FAST_KEY = 150, 3
OPTION_RUNS = (
    ("dpmpp-25", ["--sampler", "dpmpp", "--steps", "25"], 25),
    ("edm-18-heun", ["--sampler", "edm", "--steps", "18"], 2 * 18 - 1),
    ("fast-150-key3", ["--steps", str(FAST_STEPS), "--encoder-key-every", str(FAST_KEY)],
     None),
    ("dpmpp-25-spatial", ["--sampler", "dpmpp", "--steps", "25", "--attention", "spatial"],
     25),
)
# cli.sample_dataset at B=32 (guidance 1: one forward a step, no CFG rows):
# (name, flags, forwards a chunk)
DATASET_CHUNK = 32
DATASET_RUNS = (("ddim-150", ["--steps-list", "150"], 150),
                ("dpmpp-25", ["--sampler", "dpmpp", "--steps-list", "25"], 25))
OPT_TRAIN_STEPS = 3
# The evaluation stack (phase 12), f32, TF32 off. Card against CPU: the
# featuriser's features within EVAL_TOL["inception"] x max|f|, LPIPS and
# its gradient within EVAL_TOL["lpips"] (relative; the gradient of its
# max), MS-SSIM within EVAL_TOL["ms_ssim"], precision/recall equal or
# within 2/N. cli.evaluate_images on EVAL_IMAGES grey 320x288 PNGs against
# as many chest samples (cli.sample_dataset, DPM++ 25, B=32: chunks of 32,
# 32 and 11 a label) in batches of EVAL_BATCH (a ragged last batch on each
# side), then against as many PNGs that overlap it by half (precision and
# recall strictly between 0 and 1, where the first pair's are 0); FID from
# the CPU's features within EVAL_TOL["fid"] (relative). Precision/recall at the reference protocol's 10k samples a set of 2048-d
# features (a 16-d manifold projected, plus noise), chunked against not.
# The featuriser, VGG16 and the distance products launch no GroupNorm; the
# VAE's encode and decode launch 8 each.
EVAL_IMAGES, EVAL_BATCH = 150, 100
EVAL_TOL = {"inception": 1e-3, "lpips": 1e-4, "ms_ssim": 1e-5, "fid": 1e-2}
# LPIPS' gradient at 256^2 is ill-conditioned in f32: ReLU and max-pool
# switch points make it piecewise, and the unit normalisation amplifies a
# flip at a small feature; the CPU's own f32 gradient departs from its f64
# one by ~1e-2 of max|g| and ~1e-3 in L2 (and a 1e-6 relative change of
# the weights moves the f64 gradient by 3e-2 of its max). So the gradient
# is held at EVAL_TOL["lpips"] in f64 (card against CPU), and in f32 by its
# L2 departure from the CPU's f64 gradient. On an H100 (700 W) the card's
# f32 read 9.4e-4 and the CPU's own 1.09e-3, while two planted faults read
# 4.5e-2 (TF32 convolutions) and 0.31 (the fifth VGG stage left out); the
# limit sits between, and every run measures both faults again and fails
# unless each exceeds it.
LPIPS_F32_GRAD_L2 = 5e-3
PR_N, PR_DIM, PR_MANIFOLD = 10_000, 2048, 16
LPIPS_CLI_STEPS, EVAL_LE_BATCH, LATENT_STATS_N = 2, 32, 8


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sm_clock_hz():
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def cuda_ms(fn, reps):
    """Mean time of ``fn`` over ``reps`` back-to-back eager calls, after a
    warm-up (CUDA events): the device's time, or the host's where the
    Python wrapper takes longer than the kernel."""
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


def graph_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed (CUDA events): no host time between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def gn_inputs(b, s, c, dtype, gen):
    import torch

    side = int(round(s ** 0.5))
    assert side * side == s
    x = torch.randn((b, c, side, side), generator=gen, device="cuda") * 2.0 + 1.0
    scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    return x.to(dtype), scale.to(dtype), bias.to(dtype)


def attn_inputs(b, n, m, c, dtype, gen):
    """q [B, N, C], k/v [B, M, C] in the token layout."""
    import torch

    return tuple(torch.randn((b, r, c), generator=gen, device="cuda").to(dtype)
                 for r in (n, m, m))


def geglu_inputs(rows, c, dtype, gen):
    """x and the MLP's parameters; w1 and w2 as the transposed views of
    nn.Linear weights that the transformer block passes."""
    import torch

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * std + mean
        return t.to(dtype)

    f = 4 * c
    return (rnd(rows, c, std=2.0, mean=0.5), rnd(c, std=0.1, mean=1.0),
            rnd(c, std=0.1), rnd(2 * f, c, std=c ** -0.5).t(), rnd(2 * f, std=0.1),
            rnd(c, f, std=f ** -0.5).t(), rnd(c, std=0.1))


def attn_o_tol(ref):
    """(atol, rtol) for attention's o against the plain version's ``ref``.
    float32: 2e-5 (the same f32 products summed in another order). bfloat16:
    two bf16 ulps of max|ref|, no rtol. Both sides round q*s, k*s and o to
    bf16, and p to bf16 against the running (kernel) or the final (plain)
    row max; the f32 values rounded to o differ by well under an ulp, so o
    differs by at most one ulp of its own magnitude."""
    import torch

    if ref.dtype != torch.bfloat16:
        return 2e-5, 2e-5
    top = ref.abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7), 0.0


def keep(worst, kernel, name, err):
    """Record ``err`` as the kernel's largest error in dtype ``name``."""
    worst.setdefault(kernel, {})
    worst[kernel][name] = max(worst[kernel].get(name, 0.0), err)


def close(name, out, ref, atol, rtol):
    """Max |out - ref|, after asserting that they agree."""
    import torch

    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                               msg=lambda m: f"{name}: {m}")
    return err


def check_attention(FA, n, m, c, heads, dtype, gen):
    """Both entries against the plain version, o and lse, at B=2; returns
    the largest o error of each entry."""
    name = str(dtype).split(".")[-1]
    ltol = ATTN_LSE_TOL[name]
    q, k, v = attn_inputs(2, n, m, c, dtype, gen)
    scale = (c // heads) ** -0.25
    heads_of = [FA._heads(t, heads) for t in (q, k, v)]
    ro, rlse = FA.naive_attention_reference(*heads_of, scale)
    atol, rtol = attn_o_tol(ro)
    o, lse = FA.flash_attention_tokens_cuda(q, k, v, heads, scale)
    # the head entry on contiguous [B, H, N, D] copies
    oh, lseh = FA.flash_attention_cuda(*(t.contiguous() for t in heads_of), scale)
    tag = f"attn N={n} M={m} C={c} H={heads} {name}"
    errs = {"flash_attention_tokens": close(tag + " tokens o", FA._heads(o, heads),
                                            ro, atol, rtol),
            "flash_attention": close(tag + " head o", oh, ro, atol, rtol)}
    close(tag + " tokens lse", lse.transpose(1, 2), rlse, ltol, ltol)
    close(tag + " head lse", lseh, rlse, ltol, ltol)
    log(f"  {tag}: max|d| o tokens {errs['flash_attention_tokens']:.3e}, head "
        f"{errs['flash_attention']:.3e} (o atol {atol:.3e} rtol {rtol}; lse {ltol})")
    return errs


def attn_bwd_tol(ref):
    """(atol, rtol) for a backward kernel's gradient against the plain
    backward's ``ref``. float32: 2e-5 (the same products summed in another
    order). bfloat16: two bf16 ulps of max|ref|, no rtol: both sides round
    ds and p to bf16 at the same points, from f32 sums taken in another
    order, so an element of ds, and so of the gradient, may land one ulp
    apart."""
    import torch

    if ref.dtype != torch.bfloat16:
        return 2e-5, 2e-5
    top = ref.float().abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7), 0.0


def bwd_operands(FA, q, k, v, heads, layout, do):
    """The backward kernels' operands for token-layout q/k/v/do [B, N, C]:
    the forward kernel's o and lse, in the head layout (contiguous [B, H, N,
    D] copies) or the token layout ([B, H, N, D] views); at a D off
    multiples of 8, zero-padded copies (``pad_head_dim``, as the entries
    make them), so the gradients' padded columns are checked to be zero."""
    scale = (q.shape[2] // heads) ** -0.25
    if layout == "head":
        qh, kh, vh, doh = (FA._heads(t, heads).contiguous() for t in (q, k, v, do))
        o, lse = FA.flash_attention_cuda(qh, kh, vh, scale)
    else:
        o, lse = FA.flash_attention_tokens_cuda(q, k, v, heads, scale)
        qh, kh, vh, doh = (FA._heads(t, heads) for t in (q, k, v, do))
        o, lse = FA._heads(o, heads), lse.transpose(1, 2)
    qh, kh, vh, o, doh = FA.pad_head_dim(qh, kh, vh, o, doh)
    return FA.flash_attention_backward_operands(qh, kh, vh, o, lse, doh), scale


def check_bwd(FA, ops, scale, tag):
    """The kernels' dq, dk, dv (in ``ops``, after a launch of both) against
    the plain backward; returns {kernel: max error} (dk/dv: the larger)."""
    q, k, v, o, do, dq, dk, dv, lse, _ = ops
    rq, rk, rv = FA.flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    errs = {}
    for what, out, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[what] = close(f"{tag} {what}", out, ref, *attn_bwd_tol(ref))
    return {"flash_attention_bwd_dq": errs["dq"],
            "flash_attention_bwd_dkv": max(errs["dk"], errs["dv"])}


def check_attention_backward(FA, n, m, c, heads, dtype, gen):
    """Both backward kernels against the plain backward at B=2, in both
    layouts; returns the largest error of each kernel."""
    import torch

    name = str(dtype).split(".")[-1]
    q, k, v = attn_inputs(2, n, m, c, dtype, gen)
    do = torch.randn((2, n, c), generator=gen, device="cuda").to(dtype)
    worst = {}
    for layout in ("head", "tokens"):
        ops, scale = bwd_operands(FA, q, k, v, heads, layout, do)
        tag = f"attn bwd {layout} N={n} M={m} C={c} H={heads} {name}"
        FA.flash_attention_bwd_dq(ops, scale)
        FA.flash_attention_bwd_dkv(ops, scale)
        for kernel, err in check_bwd(FA, ops, scale, tag).items():
            worst[kernel] = max(worst.get(kernel, 0.0), err)
    log(f"  attn bwd N={n} M={m} C={c} H={heads} {name}: max|d| dq "
        f"{worst['flash_attention_bwd_dq']:.3e}, dk/dv "
        f"{worst['flash_attention_bwd_dkv']:.3e} (both layouts)")
    return worst


def check_geglu(GL, rows, c, dtype, gen):
    name = str(dtype).split(".")[-1]
    tol = GEGLU_TOL[name]
    args = geglu_inputs(rows, c, dtype, gen)
    out = GL.geglu_mlp_cuda(*args)
    ref = GL.geglu_mlp_reference(*args)
    err = close(f"geglu M={rows} C={c} {name}", out, ref, tol, tol)
    plan = GL.launch_shape(rows, c, 4 * c, dtype, torch_sms())
    log(f"  geglu M={rows} C={c} F={4 * c} {name} ({plan.block_rows} rows, "
        f"{plan.tiles_per_block} n-tiles a block): max|d|={err:.3e} (atol=rtol={tol})")
    return err


def torch_sms():
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def gn_route(G, b, c, s, g, dtype, plan=None):
    """The GroupNorm plan's route in words."""
    plan = plan or G._plan_for(b, c, s, g, dtype, True)
    if plan["route"] == "block":
        return (f"block: {plan['group_threads']} threads a group, {plan['groups_per_block']} "
                f"a block, {plan['units']} vectors a thread")
    return (f"cluster of {plan['cluster']}: {plan['slice']} a block, {plan['resident']} "
            f"resident, {plan['smem_bytes']} B shared, "
            f"{G.max_active_clusters(plan, dtype)} clusters resident on the card")


def check_gn_route(G, c, g, side, max_cluster, dtype, gen):
    """One GroupNorm plan (GN_ROUTE_CASES) at B=2 against the plain version,
    SiLU on and off, and the same bits from a second launch; returns the
    largest error."""
    import torch

    name = str(dtype).split(".")[-1]
    tol = TOL[name]
    s = side * side
    plan = G.launch_plan(2, c, s, g, dtype, max_cluster=max_cluster)
    worst = 0.0
    for silu in (True, False):
        x, scale, bias = gn_inputs(2, s, c, dtype, gen)
        out = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu, plan=plan)
        again = G.group_norm_silu_cuda(x, scale, bias, g, apply_silu=silu, plan=plan)
        ref = G.group_norm_silu_reference(x, scale, bias, g, apply_silu=silu)
        worst = max(worst, close(f"gn route C={c} G={g} S={s}", out, ref, tol, tol))
        if not torch.equal(out, again):
            raise RuntimeError(f"gn C={c} G={g} S={s} {name}: two launches differ")
    log(f"  gn route C={c} G={g} S={s} {name} ({gn_route(G, 2, c, s, g, dtype, plan)}): "
        f"max|d|={worst:.3e} (atol=rtol={tol}), bitwise equal across two launches")
    return worst


def phase_kernel_checks(G, FA, GL):
    """Phase 3: kernel vs plain version at every path shape. GroupNorm and
    attention at B=2 (they take the same tiles at any batch); GEGLU at
    the rows of B=2 and of the main path's batch (2 x N_SAMPLES UNet rows
    under CFG), whose launches split F differently."""
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
                err = close(f"gn {where} S={s} C={c}", out, ref, tol, tol)
                keep(worst, "group_norm_silu", name, err)
                log(f"  gn {where} S={s} C={c} G={g} {name} silu={silu} "
                    f"({gn_route(G, 2, c, s, g, dtype)}): max|d|={err:.3e} "
                    f"(atol=rtol={tol})")
        for c, g, side, max_cluster in GN_ROUTE_CASES:
            keep(worst, "group_norm_silu", name,
                 check_gn_route(G, c, g, side, max_cluster, dtype, gen))
        # every attention shape of the path, the smoke preset's head dims,
        # and N and M off the bf16 kernel's 64-row blocks and tiles at head
        # dims 16 to 128
        for n, m, c, heads in ([(n, n, c, h) for n, c, h, _, _ in ATTN_SHAPES]
                               + [(64, 64, 32, 2), (77, 45, 256, 4), (45, 77, 64, 4),
                                  (1000, 1024, 256, 8), (129, 127, 512, 4),
                                  (1, 64, 64, 4), (64, 3, 512, 4)]):
            for kernel, err in check_attention(FA, n, m, c, heads, dtype, gen).items():
                keep(worst, kernel, name, err)
        # head widths off the compiled 16/32/64/128 (zero-filled columns) and
        # above 128 (128-column chunks), two heads, N and M off the blocks
        wide = [(n, m, 2 * d, 2) for d in WIDE_HEAD_DIMS for n, m in ((77, 45), (129, 127))]
        for n, m, c, heads in wide:
            for kernel, err in check_attention(FA, n, m, c, heads, dtype, gen).items():
                keep(worst, kernel, name, err)
        # the backward at every training-path shape, ragged ones, and the
        # head widths above
        for n, m, c, heads in ([(n, n, c, h) for n, c, h, _, _ in ATTN_SHAPES]
                               + [(77, 45, 256, 4), (45, 77, 64, 4)] + wide):
            for kernel, err in check_attention_backward(FA, n, m, c, heads, dtype,
                                                        gen).items():
                keep(worst, kernel, name, err)
        for rows, c in ([(b * n, c) for b in (2, 2 * N_SAMPLES)
                         for n, c, _, _, _ in ATTN_SHAPES]
                         + [(77, 256), (130, 16), (1000, 1024), (1000, 512)]):
            keep(worst, "geglu_mlp", name, check_geglu(GL, rows, c, dtype, gen))
        torch.cuda.synchronize()
    return worst


def phase_kernel_times(G):
    """Phase 4: GroupNorm+SiLU times at the path's batch, bf16 with SiLU,
    each shape with its launch plan's route (below 50 MB the replayed
    launches find x in the 50 MB L2)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for where, s, c, g, per_call in GN_SHAPES:
        b = TIMING_BATCH[where]
        x, scale, bias = gn_inputs(b, s, c, torch.bfloat16, gen)
        reps = 20 if x.numel() < 2**26 else 5
        k = graph_ms(lambda: G.group_norm_silu_cuda(x, scale, bias, g), reps)
        eager = cuda_ms(lambda: G.group_norm_silu_cuda(x, scale, bias, g), reps)
        p = graph_ms(lambda: G.group_norm_silu_reference(x, scale, bias, g), reps)
        lib = graph_ms(lambda: F.silu(F.group_norm(x, g, scale, bias, 1e-5)), reps)
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * x.element_size()
        plan = G._plan_for(b, c, s, g, x.dtype, True)
        rows.append(dict(where=where, B=b, S=s, C=c, G=g, launches_per_call=per_call,
                         route=plan["route"], cluster=plan["cluster"],
                         ms=k, eager_ms=eager, plain_ms=p, library_ms=lib,
                         **bounds(0, nbytes)))
        bound = rows[-1]["bound_ms"]
        log(f"  gn {where} B={b} S={s} C={c} G={g} ({gn_route(G, b, c, s, g, x.dtype)}): "
            f"kernel {k:.4f} ms (eager {eager:.4f}), plain "
            f"{p:.4f} ms, library {lib:.4f} ms, bound {bound:.4f} ms "
            f"({bound / k:.1%} of bound)")
        del x
    return rows


def bounds(flops, nbytes, exp_ms=0.0):
    """The card's least time for the work, in ms, and its two parts: the
    operations (the tensor cores' bf16 FLOPs, or ``exp_ms``, the SFU's time
    for the work's exponentials, whichever is longer) and the bytes."""
    ops_ms = max(flops / BF16_FLOPS_PER_S * 1e3, exp_ms)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def exp_rate():
    """Exponentials a second: the SFU's 16 a clock on each SM at the card's
    maximum SM clock."""
    return 16 * torch_sms() * sm_clock_hz()


def phase_attention_geglu_times(FA, GL, worst):
    """Phase 4, continued: flash attention and GEGLU at the flagship batch
    (64 UNet rows), bf16, each at its path entry; bounds from this run's
    shapes: max(FLOPs / bf16 peak, bytes / HBM rate), and for attention also
    ``exp_ms``, the SFU's time for its BH*N*M exponentials (at 1,024 tokens
    d=32 the largest of the three). Attention prints its tensor rate, its
    share of the bound and its time beside SDPA's. Each timed launch is also
    held to its plain version, its error kept in ``worst``; GEGLU is timed
    and checked at the main path's batch too."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    b = TIMING_BATCH["unet"]
    sms = torch_sms()
    exp_per_s = exp_rate()
    attn, geglu = [], []
    for n, c, heads, per_fwd, layout in ATTN_SHAPES:
        d = c // heads
        scale = d ** -0.25
        q, k, v = attn_inputs(b, n, n, c, torch.bfloat16, gen)
        qh, kh, vh = (FA._heads(t, heads) for t in (q, k, v))
        if layout == "head":
            kern = lambda: FA.flash_attention_cuda(qh, kh, vh, scale)  # noqa: E731
            o = kern()[0]
        else:
            kern = lambda: FA.flash_attention_tokens_cuda(q, k, v, heads, scale)  # noqa: E731
            o = FA._heads(kern()[0], heads)
        ref = FA.naive_attention_reference(qh, kh, vh, scale)[0]
        err = close(f"attn {layout} B={b} N={n} C={c}", o, ref, *attn_o_tol(ref))
        keep(worst, "flash_attention" if layout == "head" else "flash_attention_tokens",
             "bfloat16", err)
        del o, ref
        sc = torch.tensor(scale, dtype=torch.bfloat16)
        t_k = graph_ms(kern, 20)
        t_e = cuda_ms(kern, 20)
        t_p = graph_ms(lambda: FA.naive_attention_reference(qh, kh, vh, scale), 3)
        t_l = graph_ms(lambda: F.scaled_dot_product_attention(qh * sc, kh * sc, vh,
                                                              scale=1.0), 20)
        flops = 4 * b * heads * n * n * d
        nbytes = 4 * b * n * c * 2 + b * heads * n * 4  # q, k, v, o; lse f32
        exp_ms = b * heads * n * n / exp_per_s * 1e3
        attn.append(dict(layout=layout, B=b, N=n, C=c, H=heads, d=d,
                         launches_per_forward=per_fwd, ms=t_k, eager_ms=t_e,
                         plain_ms=t_p, library_ms=t_l, exp_ms=exp_ms,
                         tflops=flops / t_k / 1e9, **bounds(flops, nbytes, exp_ms)))
        r = attn[-1]
        log(f"  attention {layout} B={b} N={n} H={heads} d={d}: max|d| o {err:.3e}; "
            f"kernel {t_k:.4f} ms (eager {t_e:.4f}) vs sdpa {t_l:.4f} ms "
            f"({t_k / t_l:.2f}x), plain {t_p:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"(FLOPs {flops / BF16_FLOPS_PER_S * 1e3:.4f}, bytes {r['bytes_ms']:.4f}, "
            f"exp_ms {exp_ms:.4f}): {r['bound_ms'] / t_k:.1%} of bound, "
            f"{r['tflops']:.1f} TFLOP/s")
        del q, k, v, qh, kh, vh
        geglu.append(geglu_times(GL, b * n, c, per_fwd, worst, gen, sms))
    # the main path's own batch: B=8 with CFG, 16 UNet rows (also held to
    # the plain version in phase 3)
    geglu_b8 = [geglu_times(GL, 2 * N_SAMPLES * n, c, per_fwd, worst, gen, sms)
                for n, c, _, per_fwd, _ in ATTN_SHAPES]
    torch.cuda.empty_cache()
    return attn, geglu, geglu_b8


def geglu_times(GL, rows, c, per_fwd, worst, gen, sms):
    """One GEGLU shape, bf16: held to the plain version, then the kernels'
    time (replayed graph and eager), the plain version's, and the two cuBLAS
    products of the same matrix work (xn [M, C] @ W1 [C, 2F] and g [M, F]
    @ W2 [F, C], timed only: the library's floor for the two-kernel
    design's products, not a call that computes the function). Bound: 6 M
    C F FLOPs, or reading x and the weights and writing the output once."""
    import torch

    f = 4 * c
    args = geglu_inputs(rows, c, torch.bfloat16, gen)
    tol = GEGLU_TOL["bfloat16"]
    err = close(f"geglu M={rows} C={c}", GL.geglu_mlp_cuda(*args),
                GL.geglu_mlp_reference(*args), tol, tol)
    keep(worst, "geglu_mlp", "bfloat16", err)
    t_k = graph_ms(lambda: GL.geglu_mlp_cuda(*args), 20)
    t_e = cuda_ms(lambda: GL.geglu_mlp_cuda(*args), 20)
    t_p = graph_ms(lambda: GL.geglu_mlp_reference(*args), 5)
    xn = torch.randn((rows, c), generator=gen, device="cuda").bfloat16()
    g = torch.randn((rows, f), generator=gen, device="cuda").bfloat16()
    w1, w2 = args[3], args[5]
    t_mm = graph_ms(lambda: xn @ w1, 20) + graph_ms(lambda: g @ w2, 20)
    flops = 6 * rows * c * f
    nbytes = (2 * rows * c + 3 * c * f + 2 * f + 3 * c) * 2
    row = dict(M=rows, C=c, F=f, launches_per_forward=per_fwd, ms=t_k, eager_ms=t_e,
               plain_ms=t_p, library_ms=None, cublas_products_ms=t_mm,
               tflops=flops / t_k / 1e9, **bounds(flops, nbytes))
    plan = GL.launch_shape(rows, c, f, torch.bfloat16, sms)
    log(f"  geglu M={rows} C={c} F={f} ({plan.block_rows} rows and {plan.tiles_per_block} "
        f"n-tiles an up-projection block, grids {plan.up_grid} and {plan.down_grid}): "
        f"max|d| {err:.3e}; kernel {t_k:.4f} ms (eager {t_e:.4f}), plain {t_p:.4f} ms "
        f"({t_p / t_k:.2f}x the kernel's time), cuBLAS products {t_mm:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_ms'] / t_k:.1%} of bound, "
        f"{row['tflops']:.1f} TFLOP/s)")
    return row


def phase_wide_attention_times(FA, worst):
    """Phase 4, continued: the attention forward at the flagship batch (64
    UNet rows), bf16, at the head widths of ``attn_heads`` 4, 2 and 1
    (WIDE_ATTN_SHAPES; 128-column chunks above d = 128), held to the plain
    version and timed beside SDPA: recorded, not judged."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    b = TIMING_BATCH["unet"]
    rows = []
    for n, c, heads in WIDE_ATTN_SHAPES:
        d = c // heads
        scale = d ** -0.25
        q, k, v = attn_inputs(b, n, n, c, torch.bfloat16, gen)
        qh, kh, vh = (FA._heads(t, heads) for t in (q, k, v))
        if n >= 1024:
            layout = "head"
            kern = lambda: FA.flash_attention_cuda(qh, kh, vh, scale)  # noqa: E731
            o = kern()[0]
        else:
            layout = "tokens"
            kern = lambda: FA.flash_attention_tokens_cuda(q, k, v, heads, scale)  # noqa: E731
            o = FA._heads(kern()[0], heads)
        ref = FA.naive_attention_reference(qh, kh, vh, scale)[0]
        err = close(f"attn {layout} B={b} N={n} d={d}", o, ref, *attn_o_tol(ref))
        keep(worst, "flash_attention" if layout == "head" else "flash_attention_tokens",
             "bfloat16", err)
        del o, ref
        sc = torch.tensor(scale, dtype=torch.bfloat16)
        t_k = graph_ms(kern, 10)
        t_l = graph_ms(lambda: F.scaled_dot_product_attention(qh * sc, kh * sc, vh,
                                                              scale=1.0), 10)
        flops = 4 * b * heads * n * n * d
        rows.append(dict(layout=layout, N=n, H=heads, d=d, ms=t_k, library_ms=t_l,
                         tflops=flops / t_k / 1e9))
        log(f"  wide heads: attention {layout} B={b} N={n} H={heads} d={d}: max|d| o "
            f"{err:.3e}; kernel {t_k:.4f} ms vs sdpa {t_l:.4f} ms ({t_k / t_l:.2f}x), "
            f"{flops / t_k / 1e9:.1f} TFLOP/s")
        del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return rows


def phase_attention_backward_times(FA, worst):
    """Phase 4, continued: the two backward kernels at the training batch
    (B=32), bf16, each at its path entry's layout. Each kernel is timed
    alone (CUDA events around a replayed graph of 20 launches) beside its
    plain version (the dQ part and the dK/dV part of the plain backward)
    and checked against the plain backward. Library: the backward of
    ``F.scaled_dot_product_attention(q*s, k*s, v, scale=1.0)`` (forward +
    backward minus forward, each a replayed graph, timed only), one call
    that yields dq, dk and dv together, so it stands beside the sum of the
    two kernels' times and is given in both rows. Bounds from this run's
    shapes: dQ 6*BH*N*M*d FLOPs and q, k, v, o, dO, lse read, dq and D
    written; dK/dV 8*BH*N*M*d FLOPs and q, k, v, dO, lse, D read, dk and dv
    written; and ``exp_ms``, the SFU's time for the kernel's BH*N*M
    exponentials at 16 a clock on each SM at the card's maximum SM clock,
    which the bound takes where it is longer than the FLOPs' time. Beside
    them, each row's tensor rate reached (its FLOPs over its time)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    b = TRAIN_BATCH
    exp_per_s = exp_rate()
    rows = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    for n, c, heads, per_fwd, layout in ATTN_SHAPES:
        d = c // heads
        q, k, v, do = attn_inputs(b, n, n, c, torch.bfloat16, gen) + (
            torch.randn((b, n, c), generator=gen, device="cuda").bfloat16(),)
        ops, scale = bwd_operands(FA, q, k, v, heads, layout, do)
        t_dq = graph_ms(lambda: FA.flash_attention_bwd_dq(ops, scale), 20)
        t_dkv = graph_ms(lambda: FA.flash_attention_bwd_dkv(ops, scale), 20)
        tag = f"attn bwd {layout} B={b} N={n} C={c}"
        for kernel, err in check_bwd(FA, ops, scale, tag).items():
            keep(worst, kernel, "bfloat16", err)
        qh, kh, vh, o, doh, _, _, _, lse, delta = ops
        p_dq = graph_ms(lambda: FA.flash_attention_bwd_dq_reference(
            qh, kh, vh, o, lse, doh, scale), 3)
        p_dkv = graph_ms(lambda: FA.flash_attention_bwd_dkv_reference(
            qh, kh, vh, lse, doh, delta, scale), 3)
        sc = torch.tensor(scale, dtype=torch.bfloat16)
        leaves = [(t * sc).detach().requires_grad_() for t in (qh, kh)] + [
            vh.detach().requires_grad_()]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, scale=1.0)

        t_fwd = graph_ms(sdpa, 10)
        t_both = graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, doh), 10)
        lib = t_both - t_fwd
        bh, e = b * heads, 2  # bf16 bytes
        tok = b * n * c * e  # one [B, N, C] bf16 tensor
        stat = bh * n * 4  # one [B, H, N] f32 vector (lse, D)
        shape = dict(layout=layout, B=b, N=n, C=c, H=heads, d=d,
                     launches_per_step=per_fwd, library_ms=lib)
        exp_ms = bh * n * n / exp_per_s * 1e3
        for kernel, t, p_t, flops in (("flash_attention_bwd_dq", t_dq, p_dq, 6),
                                      ("flash_attention_bwd_dkv", t_dkv, p_dkv, 8)):
            flops *= bh * n * n * d
            rows[kernel].append(dict(shape, ms=t, plain_ms=p_t, exp_ms=exp_ms,
                                     tflops=flops / t / 1e9,
                                     **bounds(flops, 6 * tok + 2 * stat, exp_ms)))
        r_dq, r_dkv = rows["flash_attention_bwd_dq"][-1], rows["flash_attention_bwd_dkv"][-1]
        log(f"  attention bwd {layout} B={b} N={n} H={heads} d={d}: "
            + "; ".join(f"{what} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                        f"{r['bound_ms']:.4f}, {r['bound_ms'] / r['ms']:.1%}; "
                        f"{r['tflops']:.1f} TFLOP/s)" for what, r in (("dQ", r_dq),
                                                                     ("dK/dV", r_dkv)))
            + f"; exp_ms {exp_ms:.4f} each; sum {t_dq + t_dkv:.4f} ms vs SDPA backward "
            f"{lib:.4f} ms (fwd+bwd {t_both:.4f}, fwd {t_fwd:.4f})")
        del q, k, v, do, ops, leaves
    torch.cuda.empty_cache()
    return rows


def perturb_(module, gen):
    """Move a seeded model away from its zero-initialised output convs and
    projections and its unit/zero norm affines, so that every comparison is
    non-vacuous."""
    import torch

    from medfusion_tpu_torch.nn.blocks import Norm

    with torch.no_grad():
        for m in module.modules():
            if (isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
                    and not m.weight.any()):
                bound = (m.weight[0].numel()) ** -0.5
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen, device=p.device)
                             * 2 - 1) * bound)
            elif isinstance(m, (Norm, torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
                for p, base in ((m.weight, 1.0), (m.bias, 0.0)):
                    p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen,
                                                     device=p.device))


def phase_smoke_vs_cpu(attention):
    """Phase 5: smoke preset, f32, 10 steps, guidance 3, card vs CPU; with
    attention, one head per level (head dims 16 and 32)."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

    p = PRESETS["smoke"]
    kw = dict(attention=attention, attn_heads=1 if attention != "none" else 8)
    cpu = build_pipeline(p, device="cpu", seed=0, **kw)
    gen = torch.Generator().manual_seed(0)
    perturb_(cpu.noise_estimator, gen)
    perturb_(cpu.latent_embedder, gen)
    card = build_pipeline(p, device="cuda", seed=0, **kw)
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
    log(f"  smoke attention={attention} card vs cpu: images {tuple(out.shape)}, "
        f"max|d|={err:.3e} (tol 1e-4 x max(1, max|ref|) = {tol:.3e})")
    torch.testing.assert_close(out, ref, atol=tol, rtol=1e-4)


def close_params(name, out, ref, lr, steps):
    """Parameters after ``steps`` AdamW steps against ``ref``: Adam's first
    steps move every element by about lr (m / sqrt(v) ~ sign(g)), so an
    element whose gradient is within rounding of 0 may move the other way
    on the other device: every element within 2 lr per step, and 99.9 % of
    them within 1e-3 lr (+ 1e-6 relative)."""
    worst, n_close, n = 0.0, 0, 0
    for k, r in ref.items():
        d = (out[k].detach().float().cpu() - r.detach().float().cpu()).abs()
        worst = max(worst, d.max().item())
        n_close += int((d <= 1e-3 * lr + 1e-6 * r.detach().abs().cpu()).sum())
        n += d.numel()
    log(f"  {name}: max|d| {worst:.3e} (limit {2 * lr * steps:.1e}), "
        f"{n_close / n:.5%} within 1e-3 lr")
    if not (worst <= 2 * lr * steps and n_close >= 0.999 * n):
        raise RuntimeError(f"{name} departs: max {worst}, {n_close}/{n} close")


def phase_smoke_train_vs_cpu():
    """Phase 5, continued: the smoke preset with spatial attention (one
    head: d = 16 and 32), f32, two AdamW + EMA steps on the card and on the
    CPU from the same weights, batch and draws. Losses within rtol 1e-4, the
    first step's gradients within 1e-4 of the largest |g| (f32 sums in
    another order, forward and backward), parameters and EMA as
    :func:`close_params`."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["smoke"]
    kw = dict(attention="spatial", attn_heads=1, seed=0)
    cpu = build_train_pipeline(p, device="cpu", **kw)
    gen = torch.Generator().manual_seed(5)
    perturb_(cpu.noise_estimator, gen)
    perturb_(cpu.latent_embedder, gen)
    card = build_train_pipeline(p, device="cuda", **kw)
    card.noise_estimator.load_state_dict(cpu.noise_estimator.state_dict())
    card.latent_embedder.load_state_dict(cpu.latent_embedder.state_dict())
    b = p.diffusion_batch_size
    batches = [{"source": torch.rand((b, 32, 32, 3), generator=gen) * 2 - 1,
                "target": torch.arange(b) % 2} for _ in range(2)]
    draws = [cpu.train_draws(b, p.latent_shape, generator=gen) for _ in range(2)]
    results = {}
    for name, pipe in (("cpu", cpu), ("card", card)):
        dev = pipe.device
        state = TrainState(pipe.noise_estimator, lr=p.diffusion_lr, use_ema=True)
        step = make_diffusion_train_step(pipe)
        losses, grads = [], None
        for batch, dr in zip(batches, draws):
            m = step(state, {k: v.to(dev) for k, v in batch.items()},
                     {k: v.to(dev) for k, v in dr.items()})
            losses.append(float(m["loss"]))
            if grads is None:
                grads = {k: q.grad.detach().cpu().clone()
                         for k, q in state.model.named_parameters()}
        results[name] = (losses, grads, dict(state.model.named_parameters()),
                         dict(state.ema.named_parameters()))
    (l_ref, g_ref, p_ref, e_ref), (l_out, g_out, p_out, e_out) = (
        results["cpu"], results["card"])
    log(f"  smoke training card vs cpu: losses {l_out} vs {l_ref}")
    torch.testing.assert_close(torch.tensor(l_out), torch.tensor(l_ref), rtol=1e-4, atol=0)
    top = max(g.abs().max().item() for g in g_ref.values())
    gerr = max((g_out[k] - g_ref[k]).abs().max().item() for k in g_ref)
    log(f"  smoke training step 1 gradients: max|d| {gerr:.3e} (limit 1e-4 x max|g| "
        f"= {1e-4 * top:.3e})")
    if not gerr <= 1e-4 * top:
        raise RuntimeError(f"card gradients depart from the CPU's by {gerr}")
    close_params("smoke training params after 2 steps", p_out, p_ref, p.diffusion_lr, 2)
    close_params("smoke training EMA after 2 steps", e_out, e_ref, p.diffusion_lr, 2)


def phase_main_path(ops, attention, attn_heads=8):
    """Phase 6: chest, bf16, B=8, 150 steps, CFG 8, decode, with the
    launches counted from zero and held to EXPECTED[attention] (the head
    count changes the head widths, not the launches)."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
    from medfusion_tpu_torch.nn.attention import SpatialTransformer

    p = PRESETS["chest"]
    t0 = time.perf_counter()
    f32 = build_pipeline(p, device="cuda", seed=0, attention=attention,
                         attn_heads=attn_heads)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perturb_(f32.noise_estimator, gen)
    perturb_(f32.latent_embedder, gen)
    pipe = build_pipeline(p, device="cuda", compute_dtype=torch.bfloat16, seed=0,
                          attention=attention, attn_heads=attn_heads)
    pipe.noise_estimator.load_state_dict(f32.noise_estimator.state_dict())
    pipe.latent_embedder.load_state_dict(f32.latent_embedder.state_dict())
    torch.cuda.synchronize()
    unet = pipe.noise_estimator
    n_params = sum(q.numel() for q in unet.parameters())
    n_st = sum(isinstance(m, SpatialTransformer) for m in unet.modules())
    log(f"  built chest UNet attention={attention} heads={attn_heads} "
        f"({n_params / 1e6:.1f} M params, "
        f"{n_st} spatial transformers) + VAE in {time.perf_counter() - t0:.1f} s")
    if n_st != (TRANSFORMERS if attention == "spatial" else 0):
        raise RuntimeError(f"{n_st} spatial transformers, the counts assume "
                           f"{TRANSFORMERS}")
    for name, m in (("unet", unet), ("vae", pipe.latent_embedder)):
        bad = [k for k, q in m.state_dict().items() if q.device.type != "cuda"]
        if bad:
            raise RuntimeError(f"{name} tensors off the card: {bad[:3]}")

    # one UNet forward at full width and the sampling batch's 16 rows (the
    # kernels' launches of the main path): bf16 (kernels) against f32
    # (kernels), f32 convs and matmuls without TF32
    rows = 2 * N_SAMPLES
    x = torch.randn((rows, 8, 32, 32), generator=gen, device="cuda")
    t = torch.linspace(999, 0, rows, device="cuda").long()
    c = torch.arange(rows, device="cuda") % 2
    with torch.no_grad():
        y32, _ = f32.noise_estimator(x, t, c)
        y16, _ = unet(x.bfloat16(), t, c)
    rel = ((y16.float() - y32).abs().max() / y32.abs().max()).item()
    log(f"  chest UNet forward heads={attn_heads} bf16 vs f32: max|d|/max|ref| = "
        f"{rel:.3e} (limit 5e-2)")
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
    expected = EXPECTED[attention]
    log(f"  chest attention={attention} heads={attn_heads} sample: {tuple(imgs.shape)} "
        f"in {seconds:.3f} "
        f"s = {N_SAMPLES / seconds:.3f} samples/s; launches {launches} "
        f"(expected {expected})")
    if tuple(imgs.shape) != (N_SAMPLES, 256, 256, 3):
        raise RuntimeError(f"images have shape {tuple(imgs.shape)}")
    if not torch.isfinite(imgs).all():
        raise RuntimeError("non-finite images")
    amax = imgs.abs().max().item()
    log(f"  image range [{imgs.min().item():.3f}, {imgs.max().item():.3f}]")
    if not 0 < amax < 1e4:
        raise RuntimeError(f"image magnitude {amax} out of range")
    for kernel, n in launches.items():
        if n != expected.get(kernel, 0):
            raise RuntimeError(f"{kernel} launched {n} times, expected "
                               f"{expected.get(kernel, 0)}")
    return launches, seconds, pipe


KINDS = ("group_norm_silu", "flash_attention", "flash_attention_bwd", "geglu_mlp",
         "conv", "matmul", "optimizer", "other")


def device_kernels(prof):
    """Kernel rows of a profile: device events without the user annotations
    (``Optimizer.step#...``), whose spans repeat their kernels' time."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def kind_of(kernel_name):
    name = kernel_name.lower()
    if "gn_block_kernel" in name or "gn_cluster_kernel" in name:
        return "group_norm_silu"
    if "flash_fwd" in name:
        return "flash_attention"
    if "flash_bwd" in name:
        return "flash_attention_bwd"
    if "adam" in name or "multi_tensor_apply" in name or "foreach" in name:
        return "optimizer"
    if "geglu_" in name:
        return "geglu_mlp"
    # cuDNN's FFT engines (f32 convs): the transforms, the complex products
    # and their complex GEMMs
    if any(k in name for k in ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                               "fprop", "nchwtonhwc", "nhwctonchw", "fft", "complex",
                               "cf32")):
        return "conv"
    if any(k in name for k in ("gemm", "xmma", "cutlass", "gemv", "sm90_", "nvjet")):
        return "matmul"
    return "other"


def phase_breakdown(pipe):
    """Phase 7: where a chest step's device time goes (B=8, CFG 8)."""
    import torch
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
    by_kind = dict.fromkeys(KINDS, 0.0)
    # kernel rows only: an operator's row repeats its kernels' time
    kernels = device_kernels(prof)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:90]}")
    for e in kernels:
        by_kind[kind_of(e.key)] += e.self_device_time_total / 1e3
    busy = sum(by_kind.values())
    log(f"  UNet step (CFG, B={2 * N_SAMPLES}): {step_ms:.3f} ms; decode "
        f"(B={N_SAMPLES}): {decode_ms:.3f} ms (CUDA events)")
    log(f"  profiled {steps}-step sample + decode: wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms ({busy / wall_ms:.1%}); "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in by_kind.items()))


def train_batches(p, n_batches, seed):
    """Synthetic chest batches on the card, as the training CLI makes them."""
    import torch

    from medfusion_tpu_torch.data import SimpleDataModule, SyntheticDataset2D

    ds = SyntheticDataset2D(n=TRAIN_BATCH * n_batches, image_size=p.image_size,
                            channels=p.in_channels, num_classes=p.num_classes, seed=seed)
    dm = SimpleDataModule(ds, batch_size=TRAIN_BATCH, seed=seed)
    return [{"source": torch.from_numpy(b["source"]).cuda(),
             "target": torch.from_numpy(b["target"]).long().cuda()}
            for b in dm.train_dataloader(0)]


def grads_of(pipe, batch, draws, dtype):
    """The loss and the gradients of the f32 masters at ``dtype`` compute
    (the train step's casts), without an optimizer step."""
    import torch

    from medfusion_tpu_torch.train.diffusion import estimator_params, with_compute_dtype

    unet = pipe.noise_estimator
    run = with_compute_dtype(pipe, dtype)
    loss, _ = run.train_loss(batch, draws, estimator_params=estimator_params(unet, dtype))
    names, masters = zip(*unet.named_parameters())
    grads = torch.autograd.grad(loss, masters, allow_unused=True)
    return loss.detach(), {k: (torch.zeros_like(q) if g is None else g)
                           for k, q, g in zip(names, masters, grads)}


def grad_departure(g, ref):
    """How far the gradients ``g`` depart from ``ref`` (name -> tensor):
    (the three worst tensors' |d|_2 / |ref|_2 with their names, worst
    first; max |d| over max |ref| across all elements). A tensor whose
    ``ref`` is all zero departs by 0 if its ``g`` is too, else by infinity.
    The key projections' biases are left out: softmax is invariant to a
    shift that is the same for every key, so their gradient is zero but
    for rounding in both dtypes."""
    rels = []
    for k, r in ref.items():
        if k.endswith("to_k.bias"):
            continue
        d, r_norm = (g[k] - r).norm().item(), r.norm().item()
        rels.append((d / r_norm if r_norm > 0 else (0.0 if d == 0 else math.inf), k))
    top = max(r.abs().max().item() for r in ref.values())
    return (sorted(rels, reverse=True)[:3],
            max((g[k] - r).abs().max().item() for k, r in ref.items()) / top)


@contextlib.contextmanager
def planted_fault(FA, wrapper, operand, head_dim, heads):
    """Within the block, every launch of the backward ``wrapper`` at
    ``head_dim`` is followed by zeroing its output ``operand`` on ``heads``."""
    real = getattr(FA, wrapper)

    def faulty(ops, scale):
        real(ops, scale)
        if ops[0].shape[3] == head_dim:
            ops[operand][:, heads].zero_()

    setattr(FA, wrapper, faulty)
    try:
        yield
    finally:
        setattr(FA, wrapper, real)


def check_train_grads(FA, pipe, batch, draws):
    """A bf16 loss and gradient against an f32 one on the same weights and
    draws, held to TRAIN_GRAD_REL_LIMIT; then each of PLANTED_FAULTS, which
    the same check must flag."""
    import torch

    l32, g32 = grads_of(pipe, batch, draws, None)
    l16, g16 = grads_of(pipe, batch, draws, torch.bfloat16)
    worst, glob = grad_departure(g16, g32)
    del g16
    log(f"  bf16 vs f32 step: loss {l16.item():.5f} vs {l32.item():.5f}; gradients: "
        f"worst tensors |d|_2/|g32|_2 = {fmt_worst(worst)} (limit "
        f"{TRAIN_GRAD_REL_LIMIT}); max|d|/max|g32| over all = {glob:.3e}")
    missed = []
    for label, *fault in PLANTED_FAULTS:
        with planted_fault(FA, *fault):
            _, gf = grads_of(pipe, batch, draws, torch.bfloat16)
        f_worst, f_glob = grad_departure(gf, g32)
        del gf
        log(f"  planted fault, {label}: worst tensors {fmt_worst(f_worst)}; "
            f"max|d|/max|g32| over all {f_glob:.3e}")
        if not f_worst[0][0] >= TRAIN_GRAD_REL_LIMIT:
            missed.append(label)
    del g32
    torch.cuda.empty_cache()
    if not (torch.isfinite(l16) and abs(l16.item() - l32.item()) <= 5e-2 * abs(l32.item())):
        raise RuntimeError(f"bf16 loss {l16.item()} departs from f32 {l32.item()}")
    if not worst[0][0] < TRAIN_GRAD_REL_LIMIT:
        raise RuntimeError(f"bf16 gradients depart from f32: {fmt_worst(worst)}")
    if missed:
        raise RuntimeError(f"the gradient check misses the planted faults {missed}")


def fmt_worst(worst):
    return ", ".join(f"{rel:.3e} ({name})" for rel, name in worst)


def phase_train_main_path(ops, FA):
    """Phase 8: the training path. Chest, spatial attention, 8 heads, bf16
    compute with f32 masters, B=32, AdamW (lr 1e-4, weight decay 0.01) +
    EMA, synthetic data: one warm-up step, then TRAIN_STEPS steps with the
    launches counted from zero and held to TRAIN_EXPECTED_PER_STEP; loss
    finite, masters f32; first :func:`check_train_grads`."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline
    from medfusion_tpu_torch.nn.blocks import Norm
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    t0 = time.perf_counter()
    pipe = build_train_pipeline(p, device="cuda", attention="spatial", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perturb_(pipe.noise_estimator, gen)
    perturb_(pipe.latent_embedder, gen)
    vae = pipe.latent_embedder
    enc_norms = sum(isinstance(m, Norm) for part in (vae.inc, vae.encoders, vae.out_enc)
                    for m in part.modules())
    if enc_norms != VAE_GN_PER_ENCODE:
        raise RuntimeError(f"the encoder has {enc_norms} GroupNorms, the counts assume "
                           f"{VAE_GN_PER_ENCODE}")
    batches = train_batches(p, 1 + TRAIN_STEPS, seed=0)
    draws = [pipe.train_draws(TRAIN_BATCH, p.latent_shape, generator=gen)
             for _ in batches]
    log(f"  built chest-spatial training pipeline and {len(batches)} batches of "
        f"{TRAIN_BATCH} in {time.perf_counter() - t0:.1f} s")

    check_train_grads(FA, pipe, batches[0], draws[0])  # no update

    state = TrainState(pipe.noise_estimator, lr=p.diffusion_lr, weight_decay=1e-2,
                       use_ema=True)
    step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
    step(state, batches[0], draws[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(state, b, d)["loss"] for b, d in zip(batches[1:], draws[1:])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses = [float(v) for v in losses]
    expected = {k: v * TRAIN_STEPS for k, v in TRAIN_EXPECTED_PER_STEP.items()}
    ms = seconds / TRAIN_STEPS * 1e3
    log(f"  chest-spatial training: {TRAIN_STEPS} steps at B={TRAIN_BATCH} in "
        f"{seconds:.3f} s = {ms:.1f} ms/step, {TRAIN_BATCH / ms * 1e3:.1f} samples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; losses "
        f"{[round(v, 5) for v in losses]}")
    log(f"  launches {launches} (expected {expected})")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite training loss {losses}")
    dtypes = {q.dtype for q in state.model.parameters()} | {
        q.dtype for q in state.ema.parameters()}
    if dtypes != {torch.float32}:
        raise RuntimeError(f"master or EMA parameters in {dtypes}")
    if state.step != 1 + TRAIN_STEPS:
        raise RuntimeError(f"state at step {state.step}")
    for kernel, n in launches.items():
        if n != expected.get(kernel, 0):
            raise RuntimeError(f"training: {kernel} launched {n} times, expected "
                               f"{expected.get(kernel, 0)}")
    return launches, ms, (state, step, batches[0], draws[0])


def phase_train_breakdown(train, step_ms):
    """Phase 8, continued: one profiled training step, its device time by
    kind, and the device's busy share of the profiled step's wall time and
    of ``step_ms``, the unprofiled step's (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, step, batch, draws = train
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = dict.fromkeys(KINDS, 0.0)
    kernels = device_kernels(prof)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:90]}")
    for e in kernels:
        by_kind[kind_of(e.key)] += e.self_device_time_total / 1e3
    busy = sum(by_kind.values())
    log(f"  profiled training step (B={TRAIN_BATCH}): wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%} of it, {busy / step_ms:.1%} of the "
        f"unprofiled {step_ms:.1f} ms step), {sum(e.count for e in kernels)} kernel "
        f"launches; " + ", ".join(f"{k} {v:.1f} ms" for k, v in by_kind.items()))
    # AdamW reads param, grad, m, v and writes param, m, v; the EMA reads
    # itself and the param and writes itself: 40 bytes per f32 parameter
    n_tensors = sum(1 for _ in state.model.parameters())
    n = sum(q.numel() for q in state.model.parameters())
    log(f"  {n_tensors} parameter tensors, {n / 1e6:.1f} M parameters: AdamW + EMA "
        f"bytes bound {bounds(0, 40 * n)['bound_ms']:.3f} ms, measured "
        f"{by_kind['optimizer']:.1f} ms")


def write_chexpert_tree(root, n, side, seed, first=0):
    """A CheXpert_2 tree as ``CheXpert_2_Dataset`` reads it: the two label
    CSVs (labels 0 and 1 only) and ``n`` seeded 8-bit grey PNGs of ``side``
    (H, W), smooth with noise, with all five row filters. Image i's smooth
    part is member ``first + i`` of a one-parameter family of waves."""
    import numpy as np

    from medfusion_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    (root / "labels").mkdir(parents=True)
    (root / "data").mkdir()
    rows, truth = ["Path,Image Index,fold"], ["Path,Frontal/Lateral,Cardiomegaly"]
    yy, xx = np.mgrid[:side[0], :side[1]]
    for i in range(n):
        path = f"CheXpert-v1.0/train/patient{i:05d}/study1/view1_frontal.jpg"
        rows.append(f"{path},{i + 1},train")
        truth.append(f"{path},Frontal,{float(i % 2)}")
        img = (128 + 60 * np.sin(xx / (9 + first + i)) * np.cos(yy / 13)
               + rng.normal(0, 12, side)).clip(0, 255).astype(np.uint8)
        write_png(root / "data" / f"{i + 1:06d}.png", img, filters=(0, 1, 2, 3, 4))
    (root / "labels" / "cheXPert_label.csv").write_text("\n".join(rows) + "\n")
    (root / "labels" / "train.csv").write_text("\n".join(truth) + "\n")


def check_gn_ae_shapes(G, worst):
    """Kernel 1 against its plain version at the autoencoder's four f32
    shapes at B=8, SiLU on and off, with the plan that ran there."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    tol = TOL["float32"]
    for c, side in AE_GN_SHAPES:
        s = side * side
        for silu in (True, False):
            x, scale, bias = gn_inputs(AE_BATCH, s, c, torch.float32, gen)
            out = G.group_norm_silu_cuda(x, scale, bias, 8, apply_silu=silu)
            ref = G.group_norm_silu_reference(x, scale, bias, 8, apply_silu=silu)
            keep(worst, "group_norm_silu", "float32",
                 close(f"gn ae C={c} S={s}", out, ref, tol, tol))
        log(f"  gn ae B={AE_BATCH} C={c} S={side}^2 G=8 f32 "
            f"({gn_route(G, AE_BATCH, c, s, 8, torch.float32)}): "
            f"max|d|<={worst['group_norm_silu']['float32']:.3e} (atol=rtol={tol})")
        del x, out, ref


def gn_recompute_ms(G):
    """The plain-version recompute of one autoencoder step's GroupNorm
    backward at B=8, f32 (CUDA events): each shape's backward, times the
    launches of the step at that shape (4: two in the encoder, two in the
    decoder)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    total = 0.0
    for c, side in AE_GN_SHAPES:
        x, scale, bias = gn_inputs(AE_BATCH, side * side, c, torch.float32, gen)
        x.requires_grad_(True)
        y = G.group_norm_silu(x, scale, bias, 8)
        dy = torch.randn_like(y)
        ms = cuda_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True), 5)
        total += 4 * ms
        del x, y, dy
    return total


def loader_times(root, seed):
    """Decode + transform ms per 256^2 item and per B=32 batch in this
    process, and per batch with each of LOADER_WORKERS worker processes:
    of 6 x workers batches, the last 4 x workers (after the start-up and
    the first round of prefetches)."""
    import numpy as np

    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset
    from medfusion_tpu_torch.data import SimpleDataModule

    ds = build_dataset(PRESETS["chest"], str(root), seed=seed)
    t0 = time.perf_counter()
    for i in range(TRAIN_BATCH):
        ds[i % len(ds)]
    item_ms = (time.perf_counter() - t0) / TRAIN_BATCH * 1e3
    out = {"item_ms": item_ms, "batch_ms": item_ms * TRAIN_BATCH}
    for workers in LOADER_WORKERS:
        dm = SimpleDataModule(ds, batch_size=TRAIN_BATCH, seed=seed, num_workers=workers)
        order = np.arange(6 * workers * TRAIN_BATCH) % len(ds)
        it = dm.batches(ds, order)
        for _ in range(2 * workers):
            next(it)
        t0 = time.perf_counter()
        n = sum(1 for _ in it)
        out[f"batch_ms_{workers}_workers"] = (time.perf_counter() - t0) / n * 1e3
    return out


def step_ms_and_breakdown(step, state, batch, arg, reps):
    """ms per step (host clock around ``reps`` synchronised steps after one
    warm-up), peak memory, and one profiled step's device time by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(state, batch, arg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, batch, arg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, arg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = dict.fromkeys(KINDS, 0.0)
    kernels = device_kernels(prof)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} {e.key[:90]}")
    for e in kernels:
        by_kind[kind_of(e.key)] += e.self_device_time_total / 1e3
    return ms, peak, wall_ms, by_kind


def fmt_kinds(by_kind):
    busy = sum(by_kind.values())
    return f"device busy {busy:.1f} ms: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in by_kind.items() if v)


def check_counts(what, launches, expected):
    log(f"  {what}: launches {launches} (expected {expected})")
    for kernel, n in launches.items():
        if n != expected.get(kernel, 0):
            raise RuntimeError(f"{what}: {kernel} launched {n} times, expected "
                               f"{expected.get(kernel, 0)}")


def phase_smoke_ae_vs_cpu():
    """Phase 9, first: the smoke preset's autoencoder with one
    deep-supervision head, f32, two Adam steps on the card and on the CPU
    from the same weights, batch and reparameterisation draws: both losses
    within rtol 1e-4 (the second one is of the updated weights) and the
    first step's gradients within 1e-4 of the largest |g|, as in
    :func:`phase_smoke_train_vs_cpu`. The weights after the steps are not
    held: Adam moves an element by about lr whatever its gradient, so the
    elements whose gradient is rounding noise (the loss sums 3 x 32^2
    elements an image) land up to 2 lr a step apart."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_vae
    from medfusion_tpu_torch.train import TrainState
    from medfusion_tpu_torch.train.autoencoder import (
        AutoencoderTrainer,
        make_autoencoder_train_step,
    )

    p = dataclasses.replace(PRESETS["smoke"], ae_deep_supervision=1)
    gen = torch.Generator().manual_seed(6)
    torch.manual_seed(0)
    cpu = build_vae(p)
    perturb_(cpu, gen)
    with torch.device("cuda"):
        card = build_vae(p)
    card.load_state_dict(cpu.state_dict())
    b = p.ae_batch_size
    batches = [torch.rand((b, p.image_size, p.image_size, 3), generator=gen) * 2 - 1
               for _ in range(2)]
    noises = [torch.randn((b, *p.latent_shape), generator=gen) for _ in range(2)]
    results = {}
    for name, vae in (("cpu", cpu), ("card", card)):
        dev = next(vae.parameters()).device
        state = TrainState(vae, lr=p.ae_lr, weight_decay=0.0)
        step = make_autoencoder_train_step(AutoencoderTrainer(
            vae, pixel_loss=p.ae_loss, embedding_loss_weight=p.ae_embedding_loss_weight))
        losses, grads = [], None
        for x, noise in zip(batches, noises):
            m = step(state, {"source": x.to(dev)}, noise.to(dev))
            losses.append(float(m["loss"]))
            if grads is None:
                grads = {k: q.grad.detach().cpu().clone() for k, q in vae.named_parameters()}
        results[name] = (losses, grads)
    (l_ref, g_ref), (l_out, g_out) = results["cpu"], results["card"]
    log(f"  smoke autoencoder training card vs cpu: losses {l_out} vs {l_ref}")
    torch.testing.assert_close(torch.tensor(l_out), torch.tensor(l_ref), rtol=1e-4, atol=0)
    top = max(g.abs().max().item() for g in g_ref.values())
    gerr = max((g_out[k] - g_ref[k]).abs().max().item() for k in g_ref)
    log(f"  smoke autoencoder step 1 gradients: max|d| {gerr:.3e} (limit 1e-4 x max|g| "
        f"= {1e-4 * top:.3e})")
    if not gerr <= 1e-4 * top:
        raise RuntimeError(f"card autoencoder gradients depart from the CPU's by {gerr}")


def phase_two_stage(ops, G, worst, tmp, root):
    """Phase 9: the two-stage program through its CLIs on PNG files (the
    CheXpert_2 tree ``root``; runs under ``tmp``), chest preset, full width:
    the autoencoder (B=8, f32) with checkpoints and a resume, the diffusion
    model (B=32, bf16, EMA) from its checkpoint, and cli.sample from the
    diffusion checkpoint's EMA; each run's launches counted from zero and
    held to the counts derived here."""
    import shutil

    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import sample, train_autoencoder, train_diffusion
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset, build_pipeline, build_vae
    from medfusion_tpu_torch.train import TrainState, make_lr_schedule
    from medfusion_tpu_torch.train.autoencoder import (
        AutoencoderTrainer,
        make_autoencoder_train_step,
    )
    from medfusion_tpu_torch.train.diffusion import make_diffusion_train_step
    from medfusion_tpu_torch.utils import checkpoint as C

    p = PRESETS["chest"]
    phase_smoke_ae_vs_cpu()
    check_gn_ae_shapes(G, worst)
    result = {}
    ae, ae_b = tmp / "ae", tmp / "ae_resumed"
    diff, out = tmp / "diffusion", tmp / "samples"

    # stage 1: the autoencoder, with a checkpoint at step 2 and the end
    common = ["--preset", "chest", "--data-root", str(root), "--device", "cuda",
              "--ckpt-every", str(AE_CKPT_EVERY), "--sample-every", str(AE_STEPS)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = train_autoencoder.main([*common, "--out", str(ae), "--max-steps",
                                            str(AE_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts("autoencoder CLI", ops.launch_counts(),
                 {"group_norm_silu": AE_GN_PER_STEP * (AE_STEPS + 1)})
    result["ae_launches"] = ops.launch_counts()["group_norm_silu"]
    log(f"  autoencoder CLI: {AE_STEPS} steps at B={AE_BATCH} (f32, 256^2) in {seconds:.1f} s "
        f"with loading and checkpoints; losses {losses}")
    if not all(math.isfinite(v) for v in losses) or state.step != AE_STEPS:
        raise RuntimeError(f"autoencoder: step {state.step}, losses {losses}")
    for c, side in AE_GN_SHAPES:
        plan = G._plan_for(AE_BATCH, c, side * side, 8, torch.float32, True)
        log(f"  plan that ran at C={c} S={side}^2: {plan['route']}, cluster "
            f"{plan['cluster']}, slice {plan['slice']}, resident {plan['resident']}")

    # resume: a run that holds only step 2 takes step 3
    (ae_b / "checkpoints").mkdir(parents=True)
    for name in ("step_2.pt", C.CONFIG_FILE):
        shutil.copy(ae / "checkpoints" / name, ae_b / "checkpoints" / name)
    saved = C.load_payload(ae / "checkpoints", AE_CKPT_EVERY)
    with torch.device("cuda"):
        restored = TrainState(build_vae(p), lr=p.ae_lr, weight_decay=0.0,
                              lr_schedule=make_lr_schedule("const"))
    C.restore_checkpoint(ae_b / "checkpoints", restored)
    for k, v in restored.state_dict()["model"].items():
        if not torch.equal(v.cpu(), saved["state"]["model"][k]):
            raise RuntimeError(f"restored {k} differs from the saved step 2")
    for k, v in restored.optimizer.state_dict()["state"].items():
        for name, t in v.items():
            if not torch.equal(t.cpu(), saved["state"]["optimizer"]["state"][k][name]):
                raise RuntimeError(f"restored Adam state {k}/{name} differs")
    state_b, losses_b = train_autoencoder.main([*common, "--out", str(ae_b),
                                                "--max-steps", str(AE_STEPS), "--resume"])
    final_a = C.load_payload(ae / "checkpoints")["state"]["model"]
    final_b = C.load_payload(ae_b / "checkpoints")["state"]["model"]
    d = max((final_a[k] - final_b[k]).abs().max().item() for k in final_a)
    log(f"  resume at step {AE_CKPT_EVERY}: step counter {state_b.step} (uninterrupted "
        f"{state.step}); restored weights and Adam moments bit-equal to the saved step; "
        f"step-{AE_STEPS} loss {losses_b[0]!r} vs {losses[-1]!r}; weights after it "
        f"max|d| = {d:.3e}")
    if state_b.step != state.step or len(losses_b) != 1:
        raise RuntimeError(f"resumed run at step {state_b.step}, losses {losses_b}")
    if abs(losses_b[0] - losses[-1]) > AE_RESUME_LOSS_RTOL * abs(losses[-1]):
        raise RuntimeError(f"resumed step-{AE_STEPS} loss {losses_b[0]} departs from "
                           f"{losses[-1]}")

    # the autoencoder step alone: ms, peak memory, breakdown
    ds = build_dataset(p, str(root))
    batch = {"source": torch.stack([torch.from_numpy(ds[i]["source"])
                                    for i in range(AE_BATCH)]).cuda()}
    noise = torch.randn((AE_BATCH, *p.latent_shape), device="cuda")
    ae_step = make_autoencoder_train_step(AutoencoderTrainer(
        state.model, pixel_loss=p.ae_loss, embedding_loss_weight=p.ae_embedding_loss_weight))
    ms, peak, wall, kinds = step_ms_and_breakdown(ae_step, state, batch, noise, 5)
    recompute = gn_recompute_ms(G)
    log(f"  autoencoder step (B={AE_BATCH}, f32, 256^2): {ms:.1f} ms/step, peak memory "
        f"{peak:.2f} GiB; profiled step wall {wall:.1f} ms, {fmt_kinds(kinds)}; "
        f"GroupNorm backward's plain recompute {recompute:.2f} ms a step "
        f"({recompute / ms:.1%} of the step)")
    result.update(ae_ms=ms, ae_peak=peak, ae_kinds=kinds, ae_recompute=recompute)
    del batch, ae_step, state, state_b, restored
    torch.cuda.empty_cache()

    # stage 2: the diffusion model from the autoencoder's checkpoint
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dstate, dlosses, pipe = train_diffusion.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(ae),
        "--out", str(diff), "--bf16", "--use-ema", "--max-steps", str(DIFF_STEPS),
        "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_step = UNET_GN_PER_FORWARD + VAE_GN_PER_ENCODE
    check_counts("diffusion CLI", ops.launch_counts(),
                 {"group_norm_silu": per_step * DIFF_STEPS})
    result["diff_launches"] = ops.launch_counts()["group_norm_silu"]
    vae_saved = C.load_payload(ae / "checkpoints")["state"]["model"]
    loaded = pipe.latent_embedder.state_dict()
    if set(loaded) != set(vae_saved) or not all(
            torch.equal(loaded[k].cpu(), vae_saved[k]) for k in vae_saved):
        raise RuntimeError("the diffusion stage's VAE differs from the autoencoder's")
    log(f"  diffusion CLI: {DIFF_STEPS} steps at B={TRAIN_BATCH} (bf16, EMA) in "
        f"{seconds:.1f} s with loading; losses {dlosses}; its VAE equals the "
        f"autoencoder checkpoint bit for bit ({len(vae_saved)} tensors)")
    if not all(math.isfinite(v) for v in dlosses) or dstate.step != DIFF_STEPS:
        raise RuntimeError(f"diffusion: step {dstate.step}, losses {dlosses}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    items = [ds[i] for i in range(TRAIN_BATCH)]
    dbatch = {"source": torch.from_numpy(np.stack([it["source"] for it in items])).cuda(),
              "target": torch.tensor([it["target"] for it in items]).cuda()}
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape, generator=gen)
    dstep = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
    dms, dpeak, dwall, dkinds = step_ms_and_breakdown(dstep, dstate, dbatch, draws, 3)
    log(f"  diffusion step (B={TRAIN_BATCH}, bf16, no attention): {dms:.1f} ms/step, "
        f"peak memory {dpeak:.2f} GiB; profiled step wall {dwall:.1f} ms, "
        f"{fmt_kinds(dkinds)}")
    result.update(diff_ms=dms)
    del dstate, pipe, dstep, dbatch, draws
    torch.cuda.empty_cache()

    # stage 3: samples from the diffusion checkpoint's EMA
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    images = sample.main(["--preset", "chest", "--ckpt", str(diff), "--ema",
                          "--vae-ckpt", str(ae), "--n", str(SAMPLE_N), "--out", str(out),
                          "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts("sample CLI", ops.launch_counts(),
                 {"group_norm_silu": 3 * (STEPS * UNET_GN_PER_FORWARD + VAE_GN_PER_DECODE)})
    result["sample_launches"] = ops.launch_counts()["group_norm_silu"]
    ema = C.load_payload(diff / "checkpoints")["state"]["ema"]
    direct = build_pipeline(p, device="cuda", compute_dtype=torch.bfloat16, seed=0,
                            unet_state=ema, vae_ckpt=ae)
    for cond in (0, 1, None):
        c = None if cond is None else torch.full((SAMPLE_N,), cond, device="cuda")
        want = direct.sample(SAMPLE_N, p.latent_shape, condition=c,
                             generator=torch.Generator(device="cuda").manual_seed(0),
                             steps=min(STEPS, p.timesteps),
                             guidance_scale=1.0 if cond is None else GUIDANCE,
                             eta=1.0).float().cpu().numpy()
        got = images[cond]
        side = p.image_size
        if got.shape != (SAMPLE_N, side, side, 3) or not np.isfinite(got).all():
            raise RuntimeError(f"samples of condition {cond}: {got.shape}, non-finite")
        if not np.array_equal(got, want):
            raise RuntimeError(f"cli.sample condition {cond} departs from the direct "
                               f"call by {np.abs(got - want).max()}")
    log(f"  sample CLI: {SAMPLE_N} images x 3 conditions, {STEPS} DDIM steps, CFG "
        f"{GUIDANCE}, in {seconds:.1f} s; equal to a direct call with the restored EMA "
        f"UNet and VAE, bit for bit")
    del direct
    torch.cuda.empty_cache()

    loader = loader_times(root, seed=0)
    log("  loading (decode + transform, 320x288 grey PNG -> 256^2 RGB): "
        f"{loader['item_ms']:.1f} ms an item, {loader['batch_ms']:.0f} ms a B={TRAIN_BATCH} "
        f"batch in this process; "
        + ", ".join(f"{w} workers {loader[f'batch_ms_{w}_workers']:.0f} ms a batch"
                    for w in LOADER_WORKERS)
        + f"; the diffusion step {dms:.1f} ms")
    result["loader"] = loader
    return result


def phase_smoke_gan_vs_cpu(disc):
    """Phase 10, first: the smoke autoencoder with one deep-supervision head
    and two ``disc`` discriminators, both players on from the first batch,
    two adversarial steps on the card and on the CPU from the same perturbed
    weights, batches and draws (f32), the card's second step from the CPU's
    state after the first: every metric of both steps (losses, lambdas,
    discriminator losses), the first step's gradients of each player
    (GAN_SMOKE_RTOL) and the card's own first update (check_first_update).
    Adam's first update moves each weight by about lr x sign(g), so a
    gradient that is rounding noise on both devices moves its weight 2 lr
    apart, and a second step from each device's own state departed by up to
    5.7e-4 relative (conv discriminators, 3 of 4 runs on an H100); from the
    same state it agrees to 3e-6."""
    import copy
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_discriminators, build_vae
    from medfusion_tpu_torch.train import GANTrainState
    from medfusion_tpu_torch.train.adversarial import (
        AdversarialTrainer,
        make_adversarial_train_step,
    )
    from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer

    p = dataclasses.replace(PRESETS["smoke"], ae_deep_supervision=1)
    gen = torch.Generator().manual_seed(7)
    torch.manual_seed(0)
    vae, discs = build_vae(p), build_discriminators(p, disc)
    perturb_(vae, gen)
    perturb_(discs, gen)
    b, side = p.ae_batch_size, p.image_size
    batches = [torch.rand((b, side, side, 3), generator=gen) * 2 - 1 for _ in range(2)]
    noises = [torch.randn((b, *p.latent_shape), generator=gen) for _ in range(2)]
    results, firsts, lr = {}, {}, 1e-4
    for dev in ("cpu", "cuda"):
        v, d = copy.deepcopy(vae).to(dev), copy.deepcopy(discs).to(dev)
        state = GANTrainState(v, d, lr=lr)
        step = make_adversarial_train_step(AdversarialTrainer(
            AutoencoderTrainer(v, pixel_loss=p.ae_loss,
                               embedding_loss_weight=p.ae_embedding_loss_weight),
            d, start_gan_train_step=-1))
        metrics, grads = [], None
        for i, (x, noise) in enumerate(zip(batches, noises)):
            if i == 1 and dev == "cuda":
                state.load_state_dict(firsts["cpu"])
            m = step(state, {"source": x.to(dev)}, noise.to(dev))
            metrics.append({k: float(val) for k, val in m.items()})
            if grads is None:
                grads = [{k: q.grad.detach().cpu().clone() for k, q in mod.named_parameters()}
                         for mod in (v, d)]
            if i == 0:
                firsts[dev] = copy.deepcopy(state.state_dict())
        results[dev] = metrics, grads
    (m_ref, g_ref), (m_out, g_out) = results["cpu"], results["cuda"]
    worst_m = max(abs(out[k] - ref[k]) / max(abs(ref[k]), 1e-6)
                  for ref, out in zip(m_ref, m_out) for k in ref)
    log(f"  smoke adversarial steps ({disc}) card vs cpu: step 1 loss {m_out[0]['loss']!r} vs "
        f"{m_ref[0]['loss']!r}, lambda_0 {m_out[0]['lambda_0']:.6g} vs "
        f"{m_ref[0]['lambda_0']:.6g}, lambda_1 {m_out[0]['lambda_1']:.6g} vs "
        f"{m_ref[0]['lambda_1']:.6g}, loss_1 {m_out[0]['loss_1']:.6g} vs "
        f"{m_ref[0]['loss_1']:.6g}; worst relative metric difference {worst_m:.2e}")
    for ref, out in zip(m_ref, m_out):
        if not (ref["lambda_0"] > 0 and ref["loss_1"] > 0):
            raise RuntimeError(f"smoke adversarial step: a closed term {ref}")
        for k in ref:
            torch.testing.assert_close(out[k], ref[k], rtol=GAN_SMOKE_RTOL, atol=1e-6,
                                       msg=lambda m, k=k: f"smoke {disc} {k}: {m}")
    for name, ref, out in zip(("generator", "discriminators"), g_ref, g_out):
        top = max(g.abs().max().item() for g in ref.values())
        gerr = max((out[k] - ref[k]).abs().max().item() for k in ref)
        log(f"  smoke adversarial step 1 ({disc}) {name} gradients: max|d| {gerr:.3e} (limit "
            f"{GAN_SMOKE_RTOL:g} x max|g| = {GAN_SMOKE_RTOL * top:.3e})")
        if not gerr <= GAN_SMOKE_RTOL * top:
            raise RuntimeError(f"card {name} gradients ({disc}) depart from the CPU's by {gerr}")
    check_first_update(disc, firsts["cpu"], firsts["cuda"], g_ref, lr)


def check_first_update(disc, cpu, card, g_ref, lr):
    """The card's own first adversarial step (both players' weights and
    Adam moments) against the CPU's, with bounds that follow from the
    gradient check (|g_card - g_cpu| <= GAN_SMOKE_RTOL x max|g|, a player's
    max) and Adam's first update, lr g / (|g| + eps): every weight within
    2 lr (1 + GAN_SMOKE_RTOL) + GAN_SMOKE_RTOL |w| (a noise gradient may
    flip its sign; a step on the CPU with one thread against eight reaches
    1.999 lr); a
    weight whose CPU gradient exceeds twice that limit and 1e-5 (its sign
    settled, |g| >> eps) within lr / 100 + GAN_SMOKE_RTOL |w|, so a skipped
    or garbled update fails; the moments in gradient units, m / (1 - b1)
    and sqrt(v / (1 - b2)), within the gradient limit."""
    import torch

    for key, name, grads in zip(("gen", "disc"), ("generator", "discriminators"), g_ref):
        top = max(g.abs().max().item() for g in grads.values())
        limit = GAN_SMOKE_RTOL * top
        worst_all = worst_set = worst_m = 0.0
        n_set = n_all = 0
        for i, (k, g) in enumerate(grads.items()):
            w_ref, w_out = cpu[key]["model"][k], card[key]["model"][k].cpu()
            over = (w_out - w_ref).abs() - GAN_SMOKE_RTOL * w_ref.abs()
            settled = g.abs() > max(2 * limit, 1e-5)
            worst_all = max(worst_all, over.max().item() / lr)
            if settled.any():
                worst_set = max(worst_set, over[settled].max().item() / lr)
            n_set, n_all = n_set + int(settled.sum()), n_all + g.numel()
            s_ref, s_out = cpu[key]["optimizer"]["state"][i], card[key]["optimizer"]["state"][i]
            for moment, units in (("exp_avg", lambda m: m / 0.1),
                                  ("exp_avg_sq", lambda v: torch.sqrt(v / 1e-3))):
                err = (units(s_out[moment].cpu()) - units(s_ref[moment])).abs().max().item()
                worst_m = max(worst_m, err)
        log(f"  smoke adversarial step 1 ({disc}) {name}: the card's own update, "
            f"max(|dw| - {GAN_SMOKE_RTOL:g}|w|) {worst_all:.3f} lr over all {n_all} weights "
            f"(limit 2(1 + {GAN_SMOKE_RTOL:g}) lr), {worst_set:.2e} lr over the {n_set} with a "
            f"settled sign (limit "
            f"0.01 lr); Adam moments in gradient units max|d| {worst_m:.3e} (limit {limit:.3e})")
        if not (worst_all <= 2.0 * (1 + GAN_SMOKE_RTOL) and worst_set <= 0.01 and worst_m <= limit and n_set > 0):
            raise RuntimeError(f"the card's first {name} update ({disc}) departs from the "
                               f"CPU's: {worst_all} lr, {worst_set} lr settled ({n_set}), "
                               f"moments {worst_m} > {limit}")


def check_gn_disc_shapes(G, worst):
    """Kernel 1 against its plain version at the conv discriminator's ten
    f32 shapes at B=8 (G=32), SiLU on and off, with the plan that runs
    there, and the same bits from a second launch."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    tol = TOL["float32"]
    for c, side in DISC_GN_SHAPES:
        s = side * side
        err = 0.0
        for silu in (True, False):
            x, scale, bias = gn_inputs(AE_BATCH, s, c, torch.float32, gen)
            out = G.group_norm_silu_cuda(x, scale, bias, 32, apply_silu=silu)
            again = G.group_norm_silu_cuda(x, scale, bias, 32, apply_silu=silu)
            ref = G.group_norm_silu_reference(x, scale, bias, 32, apply_silu=silu)
            err = max(err, close(f"gn disc C={c} S={s}", out, ref, tol, tol))
            if not torch.equal(out, again):
                raise RuntimeError(f"gn disc C={c} S={side}^2: two launches differ")
        keep(worst, "group_norm_silu", "float32", err)
        log(f"  gn disc B={AE_BATCH} C={c} S={side}^2 G=32 f32 (n={c // 32 * s}; "
            f"{gn_route(G, AE_BATCH, c, s, 32, torch.float32)}): max|d|={err:.3e} "
            f"(atol=rtol={tol}), bitwise equal across two launches")
        del x, out, again, ref


def gan_recompute_ms(G):
    """The plain-version recompute of one adversarial step's GroupNorm
    backward at B=8, f32 (CUDA events): the autoencoder's (as phase 9's) and
    the conv discriminators', each of the ten shapes backward 4 times (the
    lambda's and the generator's backward through D(pred), and the
    discriminator's through D(real) and D(fake))."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)
    total = 0.0
    for c, side in DISC_GN_SHAPES:
        x, scale, bias = gn_inputs(AE_BATCH, side * side, c, torch.float32, gen)
        x.requires_grad_(True)
        y = G.group_norm_silu(x, scale, bias, 32)
        dy = torch.randn_like(y)
        total += 4 * cuda_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True), 5)
        del x, y, dy
    return gn_recompute_ms(G) + total


def gan_step_setup(p, disc, start, model="vae", perceiver=None):
    """A chest GANTrainState on the card (seeded) and its step function;
    ``perceiver`` adds the LPIPS term."""
    import torch

    from medfusion_tpu_torch.cli.presets import build_discriminators, build_vae
    from medfusion_tpu_torch.train import GANTrainState
    from medfusion_tpu_torch.train.adversarial import (
        AdversarialTrainer,
        make_adversarial_train_step,
    )
    from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer

    with torch.device("cuda"):
        torch.manual_seed(0)
        vae, discs = build_vae(p, model), build_discriminators(p, disc)
    state = GANTrainState(vae, discs, lr=1e-6)
    step = make_adversarial_train_step(AdversarialTrainer(
        AutoencoderTrainer(vae, flavor=model, pixel_loss=p.ae_loss, perceiver=perceiver,
                           embedding_loss_weight=p.ae_embedding_loss_weight),
        discs, start_gan_train_step=start))
    return state, step


def phase_adversarial(ops, G, worst, tmp, root):
    """Phase 10: the adversarial autoencoder and the VQVAE family through
    ``cli.train_autoencoder`` on phase 9's tree (chest, full width, B=8,
    f32): VAEGAN with the conv discriminators (3 steps, the GAN on in the
    last two) and a resume; VAEGAN with the PatchGAN; the VQVAE with and
    without the GAN; ``cli.train_diffusion --vae-ckpt`` from the VAEGAN run.
    Also kernel 1 at the discriminators' shapes, the adversarial step's ms,
    memory and breakdown, and its GroupNorm launches per step."""
    import shutil

    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import train_autoencoder, train_diffusion
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset
    from medfusion_tpu_torch.utils import checkpoint as C

    p = PRESETS["chest"]
    for disc in ("conv", "patch"):
        phase_smoke_gan_vs_cpu(disc)
    check_gn_disc_shapes(G, worst)
    result = {}
    gan, gan_b = tmp / "vaegan", tmp / "vaegan_resumed"
    common = ["--preset", "chest", "--data-root", str(root), "--device", "cuda"]

    def run(what, argv, expected):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses = train_autoencoder.main([*common, *argv])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_counts(what, ops.launch_counts(), {"group_norm_silu": expected})
        log(f"  {what}: {len(losses)} steps in {seconds:.1f} s with loading; losses {losses}")
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"{what}: losses {losses}")
        result[f"{what} launches"] = expected
        return state, losses

    # VAEGAN, conv discriminators: batch 1 off, batches 2 and 3 on, the grid
    gn = GAN_GN_PER_STEP
    state, losses = run("VAEGAN CLI (conv)", [
        "--gan", "--start-gan-step", str(GAN_START), "--max-steps", str(GAN_STEPS),
        "--out", str(gan), "--ckpt-every", str(AE_CKPT_EVERY), "--sample-every",
        str(GAN_STEPS)], gn["off"] + 2 * gn["conv"] + AE_GN_PER_STEP)
    d_steps = {int(s["step"]) for s in state.disc.optimizer.state.values()}
    if state.step != 2 * GAN_STEPS or d_steps != {GAN_STEPS - 1}:
        raise RuntimeError(f"VAEGAN: step {state.step}, discriminator Adam steps {d_steps}")
    # resume: a run that holds only step 2 takes step 3
    (gan_b / "checkpoints").mkdir(parents=True)
    for name in ("step_2.pt", C.CONFIG_FILE):
        shutil.copy(gan / "checkpoints" / name, gan_b / "checkpoints" / name)
    saved = C.load_payload(gan / "checkpoints", AE_CKPT_EVERY)["state"]
    state_b, losses_b = train_autoencoder.main([
        *common, "--gan", "--start-gan-step", str(GAN_START), "--max-steps", str(GAN_STEPS),
        "--out", str(gan_b), "--resume", "--sample-every", "0"])
    restored = C.load_payload(gan_b / "checkpoints", GAN_STEPS)["state"]
    final = C.load_payload(gan / "checkpoints", GAN_STEPS)["state"]
    d = max((final[who]["model"][k].float() - restored[who]["model"][k].float()).abs().max().item()
            for who in ("gen", "disc") for k in final[who]["model"])
    log(f"  VAEGAN resume at step {AE_CKPT_EVERY}: counters {state_b.step} (uninterrupted "
        f"{state.step}), saved step 2 holds {len(saved['disc']['optimizer']['state'])} "
        f"discriminator Adam states; step-{GAN_STEPS} loss {losses_b[0]!r} vs "
        f"{losses[-1]!r}; both players after it max|d| = {d:.3e}")
    if state_b.step != state.step or len(losses_b) != 1:
        raise RuntimeError(f"resumed VAEGAN at step {state_b.step}, losses {losses_b}")
    if abs(losses_b[0] - losses[-1]) > AE_RESUME_LOSS_RTOL * abs(losses[-1]):
        raise RuntimeError(f"resumed VAEGAN step-{GAN_STEPS} loss {losses_b[0]} departs "
                           f"from {losses[-1]}")
    del state, state_b
    torch.cuda.empty_cache()

    # the PatchGAN: batch 1 D only, batch 2 both; BatchNorm moves 5 times
    state, _ = run("VAEGAN CLI (patch)", ["--gan", "--disc", "patch", "--start-gan-step", "0",
                                          "--max-steps", "2", "--sample-every", "0"],
                   2 * gn["patch"])
    tracked = {int(b) for k, b in state.disc.model.named_buffers()
               if k.endswith("num_batches_tracked")}
    if tracked != {5}:
        raise RuntimeError(f"PatchGAN BatchNorm updates {tracked}, expected 5")
    del state
    run("VQVAE CLI", ["--model", "vqvae", "--max-steps", "2", "--sample-every", "0"],
        2 * gn["off"])
    run("VQGAN CLI (conv)", ["--model", "vqvae", "--gan", "--start-gan-step", "0",
                             "--max-steps", "2", "--sample-every", "0"],
        gn["off"] + 4 * DISC_GN_PER_FORWARD + gn["conv"])
    torch.cuda.empty_cache()

    # the diffusion stage from the VAEGAN run's generator
    ops.reset_launch_counts()
    dstate, dlosses, pipe = train_diffusion.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(gan), "--bf16",
        "--max-steps", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    check_counts("diffusion CLI from the VAEGAN run", ops.launch_counts(),
                 {"group_norm_silu": 2 * (UNET_GN_PER_FORWARD + VAE_GN_PER_ENCODE)})
    loaded = pipe.latent_embedder.state_dict()
    if not all(torch.equal(loaded[k].cpu(), v) for k, v in final["gen"]["model"].items()):
        raise RuntimeError("the diffusion stage's VAE differs from the VAEGAN generator")
    log(f"  diffusion CLI --vae-ckpt <VAEGAN run>: losses {dlosses}; its VAE equals the "
        f"generator of the VAEGAN checkpoint bit for bit")
    if not all(math.isfinite(v) for v in dlosses):
        raise RuntimeError(f"diffusion from the VAEGAN run: losses {dlosses}")
    del dstate, pipe
    torch.cuda.empty_cache()

    # the adversarial step alone: launches a step by configuration, then ms
    ds = build_dataset(p, str(root))
    batch = {"source": torch.from_numpy(np.stack([ds[i]["source"]
                                                  for i in range(AE_BATCH)])).cuda()}
    noise = torch.randn((AE_BATCH, *p.latent_shape), device="cuda")
    per_step = {}
    for name, disc, start in (("off", "conv", 10**9), ("patch", "patch", -1),
                              ("conv", "conv", -1)):
        state, step = gan_step_setup(p, disc, start)
        ops.reset_launch_counts()
        step(state, batch, noise)
        torch.cuda.synchronize()
        per_step[name] = ops.launch_counts()
        check_counts(f"adversarial step, GAN {name}", per_step[name],
                     {"group_norm_silu": gn[name]})
        if name != "conv":
            del state, step
            torch.cuda.empty_cache()
    ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, noise, 5)
    recompute = gan_recompute_ms(G)
    log(f"  adversarial step (VAEGAN, conv discriminators, GAN on, B={AE_BATCH}, f32, 256^2): "
        f"{ms:.1f} ms/step, peak memory {peak:.2f} GiB; profiled step wall {wall:.1f} ms, "
        f"{fmt_kinds(kinds)}; GroupNorm backward's plain recompute {recompute:.2f} ms a step "
        f"({recompute / ms:.1%} of the step); GroupNorm launches a step: GAN off "
        f"{per_step['off']['group_norm_silu']}, PatchGAN {per_step['patch']['group_norm_silu']}, "
        f"conv {per_step['conv']['group_norm_silu']}")
    result.update(gan_ms=ms, gan_peak=peak, gan_kinds=kinds, gan_recompute=recompute,
                  gan_launches={k: v["group_norm_silu"] for k, v in per_step.items()})
    del state, step, batch
    torch.cuda.empty_cache()
    return result


def smoke_option_pair(self_cond=False, zero_snr=False, objective="x_T"):
    """Phase 11: the smoke preset's pipeline on the CPU and on the card from
    the same perturbed weights; a self-conditioning UNet and a
    zero-terminal-SNR schedule where asked."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline, build_unet

    p = PRESETS["smoke"]
    pipes = {}
    for dev in ("cpu", "cuda"):
        pipe = build_pipeline(p, device=dev, seed=0, objective=objective,
                              zero_terminal_snr=zero_snr)
        if self_cond:
            with torch.device(dev):
                unet = build_unet(p, use_self_conditioning=True).eval()
            pipe = dataclasses.replace(pipe, noise_estimator=unet,
                                       use_self_conditioning=True)
        pipes[dev] = pipe
    gen = torch.Generator().manual_seed(11)
    for part in ("noise_estimator", "latent_embedder"):
        perturb_(getattr(pipes["cpu"], part), gen)
        getattr(pipes["cuda"], part).load_state_dict(getattr(pipes["cpu"], part).state_dict())
    return pipes["cpu"], pipes["cuda"]


def phase_smoke_options_vs_cpu():
    """Phase 11, first: each new sampler and option on the smoke preset, f32,
    on the card against the CPU from the same perturbed weights and the same
    injected draws (B=4, labels 0, 1, 0, 1, CFG 3 with ``un_cond`` where
    given), decoded images within SMOKE_TOL x max(1, max|ref|), rtol
    SMOKE_TOL (the smoke sampling check's tolerance)."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS
    from medfusion_tpu_torch.pipelines.diffusion import repaint_op_schedule

    p = PRESETS["smoke"]
    b, n = 4, 10
    lat = (b, *p.latent_shape)
    gen = torch.Generator().manual_seed(12)
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    x_T, known = rnd(*lat), rnd(*lat)
    image = torch.rand((b, p.image_size, p.image_size, p.in_channels), generator=gen) * 2 - 1
    cond = torch.tensor([0, 1, 0, 1])
    mask = torch.zeros((*lat[:3], 1))
    mask[:, :, : lat[2] // 2] = 1.0
    n_ops = len(repaint_op_schedule(n, 2, 2))
    draws = dict(x_T=x_T, known=known, image=image, cond=cond, un_cond=1 - cond, mask=mask,
                 noise2=rnd(n, 2, *lat), noise_rp=rnd(n_ops, 3, *lat), churn=rnd(6, *lat),
                 fast=rnd(n, *lat), enc=rnd(*lat), x_noise=rnd(*lat))
    cfg = lambda d: dict(condition=d["cond"], guidance_scale=3.0, un_cond=d["un_cond"])
    cases = (
        ("DDIM, self-conditioning, un_cond, cold diffusion, v", dict(self_cond=True, objective="v"),
         lambda pipe, d: pipe.denoise(d["x_T"], steps=n, cold_diffusion=True,
                                      noise=d["noise2"], **cfg(d))),
        ("DDIM RePaint (inpainting, resample 2, jump 2)", dict(),
         lambda pipe, d: pipe.denoise(d["x_T"], steps=n, known=d["known"], mask=d["mask"],
                                      resample_steps=2, jump_length=2, noise=d["noise_rp"],
                                      **cfg(d))),
        ("DDIM trailing, zero-terminal-SNR, v", dict(zero_snr=True, objective="v"),
         lambda pipe, d: pipe.denoise(d["x_T"], steps=n, timestep_spacing="trailing",
                                      noise=d["noise2"], **cfg(d))),
        ("DPM++(2M) 10 steps", dict(),
         lambda pipe, d: pipe.denoise_dpmpp(d["x_T"], steps=n, **cfg(d))),
        ("DPM++(2M) 10 steps trailing, zero-terminal-SNR, v", dict(zero_snr=True, objective="v"),
         lambda pipe, d: pipe.denoise_dpmpp(d["x_T"], steps=n, timestep_spacing="trailing",
                                            **cfg(d))),
        ("EDM 6 steps, Heun, churn 1", dict(),
         lambda pipe, d: pipe.denoise_edm(d["x_T"], steps=6, s_churn=1.0,
                                          churn_noise=d["churn"], **cfg(d))),
        ("fast sampler, encoder every 3, eta 1", dict(),
         lambda pipe, d: pipe.denoise_fast(d["x_T"], steps=n, encoder_key_every=3, eta=1.0,
                                           noise=d["fast"], **cfg(d))),
        ("img2img, strength 0.6", dict(),
         lambda pipe, d: pipe.img2img(d["image"], strength=0.6, steps=n,
                                      enc_noise=d["enc"], x_noise=d["x_noise"],
                                      noise=d["noise2"], **cfg(d))),
        ("invert -> denoise (eta 0)", dict(),
         lambda pipe, d: pipe.denoise(pipe.invert(d["known"], steps=n, **cfg(d)), steps=n,
                                      eta=0.0, noise=d["noise2"], **cfg(d))),
    )
    for name, settings, run in cases:
        cpu, card = smoke_option_pair(**settings)
        ref = run(cpu, draws)
        out = run(card, {k: v.cuda() for k, v in draws.items()}).cpu()
        scale = max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item()
        log(f"  smoke {name}: card vs cpu max|d| = {err:.3e} (limit {SMOKE_TOL} x "
            f"max(1, max|ref|) = {SMOKE_TOL * scale:.3e})")
        if not torch.isfinite(ref).all():
            raise RuntimeError(f"{name}: non-finite CPU result")
        torch.testing.assert_close(out, ref, atol=SMOKE_TOL * scale, rtol=SMOKE_TOL)


@contextlib.contextmanager
def timed_calls(module, name):
    """Within the block, each call of ``module.name`` is timed (host clock,
    after a synchronize before and after); yields the list of seconds."""
    import torch

    real, seconds = getattr(module, name), []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


def forward_launches(attention):
    """Launches of one chest UNet forward, by kernel (EXPECTED less the
    decode, over the steps)."""
    return {k: (v - (VAE_GN_PER_DECODE if k == "group_norm_silu" else 0)) // STEPS
            for k, v in EXPECTED[attention].items()}


def encoder_group_norms():
    """GroupNorms of the chest UNet's in conv and encoder (counted on a
    meta-device build), and of the whole UNet."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_unet
    from medfusion_tpu_torch.nn.blocks import Norm

    with torch.device("meta"):
        unet = build_unet(PRESETS["chest"])
    enc = sum(isinstance(m, Norm) for part in (unet.in_conv, unet.in_blocks)
              for m in part.modules())
    return enc, sum(isinstance(m, Norm) for m in unet.modules())


def option_expected(forwards, attention="none", decoder_only=0, enc_gn=0, samplings=1):
    """Launches of ``samplings`` samplings of ``forwards`` full UNet forwards
    (and ``decoder_only`` forwards of the middle and decoder alone) and one
    decode each."""
    per = forward_launches(attention)
    out = {k: samplings * forwards * v for k, v in per.items()}
    out["group_norm_silu"] += samplings * (
        decoder_only * (per["group_norm_silu"] - enc_gn) + VAE_GN_PER_DECODE)
    return out


def phase_option_samplers(ops, tmp):
    """Phase 11, continued: the chest preset at full width through
    ``cli.sample`` (bf16, 8 images a condition, conditions 0 and 1 under CFG
    8 and None without, seeded weights) with each new sampler, its launches
    counted from zero and held to the count derived from the module
    structure, its seconds a sampling; then ``cli.sample_dataset`` at B=32
    (labels 0 and 1, guidance 1), its PNG tree read back and its samples/s
    on the host clock."""
    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import sample, sample_dataset
    from medfusion_tpu_torch.data.png import read_png

    enc_gn, total = encoder_group_norms()
    if total != UNET_GN_PER_FORWARD:
        raise RuntimeError(f"the chest UNet has {total} GroupNorms, the counts assume "
                           f"{UNET_GN_PER_FORWARD}")
    n_key = -(-FAST_STEPS // FAST_KEY)
    log(f"  the chest UNet's encoder holds {enc_gn} of its {total} GroupNorms; the fast "
        f"sampler at {FAST_STEPS} steps, key every {FAST_KEY}: {n_key} full forwards and "
        f"{FAST_STEPS - n_key} decoder-only ones")
    report = {}
    for name, flags, forwards in OPTION_RUNS:
        attention = "spatial" if "spatial" in flags else "none"
        if forwards is None:
            per_sampling = option_expected(n_key, decoder_only=FAST_STEPS - n_key,
                                           enc_gn=enc_gn)
        else:
            per_sampling = option_expected(forwards, attention)
        expected = {k: 3 * v for k, v in per_sampling.items()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_calls(sample, "run_sampler") as seconds:
            results = sample.main(["--preset", "chest", "--n", str(N_SAMPLES),
                                   "--out", str(tmp / name), *flags])
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        log(f"  cli.sample {name}: seconds a sampling (conditions 0, 1, None) "
            f"{[round(s, 3) for s in seconds]}, CLI {wall:.1f} s; per sampling derived "
            f"{per_sampling}")
        check_counts(f"cli.sample {name} (3 samplings)", launches, expected)
        for c, imgs in results.items():
            if imgs.shape != (N_SAMPLES, 256, 256, 3) or not np.isfinite(imgs).all():
                raise RuntimeError(f"{name} condition {c}: images {imgs.shape}, or non-finite")
        if not (tmp / name / "sample_diff.png").exists():
            raise RuntimeError(f"{name}: no sample_diff.png")
        report[name] = (seconds, launches)
    for name, flags, forwards in DATASET_RUNS:
        out = tmp / f"fake_{name}"
        expected = option_expected(forwards, samplings=2)
        ops.reset_launch_counts()
        with timed_calls(sample_dataset, "run_sampler") as seconds:
            dirs = sample_dataset.main(["--preset", "chest", "--chunk", str(DATASET_CHUNK),
                                        "--n-samples", str(DATASET_CHUNK), "--out", str(out),
                                        *flags])
        check_counts(f"cli.sample_dataset {name} (labels 0 and 1)", ops.launch_counts(),
                     expected)
        for (steps, label), d in sorted(dirs.items()):
            files = sorted(d.iterdir())
            imgs = [read_png(f) for f in files]
            if (len(files) != DATASET_CHUNK
                    or {f.name for f in files} != {f"fake_{i}.png" for i in range(DATASET_CHUNK)}
                    or any(im.shape != (256, 256, 3) or im.dtype != np.uint8 for im in imgs)):
                raise RuntimeError(f"{d}: {len(files)} files, not {DATASET_CHUNK} 256x256 RGB")
        log(f"  cli.sample_dataset {name}: tree {sorted(dirs)} of {DATASET_CHUNK} uint8 "
            f"256x256x3 PNGs each, read back; B={DATASET_CHUNK} sampling seconds "
            f"{[round(s, 3) for s in seconds]} = "
            f"{[round(DATASET_CHUNK / s, 2) for s in seconds]} samples/s (host clock, "
            f"decode included, PNG writing not)")
        report[f"dataset {name}"] = seconds
    return report


def phase_option_training(ops):
    """Phase 11, last: one training step of a chest UNet with
    self-conditioning, a learned variance and two deep-supervision heads,
    the v objective on a zero-terminal-SNR schedule with Min-SNR 5, B=32,
    bf16 compute on f32 masters, through the pipeline: loss finite; the
    bf16 gradients against the f32 ones per tensor under
    TRAIN_GRAD_REL_LIMIT; GroupNorm launches a step (UNet, the
    self-conditioning pre-pass and the frozen encoder) counted; ms a step
    beside the plain chest step's (no option, no attention)."""
    import torch

    from medfusion_tpu_torch.cli.presets import (
        PRESETS,
        build_scheduler,
        build_train_pipeline,
        build_unet,
        build_vae,
    )
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    torch.manual_seed(0)
    with torch.device("cuda"):
        unet = build_unet(p, use_self_conditioning=True, estimate_variance=True,
                          deep_supervision=True)
        vae = build_vae(p)
    options = DiffusionPipeline(
        scheduler=build_scheduler(p, "cuda", zero_terminal_snr=True), noise_estimator=unet,
        latent_embedder=vae.eval().requires_grad_(False), estimator_objective="v",
        estimate_variance=True, use_self_conditioning=True, min_snr_gamma=5.0,
        classifier_free_guidance_dropout=p.cfg_dropout, do_input_centering=False,
        clip_x0=False, loss="l1")
    gen = torch.Generator(device="cuda").manual_seed(3)
    perturb_(unet, gen)
    perturb_(vae, gen)
    log(f"  full-option chest UNet: {len(unet.outc_ver)} deep-supervision heads, out "
        f"channels {unet.outc.conv.conv.out_channels}, in conv channels "
        f"{unet.in_conv.conv.in_channels}")
    batches = train_batches(p, 1 + OPT_TRAIN_STEPS, seed=1)
    draws = [options.train_draws(TRAIN_BATCH, p.latent_shape, generator=gen)
             for _ in batches]
    l32, g32 = grads_of(options, batches[0], draws[0], None)
    l16, g16 = grads_of(options, batches[0], draws[0], torch.bfloat16)
    worst, glob = grad_departure(g16, g32)
    del g16, g32
    log(f"  full-option step bf16 vs f32: loss {l16.item():.5f} vs {l32.item():.5f}; "
        f"gradients: worst tensors |d|_2/|g32|_2 = {fmt_worst(worst)} (limit "
        f"{TRAIN_GRAD_REL_LIMIT}); max|d|/max|g32| over all = {glob:.3e}")
    if not (torch.isfinite(l16) and torch.isfinite(l32)):
        raise RuntimeError(f"non-finite full-option loss {l16.item()} / {l32.item()}")
    if not worst[0][0] < TRAIN_GRAD_REL_LIMIT:
        raise RuntimeError(f"full-option bf16 gradients depart from f32: {fmt_worst(worst)}")
    per_step = {"group_norm_silu": 2 * UNET_GN_PER_FORWARD + VAE_GN_PER_ENCODE}
    ms = {}
    plain = build_train_pipeline(p, device="cuda", seed=0)
    for name, pipe, expected in (("full-option", options, per_step),
                                 ("plain", plain, {"group_norm_silu": UNET_GN_PER_FORWARD
                                                   + VAE_GN_PER_ENCODE})):
        state = TrainState(pipe.noise_estimator, lr=p.diffusion_lr, weight_decay=1e-2)
        step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
        step(state, batches[0], draws[0])  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(state, b, d)["loss"] for b, d in zip(batches[1:], draws[1:])]
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / OPT_TRAIN_STEPS * 1e3
        losses = [float(v) for v in losses]
        log(f"  {name} chest step, B={TRAIN_BATCH}, bf16: {ms[name]:.1f} ms/step, losses "
            f"{[round(v, 5) for v in losses]}")
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"{name}: non-finite loss {losses}")
        check_counts(f"{name} training, {OPT_TRAIN_STEPS} steps", ops.launch_counts(),
                     {k: v * OPT_TRAIN_STEPS for k, v in expected.items()})
        del state, step
        torch.cuda.empty_cache()
    return ms


def perturb_bn_(module, gen):
    """Move every BatchNorm's statistics and affine off their init (the
    variances stay in [0.5, 1.5])."""
    import torch

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))


def close_rel(name, out, ref, rel):
    """``out`` against ``ref`` within ``rel`` x max|ref|; returns the error."""
    limit = rel * ref.abs().max().item()
    err = close(name, out.cpu(), ref.cpu(), limit, 0.0)
    log(f"  {name}: max|d| {err:.3e} (limit {rel:g} x max|ref| = {limit:.3e})")
    return err


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuDNN's convolutions and cuBLAS's products inside; the
    script runs with both off."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def pr_close(name, got, want, n):
    log(f"  {name}: precision/recall {got} vs {want} (limit 2/N = {2 / n:.2e})")
    if any(abs(a - b) > 2 / n for a, b in zip(got, want)):
        raise RuntimeError(f"{name}: precision/recall {got} departs from {want}")


def phase_eval_vs_cpu():
    """Phase 12a: the evaluation networks on the card against the CPU at
    their full widths, f32: InceptionV3 (random He convs, BatchNorm moved)
    on 4 uint8 256^2 images through the 299^2 resize; LPIPS of 4 pairs at
    256^2 (a seeded random VGG16) and its gradient with respect to pred (in
    f64, and in f32 by LPIPS_F32_GRAD_L2, which two planted faults must
    exceed); MS-SSIM at 256^2;
    precision/recall of 512 + 512 seeded features."""
    import copy

    import torch

    from medfusion_tpu_torch.losses import LPIPS, ms_ssim
    from medfusion_tpu_torch.metrics import InceptionV3, precision_recall

    gen = torch.Generator().manual_seed(12)
    torch.manual_seed(12)
    inc = InceptionV3().eval()
    perturb_bn_(inc, gen)
    x = torch.randint(0, 256, (4, 3, 256, 256), generator=gen, dtype=torch.uint8)
    with torch.no_grad():
        ref = inc(x)
        out = copy.deepcopy(inc).cuda()(x.cuda())
    close_rel("InceptionV3 features, 4 x 256^2 -> 299^2", out, ref, EVAL_TOL["inception"])

    lpips = LPIPS().eval().requires_grad_(False)
    pred = (torch.rand((4, 3, 256, 256), generator=gen) * 2 - 1)
    target = (pred + 0.3 * torch.randn(pred.shape, generator=gen)).clamp(-1, 1)
    weights = torch.arange(1.0, 5.0).reshape(-1, 1, 1, 1)
    res = {}
    for dev in ("cpu", "cuda"):
        for dtype in (torch.float32, torch.float64):
            net = copy.deepcopy(lpips).to(dev, dtype)
            p = pred.to(dev, dtype).detach().requires_grad_(True)
            val = net(p, target.to(dev, dtype))
            (val * weights.to(dev, dtype)).sum().backward()
            res[dev, dtype] = (val.detach().cpu().double(), p.grad.cpu().double())
    f32, f64 = torch.float32, torch.float64
    close_rel("LPIPS, 4 pairs at 256^2, f32", res["cuda", f32][0], res["cpu", f32][0],
              EVAL_TOL["lpips"])
    close_rel("LPIPS gradient w.r.t. pred, f64", res["cuda", f64][1], res["cpu", f64][1],
              EVAL_TOL["lpips"])
    ref = res["cpu", f64][1]

    def departure(grad):
        return ((grad - ref).norm() / ref.norm()).item()

    # two wrong results the f32 check must flag: TF32 convolutions, and
    # the fifth VGG stage left out of the sum
    def card_f32_grad(net):
        p = pred.cuda().detach().requires_grad_(True)
        (net(p, target.cuda()) * weights.cuda()).sum().backward()
        return p.grad.cpu().double()

    with tf32_on():
        tf32 = departure(card_f32_grad(copy.deepcopy(lpips).cuda()))
    four = copy.deepcopy(lpips).cuda()
    four_stages = four.vgg.forward
    four.vgg.forward = lambda x: four_stages(x)[:4]
    dropped = departure(card_f32_grad(four))
    own, card = departure(res["cpu", f32][1]), departure(res["cuda", f32][1])
    log(f"  LPIPS gradient w.r.t. pred, f32 against the CPU's f64: |d|_2/|g|_2 card {card:.3e}, "
        f"CPU {own:.3e} (limit {LPIPS_F32_GRAD_L2}; max|d| card "
        f"{(res['cuda', f32][1] - ref).abs().max().item() / ref.abs().max().item():.3e} of "
        f"max|g|); the planted faults: TF32 convolutions {tf32:.3e}, stage 5 left out "
        f"{dropped:.3e}")
    if not card <= LPIPS_F32_GRAD_L2:
        raise RuntimeError(f"the card's f32 LPIPS gradient departs by {card} in L2")
    if not min(tf32, dropped) > LPIPS_F32_GRAD_L2:
        raise RuntimeError(f"the f32 LPIPS gradient check misses a planted fault: TF32 "
                           f"{tf32}, stage 5 left out {dropped}")

    a, b = torch.rand((4, 3, 256, 256), generator=gen), torch.rand((4, 3, 256, 256), generator=gen)
    b = (0.7 * a + 0.3 * b).clamp(0, 1)
    ref = ms_ssim(a, b, size_average=False)
    err = (ms_ssim(a.cuda(), b.cuda(), size_average=False).cpu() - ref).abs().max().item()
    log(f"  MS-SSIM at 256^2: {ref.tolist()}, max|d| {err:.3e} (limit {EVAL_TOL['ms_ssim']})")
    if not err <= EVAL_TOL["ms_ssim"]:
        raise RuntimeError(f"MS-SSIM departs by {err}")

    real, fake = pr_features(512, gen)
    want = [float(v) for v in precision_recall(real, fake)]
    got = [float(v) for v in precision_recall(real.cuda(), fake.cuda())]
    pr_close("precision/recall, 512 + 512 features", got, want, 512)


def pr_features(n, gen, device="cpu"):
    """(real, fake) [n, PR_DIM] f32: points of a PR_MANIFOLD-d Gaussian,
    the fake one wider and shifted, projected to PR_DIM plus noise."""
    import torch

    kw = dict(generator=gen, device=device)
    proj = torch.randn((PR_MANIFOLD, PR_DIM), **kw) / PR_MANIFOLD ** 0.5
    real = torch.randn((n, PR_MANIFOLD), **kw) @ proj + 0.05 * torch.randn((n, PR_DIM), **kw)
    fake = ((1.15 * torch.randn((n, PR_MANIFOLD), **kw) + 0.15) @ proj
            + 0.05 * torch.randn((n, PR_DIM), **kw))
    return real, fake


def phase_evaluate_images(ops, tmp):
    """Phase 12b: ``cli.evaluate_images`` between a real tree (grey 320x288
    PNGs in the CheXpert_2 layout) and a fake tree of chest samples written
    by ``cli.sample_dataset``, batch EVAL_BATCH; its seconds, FID and
    precision/recall, and the same metrics from the CPU's features of the
    same images. The random featuriser parts those two sets completely
    (precision and recall 0), so the CLI then also compares the real tree
    with a second one whose images continue its family of waves from its
    middle on: manifolds that overlap by half, where precision and recall
    must lie strictly between 0 and 1 before they are held to the CPU's.
    Returns the real tree (phase 12d trains on it) and the report."""
    import os

    import torch

    from medfusion_tpu_torch.cli import evaluate_images, sample_dataset
    from medfusion_tpu_torch.metrics import InceptionV3

    os.environ["MEDFUSION_WEIGHTS_DIR"] = str(tmp / "no_weights")
    real, fake, overlap = tmp / "real", tmp / "fake", tmp / "overlap"
    t0 = time.perf_counter()
    write_chexpert_tree(real, EVAL_IMAGES, TWO_STAGE_SIDE, seed=3)
    write_chexpert_tree(overlap, EVAL_IMAGES, TWO_STAGE_SIDE, seed=4, first=EVAL_IMAGES // 2)
    log(f"  wrote 2 x {EVAL_IMAGES} grey {TWO_STAGE_SIDE[0]}x{TWO_STAGE_SIDE[1]} PNGs in "
        f"{time.perf_counter() - t0:.1f} s")
    per_label = EVAL_IMAGES // 2
    chunks = -(-per_label // DATASET_CHUNK)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sample_dataset.main(["--preset", "chest", "--sampler", "dpmpp", "--steps-list", "25",
                         "--chunk", str(DATASET_CHUNK), "--n-samples", str(per_label),
                         "--out", str(fake)])
    check_counts(f"cli.sample_dataset DPM++ 25, 2 labels x {per_label}", ops.launch_counts(),
                 option_expected(25, samplings=2 * chunks))
    log(f"  fake tree: {2 * per_label} chest samples in {time.perf_counter() - t0:.1f} s")

    nets = {}
    feats = {}

    def cpu_features(folder):
        """The tree's features on the CPU, held to the card's from the same
        weights (taken after the CLI's first run, so that it runs cold)."""
        if not nets:
            nets["cuda"] = evaluate_images.load_inception(torch.device("cuda"))
            nets["cpu"] = InceptionV3()
            nets["cpu"].load_state_dict({k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
            nets["cpu"].eval()
        if folder not in feats:
            got = {"cuda": [], "cpu": []}
            for batch in evaluate_images.iter_uint8_batches(folder, EVAL_BATCH):
                x = torch.from_numpy(batch).permute(0, 3, 1, 2).contiguous()
                with torch.no_grad():
                    got["cuda"].append(nets["cuda"](x.cuda()).cpu())
                    got["cpu"].append(nets["cpu"](x))
            got = {k: torch.cat(v) for k, v in got.items()}
            close_rel(f"{folder.name} features, card vs CPU", got["cuda"], got["cpu"],
                      EVAL_TOL["inception"])
            feats[folder] = got["cpu"]
        return feats[folder]

    report = {}
    for name, folder, n_fake in (("fake", fake, 2 * per_label),
                                 ("overlap", overlap, EVAL_IMAGES)):
        report[name] = evaluate_pair(ops, real, folder, tmp / f"metrics_{name}",
                                     (EVAL_IMAGES, n_fake), cpu_features)
    precision, recall = report["overlap"]["precision"], report["overlap"]["recall"]
    if not (0 < precision < 1 and 0 < recall < 1):
        raise RuntimeError(f"overlapping trees: precision {precision}, recall {recall}; "
                           "the check needs both strictly between 0 and 1")
    return real, report


def evaluate_pair(ops, real, fake, out, counts, cpu_features):
    """``cli.evaluate_images`` on the card between ``real`` and ``fake``: its
    image counts, launches and seconds, and its FID and precision/recall
    against the same metrics from the CPU's features of the same images
    (``cpu_features(folder)``)."""
    from medfusion_tpu_torch.cli import evaluate_images
    from medfusion_tpu_torch.metrics import FrechetInceptionDistance, precision_recall

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = evaluate_images.main(["--real", str(real), "--fake", str(fake), "--batch-size",
                                   str(EVAL_BATCH), "--out", str(out)])
    wall = time.perf_counter() - t0
    what = f"cli.evaluate_images {real.name} vs {fake.name}"
    check_counts(what, ops.launch_counts(), {})
    if (result["n_real"], result["n_fake"]) != counts:
        raise RuntimeError(f"{what} counted {result['n_real']} + {result['n_fake']}")
    rate = sum(counts) / result["seconds_featurize"]
    log(f"  {what}: {wall:.1f} s; reading {result['seconds_read']:.2f} s, "
        f"featurising {result['seconds_featurize']:.3f} s ({rate:.1f} images/s), FID and "
        f"P/R {result['seconds_compute']:.2f} s; FID {result['FID']!r}, precision "
        f"{result['precision']!r}, recall {result['recall']!r}")
    real_cpu, fake_cpu = cpu_features(real), cpu_features(fake)
    fid = FrechetInceptionDistance()
    fid.update(real_cpu, real=True)
    fid.update(fake_cpu, real=False)
    fid_cpu = fid.compute()
    rel = abs(fid_cpu - result["FID"]) / abs(fid_cpu)
    log(f"  FID from the CPU's features {fid_cpu!r}: relative departure {rel:.2e} "
        f"(limit {EVAL_TOL['fid']})")
    if not rel <= EVAL_TOL["fid"]:
        raise RuntimeError(f"{what}: FID {result['FID']} departs from the CPU's {fid_cpu}")
    pr_close("P/R from the CPU's features", [result["precision"], result["recall"]],
             [float(v) for v in precision_recall(real_cpu, fake_cpu)], min(counts))
    return {**result, "images_per_s": rate, "fid_cpu": fid_cpu}


def phase_pr_scale():
    """Phase 12c: precision/recall of PR_N + PR_N x PR_DIM seeded features
    on the card, in row chunks of 1024 and unchunked: equal results, the
    seconds and the peak memory above the features of each."""
    import torch

    from medfusion_tpu_torch.metrics import precision_recall

    gen = torch.Generator(device="cuda").manual_seed(13)
    real, fake = pr_features(PR_N, gen, "cuda")
    precision_recall(real[:2048], fake[:2048], row_chunk=1024)  # warm-up
    report = {}
    for chunk in (1024, None):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pr = [float(v) for v in precision_recall(real, fake, row_chunk=chunk)]
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        report[chunk] = (pr, seconds, peak)
        log(f"  P/R at {PR_N} + {PR_N} x {PR_DIM}, row_chunk {chunk}: {pr} in {seconds:.3f} s, "
            f"peak memory {peak:.3f} GiB above the features")
    if report[1024][0] != report[None][0]:
        raise RuntimeError(f"chunked P/R {report[1024][0]} != unchunked {report[None][0]}")
    return report


def seeded_checkpoints(tmp):
    """Seeded random torchvision-layout files: VGG16 (``features`` and a
    small classifier) and a pytorch-fid InceptionV3 wrapper's state dict
    (``blocks.N.M.`` keys, no ``num_batches_tracked``, the ``AuxLogits``
    and ``fc`` heads)."""
    import torch

    from medfusion_tpu_torch.losses.lpips import VGG16Features
    from medfusion_tpu_torch.metrics import InceptionV3
    from medfusion_tpu_torch.metrics.inception import _PYTORCH_FID_BLOCKS

    torch.manual_seed(21)
    vgg = dict(VGG16Features().state_dict())
    vgg["classifier.6.weight"], vgg["classifier.6.bias"] = torch.zeros(8, 16), torch.zeros(8)
    names = {v: k for k, v in _PYTORCH_FID_BLOCKS.items()}
    inc = {}
    for k, v in InceptionV3().state_dict().items():
        if not k.endswith("num_batches_tracked"):
            module, rest = k.split(".", 1)
            inc["blocks.{}.{}.{}".format(*names[module], rest)] = v
    inc["AuxLogits.fc.weight"], inc["fc.weight"] = torch.zeros(1000, 768), torch.zeros(1008, 2048)
    paths = {"vgg16": tmp / "vgg16-seeded.pth", "inception": tmp / "pt_inception-seeded.pth"}
    torch.save(vgg, paths["vgg16"])
    torch.save(inc, paths["inception"])
    return paths, {"vgg16": vgg, "inception": inc}


def phase_ingest_and_lpips(ops, tmp, root):
    """Phase 12d: ``cli.ingest_weights`` of seeded torchvision-layout files
    into a temporary store; ``cli.train_autoencoder --lpips`` at the chest
    preset (B=8, f32), plain and ``--gan``, with its launches; the --lpips
    steps' ms, peak memory and GroupNorm launches; then
    ``cli.evaluate_latent_embedder`` and ``cli.helpers latent-stats`` on the
    plain run's checkpoint."""
    import os

    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import (
        evaluate_latent_embedder,
        helpers,
        ingest_weights,
        train_autoencoder,
    )
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset, build_vae
    from medfusion_tpu_torch.data.png import read_png
    from medfusion_tpu_torch.losses.lpips import frozen_lpips
    from medfusion_tpu_torch.metrics.inception import fid_state_dict
    from medfusion_tpu_torch.train import TrainState
    from medfusion_tpu_torch.train.autoencoder import (
        AutoencoderTrainer,
        make_autoencoder_train_step,
    )
    from medfusion_tpu_torch.utils import pretrained as P

    p = PRESETS["chest"]
    os.environ["MEDFUSION_WEIGHTS_DIR"] = str(tmp / "weights")
    paths, sources = seeded_checkpoints(tmp)
    for kind in ("vgg16", "inception"):
        t0 = time.perf_counter()
        out = ingest_weights.main([kind, "--src", str(paths[kind])])
        stored = P.load_pretrained(out["name"])
        # the source as the port's module holds it: VGG16's features; the
        # InceptionV3 renamed to torchvision's modules, without its heads
        want = (fid_state_dict(sources[kind]) if kind == "inception" else
                {k: v for k, v in sources[kind].items() if k.startswith("features.")})
        log(f"  cli.ingest_weights {kind}: {out['n_leaves']} tensors in "
            f"{time.perf_counter() - t0:.1f} s, read back with its hash verified; "
            f"params_sha256 {out['params_sha256'][:16]}")
        if set(stored) != set(want) or not all(torch.equal(stored[k], want[k]) for k in want):
            raise RuntimeError(f"the stored {kind} differs from its source, key by key")
        if len(want) != {"vgg16": 26, "inception": 564}[kind]:
            raise RuntimeError(f"the stored {kind} holds {len(want)} tensors")
    report = {}
    common = ["--preset", "chest", "--data-root", str(root), "--device", "cuda",
              "--sample-every", "0"]
    gn = GAN_GN_PER_STEP
    runs = (("--lpips CLI", ["--max-steps", str(LPIPS_CLI_STEPS), "--out", str(tmp / "ae")],
             LPIPS_CLI_STEPS * gn["off"]),
            ("--lpips --gan CLI (conv)", ["--gan", "--start-gan-step", str(GAN_START),
                                          "--max-steps", str(GAN_STEPS)],
             gn["off"] + (GAN_STEPS - 1) * gn["conv"]))
    for what, argv, expected in runs:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses = train_autoencoder.main([*common, "--lpips", *argv])
        torch.cuda.synchronize()
        check_counts(what, ops.launch_counts(), {"group_norm_silu": expected})
        log(f"  {what}: {len(losses)} batches in {time.perf_counter() - t0:.1f} s with "
            f"loading; losses {losses}")
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"{what}: losses {losses}")
        del state
        torch.cuda.empty_cache()

    # the --lpips steps alone: launches a step, ms, peak memory, breakdown
    ds = build_dataset(p, str(root))
    batch = {"source": torch.from_numpy(np.stack([ds[i]["source"]
                                                  for i in range(AE_BATCH)])).cuda()}
    noise = torch.randn((AE_BATCH, *p.latent_shape), device="cuda")
    perceiver = frozen_lpips(P.load_pretrained(P.VGG16), "cuda")

    def setup(name):
        if name == "gan":
            return gan_step_setup(p, "conv", -1, perceiver=perceiver)
        with torch.device("cuda"):
            torch.manual_seed(0)
            vae = build_vae(p)
        return (TrainState(vae, lr=p.ae_lr, weight_decay=0.0),
                make_autoencoder_train_step(AutoencoderTrainer(
                    vae, pixel_loss=p.ae_loss, perceiver=perceiver,
                    embedding_loss_weight=p.ae_embedding_loss_weight)))

    for name in ("plain", "gan"):
        state, step = setup(name)
        ops.reset_launch_counts()
        step(state, batch, noise)
        torch.cuda.synchronize()
        per = ops.launch_counts()["group_norm_silu"]
        check_counts(f"--lpips step ({name})", ops.launch_counts(),
                     {"group_norm_silu": gn["conv" if name == "gan" else "off"]})
        ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, noise, 5)
        log(f"  --lpips {name} step (B={AE_BATCH}, f32, 256^2): {ms:.1f} ms/step, peak memory "
            f"{peak:.2f} GiB, GroupNorm launches {per} a step; profiled step wall "
            f"{wall:.1f} ms, {fmt_kinds(kinds)}")
        report[f"lpips_{name}"] = (ms, peak, per)
        del state, step
        torch.cuda.empty_cache()
    del batch, perceiver

    ae = tmp / "ae"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = evaluate_latent_embedder.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(ae), "--batch-size",
        str(EVAL_LE_BATCH), "--max-batches", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts("cli.evaluate_latent_embedder", ops.launch_counts(),
                 {"group_norm_silu": 2 * VAE_GN_PER_DECODE})
    log(f"  cli.evaluate_latent_embedder: a batch of {EVAL_LE_BATCH} in {seconds:.1f} s "
        f"(loading included): {metrics}")
    if metrics["n"] != EVAL_LE_BATCH or not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"evaluate_latent_embedder: {metrics}")
    ops.reset_launch_counts()
    stats = helpers.main(["latent-stats", "--preset", "chest", "--data-root", str(root),
                          "--vae-ckpt", str(ae), "--n", str(LATENT_STATS_N),
                          "--out", str(tmp / "latents")])
    check_counts("cli.helpers latent-stats", ops.launch_counts(),
                 {"group_norm_silu": 2 * VAE_GN_PER_DECODE})
    hist = read_png(tmp / "latents" / "latent_hist.png")
    grid = read_png(tmp / "latents" / "roundtrip.png")
    log(f"  cli.helpers latent-stats: {stats}; latent_hist.png {hist.shape}, roundtrip.png "
        f"{grid.shape}")
    if not all(math.isfinite(v) for v in stats.values()):
        raise RuntimeError(f"latent-stats: {stats}")
    report.update(le_seconds=seconds, le_metrics=metrics, latent_stats=stats)
    return report


def kernel_row(name, source, replaces, launches, err, rows):
    """One entry of the kernels line: times summed over one launch at each
    of ``rows``' shapes."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)

    by_ops = total("ops_ms") >= total("bytes_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if by_ops else "bytes",
            "library_ms": total("library_ms")}


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
    from medfusion_tpu_torch.ops import flash_attention as FA
    from medfusion_tpu_torch.ops import geglu as GL
    from medfusion_tpu_torch.ops import group_norm as G

    t_all = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s; each library "
        f"done after (s): " + ", ".join(f"{k} {v:.1f}" for k, v in build.BUILD_SECONDS.items()))
    for stem, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {stem}: {line.strip()}")

    log("[3] kernels against their plain versions (B=2)")
    worst = phase_kernel_checks(G, FA, GL)

    log("[4] kernel times (bf16; CUDA events around a replayed CUDA graph of "
        "the launches, and around the same launches made eagerly)")
    rows = phase_kernel_times(G)
    attn_rows, geglu_rows, geglu_b8 = phase_attention_geglu_times(FA, GL, worst)
    bwd_rows = phase_attention_backward_times(FA, worst)
    wide_rows = phase_wide_attention_times(FA, worst)

    log("[5] smoke preset: card against CPU (float32)")
    for attention in ("none", "spatial"):
        phase_smoke_vs_cpu(attention)
    phase_smoke_train_vs_cpu()

    log("[6] sampling paths: chest, bf16")
    launches_none, _, pipe = phase_main_path(ops, "none")
    del pipe
    torch.cuda.empty_cache()
    launches, seconds, pipe = phase_main_path(ops, "spatial")

    log("[7] where a chest-spatial sampling step's device time goes")
    phase_breakdown(pipe)
    del pipe
    torch.cuda.empty_cache()
    log(f"[6b] sampling path: chest-spatial at {WIDE_SAMPLE_HEADS} heads, bf16")
    launches_wide, _, pipe = phase_main_path(ops, "spatial", WIDE_SAMPLE_HEADS)
    del pipe
    torch.cuda.empty_cache()

    log("[8] training path: chest-spatial, bf16 compute, f32 masters, "
        f"B={TRAIN_BATCH}, AdamW + EMA")
    train_launches, train_ms, train = phase_train_main_path(ops, FA)
    phase_train_breakdown(train, train_ms)
    del train
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="two_stage_") as tmp:
        tmp = Path(tmp)
        root = tmp / "chexpert"
        t0 = time.perf_counter()
        write_chexpert_tree(root, TWO_STAGE_IMAGES, TWO_STAGE_SIDE, seed=0)
        log("[9] two-stage program: chest, PNG files, autoencoder -> diffusion -> samples; "
            f"wrote {TWO_STAGE_IMAGES} grey PNGs of {TWO_STAGE_SIDE[0]}x{TWO_STAGE_SIDE[1]} "
            f"(row filters 0-4) in {time.perf_counter() - t0:.1f} s")
        two_stage = phase_two_stage(ops, G, worst, tmp, root)
        log("[10] adversarial autoencoder and the VQVAE family: chest, PNG files, B=8, f32")
        adversarial = phase_adversarial(ops, G, worst, tmp, root)

    with tempfile.TemporaryDirectory(prefix="options_") as tmp:
        log("[11] the diffusion family's options: samplers, editing, zero-terminal-SNR, "
            "self-conditioning, learned variance, deep supervision, Min-SNR")
        phase_smoke_options_vs_cpu()
        option_report = phase_option_samplers(ops, Path(tmp))
        option_train_ms = phase_option_training(ops)

    with tempfile.TemporaryDirectory(prefix="evaluation_") as tmp:
        tmp = Path(tmp)
        log("[12] evaluation: InceptionV3 FID and precision/recall, LPIPS and MS-SSIM, the "
            "weight ingest and --lpips training, the helper CLIs (f32)")
        phase_eval_vs_cpu()
        real, eval_report = phase_evaluate_images(ops, tmp)
        pr_report = phase_pr_scale()
        lpips_report = phase_ingest_and_lpips(ops, tmp, real)

    per_fwd = sum(r["ms"] * r["launches_per_call"] for r in rows if r["where"] == "unet")
    per_dec = sum(r["ms"] * r["launches_per_call"] for r in rows if r["where"] == "vae")
    attn_fwd = sum(r["ms"] * r["launches_per_forward"] for r in attn_rows)
    attn_sdpa = sum(r["library_ms"] * r["launches_per_forward"] for r in attn_rows)
    geglu_fwd = sum(r["ms"] * r["launches_per_forward"] for r in geglu_rows)
    geglu_mm = sum(r["cublas_products_ms"] * r["launches_per_forward"] for r in geglu_rows)
    geglu_fwd_b8 = sum(r["ms"] * r["launches_per_forward"] for r in geglu_b8)
    geglu_plain_b8 = sum(r["plain_ms"] * r["launches_per_forward"] for r in geglu_b8)
    bwd_step = sum(r["ms"] * r["launches_per_step"] for k in bwd_rows for r in bwd_rows[k])
    log(f"  per UNet forward (B=64): group_norm_silu {per_fwd:.4f} ms (the conv "
        f"blocks'), attention {attn_fwd:.4f} ms (sdpa {attn_sdpa:.4f}), geglu "
        f"{geglu_fwd:.4f} ms (its cuBLAS products {geglu_mm:.4f}; at the sampling batch, "
        f"16 rows: {geglu_fwd_b8:.4f} ms, plain {geglu_plain_b8:.4f}); "
        f"group_norm_silu per decode (B=32): {per_dec:.4f} ms; attention backward "
        f"per training step (B=32): {bwd_step:.4f} ms of {train_ms:.1f} ms")

    fa_src = "medfusion_tpu_torch/csrc/flash_attention.cu"
    bwd_src = "medfusion_tpu_torch/csrc/flash_attention_bwd.cu"
    kernels = [
        kernel_row("group_norm_silu", "medfusion_tpu_torch/csrc/group_norm_silu.cu",
                   "medfusion_tpu/ops/group_norm.py:25", launches["group_norm_silu"],
                   worst["group_norm_silu"]["bfloat16"], rows),
        kernel_row("flash_attention", fa_src, "medfusion_tpu/ops/flash_attention.py:73",
                   launches["flash_attention"], worst["flash_attention"]["bfloat16"],
                   [r for r in attn_rows if r["layout"] == "head"]),
        kernel_row("flash_attention_bwd_dq", bwd_src,
                   "medfusion_tpu/ops/flash_attention.py:113",
                   train_launches["flash_attention_bwd_dq"],
                   worst["flash_attention_bwd_dq"]["bfloat16"],
                   bwd_rows["flash_attention_bwd_dq"]),
        kernel_row("flash_attention_bwd_dkv", bwd_src,
                   "medfusion_tpu/ops/flash_attention.py:141",
                   train_launches["flash_attention_bwd_dkv"],
                   worst["flash_attention_bwd_dkv"]["bfloat16"],
                   bwd_rows["flash_attention_bwd_dkv"]),
        kernel_row("flash_attention_tokens", fa_src,
                   "medfusion_tpu/ops/flash_attention.py:327",
                   launches["flash_attention_tokens"],
                   worst["flash_attention_tokens"]["bfloat16"],
                   [r for r in attn_rows if r["layout"] == "tokens"]),
        kernel_row("geglu_mlp", "medfusion_tpu_torch/csrc/geglu_mlp.cu",
                   "medfusion_tpu/ops/geglu.py:96", launches["geglu_mlp"],
                   worst["geglu_mlp"]["bfloat16"], geglu_rows),
    ]
    log(f"  worst errors by kernel and dtype: {worst}")
    log(f"  launches: chest none {launches_none}, chest spatial {launches}, chest spatial "
        f"at {WIDE_SAMPLE_HEADS} heads {launches_wide}, chest-spatial training "
        f"{train_launches}; two-stage group_norm_silu: autoencoder CLI "
        f"{two_stage['ae_launches']}, diffusion CLI {two_stage['diff_launches']}, sample "
        f"CLI {two_stage['sample_launches']}; adversarial step group_norm_silu "
        f"{adversarial['gan_launches']}; slice 11 group_norm_silu: --lpips step "
        f"{lpips_report['lpips_plain'][2]}, --lpips --gan step {lpips_report['lpips_gan'][2]}, "
        f"evaluate_latent_embedder and latent-stats {2 * VAE_GN_PER_DECODE} a batch, "
        f"evaluate_images 0")
    log("  wide heads (ms kernel / sdpa): " + ", ".join(
        f"N={r['N']} d={r['d']} {r['ms']:.4f}/{r['library_ms']:.4f}" for r in wide_rows))
    log("  slice 10 on the card: " + "; ".join(
        f"{k} {[round(v, 3) for v in (r[0] if isinstance(r, tuple) else r)]} s"
        for k, r in option_report.items())
        + f"; full-option training step {option_train_ms['full-option']:.1f} ms, plain "
        f"{option_train_ms['plain']:.1f} ms")
    log("  slice 11 on the card: " + "; ".join(
        f"real vs {k}: featurising {r['images_per_s']:.1f} images/s, FID {r['FID']!r} (CPU "
        f"features {r['fid_cpu']!r}), precision {r['precision']!r}, recall {r['recall']!r}"
        for k, r in eval_report.items()) + f"; P/R at {PR_N} + "
        f"{PR_N}: " + ", ".join(f"row_chunk {c}: {r[1]:.3f} s, {r[2]:.3f} GiB"
                                for c, r in pr_report.items())
        + f"; --lpips step {lpips_report['lpips_plain'][0]:.1f} ms (phase 9's plain step "
        f"{two_stage['ae_ms']:.1f}), --lpips --gan step {lpips_report['lpips_gan'][0]:.1f} ms "
        f"(phase 10's {adversarial['gan_ms']:.1f}), peak {lpips_report['lpips_plain'][1]:.2f} / "
        f"{lpips_report['lpips_gan'][1]:.2f} GiB; evaluate_latent_embedder "
        f"{lpips_report['le_seconds']:.1f} s")
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
