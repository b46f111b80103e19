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
    latent-stats`` on its checkpoint;
13. the flow family and classifier guidance (slice 12): the smoke flow
    pipeline's train loss and gradients, a Heun sample, the ODE inversion
    and inpainting card against CPU (f32); the f32 attention kernels at the
    classifier's shapes (1 head of 128 and 4 of 32 at 256 tokens, 4 of 32
    at 257) against their plain versions and timed beside SDPA and the
    split-TF32 and f32 FMA bounds; the chest
    classifier's logits and input gradient with both attending pools and
    one classifier train step card against CPU, and the gradient check
    shown to flag dq zeroed at d = 128; on phase 9's tree,
    ``cli.train_diffusion --family flow`` (ms a step) and ``cli.sample
    --family flow`` (Heun 25), ``cli.train_classifier`` with a resume, and
    ``cli.sample --classifier-ckpt`` (DDIM 50 with each pool, DPM++ 25)
    beside the unguided run (seconds, peak memory), each run's launches
    held to the counts derived here;
14. the DiT estimator, its mixture-of-experts blocks and distillation
    (slice 13): the smoke DiT and a DiT-MoE of 4 experts card against CPU
    (f32: forward, ``train_loss`` with ``moe_aux``, gradients); the
    token-layout forward and both backward kernels at the chest DiT's
    shape (256 tokens, 16 heads of 64) on q/k/v column slices of one
    [B, N, 3C] projection, f32 and bf16, against their plain versions (the
    forward shown to read the slices in place), then timed at the sampling
    and training batches beside SDPA and the bound; on phase 9's tree,
    ``cli.train_diffusion --estimator dit`` (B=32, bf16, EMA; ms a step,
    peak memory, breakdown) with phase 8's gradient check on a perturbed
    chest DiT shown to flag dq zeroed at d = 64; ``cli.sample --estimator
    dit --ckpt --ema`` (DDIM 50, CFG 8); the flow family with the DiT
    (training, Heun 25); a DiT-MoE of 8 experts, top-2, capacity 1.25,
    every second block (one bf16 step at B=32: ms, peak memory,
    ``moe_aux``, router gradients, each routed block's dropped share);
    ``cli.distill`` pd (from phase 9's UNet and from the DiT), cd and then
    ``cli.sample --sampler consistency``, ct, and reflow from phase 13's
    flow run; every run's launches held to the counts derived from the
    architecture;
15. the other estimator families and the diffusers autoencoders (slice
    14): the smoke legacy UNet (attention, deep supervision), the OpenAI
    UNet (attention in both channel orders, scale-shift norm, resblock
    up/down; a spatial transformer with a context), the lucidrains UNet
    (self-conditioning, learned variance and sinusoidal embedding) and the
    diffusers KL and VQ autoencoders card against CPU (f32: forward, one
    train step's loss, gradients); kernel 5 and both backward kernels at
    the chest OpenAI middle block (16 tokens, 8 heads of 128) in both
    channel orders against their plain versions and timed at the sampling
    and training batches beside SDPA and the bound; on phase 9's tree,
    ``cli.train_diffusion --estimator unet_legacy|openai|lucidrains --bf16``
    (ms a step, peak memory, breakdown), phase 8's gradient check on a
    perturbed chest OpenAI UNet, ``--remat`` for openai and unet (launches
    with the recompute; loss and gradients against the plain step, peak
    memory below it); ``cli.sample`` from each run (DDIM 25, CFG 8);
    ``cli.train_autoencoder --model diffusers_kl`` and ``diffusers_vq
    --gan`` (B=8, f32) with a resume; every run's launches held to the
    counts derived from the architecture;
16. serving and the 3-D models (slice 15): seeded, perturbed chest weights
    written as a reference Lightning ``.ckpt``; ``cli.sample --ckpt``
    bit-equal to a direct call on them; ``demo.server`` in this process on
    127.0.0.1:0 from that file (bf16, ``--serve-batch 8``, kernels built
    and warmed before it serves): a ``/sample`` page and its ``/img``
    fetches at once, deduplicated onto one run and equal to the direct
    call; 32 concurrent ``/one`` requests (PNGs decoded, batches, latency
    p50/p95, images/s, a batch's time), two seeds served alone against their
    burst rows (bit-equal, or equal to their row of a batch of copies: the
    row position, and cuDNN's bf16 convs measured at 16 identical rows); a
    spatial-attention server's ``/one`` batch; the
    refusal of ``--no-flash`` (exit 2); the smoke ``/one`` batch function
    card against CPU; kernel 1 against its plain version at the 3-D chest
    VAE's GroupNorm shapes (B=2, 64x128x128, 8 groups, f32 and bf16; the
    partly resident cluster route among them) with each plan, and its time
    at the largest beside ``F.group_norm`` + ``F.silu`` and the bytes bound;
    one f32 train step of the chest-width 3-D VAE and VQVAE at that size;
    the chest-width 3-D UNet's DDIM 50 with CFG 4 at B=2 and the decode;
    ``tests/test_3d.py``'s sizes card against CPU; a ``.nii.gz`` read
    through ``SimpleDataset3D``; every run's launches held to the counts
    derived from the architecture;
17. the last data and utility modules and the diffusers blocks (slice 16):
    ``cli.train_diffusion --grain --no-donate`` on phase 9's tree (chest,
    B=32, bf16, EMA, 3 steps): kernel 1's launches held, each step's
    indices held to grain's order of seed + epoch, a run resumed at step 2
    bit-equal to the unbroken one (cuDNN's deterministic algorithms on);
    ``prefetch_to_device`` over that loader's batches bit-equal and in order
    on the card, a 5-step loop's ms with and without it, and that loop inside
    ``utils.profiling.trace`` whose trace file must hold the ``annotate``
    region with CUDA kernels in it; the FIR resamplers, ``DResnetBlock``'s FIR
    modes, the factories' 14 block types and a small
    ``UNet2DConditionDiffusers`` card against CPU (f32, TF32 off), and the
    small UNet's bf16 step against its f32 step; the UNet at its default
    widths (859.5 M parameters) on the chest latent: a B=32 bf16 step with
    AdamW + EMA (ms, peak memory, breakdown) and DDIM 50 with CFG 4 at B=8
    and the decode;
18. parallelism (slice 17) at world 1, the one card, over NCCL (two ranks
    on one card are refused): torch's and NCCL's versions and whether
    ``fully_shard`` takes ``shard_placement_fn``; ``initialize_multihost``
    and the ('data', 'model') mesh; ``make_sharded_sampler`` at the chest
    preset's full width (B=32, bf16, DDIM 50, eta 1, CFG with
    un_cond = 1 - label, decode) bit-equal to ``pipe.denoise`` on the same
    generator with kernel 1's launches held; ``cli.sample_dataset`` under
    ``torch.distributed.run`` (one process) writing PNGs byte-equal to a
    plain run; two chest-UNet train steps (B=32, bf16) through
    ``shard_params``/``shard_batch`` for dp, FSDP and TP (min_shard_dim
    256), each bit-equal to the plain steps; ring attention bit-equal to
    kernel 2 alone (its launch counted) and the lse merge over K/V in 2 and
    4 blocks against the plain merge; its gradient (B=32): the
    ring's backward bit-equal to kernels 3 and 4 on the whole (one launch
    each), the block-pair backward over 2 and 4 K/V blocks against the plain
    backward's pairs (bf16) and over 2 at the classifier's f32 shape; the
    chest DiT-MoE with
    ``moe_expert_axis``, its forward and train steps bit-equal to the dense
    layout with kernels 3-5 counted; ``pipeline_apply`` at one stage
    bit-equal to the stage, forward and gradients; each path's ms beside
    its unsharded ms;
19. the constructor options no CLI reaches (slice 21): the chest UNet and
    VAE with ``learnable_interpolation=False`` (average-pooled encoder
    levels, resized decoder levels), bf16, DDIM 25 with CFG 8 at B=8 and
    the decode, kernel 1's launches held; one bf16 train step at B=32 of
    that UNet and of the legacy UNet whose decoders concatenate their skips
    (spatial attention at level 1, so kernel 1 normalises the 768-channel
    concatenation), each step's gradients held to an f32 step's; kernel 1
    against its plain version at every GroupNorm shape those paths ran,
    kernels 5, 3 and 4 at the legacy UNet's and the 3-D classifier's
    attention shapes, and kernel 6 at the legacy UNet's two GEGLU widths; the 3-D ``EncoderUNetOpenAI`` (attention at one
    resolution, adaptive pool) on phase 16's latent, f32 forward and
    backward with its launches held; small widths of the three on the card
    against the CPU.

Every phase's seconds are printed on a line of their own when it ends,
and all of them together before the kernels' line. The last three lines
are the kernels' JSON, the card's name and power limit as ``nvidia-smi``
gives them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
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


def bounds(flops, nbytes, exp_ms=0.0, flops_per_s=BF16_FLOPS_PER_S):
    """The card's least time for the work, in ms, and its two parts: the
    operations (the FLOPs at ``flops_per_s``, the tensor cores' bf16 peak by
    default, or ``exp_ms``, the SFU's time for the work's exponentials,
    whichever is longer) and the bytes."""
    ops_ms = max(flops / flops_per_s * 1e3, exp_ms)
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
            if (isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear))
                    and not m.weight.any()):
                bound = (m.weight[0].numel()) ** -0.5
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen, device=p.device)
                             * 2 - 1) * bound)
            elif isinstance(m, (Norm, torch.nn.LayerNorm, torch.nn.BatchNorm2d,
                                torch.nn.BatchNorm3d)) and m.weight is not None:
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


def split_fused_qkv(grads, qkv_heads=None):
    """A DiT block's fused q/k/v projection as three tensors (its q, k and
    v rows), so that a fault confined to one of them is not diluted by the
    other two; with ``qkv_heads`` an OpenAI attention block's ``qkv`` too,
    its rows in the legacy [H, 3, D] order."""
    out = {}
    for k, g in grads.items():
        stem, leaf = k.rsplit(".", 1)
        if k.endswith(("attn_qkv.weight", "attn_qkv.bias")):
            out.update({f"{stem}.{part}.{leaf}": gi for part, gi in zip("qkv", g.chunk(3))})
        elif qkv_heads and k.endswith((".qkv.weight", ".qkv.bias")):
            rows = g.unflatten(0, (qkv_heads, 3, -1))
            out.update({f"{stem}.{part}.{leaf}": rows[:, i].flatten(0, 1)
                        for i, part in enumerate("qkv")})
        else:
            out[k] = g
    return out


def grad_departure(g, ref, qkv_heads=None):
    """How far the gradients ``g`` depart from ``ref`` (name -> tensor):
    (the three worst tensors' |d|_2 / |ref|_2 with their names, worst
    first; max |d| over max |ref| across all elements). A tensor whose
    ``ref`` is all zero departs by 0 if its ``g`` is too, else by infinity.
    A fused q/k/v projection counts as three tensors
    (:func:`split_fused_qkv`). The key projections' biases are left out:
    softmax is invariant to a shift that is the same for every key, so
    their gradient is zero but for rounding in both dtypes."""
    g, ref = split_fused_qkv(g, qkv_heads), split_fused_qkv(ref, qkv_heads)
    rels = []
    for k, r in ref.items():
        if k.endswith(("to_k.bias", "qkv.k.bias")):
            continue
        d, r_norm = (g[k] - r).norm().item(), r.norm().item()
        rels.append((d / r_norm if r_norm > 0 else (0.0 if d == 0 else math.inf), k))
    top = max(r.abs().max().item() for r in ref.values())
    return (sorted(rels, reverse=True)[:3],
            max((g[k] - r).abs().max().item() for k, r in ref.items()) / top)


@contextlib.contextmanager
def planted_lse_fault(FA, head_dim, head, shift):
    """Within the block, every token-layout forward at ``head_dim`` has
    ``shift`` added to its lse on ``head``; yields the list of the faulted
    launches, so a check can tell that the fault was reached."""
    real = FA.flash_attention_tokens_cuda
    hits = []

    def faulty(q, k, v, num_heads, scale):
        o, lse = real(q, k, v, num_heads, scale)
        if q.shape[2] // num_heads == head_dim:
            lse[:, :, head] += shift
            hits.append(q.shape)
        return o, lse

    FA.flash_attention_tokens_cuda = faulty
    try:
        yield hits
    finally:
        FA.flash_attention_tokens_cuda = real


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


def check_train_grads(FA, pipe, batch, draws, faults=PLANTED_FAULTS,
                      limit=TRAIN_GRAD_REL_LIMIT, qkv_heads=None):
    """A bf16 loss and gradient against an f32 one on the same weights and
    draws, held to ``limit``; then each of ``faults``, which the same check
    must flag (``qkv_heads``: :func:`split_fused_qkv`)."""
    import torch

    l32, g32 = grads_of(pipe, batch, draws, None)
    l16, g16 = grads_of(pipe, batch, draws, torch.bfloat16)
    worst, glob = grad_departure(g16, g32, qkv_heads)
    del g16
    log(f"  bf16 vs f32 step: loss {l16.item():.5f} vs {l32.item():.5f}; gradients: "
        f"worst tensors |d|_2/|g32|_2 = {fmt_worst(worst)} (limit "
        f"{limit}); max|d|/max|g32| over all = {glob:.3e}")
    missed = []
    for label, *fault in faults:
        with planted_fault(FA, *fault):
            _, gf = grads_of(pipe, batch, draws, torch.bfloat16)
        f_worst, f_glob = grad_departure(gf, g32, qkv_heads)
        del gf
        log(f"  planted fault, {label}: worst tensors {fmt_worst(f_worst)}; "
            f"max|d|/max|g32| over all {f_glob:.3e}")
        if not f_worst[0][0] >= limit:
            missed.append(label)
    del g32
    torch.cuda.empty_cache()
    if not (torch.isfinite(l16) and abs(l16.item() - l32.item()) <= 5e-2 * abs(l32.item())):
        raise RuntimeError(f"bf16 loss {l16.item()} departs from f32 {l32.item()}")
    if not worst[0][0] < limit:
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


@contextlib.contextmanager
def timed_samplers(module):
    """Within the block, each call of a sampler that
    ``module.make_sharded_sampler`` makes is timed (host clock, after a
    synchronize before and after); yields the list of seconds."""
    import torch

    real, seconds = module.make_sharded_sampler, []

    def make(*args, **kwargs):
        fn = real(*args, **kwargs)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        return timed

    module.make_sharded_sampler = make
    try:
        yield seconds
    finally:
        module.make_sharded_sampler = real


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
        with timed_samplers(sample_dataset) as seconds:
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


# The flow family and classifier guidance (phase 13). 13a, card against
# CPU, f32: the smoke flow pipeline (spatial attention, one head) trained
# and sampled at SMOKE_TOL, its train-step gradients within CLF_GRAD_TOL x
# max|g|; the chest classifier (model channels 64 on the 32^2 x 8 latent)
# with both attending pools, its logits at SMOKE_TOL, its input gradient
# within CLF_GRAD_TOL x max|g|, and one classifier train step as phase 5's.
# The classifier attends at 16^2 = 256 tokens of width 128: one head
# (adaptive pool; d = 128) or 4 heads of 32 (attention pool,
# num_head_channels 32), and its attention pool over 257 tokens (the mean
# token prepended), 4 heads of 32: (N, C, heads), f32.
CLF_ATTN_SHAPES = ((256, 128, 1), (256, 128, 4), (257, 128, 4))
CLF_GRAD_TOL = 1e-4
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# f32-accurate products on the tensor cores: split-TF32, three tf32 products
# for each f32 one (SDPA's f32 kernels and the f32 attention backward)
SPLIT_TF32_FLOPS_PER_S = 495e12 / 3
CLF_CHANNELS = 64
# 13b: the classifier gradient's check must flag dq zeroed at d = 128, and
# a forward whose lse is 1e-3 high on one head at d = 128 (the backward
# reads lse: p = exp(s - lse) drops by 1e-3 and the attention's share of the
# gradient with it; the plain path gives 3.0e-4 x max|g| on the CPU)
CLF_FAULT = ("dq zeroed at d=128, every head", "flash_attention_bwd_dq", 5, 128,
             slice(None))
CLF_LSE_FAULT = ("lse + 1e-3 at d=128, head 0", 128, 0, 1e-3)
# 13c: the flow program on phase 9's tree and autoencoder: cli.train_diffusion
# --family flow (B=32, bf16, EMA; UNet forward + frozen encode a step), then
# cli.sample --family flow --ckpt --ema: Heun 25 (2 x 25 - 1 UNet forwards,
# CFG 8 batched), B=8, one decode, for each of 3 conditions
FLOW_STEPS, FLOW_TRAIN_STEPS = 25, 3
FLOW_GN_PER_CONDITION = (2 * FLOW_STEPS - 1) * UNET_GN_PER_FORWARD + VAE_GN_PER_DECODE  # 1674
# 13d: cli.train_classifier (B=32, f32; VAE encode 8 GroupNorms, and each
# classifier attention one token-layout forward, one dQ and one dK/dV a
# step), a resume, then cli.sample --classifier-ckpt from phase 9's
# diffusion run, B=8: (name, flags, UNet forwards a condition, classifier
# attentions a forward); the classifier runs once a forward on the 2
# labelled conditions, not on the unconditioned one. The DDIM runs take
# GUIDED_STEPS steps (150 through PR 14; cut to keep the whole script near
# its time).
CLF_TRAIN_STEPS, CLF_CKPT_EVERY = 3, 2
GUIDED_STEPS = 50
GUIDED_RUNS = ((f"ddim-{GUIDED_STEPS}-adaptive", [], GUIDED_STEPS, 1),
               (f"ddim-{GUIDED_STEPS}-attention", ["--classifier-pool", "attention"],
                GUIDED_STEPS, 2),
               ("dpmpp-25-adaptive", ["--sampler", "dpmpp", "--steps", "25"], 25, 1))


def perturb_gn_(module, gen):
    """The classifier's GroupNorm32 affines away from 1 and 0."""
    import torch

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.GroupNorm):
                for p, x in ((m.weight, 0.1), (m.bias, 0.1)):
                    p.add_(x * torch.randn(p.shape, generator=gen, device=gen.device).to(p.device))


def close_scaled(name, out, ref):
    """``out`` against ``ref`` within SMOKE_TOL x max(1, max|ref|), rtol
    SMOKE_TOL (phases 5 and 11)."""
    import torch

    out, ref = out.float().cpu(), ref.float().cpu()
    tol = SMOKE_TOL * max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    log(f"  {name}: max|d| {err:.3e} (tol {tol:.3e})")
    torch.testing.assert_close(out, ref, atol=tol, rtol=SMOKE_TOL)
    return err


def grad_gap(out, ref):
    """max |out - ref| over max |ref| (name -> tensor, or two tensors)."""
    if isinstance(ref, dict):
        top = max(r.abs().max().item() for r in ref.values())
        return max((out[k].cpu() - r.cpu()).abs().max().item() for k, r in ref.items()) / top
    return (out.cpu() - ref.cpu()).abs().max().item() / ref.abs().max().item()


def phase_smoke_flow_vs_cpu():
    """13a: the smoke flow pipeline (spatial attention, one head: d = 16 and
    32; shift 2), f32, card against CPU from the same perturbed weights,
    batch and draws: the train loss (rtol 1e-4) and its gradients (within
    CLF_GRAD_TOL x max|g|); a Heun 4-step sample with CFG 3 (decoded), the
    ODE inversion and inpainting with 2 resamplings at SMOKE_TOL."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline, build_train_pipeline

    p = PRESETS["smoke"]
    kw = dict(attention="spatial", attn_heads=1, seed=0, family="flow", flow_shift=2.0)
    cpu = build_train_pipeline(p, device="cpu", **kw)
    gen = torch.Generator().manual_seed(13)
    perturb_(cpu.noise_estimator, gen)
    perturb_(cpu.latent_embedder, gen)
    card = build_train_pipeline(p, device="cuda", **kw)
    for part in ("noise_estimator", "latent_embedder"):
        getattr(card, part).load_state_dict(getattr(cpu, part).state_dict())
    b = p.diffusion_batch_size
    batch = {"source": torch.rand((b, 32, 32, 3), generator=gen) * 2 - 1,
             "target": torch.arange(b) % 2}
    draws = cpu.train_draws(b, p.latent_shape, generator=gen)
    draws["drop"] = torch.tensor(False)  # keep the labels
    res = {}
    for name, pipe in (("cpu", cpu), ("card", card)):
        dev = pipe.device
        loss, _ = pipe.train_loss({k: v.to(dev) for k, v in batch.items()},
                                  {k: v.to(dev) for k, v in draws.items()})
        names, params = zip(*pipe.noise_estimator.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[name] = (loss.item(), {k: (torch.zeros_like(q) if g is None else g).cpu()
                                   for k, q, g in zip(names, params, grads)})
    gap = grad_gap(res["card"][1], res["cpu"][1])
    log(f"  flow train loss card {res['card'][0]!r} vs cpu {res['cpu'][0]!r}; gradients "
        f"max|d|/max|g| {gap:.3e} (limit {CLF_GRAD_TOL})")
    if abs(res["card"][0] - res["cpu"][0]) > 1e-4 * abs(res["cpu"][0]) or gap > CLF_GRAD_TOL:
        raise RuntimeError("the flow train loss departs on the card")

    samplers = {}
    for dev, src in (("cpu", cpu), ("cuda", card)):
        pipe = build_pipeline(p, device=dev, **kw)
        for part in ("noise_estimator", "latent_embedder"):
            getattr(pipe, part).load_state_dict(getattr(src, part).state_dict())
        samplers[dev] = pipe
    x_T = torch.randn((4, *p.latent_shape), generator=gen)
    known = torch.rand((4, *p.latent_shape), generator=gen) * 2 - 1
    mask = torch.zeros((4, *p.latent_shape[:2], 1))
    mask[:, :, :4] = 1.0
    noise = torch.randn((4, 2, 2, 4, *p.latent_shape), generator=gen)
    cond = torch.tensor([0, 1, 0, 1])
    runs = {
        "Heun 4-step sample": lambda s, d: s.denoise(x_T.to(d), condition=cond.to(d), steps=4,
                                                     guidance_scale=3.0),
        "ODE inversion": lambda s, d: s.invert(known.to(d), condition=cond.to(d), steps=4,
                                               guidance_scale=3.0),
        "inpainting, 2 resamplings": lambda s, d: s.sample_inpaint(
            known.to(d), mask.to(d), condition=cond.to(d), x_T=x_T.to(d), noise=noise.to(d),
            steps=4, resample_steps=2, decode=False),
    }
    for name, run in runs.items():
        close_scaled(f"flow {name} card vs cpu", run(samplers["cuda"], "cuda"),
                     run(samplers["cpu"], "cpu"))


def classifier_pair(pool, gen):
    """The chest classifier on the CPU and the card from the same perturbed
    weights."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, seeded
    from medfusion_tpu_torch.cli.train_classifier import build_classifier

    p = PRESETS["chest"]
    pair = {}
    for dev in ("cpu", "cuda"):
        with seeded(torch.device(dev), 0):
            pair[dev] = build_classifier(p, CLF_CHANNELS, pool).eval()
    perturb_(pair["cpu"], gen)
    perturb_gn_(pair["cpu"], gen)
    pair["cuda"].load_state_dict(pair["cpu"].state_dict())
    return pair


def classifier_grads(FA, pair, x, t, label):
    """The classifier's input gradient on the CPU and on the card."""
    from medfusion_tpu_torch.pipelines.diffusion import make_classifier_grad

    return {dev: make_classifier_grad(clf, label.to(dev))(x.to(dev), t.to(dev))
            for dev, clf in pair.items()}


def phase_classifier_vs_cpu(FA, worst):
    """13a and 13b: the f32 attention kernels at the classifier's shapes
    against their plain versions (forward, both backward kernels, both
    layouts; B=2); the chest classifier with each attending pool, card
    against CPU (B=2): logits at SMOKE_TOL, the input gradient within
    CLF_GRAD_TOL x max|g|; the same gradient check with dq zeroed at d =
    128 and with the forward's lse 1e-3 high on one head at d = 128 (13b),
    which it must flag; one classifier train step (the
    attention pool, on latents, B=4) with its loss, gradients and updated
    weights as phase 5's."""
    import torch

    from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
    from medfusion_tpu_torch.train import (
        ClassifierTrainer,
        TrainState,
        make_classifier_train_step,
    )

    gen = torch.Generator(device="cuda").manual_seed(14)
    for n, c, heads in CLF_ATTN_SHAPES:
        for kernel, err in check_attention(FA, n, n, c, heads, torch.float32, gen).items():
            keep(worst, kernel, "float32", err)
        for kernel, err in check_attention_backward(FA, n, n, c, heads, torch.float32,
                                                    gen).items():
            keep(worst, kernel, "float32", err)

    cgen = torch.Generator().manual_seed(15)
    x = torch.randn((2, 8, 32, 32), generator=cgen)
    t = torch.tensor([3, 900])
    label = torch.tensor([1, 0])
    report = {}
    for pool in ("adaptive", "attention"):
        pair = classifier_pair(pool, cgen)
        with torch.no_grad():
            logits = {dev: clf(x.to(dev), t.to(dev)) for dev, clf in pair.items()}
        close_scaled(f"classifier ({pool} pool) logits card vs cpu", logits["cuda"],
                     logits["cpu"])
        g = classifier_grads(FA, pair, x, t, label)
        gap = grad_gap(g["cuda"], g["cpu"])
        log(f"  classifier ({pool} pool) input gradient card vs cpu: max|d|/max|g| "
            f"{gap:.3e} (limit {CLF_GRAD_TOL})")
        if not gap <= CLF_GRAD_TOL:
            raise RuntimeError(f"the classifier gradient departs on the card by {gap:.3e}")
        report[pool] = gap
        if pool == "adaptive":  # 13b: d = 128, one head
            label_f, *fault = CLF_FAULT
            with planted_fault(FA, *fault):
                gf = classifier_grads(FA, {"cuda": pair["cuda"]}, x, t, label)["cuda"]
            f_gap = grad_gap(gf, g["cpu"])
            log(f"  [13b] planted fault, {label_f}: the classifier gradient departs by "
                f"max|d|/max|g| {f_gap:.3e} (limit {CLF_GRAD_TOL}: flagged "
                f"{f_gap > CLF_GRAD_TOL})")
            if not f_gap > CLF_GRAD_TOL:
                raise RuntimeError("the classifier gradient check misses dq zeroed at d=128")
            report["fault"] = f_gap
            label_l, *lse_fault = CLF_LSE_FAULT
            with planted_lse_fault(FA, *lse_fault) as hits:
                gl = classifier_grads(FA, {"cuda": pair["cuda"]}, x, t, label)["cuda"]
            l_gap = grad_gap(gl, g["cpu"])
            log(f"  [13b] planted forward fault, {label_l} ({len(hits)} launches): the "
                f"classifier gradient departs by max|d|/max|g| {l_gap:.3e} (limit "
                f"{CLF_GRAD_TOL}: flagged {l_gap > CLF_GRAD_TOL})")
            if not hits or not l_gap > CLF_GRAD_TOL:
                raise RuntimeError("the classifier gradient check misses the forward's lse "
                                   "1e-3 high at d=128")
            report["lse_fault"] = l_gap

    pair = classifier_pair("attention", cgen)
    sched = dict(timesteps=1000, schedule_strategy="scaled_linear", beta_start=0.002,
                 beta_end=0.02)
    b = 4
    batch = {"source": torch.randn((b, 32, 32, 8), generator=cgen),
             "target": torch.tensor([0, 1, 1, 0])}
    draws = {"t": torch.randint(0, 1000, (b,), generator=cgen),
             "eps": torch.randn((b, 32, 32, 8), generator=cgen)}
    res = {}
    for dev, clf in pair.items():
        trainer = ClassifierTrainer(classifier=clf.train(), scheduler=GaussianDiffusionSchedule
                                    .create(device=dev, **sched))
        state = TrainState(clf, lr=3e-4, weight_decay=1e-4)
        m = make_classifier_train_step(trainer)(
            state, {k: v.to(dev) for k, v in batch.items()},
            {k: v.to(dev) for k, v in draws.items()})
        res[dev] = (m["loss"].item(), {k: q.grad.cpu() for k, q in clf.named_parameters()},
                    dict(clf.named_parameters()))
    gap = grad_gap(res["cuda"][1], res["cpu"][1])
    log(f"  classifier train step card vs cpu: loss {res['cuda'][0]!r} vs {res['cpu'][0]!r}; "
        f"gradients max|d|/max|g| {gap:.3e} (limit {CLF_GRAD_TOL})")
    if abs(res["cuda"][0] - res["cpu"][0]) > 1e-4 * abs(res["cpu"][0]) or gap > CLF_GRAD_TOL:
        raise RuntimeError("the classifier train step departs on the card")
    close_settled("classifier params after 1 step", res["cuda"][2], res["cpu"][2],
                  res["cpu"][1], 3e-4)
    return report


def close_settled(name, out, ref, grads, lr):
    """Parameters after one AdamW step against ``ref``: each element within
    2 lr, and within 1e-3 lr (+ 1e-6 relative) where the step is settled by
    its gradient, |g| >= 1e-3 max|g|. Adam's first step moves an element by
    lr g / (|g| + eps), ~lr sign(g); a gradient departure of dg (the
    gradient check allows CLF_GRAD_TOL max|g|) moves it by lr eps dg / g^2,
    under 1e-3 lr there for max|g| >= 1e-3. A smaller gradient (a key bias
    under the softmax: zero but for rounding) may point either way."""
    top = max(g.abs().max().item() for g in grads.values())
    worst = worst_settled = 0.0
    n_settled = n = 0
    for k, r in ref.items():
        d = (out[k].detach().float().cpu() - r.detach().float().cpu()).abs()
        settled = grads[k].abs() >= 1e-3 * top
        worst = max(worst, d.max().item())
        excess = d - 1e-3 * lr - 1e-6 * r.detach().abs().cpu()
        n_settled, n = n_settled + int(settled.sum()), n + d.numel()
        if settled.any():
            worst_settled = max(worst_settled, excess[settled].max().item())
    log(f"  {name}: max|d| {worst:.3e} (limit {2 * lr:.1e}); the {n_settled / n:.2%} of "
        f"elements settled by their gradient (max|g| {top:.3e}) "
        f"{'within' if worst_settled <= 0 else 'beyond'} 1e-3 lr")
    if top < 1e-3:
        raise RuntimeError(f"{name}: max|g| {top} is too small for the settled test")
    if not (worst <= 2 * lr and worst_settled <= 0):
        raise RuntimeError(f"{name} departs: max {worst}, settled excess {worst_settled}")


def clf_attention_times(FA, worst):
    """13a: the f32 attention kernels at the classifier's shapes and the
    guided sampler's batch (B=8, token layout): the forward and each
    backward kernel (replayed graph of 20 launches) beside the plain
    versions and SDPA's forward and backward, each held to the plain
    version. SDPA's f32 kernels (CUTLASS's memory-efficient attention) run
    their products on the tensor cores in split-TF32
    (``OpMultiplyAddFastF32``: three tf32 products for each f32 one, not
    single-pass TF32, whatever ``allow_tf32`` says), as the forward and
    backward kernels do. So the bound is the least time for
    f32-accurate work: the FLOPs at the split-TF32 rate (495 / 3 TFLOP/s),
    the bytes, or the SFU's exponentials, whichever is longest; each
    kernel's share of it is printed beside its share of the f32 FMA bound
    (67 TFLOP/s)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(16)
    b = N_SAMPLES
    exp_per_s = exp_rate()
    rows = []
    for n, c, heads in CLF_ATTN_SHAPES:
        d = c // heads
        scale = d ** -0.25
        q, k, v, do = attn_inputs(b, n, n, c, torch.float32, gen) + (
            torch.randn((b, n, c), generator=gen, device="cuda"),)
        qh, kh, vh = (FA._heads(t, heads) for t in (q, k, v))
        fwd = lambda: FA.flash_attention_tokens_cuda(q, k, v, heads, scale)  # noqa: E731
        ref = FA.naive_attention_reference(qh, kh, vh, scale)[0]
        keep(worst, "flash_attention_tokens", "float32",
             close(f"attn f32 B={b} N={n} H={heads}", FA._heads(fwd()[0], heads), ref,
                   *attn_o_tol(ref)))
        ops, _ = bwd_operands(FA, q, k, v, heads, "tokens", do)
        t_f = graph_ms(fwd, 20)
        t_dq = graph_ms(lambda: FA.flash_attention_bwd_dq(ops, scale), 20)
        t_dkv = graph_ms(lambda: FA.flash_attention_bwd_dkv(ops, scale), 20)
        for kernel, err in check_bwd(FA, ops, scale, f"attn bwd f32 B={b} N={n}").items():
            keep(worst, kernel, "float32", err)
        oh, lse, doh, delta = ops[3], ops[8], ops[4], ops[9]
        p_f = graph_ms(lambda: FA.naive_attention_reference(qh, kh, vh, scale), 3)
        p_dq = graph_ms(lambda: FA.flash_attention_bwd_dq_reference(
            qh, kh, vh, oh, lse, doh, scale), 3)
        p_dkv = graph_ms(lambda: FA.flash_attention_bwd_dkv_reference(
            qh, kh, vh, lse, doh, delta, scale), 3)
        sc = torch.tensor(scale)
        leaves = [(t * sc).detach().requires_grad_() for t in (qh, kh)] + [
            vh.detach().requires_grad_()]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, scale=1.0)

        l_f = graph_ms(sdpa, 10)
        l_bwd = graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, doh), 10) - l_f
        bh = b * heads
        tok, stat = b * n * c * 4, bh * n * 4
        exp_ms = bh * n * n / exp_per_s * 1e3
        row = dict(B=b, N=n, C=c, H=heads, d=d)
        for what, t_k, t_p, lib, flops, nbytes in (
                ("forward", t_f, p_f, l_f, 4, 4 * tok + stat),
                ("dQ", t_dq, p_dq, l_bwd, 6, 6 * tok + 2 * stat),
                ("dK/dV", t_dkv, p_dkv, l_bwd, 8, 6 * tok + 2 * stat)):
            flops *= bh * n * n * d
            bd = bounds(flops, nbytes, exp_ms, flops_per_s=SPLIT_TF32_FLOPS_PER_S)
            fma = bounds(flops, nbytes, exp_ms, flops_per_s=F32_FLOPS_PER_S)["bound_ms"]
            row[what] = dict(ms=t_k, plain_ms=t_p, library_ms=lib, fma_bound_ms=fma, **bd)
            log(f"  f32 attention {what} B={b} N={n} H={heads} d={d}: {t_k:.4f} ms, plain "
                f"{t_p:.4f}, sdpa {'backward ' if what != 'forward' else ''}{lib:.4f}; bound "
                f"{bd['bound_ms']:.4f} ms ({'operations' if bd['ops_ms'] >= bd['bytes_ms'] else 'bytes'}"
                f", split-TF32), {bd['bound_ms'] / t_k:.1%} of bound; f32 FMA bound "
                f"{fma:.4f} ms, {fma / t_k:.1%}")
        rows.append(row)
        del q, k, v, do, ops, leaves
    torch.cuda.empty_cache()
    return rows


def sample_run(ops, sample, argv, expected, what):
    """One cli.sample run on the card: its images, seconds and peak memory,
    with the launches counted from zero and held to ``expected``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    images = sample.main([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts(what, ops.launch_counts(), expected)
    for cond, imgs in images.items():
        if imgs.shape != (N_SAMPLES, 256, 256, 3) or not math.isfinite(float(abs(imgs).max())):
            raise RuntimeError(f"{what}: condition {cond} gave {imgs.shape} or non-finite")
    log(f"  {what}: {N_SAMPLES} images x 3 conditions in {seconds:.3f} s, peak memory "
        f"{peak:.3f} GiB")
    return images, seconds, peak


def phase_flow_program(ops, tmp, root):
    """13c: the two-stage flow program on phase 9's tree and autoencoder,
    chest at full width: cli.train_diffusion --family flow (B=32, bf16,
    EMA; 42 GroupNorms a step) with the step's ms, then cli.sample --family
    flow --ckpt --ema (Heun 25, CFG 8, B=8; 1,674 GroupNorms a condition)."""
    import torch

    from medfusion_tpu_torch.cli import sample, train_diffusion
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset
    from medfusion_tpu_torch.train import make_flow_train_step

    p = PRESETS["chest"]
    ae, run = tmp / "ae", tmp / "flow"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, pipe = train_diffusion.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(ae), "--family",
        "flow", "--out", str(run), "--bf16", "--use-ema", "--max-steps",
        str(FLOW_TRAIN_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts("flow train CLI", ops.launch_counts(),
                 {"group_norm_silu": (UNET_GN_PER_FORWARD + VAE_GN_PER_ENCODE)
                  * FLOW_TRAIN_STEPS})
    log(f"  flow train CLI: {FLOW_TRAIN_STEPS} steps at B={TRAIN_BATCH} (bf16, EMA) in "
        f"{seconds:.1f} s with loading; losses {losses}")
    if not all(math.isfinite(v) for v in losses) or state.step != FLOW_TRAIN_STEPS:
        raise RuntimeError(f"flow training: step {state.step}, losses {losses}")
    ds = build_dataset(p, str(root))
    items = [ds[i] for i in range(TRAIN_BATCH)]
    batch = {"source": torch.stack([torch.from_numpy(it["source"]) for it in items]).cuda(),
             "target": torch.tensor([it["target"] for it in items]).cuda()}
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(2))
    step = make_flow_train_step(pipe, compute_dtype=torch.bfloat16)
    ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, draws, 3)
    log(f"  flow train step (B={TRAIN_BATCH}, bf16, no attention): {ms:.1f} ms/step, peak "
        f"memory {peak:.2f} GiB; profiled step wall {wall:.1f} ms, {fmt_kinds(kinds)}")
    del state, pipe, step, batch, draws
    torch.cuda.empty_cache()
    _, s_seconds, s_peak = sample_run(
        ops, sample, ["--preset", "chest", "--family", "flow", "--ckpt", str(run), "--ema",
                      "--vae-ckpt", str(ae), "--steps", str(FLOW_STEPS), "--n", str(N_SAMPLES),
                      "--out", str(tmp / "flow_samples")],
        {"group_norm_silu": 3 * FLOW_GN_PER_CONDITION},
        f"flow sample CLI (Heun {FLOW_STEPS}, CFG {GUIDANCE})")
    return {"train_ms": ms, "train_peak": peak, "sample_s": s_seconds, "sample_peak": s_peak}


def phase_classifier_program(ops, tmp, root):
    """13d: cli.train_classifier on phase 9's tree and autoencoder (chest,
    model channels 64, B=32, f32): CLF_TRAIN_STEPS steps with the launches
    held, a resume from step CLF_CKPT_EVERY (its step-3 loss held to the
    uninterrupted one's at 1e-6), a 2-step run with the attention pool;
    then cli.sample from phase 9's diffusion run, B=8, unguided and with
    each of GUIDED_RUNS, launches held, seconds and peak memory beside the
    unguided run's; the unconditioned samples bit-equal to the unguided
    run's, the labelled ones moved by the guidance."""
    import shutil

    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import sample, train_classifier
    from medfusion_tpu_torch.utils import checkpoint as C

    ae, diff = tmp / "ae", tmp / "diffusion"
    clf, clf_b, clf_attn = tmp / "classifier", tmp / "classifier_resumed", tmp / "clf_attn"
    common = ["--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(ae),
              "--device", "cuda", "--ckpt-every", str(CLF_CKPT_EVERY)]

    def per_step(attn):
        return {"group_norm_silu": VAE_GN_PER_ENCODE, "flash_attention_tokens": attn,
                "flash_attention_bwd_dq": attn, "flash_attention_bwd_dkv": attn}

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = train_classifier.main([*common, "--out", str(clf), "--max-steps",
                                           str(CLF_TRAIN_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts("classifier train CLI (adaptive pool)", ops.launch_counts(),
                 {k: v * CLF_TRAIN_STEPS for k, v in per_step(1).items()})
    log(f"  classifier train CLI: {CLF_TRAIN_STEPS} steps at B={TRAIN_BATCH} (f32) in "
        f"{seconds:.1f} s with loading; losses {losses}")
    if not all(math.isfinite(v) for v in losses) or state.step != CLF_TRAIN_STEPS:
        raise RuntimeError(f"classifier training: step {state.step}, losses {losses}")
    (clf_b / "checkpoints").mkdir(parents=True)
    for name in (f"step_{CLF_CKPT_EVERY}.pt", C.CONFIG_FILE):
        shutil.copy(clf / "checkpoints" / name, clf_b / "checkpoints" / name)
    state_b, losses_b = train_classifier.main([*common, "--out", str(clf_b), "--max-steps",
                                               str(CLF_TRAIN_STEPS), "--resume"])
    final_a = C.load_payload(clf / "checkpoints")["state"]["model"]
    final_b = C.load_payload(clf_b / "checkpoints")["state"]["model"]
    d = max((final_a[k] - final_b[k]).abs().max().item() for k in final_a)
    log(f"  classifier resume at step {CLF_CKPT_EVERY}: step {state_b.step}; step-"
        f"{CLF_TRAIN_STEPS} loss {losses_b[0]!r} vs {losses[-1]!r}; weights after it "
        f"max|d| = {d:.3e}")
    if (state_b.step != state.step or len(losses_b) != 1
            or abs(losses_b[0] - losses[-1]) > AE_RESUME_LOSS_RTOL * abs(losses[-1])):
        raise RuntimeError(f"resumed classifier: step {state_b.step}, losses {losses_b}")
    ops.reset_launch_counts()
    train_classifier.main([*common, "--out", str(clf_attn), "--max-steps", "2", "--pool",
                           "attention"])
    check_counts("classifier train CLI (attention pool)", ops.launch_counts(),
                 {k: v * 2 for k, v in per_step(2).items()})
    del state, state_b
    torch.cuda.empty_cache()

    base = ["--preset", "chest", "--ckpt", str(diff), "--ema", "--vae-ckpt", str(ae),
            "--n", str(N_SAMPLES), "--steps", str(GUIDED_STEPS)]
    plain, p_s, p_peak = sample_run(
        ops, sample, [*base, "--out", str(tmp / "unguided")],
        {"group_norm_silu": 3 * (GUIDED_STEPS * UNET_GN_PER_FORWARD + VAE_GN_PER_DECODE)},
        f"unguided sample CLI (DDIM {GUIDED_STEPS}, CFG {GUIDANCE})")
    report = {"unguided": (p_s, p_peak)}
    for name, flags, forwards, attn in GUIDED_RUNS:
        ckpt = clf_attn if "attention" in flags else clf
        images, s, peak = sample_run(
            ops, sample, [*base, "--classifier-ckpt", str(ckpt), *flags,
                          "--out", str(tmp / name)],
            {"group_norm_silu": 3 * (forwards * UNET_GN_PER_FORWARD + VAE_GN_PER_DECODE),
             "flash_attention_tokens": 2 * forwards * attn,
             "flash_attention_bwd_dq": 2 * forwards * attn,
             "flash_attention_bwd_dkv": 2 * forwards * attn},
            f"guided sample CLI {name}")
        report[name] = (s, peak)
        if name.startswith("ddim-"):
            if not np.array_equal(images[None], plain[None]):
                raise RuntimeError(f"{name}: the unconditioned samples moved")
            moved = max(np.abs(images[c] - plain[c]).max() for c in (0, 1))
            log(f"  {name}: unconditioned samples bit-equal to the unguided run's; the "
                f"labelled ones moved by up to {moved:.3e}")
            if not moved > 0:
                raise RuntimeError(f"{name}: the guidance moved nothing")
    log(f"  guided sampling against unguided (DDIM {GUIDED_STEPS}, B=8): " + "; ".join(
        f"{k} {s:.3f} s, {peak:.3f} GiB" for k, (s, peak) in report.items()))
    return report


# Phase 14: the DiT estimator, its mixture-of-experts blocks and distillation
# (slice 13). The chest DiT (cli/presets.py::dit_sizing): hidden 1,024, 16
# heads of 64, depth 12, patch 2 on the 32^2 x 8 latent, so 256 tokens; each
# block's attention takes q, k and v as column slices of one [B, N, 3C]
# projection (row stride 3C) and launches one token-layout forward, and in
# training one dQ and one dK/dV. The DiT has no GroupNorm: a run's
# GroupNorms are the frozen VAE's (8 an encode, 8 a decode).
DIT_TOKENS, DIT_WIDTH, DIT_HEADS, DIT_DEPTH = 256, 1024, 16, 12
DIT_TRAIN_STEPS = 2  # cut from 3 for the script's time
# the kernels at the DiT's shape: the sampling batch's CFG rows (forward) and
# the training batch (backward)
DIT_FWD_B, DIT_BWD_B = 2 * N_SAMPLES, TRAIN_BATCH
# 14a: the smoke DiT card against CPU (f32), dense and with 4 experts
DIT_SMOKE_MOE = dict(moe_experts=4, moe_every=2)
# 14b: the DiT's gradient check must flag dq zeroed at d = 64 on head 0
DIT_FAULT = ("dq zeroed at d=64, head 0", "flash_attention_bwd_dq", 5, 64, 0)
# 14d: the chest DiT with 8 experts, top-2, capacity 1.25, every second
# block (GShard's default; DiT-MoE's expert count, arXiv:2407.11633)
DIT_MOE = dict(moe_experts=8, moe_num_selected=2, moe_capacity_factor=1.25, moe_every=2)
# 14e: cli.distill, DISTILL_ITERS iterations of each method at B=32, bf16;
# the consistency student sampled in CONSISTENCY_STEPS rounds; reflow's pool
# REFLOW_PAIR_BATCHES batches of a REFLOW_TEACHER_STEPS-step Heun ODE
DISTILL_ITERS, CONSISTENCY_STEPS = 2, 2  # DISTILL_ITERS cut from 3 for time
DIT_SAMPLE_STEPS = 50  # 14b's DiT DDIM (cut from 150 for the script's time)
REFLOW_TEACHER_STEPS, REFLOW_PAIR_BATCHES = 4, 1


def dit_launches(forwards=0, backwards=0, encodes=0, decodes=0):
    """The kernel launches of DiT forwards and backwards and VAE encodes and
    decodes, from the architecture: one token-layout attention a block, and
    the VAE's GroupNorms."""
    return {"group_norm_silu": VAE_GN_PER_ENCODE * encodes + VAE_GN_PER_DECODE * decodes,
            "flash_attention_tokens": DIT_DEPTH * forwards,
            "flash_attention_bwd_dq": DIT_DEPTH * backwards,
            "flash_attention_bwd_dkv": DIT_DEPTH * backwards}


def unet_launches(forwards=0, encodes=0, decodes=0):
    return {"group_norm_silu": UNET_GN_PER_FORWARD * forwards + VAE_GN_PER_ENCODE * encodes
            + VAE_GN_PER_DECODE * decodes}


def phase_dit_vs_cpu():
    """14a: the smoke preset's DiT (hidden 64, 4 heads of 16, depth 6) and
    a DiT-MoE of 4 experts, f32, card against CPU from the same perturbed
    weights, batch and draws: a CFG-masked forward at SMOKE_TOL, the train
    loss and ``moe_aux`` (rtol SMOKE_TOL) and its gradients within
    CLF_GRAD_TOL x max|g| (phase 5's tolerances)."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline, build_unet, seeded

    p = PRESETS["smoke"]
    for name, options in (("DiT", {}), ("DiT-MoE", DIT_SMOKE_MOE)):
        pipes = {}
        for dev in ("cpu", "cuda"):
            pipe = build_train_pipeline(p, device=dev, estimator="dit", seed=0)
            with seeded(torch.device(dev), 0):
                dit = build_unet(p, "dit", **options)
            pipes[dev] = dataclasses.replace(pipe, noise_estimator=dit)
        gen = torch.Generator().manual_seed(14)
        cpu, card = pipes["cpu"], pipes["cuda"]
        perturb_(cpu.noise_estimator, gen)
        perturb_(cpu.latent_embedder, gen)
        card.noise_estimator.load_state_dict(cpu.noise_estimator.state_dict())
        card.latent_embedder.load_state_dict(cpu.latent_embedder.state_dict())
        b = p.diffusion_batch_size
        x = torch.randn((b, p.emb_channels, *p.latent_shape[:2]), generator=gen)
        t = torch.randint(0, p.timesteps, (b,), generator=gen)
        cond, mask = torch.arange(b) % 2, torch.tensor([1.0, 0.0] * (b // 2))
        batch = {"source": torch.rand((b, 32, 32, 3), generator=gen) * 2 - 1,
                 "target": torch.arange(b) % 2}
        draws = dict(cpu.train_draws(b, p.latent_shape, generator=gen),
                     drop=torch.tensor(False))
        out = {}
        for dev, pipe in (("cpu", cpu), ("cuda", card)):
            est = pipe.noise_estimator
            with torch.no_grad():
                y, _ = est(x.to(dev), t.to(dev), cond.to(dev), mask.to(dev))
            est.zero_grad(set_to_none=True)
            loss, metrics = pipe.train_loss({k: v.to(dev) for k, v in batch.items()},
                                            {k: v.to(dev) for k, v in draws.items()})
            loss.backward()
            out[dev] = (y, loss.detach(), metrics["moe_aux"].detach(),
                        {k: q.grad.detach().cpu() for k, q in est.named_parameters()
                         if q.grad is not None})
        (y0, l0, a0, g0), (y1, l1, a1, g1) = out["cpu"], out["cuda"]
        close_scaled(f"smoke {name} forward (labels, CFG mask)", y1, y0)
        torch.testing.assert_close(torch.stack([l1, a1]).cpu(), torch.stack([l0, a0]),
                                   rtol=SMOKE_TOL, atol=0)
        gap = grad_gap(g1, g0)
        log(f"  smoke {name} train_loss: loss {l1.item():.6f} vs {l0.item():.6f}, moe_aux "
            f"{a1.item():.6e} vs {a0.item():.6e}; gradients ({len(g0)} tensors) max|d| "
            f"{gap:.3e} of max|g| (limit {CLF_GRAD_TOL})")
        if set(g1) != set(g0) or not gap <= CLF_GRAD_TOL:
            raise RuntimeError(f"smoke {name}: card gradients depart by {gap}")
        if options and not a0.item() > 0:
            raise RuntimeError(f"smoke {name}: moe_aux {a0.item()} is not positive")


def qkv_slices(b, n, c, heads, dtype, gen, new_order=True):
    """q, k, v as an attention block makes them from one [B, N, 3C]
    projection (returned last): column slices (row stride 3C) in the [3, H,
    D] channel order (the DiT's, the OpenAI UNet's ``new_order``), or
    copies of each head's columns in the [H, 3, D] order (the OpenAI UNet's
    legacy ``QKVAttentionLegacy``, ``models/unet_openai.py::_split_qkv``)."""
    import torch

    from medfusion_tpu_torch.models.unet_openai import _split_qkv

    qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda").to(dtype)
    return (*_split_qkv(qkv, heads, new_order), qkv)


def dit_qkv(b, dtype, gen):
    return qkv_slices(b, DIT_TOKENS, DIT_WIDTH, DIT_HEADS, dtype, gen)


def slice_attention_checks(FA, worst, label, n, c, heads, new_order=True):
    """Kernel 5 and both backward kernels at B=2 on q/k/v from one [B, N,
    3C] projection (:func:`qkv_slices`), bf16 and f32, against their plain
    versions; the forward reads column slices in place (no copy), and the
    autograd backward returns one [B, N, 3C] gradient of the projection,
    held to the plain backward's."""
    import torch

    from medfusion_tpu_torch.models.unet_openai import _split_qkv

    gen = torch.Generator(device="cuda").manual_seed(15)
    d = c // heads
    scale = d ** -0.25
    order = "row stride 3C" if new_order else "[H, 3, D] order, copies"
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, qkv = qkv_slices(2, n, c, heads, dtype, gen, new_order)
        ops = FA.flash_attention_forward_operands(q, k, v, heads)
        if [t.data_ptr() for t in ops[:3]] != [t.data_ptr() for t in (q, k, v)]:
            raise RuntimeError("the token-layout forward copied the strided q/k/v slices")
        qh, kh, vh = (FA._heads(t, heads) for t in (q, k, v))
        ro, rlse = FA.naive_attention_reference(qh, kh, vh, scale)
        o, lse = FA.flash_attention_tokens_cuda(q, k, v, heads, scale)
        tag = f"{label} attention B=2 N={n} H={heads} d={d} ({order}) {name}"
        keep(worst, "flash_attention_tokens", name,
             close(tag + " o", FA._heads(o, heads), ro, *attn_o_tol(ro)))
        close(tag + " lse", lse.transpose(1, 2), rlse, ATTN_LSE_TOL[name], ATTN_LSE_TOL[name])
        leaf = qkv.detach().requires_grad_()
        do = torch.randn((2, n, c), generator=gen, device="cuda").to(dtype)
        out, _ = FA.flash_attention_tokens(*_split_qkv(leaf, heads, new_order), heads, scale)
        (g,) = torch.autograd.grad(out, leaf, do)
        refs = FA.flash_attention_backward_reference(
            qh, kh, vh, FA._heads(o, heads), lse.transpose(1, 2), FA._heads(do, heads), scale)
        errs = [close(f"{tag} d{w}", FA._heads(gi, heads), r, *attn_bwd_tol(r))
                for w, gi, r in zip("qkv", _split_qkv(g, heads, new_order), refs)]
        keep(worst, "flash_attention_bwd_dq", name, errs[0])
        keep(worst, "flash_attention_bwd_dkv", name, max(errs[1:]))
        log(f"  {tag}: forward in place, max|d| o {worst['flash_attention_tokens'][name]:.3e}; "
            f"the [B, N, 3C] gradient {tuple(g.shape)}: dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
            f"dv {errs[2]:.3e}")


def dit_attention_checks(FA, worst):
    """14a: :func:`slice_attention_checks` at the DiT's shape (256 tokens,
    16 heads of 64)."""
    slice_attention_checks(FA, worst, "DiT", DIT_TOKENS, DIT_WIDTH, DIT_HEADS)


def slice_attention_times(FA, worst, label, n, c, heads, fwd_b, bwd_b, new_order=True):
    """Kernel 5 at ``fwd_b`` rows and kernels 3 and 4 at ``bwd_b``, bf16, on
    q/k/v of one projection (:func:`qkv_slices`; replayed graph of 20
    launches), each beside its plain version and SDPA (its backward one
    call for dq, dk and dv), each checked; the bounds as phase 4's; then
    the copy the backward's token-layout gradients cost (dq, dk and dv come
    back in [B, H, N, D] order, and their [B, N, C] views are copied before
    the projection's gradient is assembled)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(16)
    exp_per_s = exp_rate()
    d, h = c // heads, heads
    scale = d ** -0.25
    rows = {}
    for what, b in (("forward", fwd_b), ("backward", bwd_b)):
        q, k, v, _ = qkv_slices(b, n, c, h, torch.bfloat16, gen, new_order)
        qh, kh, vh = (FA._heads(t, h) for t in (q, k, v))
        sc = torch.tensor(scale, dtype=torch.bfloat16)
        leaves = [(t * sc).detach().requires_grad_() for t in (qh, kh)] + [
            vh.detach().requires_grad_()]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, scale=1.0)

        bh, tok, stat = b * h, b * n * c * 2, b * h * n * 4
        exp_ms = bh * n * n / exp_per_s * 1e3
        if what == "forward":
            fwd = lambda: FA.flash_attention_tokens_cuda(q, k, v, h, scale)  # noqa: E731
            ref = FA.naive_attention_reference(qh, kh, vh, scale)[0]
            keep(worst, "flash_attention_tokens", "bfloat16",
                 close(f"{label} attention B={b}", FA._heads(fwd()[0], h), ref,
                       *attn_o_tol(ref)))
            flops = 4 * bh * n * n * d
            rows["flash_attention_tokens"] = dict(
                B=b, ms=graph_ms(fwd, 20),
                plain_ms=graph_ms(lambda: FA.naive_attention_reference(qh, kh, vh, scale), 3),
                library_ms=graph_ms(sdpa, 10), **bounds(flops, 4 * tok + stat, exp_ms))
            continue
        do = torch.randn((b, n, c), generator=gen, device="cuda").bfloat16()
        ops, _ = bwd_operands(FA, q, k, v, h, "tokens", do)
        t_dq = graph_ms(lambda: FA.flash_attention_bwd_dq(ops, scale), 20)
        t_dkv = graph_ms(lambda: FA.flash_attention_bwd_dkv(ops, scale), 20)
        for kernel, err in check_bwd(FA, ops, scale, f"{label} attention bwd B={b}").items():
            keep(worst, kernel, "bfloat16", err)
        oh, doh, lse, delta = ops[3], ops[4], ops[8], ops[9]
        p_dq = graph_ms(lambda: FA.flash_attention_bwd_dq_reference(
            qh, kh, vh, oh, lse, doh, scale), 3)
        p_dkv = graph_ms(lambda: FA.flash_attention_bwd_dkv_reference(
            qh, kh, vh, lse, doh, delta, scale), 3)
        l_f = graph_ms(sdpa, 10)
        lib = graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, doh), 10) - l_f
        for kernel, t_k, t_p, f in (("flash_attention_bwd_dq", t_dq, p_dq, 6),
                                    ("flash_attention_bwd_dkv", t_dkv, p_dkv, 8)):
            rows[kernel] = dict(B=b, ms=t_k, plain_ms=t_p, library_ms=lib,
                                **bounds(f * bh * n * n * d, 6 * tok + 2 * stat, exp_ms))
        grads = ops[5:8]
        copy_ms = graph_ms(lambda: [gr.transpose(1, 2).flatten(2) for gr in grads], 20)
        log(f"  {label} attention backward: dq/dk/dv strides {grads[0].stride()} ([B, H, N, "
            f"D] order); their [B, N, C] views copied: {copy_ms:.4f} ms a layer at B={b}")
        rows["grad_copy_ms"] = copy_ms
        del ops, do
    for kernel in ("flash_attention_tokens", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv"):
        r = rows[kernel]
        log(f"  {kernel} at the {label}'s shape (B={r['B']}, N={n}, H={h}, d={d}, bf16): "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA{'' if kernel.endswith('tokens') else ' backward'} "
            f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
            f"({'operations' if r['ops_ms'] >= r['bytes_ms'] else 'bytes'}), "
            f"{r['bound_ms'] / r['ms']:.1%} of bound")
    torch.cuda.empty_cache()
    return rows


def dit_attention_times(FA, worst):
    """14a: :func:`slice_attention_times` at the DiT's shape, the sampling
    rows (B=16) forward and the training batch (B=32) backward."""
    return slice_attention_times(FA, worst, "DiT", DIT_TOKENS, DIT_WIDTH, DIT_HEADS,
                                 DIT_FWD_B, DIT_BWD_B)


def phase_dit_train(ops, FA, tmp, root):
    """14b: cli.train_diffusion --estimator dit on phase 9's tree and
    autoencoder (chest, B=32, bf16, EMA, DIT_TRAIN_STEPS steps) with its
    launches held to the architecture's; the step's ms, peak memory and
    breakdown; then phase 8's bf16-against-f32 gradient check on a
    perturbed chest DiT, shown to flag DIT_FAULT."""
    import torch

    from medfusion_tpu_torch.cli import train_diffusion
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset, build_train_pipeline
    from medfusion_tpu_torch.models.dit import DiTBlock
    from medfusion_tpu_torch.train import make_diffusion_train_step

    p = PRESETS["chest"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, pipe = train_diffusion.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(tmp / "ae"),
        "--estimator", "dit", "--out", str(tmp / "dit"), "--bf16", "--use-ema",
        "--max-steps", str(DIT_TRAIN_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    blocks = sum(isinstance(m, DiTBlock) for m in pipe.noise_estimator.modules())
    if blocks != DIT_DEPTH:
        raise RuntimeError(f"the chest DiT has {blocks} blocks, the counts assume {DIT_DEPTH}")
    check_counts("DiT train CLI", ops.launch_counts(),
                 {k: v * DIT_TRAIN_STEPS for k, v in dit_launches(1, 1, encodes=1).items()})
    n_params = sum(q.numel() for q in state.model.parameters())
    log(f"  DiT train CLI ({n_params / 1e6:.1f} M parameters): {DIT_TRAIN_STEPS} steps at "
        f"B={TRAIN_BATCH} (bf16, EMA) in {seconds:.1f} s with loading; losses {losses}; "
        f"a step launches {dit_launches(1, 1, encodes=1)}")
    if not all(math.isfinite(v) for v in losses) or state.step != DIT_TRAIN_STEPS:
        raise RuntimeError(f"DiT training: step {state.step}, losses {losses}")
    ds = build_dataset(p, str(root))
    items = [ds[i] for i in range(TRAIN_BATCH)]
    batch = {"source": torch.stack([torch.from_numpy(it["source"]) for it in items]).cuda(),
             "target": torch.tensor([it["target"] for it in items]).cuda()}
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(2))
    step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
    ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, draws, 3)
    log(f"  DiT train step (B={TRAIN_BATCH}, bf16): {ms:.1f} ms/step, peak memory "
        f"{peak:.2f} GiB; profiled step wall {wall:.1f} ms, {fmt_kinds(kinds)}")
    del state, pipe, step
    torch.cuda.empty_cache()
    check = build_train_pipeline(p, device="cuda", estimator="dit", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    perturb_(check.noise_estimator, gen)
    check_train_grads(FA, check, batch, draws, faults=(DIT_FAULT,))
    del check, batch, draws
    torch.cuda.empty_cache()
    return {"train_ms": ms, "train_peak": peak}


def phase_dit_sample_and_flow(ops, tmp, root):
    """14c: cli.sample --estimator dit --ckpt --ema from 14b's run (DDIM
    150, CFG 8, B=8, 3 conditions: 1,800 token launches a condition);
    cli.train_diffusion --family flow --estimator dit (DIT_TRAIN_STEPS steps)
    and cli.sample --family flow from it (Heun 25: 49 forwards a
    condition); launches held, seconds and peak memory."""
    import torch

    from medfusion_tpu_torch.cli import sample, train_diffusion

    ae = str(tmp / "ae")
    _, s_dit, p_dit = sample_run(
        ops, sample, ["--preset", "chest", "--estimator", "dit", "--ckpt", str(tmp / "dit"),
                      "--ema", "--vae-ckpt", ae, "--n", str(N_SAMPLES), "--steps",
                      str(DIT_SAMPLE_STEPS), "--out", str(tmp / "dit_samples")],
        dit_launches(3 * DIT_SAMPLE_STEPS, decodes=3),
        f"DiT sample CLI (DDIM {DIT_SAMPLE_STEPS}, CFG {GUIDANCE})")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, _ = train_diffusion.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", ae, "--estimator", "dit",
        "--family", "flow", "--out", str(tmp / "dit_flow"), "--bf16", "--use-ema",
        "--max-steps", str(DIT_TRAIN_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    f_train_s = time.perf_counter() - t0
    check_counts("DiT flow train CLI", ops.launch_counts(),
                 {k: v * DIT_TRAIN_STEPS for k, v in dit_launches(1, 1, encodes=1).items()})
    if not all(math.isfinite(v) for v in losses) or state.step != DIT_TRAIN_STEPS:
        raise RuntimeError(f"DiT flow training: step {state.step}, losses {losses}")
    log(f"  DiT flow train CLI: {DIT_TRAIN_STEPS} steps in {f_train_s:.1f} s with loading; "
        f"losses {losses}")
    del state
    torch.cuda.empty_cache()
    _, s_flow, p_flow = sample_run(
        ops, sample, ["--preset", "chest", "--estimator", "dit", "--family", "flow", "--ckpt",
                      str(tmp / "dit_flow"), "--ema", "--vae-ckpt", ae, "--steps",
                      str(FLOW_STEPS), "--n", str(N_SAMPLES), "--out", str(tmp / "dit_flow_s")],
        dit_launches(3 * (2 * FLOW_STEPS - 1), decodes=3),
        f"DiT flow sample CLI (Heun {FLOW_STEPS}, CFG {GUIDANCE})")
    return {"sample_s": s_dit, "sample_peak": p_dit, "flow_sample_s": s_flow,
            "flow_sample_peak": p_flow}


def phase_dit_moe(ops):
    """14d: the chest DiT with DIT_MOE, one bf16 train step at B=32 (after a
    warm-up): ms, peak memory, a finite positive ``moe_aux``, a non-zero
    router gradient in every routed block, and each routed block's share of
    dropped (token, expert) assignments."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline, build_unet, seeded
    from medfusion_tpu_torch.parallel.moe import MoEMLP
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    pipe = build_train_pipeline(p, device="cuda", estimator="dit", seed=0)
    with seeded(torch.device("cuda"), 0):
        dit = build_unet(p, "dit", **DIT_MOE)
    pipe = dataclasses.replace(pipe, noise_estimator=dit)
    moes = [m for m in dit.modules() if isinstance(m, MoEMLP)]
    dropped = {}

    def record(i, moe):
        def hook(_, __, logits):
            _, combine, _ = moe.route(logits.detach().float())
            k = min(moe.num_selected, moe.num_experts)
            kept = (combine > 0).sum().item()
            dropped[i] = 1.0 - kept / (logits.shape[0] * logits.shape[1] * k)
        return hook

    handles = [m.router.register_forward_hook(record(i, m)) for i, m in enumerate(moes)]
    batch = train_batches(p, 1, seed=4)[0]
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(4))
    state = TrainState(dit, lr=p.diffusion_lr, weight_decay=1e-2, use_ema=True)
    step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
    ops.reset_launch_counts()
    metrics = step(state, batch, draws)
    check_counts("DiT-MoE train step", ops.launch_counts(),
                 dit_launches(1, 1, encodes=1))
    aux = float(metrics["moe_aux"])
    router = [m.router.weight.grad.abs().max().item() for m in moes]
    shares = [round(dropped[i], 4) for i in range(len(moes))]
    for h in handles:
        h.remove()
    ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, draws, 3)
    n_params = sum(q.numel() for q in dit.parameters())
    log(f"  DiT-MoE ({len(moes)} routed blocks of {DIT_MOE['moe_experts']} experts, top-"
        f"{DIT_MOE['moe_num_selected']}, capacity factor {DIT_MOE['moe_capacity_factor']}; "
        f"{n_params / 1e6:.1f} M parameters) train step B={TRAIN_BATCH}, bf16: {ms:.1f} "
        f"ms/step, peak memory {peak:.2f} GiB; moe_aux {aux:.6f}; router max|grad| by "
        f"block {[f'{g:.2e}' for g in router]}; dropped share by block {shares}; profiled "
        f"step wall {wall:.1f} ms, {fmt_kinds(kinds)}")
    if not (math.isfinite(aux) and aux > 0 and all(g > 0 for g in router)):
        raise RuntimeError(f"DiT-MoE: moe_aux {aux}, router gradients {router}")
    del state, step, pipe, dit, batch, draws
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "aux": aux, "dropped": shares}


def phase_distill(ops, tmp, root):
    """14e: cli.distill at the chest preset's full width on phase 9's tree
    and autoencoder, B=32, bf16, DISTILL_ITERS iterations each, launches
    held: pd (one stage to 8 steps) from phase 9's UNet and from 14b's DiT;
    cd (Heun teacher) from the UNet, then cli.sample --sampler consistency
    from its student; ct; reflow from phase 13's flow run. Each
    iteration's frozen encode launches the encoder's GroupNorms; a UNet
    forward its 34, a DiT forward and backward its 12 attentions."""
    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import distill, sample

    base = ["--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(tmp / "ae"),
            "--iters-per-stage", str(DISTILL_ITERS), "--bf16", "--device", "cuda"]
    it = DISTILL_ITERS

    def per_iter(counts, n=it):
        return {k: v * n for k, v in counts.items()}

    reflow_pool = REFLOW_PAIR_BATCHES * (2 * REFLOW_TEACHER_STEPS - 1)
    runs = (
        ("pd UNet", ["--method", "pd", "--teacher-ckpt", str(tmp / "diffusion"), "--objective",
                     "x_T", "--start-steps", "8", "--stages", "1"],
         per_iter(unet_launches(3, encodes=1))),
        ("pd DiT", ["--method", "pd", "--estimator", "dit", "--teacher-ckpt",
                    str(tmp / "dit"), "--objective", "x_T", "--start-steps", "8", "--stages",
                    "1"], per_iter(dit_launches(3, 1, encodes=1))),
        ("cd UNet", ["--method", "cd", "--teacher-ckpt", str(tmp / "diffusion"),
                     "--objective", "x_T", "--cd-solver", "heun"],
         per_iter(unet_launches(4, encodes=1))),
        ("ct UNet", ["--method", "ct", "--objective", "x_T", "--ct-doublings", "1"],
         per_iter(unet_launches(2, encodes=1))),
        ("reflow UNet", ["--method", "reflow", "--teacher-ckpt", str(tmp / "flow"),
                         "--reflow-teacher-steps", str(REFLOW_TEACHER_STEPS), "--pair-batches",
                         str(REFLOW_PAIR_BATCHES)],
         unet_launches(reflow_pool + it)),
    )
    report = {}
    for name, flags, expected in runs:
        out = tmp / "distill" / name.replace(" ", "_")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        records = distill.main([*base, *flags, "--out", str(out)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_counts(f"distill {name}", ops.launch_counts(), expected)
        rec = records[0]
        if len(rec["losses"]) != it or not all(math.isfinite(v) for v in rec["losses"]):
            raise RuntimeError(f"distill {name}: losses {rec['losses']}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        report[name] = (rec["seconds"] / it * 1e3, seconds, peak)
        log(f"  distill {name}: {it} iterations at B={TRAIN_BATCH} in {rec['seconds']:.2f} s "
            f"({rec['seconds'] / it * 1e3:.1f} ms an iteration, the first with its warm-up; "
            f"loading batches included), {seconds:.1f} s with set-up; peak memory {peak:.2f} "
            f"GiB; losses {[round(v, 5) for v in rec['losses']]}")
        torch.cuda.empty_cache()
    images, s, peak = sample_run(
        ops, sample, ["--preset", "chest", "--sampler", "consistency", "--objective", "x_T",
                      "--ckpt", str(tmp / "distill" / "cd_UNet" / "consistency"),
                      "--vae-ckpt", str(tmp / "ae"), "--steps", str(CONSISTENCY_STEPS),
                      "--n", str(N_SAMPLES), "--out", str(tmp / "consistency_samples")],
        unet_launches(3 * CONSISTENCY_STEPS, decodes=3),
        f"consistency sample CLI ({CONSISTENCY_STEPS} rounds)")
    if np.array_equal(images[0], images[1]):
        raise RuntimeError("consistency samples ignore the label")
    report["consistency sample"] = (None, s, peak)
    return report


# Phase 15: the other estimator families and the diffusers autoencoders
# (slice 14). At the chest preset (cli/presets.py::build_unet): unet_legacy
# has the unet family's widths with one down and up block a level, 14
# GroupNorm(+SiLU) launches a forward (2 in its inc conv block and in each
# of its 3 encoder and 3 decoder conv blocks); openai (model channels 256,
# mult 1, 1, 2, 4, two res blocks, scale-shift norm, resblock up/down)
# keeps its GroupNorms in float32 with F.group_norm and attends once, in
# its middle block at 4^2 = 16 tokens of 1,024 channels, 8 heads of 128:
# one token-layout forward a forward, and in training one dQ and one dK/dV;
# lucidrains (dim 256) launches nothing. A run's other GroupNorms are the
# frozen VAE's (8 an encode, 8 a decode). With --remat, the unet family's 17
# conv blocks (all 34 of its GroupNorms) and the openai family's res and
# attention blocks run their forward again in the backward.
FAMILIES = ("unet_legacy", "openai", "lucidrains")
FAMILY_STEPS = 2  # cut from 3 for the script's time
FAMILY_SAMPLE_STEPS = 25  # 15d's DDIM (cut from 150, then 50, for the script's time)
LEGACY_GN_PER_FORWARD = 14
OPENAI_TOKENS, OPENAI_WIDTH, OPENAI_HEADS = 16, 1024, 8
# 15a: the smoke-width families, card against CPU (f32) at phase 14a's
# tolerances: (label, estimator, model options, pipeline options, context)
FAMILY_SMOKE = (
    ("unet_legacy (attention, deep supervision)", "unet_legacy",
     dict(use_attention=["none", "spatial"], deep_supervision=True), {}, False),
    ("openai (attention legacy order)", "openai",
     dict(attention_resolutions=(1, 2), num_heads=4), {}, False),
    ("openai (attention new order)", "openai",
     dict(attention_resolutions=(1, 2), num_head_channels=8, use_new_attention_order=True),
     {}, False),
    ("openai (spatial transformer, context)", "openai",
     dict(attention_resolutions=(2,), use_spatial_transformer=True, context_dim=8,
          num_heads=2), {}, True),
    ("lucidrains (self-cond, learned variance, learned sinusoidal)", "lucidrains",
     dict(self_condition=True, learned_variance=True, learned_sinusoidal_cond=True),
     dict(use_self_conditioning=True, estimate_variance=True), False),
)
# 15c: phase 8's bf16-against-f32 check on the chest OpenAI UNet, its
# middle block's qkv split into q, k and v rows (legacy [H, 3, D] order) so
# that dq zeroed on every head reads its whole q part. The scale-shift
# projections' gradients are sums over the positions of products that
# cancel, and depart further in bf16 than phase 8's UNet's: on an H100
# (700 W) the sound step read 9.2e-2 at worst (an emb_layers weight),
# against 2.1e-2 for phase 8's UNet, hence a limit of its own
OPENAI_GRAD_REL_LIMIT = 0.3
# 15c: the remat step's gradients against the plain step's on the same
# weights and draws (bf16): the same operations, but cuDNN's backward is not
# deterministic, so each tensor within REMAT_GRAD_REL (|d|_2 / |g|_2); the
# loss to REMAT_LOSS_RTOL (the forward is)
REMAT_GRAD_REL, REMAT_LOSS_RTOL = 1e-2, 1e-6
# 15e: the diffusers autoencoders through cli.train_autoencoder, chest, f32,
# B=8: KL plain, VQ with the GAN (one PatchGAN; the discriminator's terms
# from optimizer step 2 // 2 = 1, the generator's after 2: both on in batch
# 3); checkpoints at 2 and 3 and a resume from 2. They launch no kernel.
DIFFUSERS_RUNS = (("diffusers_kl", []), ("diffusers_vq", ["--gan", "--start-gan-step", "2"]))


def ram_dir(need_gib=64):
    """/dev/shm where the machine has it with ``need_gib`` free, else None
    (the default temporary directory): phase 15's checkpoints (some GB a
    run, each saved twice with the best pointer's copy) stay off the disk,
    to which the earlier phases' runs already write some 40 GiB."""
    import shutil

    try:
        return "/dev/shm" if shutil.disk_usage("/dev/shm").free >= need_gib * 2**30 else None
    except OSError:
        return None


def family_launches(estimator, forwards=0, backwards=0, encodes=0, decodes=0, remat=False):
    """The kernel launches of estimator forwards and backwards and VAE
    encodes and decodes at the chest preset, from the architecture; with
    ``remat`` each backward runs the recomputed blocks' forward again."""
    fwd = {"unet": {"group_norm_silu": UNET_GN_PER_FORWARD},
           "unet_legacy": {"group_norm_silu": LEGACY_GN_PER_FORWARD},
           "openai": {"flash_attention_tokens": 1}, "lucidrains": {}}[estimator]
    again = backwards if remat else 0
    out = {k: v * (forwards + again) for k, v in fwd.items()}
    if estimator == "openai":
        out.update(flash_attention_bwd_dq=backwards, flash_attention_bwd_dkv=backwards)
    out["group_norm_silu"] = (out.get("group_norm_silu", 0) + VAE_GN_PER_ENCODE * encodes
                              + VAE_GN_PER_DECODE * decodes)
    return out


def phase_families_vs_cpu():
    """15a: the smoke preset's legacy, OpenAI and lucidrains UNets and the
    diffusers KL and VQ autoencoders, f32, card against CPU from the same
    perturbed weights, batch and draws: a forward at SMOKE_TOL, one train
    step's loss (rtol SMOKE_TOL) and its gradients within CLF_GRAD_TOL x
    max|g| (phase 14a's tolerances). The OpenAI UNet with a context trains
    on its own MSE (the pipeline passes no context)."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import (
        PRESETS,
        build_train_pipeline,
        build_unet,
        build_vae,
        seeded,
    )
    from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer

    p = PRESETS["smoke"]
    b = p.diffusion_batch_size
    gen = torch.Generator().manual_seed(15)
    x = torch.randn((b, p.emb_channels, *p.latent_shape[:2]), generator=gen)
    t = torch.randint(0, p.timesteps, (b,), generator=gen)
    cond, mask = torch.arange(b) % 2, torch.tensor([1.0, 0.0] * (b // 2))
    ctx = torch.randn((b, 3, 8), generator=gen)
    batch = {"source": torch.rand((b, 32, 32, 3), generator=gen) * 2 - 1,
             "target": torch.arange(b) % 2}
    report = {}
    for label, est, options, pipe_options, with_ctx in FAMILY_SMOKE:
        pipes = {}
        for dev in ("cpu", "cuda"):
            pipe = build_train_pipeline(p, device=dev, estimator=est, seed=0)
            with seeded(torch.device(dev), 0):
                model = build_unet(p, est, **options)
            pipes[dev] = dataclasses.replace(pipe, noise_estimator=model, **pipe_options)
        cpu, card = pipes["cpu"], pipes["cuda"]
        perturb_(cpu.noise_estimator, gen)
        perturb_gn_(cpu.noise_estimator, gen)
        perturb_(cpu.latent_embedder, gen)
        card.noise_estimator.load_state_dict(cpu.noise_estimator.state_dict())
        card.latent_embedder.load_state_dict(cpu.latent_embedder.state_dict())
        draws = dict(cpu.train_draws(b, p.latent_shape, generator=gen), drop=torch.tensor(False))
        out = {}
        for dev, pipe in (("cpu", cpu), ("cuda", card)):
            est_m = pipe.noise_estimator
            kw = {"context": ctx.to(dev)} if with_ctx else {}
            if pipe_options.get("use_self_conditioning"):
                kw["self_cond"] = x.to(dev) * 0.5
            with torch.no_grad():
                y, _ = est_m(x.to(dev), t.to(dev), cond.to(dev), mask.to(dev), **kw)
            est_m.zero_grad(set_to_none=True)
            if with_ctx:
                loss = (est_m(x.to(dev), t.to(dev), cond.to(dev), mask.to(dev), **kw)[0] ** 2
                        ).mean()
            else:
                loss, _ = pipe.train_loss({k: v.to(dev) for k, v in batch.items()},
                                          {k: v.to(dev) for k, v in draws.items()})
            loss.backward()
            out[dev] = (y, loss.detach(), {k: q.grad.detach().cpu()
                                           for k, q in est_m.named_parameters()
                                           if q.grad is not None})
        (y0, l0, g0), (y1, l1, g1) = out["cpu"], out["cuda"]
        close_scaled(f"smoke {label} forward", y1, y0)
        torch.testing.assert_close(l1.cpu(), l0, rtol=SMOKE_TOL, atol=0)
        gap = grad_gap(g1, g0)
        log(f"  smoke {label} train step: loss {l1.item():.6f} vs {l0.item():.6f}; gradients "
            f"({len(g0)} tensors) max|d| {gap:.3e} of max|g| (limit {CLF_GRAD_TOL})")
        if set(g1) != set(g0) or not gap <= CLF_GRAD_TOL:
            raise RuntimeError(f"smoke {label}: card gradients depart by {gap}")
        report[label] = gap
    img = batch["source"].movedim(-1, 1).contiguous()
    noise = torch.randn((b, p.emb_channels, *p.latent_shape[:2]), generator=gen)
    for kind in ("diffusers_kl", "diffusers_vq"):
        quantized = kind.endswith("vq")
        out = {}
        for dev in ("cpu", "cuda"):
            with seeded(torch.device(dev), 0):
                ae = build_vae(p, kind)
            if dev == "cpu":
                perturb_(ae, gen)
                perturb_gn_(ae, gen)
                weights = ae.state_dict()
            else:
                ae.load_state_dict(weights)
            trainer = AutoencoderTrainer(ae, flavor="vqvae" if quantized else "vae",
                                         pixel_loss="l2", embedding_loss_weight=1.0,
                                         use_ssim=False)
            args = (img.to(dev),) if quantized else (img.to(dev), noise.to(dev))
            with torch.no_grad():
                pred = ae(*args)[0]
            loss, _ = trainer.loss(*args)
            loss.backward()
            out[dev] = (pred, loss.detach(), {k: q.grad.detach().cpu()
                                              for k, q in ae.named_parameters()})
        (y0, l0, g0), (y1, l1, g1) = out["cpu"], out["cuda"]
        close_scaled(f"smoke {kind} forward", y1, y0)
        torch.testing.assert_close(l1.cpu(), l0, rtol=SMOKE_TOL, atol=0)
        gap = grad_gap(g1, g0)
        log(f"  smoke {kind} train step: loss {l1.item():.6f} vs {l0.item():.6f}; gradients "
            f"({len(g0)} tensors) max|d| {gap:.3e} of max|g| (limit {CLF_GRAD_TOL})")
        if not gap <= CLF_GRAD_TOL:
            raise RuntimeError(f"smoke {kind}: card gradients depart by {gap}")
        report[kind] = gap
    return report


def openai_attention_checks_and_times(FA, worst):
    """15b: kernel 5 and both backward kernels at the chest OpenAI UNet's
    middle block (16 tokens, 8 heads of 128) in both channel orders
    against their plain versions, then timed at the sampling rows (B=16:
    8 samples with CFG) and the training batch (B=32), new order (column
    slices, as the DiT's) and legacy order (copies, the preset's)."""
    rows = {}
    for new_order in (True, False):
        label = f"OpenAI middle ({'new' if new_order else 'legacy'} order)"
        slice_attention_checks(FA, worst, label, OPENAI_TOKENS, OPENAI_WIDTH, OPENAI_HEADS,
                               new_order)
        rows[label] = slice_attention_times(FA, worst, label, OPENAI_TOKENS, OPENAI_WIDTH,
                                            OPENAI_HEADS, 2 * N_SAMPLES, TRAIN_BATCH,
                                            new_order)
    return rows


def family_batch(p, root):
    """The first TRAIN_BATCH images of phase 9's tree and their labels."""
    import torch

    from medfusion_tpu_torch.cli.presets import build_dataset

    ds = build_dataset(p, str(root))
    items = [ds[i] for i in range(TRAIN_BATCH)]
    return {"source": torch.stack([torch.from_numpy(it["source"]) for it in items]).cuda(),
            "target": torch.tensor([it["target"] for it in items]).cuda()}


def train_cli(ops, tmp, root, estimator, *flags, out=None):
    """cli.train_diffusion at the chest preset on phase 9's tree and
    autoencoder (B=32, bf16, FAMILY_STEPS steps; its run directory ``out``,
    none when None): (state, losses, pipeline, seconds), with the launches
    counted from zero."""
    import torch

    from medfusion_tpu_torch.cli import train_diffusion

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, pipe = train_diffusion.main([
        "--preset", "chest", "--data-root", str(root), "--vae-ckpt", str(tmp / "ae"),
        "--estimator", estimator, "--bf16", "--max-steps", str(FAMILY_STEPS), "--device",
        "cuda", *flags, *([] if out is None else ["--out", str(out)])])
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in losses) or state.step != FAMILY_STEPS:
        raise RuntimeError(f"{estimator} {flags} training: step {state.step}, losses {losses}")
    return state, losses, pipe, time.perf_counter() - t0


def phase_family_train(ops, FA, tmp, root):
    """15c: cli.train_diffusion --estimator unet_legacy|openai|lucidrains
    --bf16 on phase 9's tree, each run's checkpoint under ``tmp`` for 15d
    (launches held; ms a step, peak memory and breakdown); phase 8's bf16-against-f32 gradient check on a perturbed
    chest OpenAI UNet, shown to flag dq zeroed at d = 128; then --remat
    for openai and unet: the CLI's launches with the recompute, and on the
    same perturbed weights, latents and draws the remat step's loss and
    gradients against the plain step's, its ms beside (host clock around
    3 synchronised forward + backward passes) and its peak memory below (the estimator's
    forward and backward alone: with the frozen encoder in the step, its
    256^2 activations set the peak)."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline
    from medfusion_tpu_torch.nn.blocks import Norm
    from medfusion_tpu_torch.train import make_diffusion_train_step

    p = PRESETS["chest"]
    batch = family_batch(p, root)
    gen = torch.Generator(device="cuda").manual_seed(2)
    latents = {"source": torch.randn((TRAIN_BATCH, *p.latent_shape), generator=gen,
                                     device="cuda"), "target": batch["target"]}
    draws = None
    report = {}
    for est in FAMILIES:
        state, losses, pipe, seconds = train_cli(ops, tmp, root, est, out=tmp / est)
        if est == "unet_legacy":
            norms = sum(isinstance(m, Norm) for m in pipe.noise_estimator.modules())
            if norms != LEGACY_GN_PER_FORWARD:
                raise RuntimeError(f"the chest legacy UNet has {norms} GroupNorms, the "
                                   f"counts assume {LEGACY_GN_PER_FORWARD}")
        per_step = family_launches(est, 1, 1, encodes=1)
        check_counts(f"{est} train CLI", ops.launch_counts(),
                     {k: v * FAMILY_STEPS for k, v in per_step.items()})
        if draws is None:
            draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape, generator=gen)
        step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
        ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, draws, 3)
        n_params = sum(q.numel() for q in state.model.parameters())
        log(f"  {est} train CLI ({n_params / 1e6:.1f} M parameters): {FAMILY_STEPS} steps at "
            f"B={TRAIN_BATCH} (bf16) in {seconds:.1f} s with loading; losses {losses}; a "
            f"step launches {per_step}; {ms:.1f} ms/step, peak memory {peak:.2f} GiB; profiled "
            f"step wall {wall:.1f} ms, {fmt_kinds(kinds)}")
        report[est] = {"ms": ms, "peak": peak}
        del state, pipe, step
        torch.cuda.empty_cache()
    check = build_train_pipeline(p, device="cuda", estimator="openai", seed=0)
    perturb_(check.noise_estimator, gen)
    perturb_gn_(check.noise_estimator, gen)
    check_train_grads(FA, check, batch, draws, faults=(CLF_FAULT,),
                      limit=OPENAI_GRAD_REL_LIMIT, qkv_heads=OPENAI_HEADS)
    del check
    torch.cuda.empty_cache()
    for est in ("openai", "unet"):
        _, losses, _, seconds = train_cli(ops, tmp, root, est, "--remat")
        expected = {k: v * FAMILY_STEPS
                    for k, v in family_launches(est, 1, 1, encodes=1, remat=True).items()}
        check_counts(f"{est} --remat train CLI", ops.launch_counts(), expected)
        pipes = {remat: dataclasses.replace(
            build_train_pipeline(p, device="cuda", estimator=est, seed=0, remat=remat),
            latent_embedder=None) for remat in (False, True)}
        # away from the zero-initialised output conv, so that every block
        # has a gradient to compare
        perturb_(pipes[False].noise_estimator, gen)
        perturb_gn_(pipes[False].noise_estimator, gen)
        pipes[True].noise_estimator.load_state_dict(pipes[False].noise_estimator.state_dict())
        runs = {}
        for remat, pipe in pipes.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, grads = grads_of(pipe, latents, draws, torch.bfloat16)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            t0 = time.perf_counter()
            for _ in range(3):
                grads_of(pipe, latents, draws, torch.bfloat16)
            torch.cuda.synchronize()
            runs[remat] = (loss, grads, peak, (time.perf_counter() - t0) / 3 * 1e3)
        del pipes, pipe
        (l0, g0, p0, ms0), (l1, g1, p1, ms1) = runs[False], runs[True]
        worst, glob = grad_departure(g1, g0)
        log(f"  {est} --remat: CLI {FAMILY_STEPS} steps in {seconds:.1f} s, losses {losses}; "
            f"the step on the same weights and draws: loss {l1.item()!r} vs {l0.item()!r}; "
            f"gradients worst |d|_2/|g|_2 {fmt_worst(worst)} (limit {REMAT_GRAD_REL}); "
            f"the estimator's forward + backward peak above the weights {p1:.2f} GiB vs "
            f"{p0:.2f} GiB, {ms1:.1f} ms vs {ms0:.1f} ms")
        if abs(l1.item() - l0.item()) > REMAT_LOSS_RTOL * abs(l0.item()):
            raise RuntimeError(f"{est} remat loss {l1.item()} departs from {l0.item()}")
        if not worst[0][0] <= REMAT_GRAD_REL or not p1 < p0:
            raise RuntimeError(f"{est} remat: gradients {fmt_worst(worst)}, peak {p1} vs {p0}")
        del g0, g1
        torch.cuda.empty_cache()
        report[f"{est} remat"] = {"peak": p1, "plain_peak": p0, "remat_ms": ms1,
                                  "plain_ms": ms0}
    return report


def phase_family_sample(ops, tmp):
    """15d: cli.sample --ckpt from each 15c run (the estimator from the
    run's config), then the run's directory removed: DDIM
    FAMILY_SAMPLE_STEPS, CFG 8, B=8, 3 conditions; seconds, peak memory and
    launches held."""
    import shutil

    from medfusion_tpu_torch.cli import sample

    report = {}
    for est in FAMILIES:
        _, seconds, peak = sample_run(
            ops, sample, ["--preset", "chest", "--ckpt", str(tmp / est), "--vae-ckpt",
                          str(tmp / "ae"), "--n", str(N_SAMPLES), "--steps",
                          str(FAMILY_SAMPLE_STEPS), "--out", str(tmp / f"{est}_samples")],
            family_launches(est, 3 * FAMILY_SAMPLE_STEPS, decodes=3),
            f"{est} sample CLI (DDIM {FAMILY_SAMPLE_STEPS}, CFG {GUIDANCE})")
        shutil.rmtree(tmp / est)
        report[est] = (seconds, peak)
    return report


def phase_diffusers_autoencoders(ops, tmp, root):
    """15e: cli.train_autoencoder --model diffusers_kl and --model
    diffusers_vq --gan at the chest preset, f32, B=8, 3 steps on phase 9's
    tree (no kernel launches); a run that holds only step 2 resumes and its
    step-3 loss is held to the uninterrupted run's (AE_RESUME_LOSS_RTOL);
    then the step's ms, peak memory and breakdown."""
    import shutil

    import torch

    from medfusion_tpu_torch.cli import train_autoencoder
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset
    from medfusion_tpu_torch.train.adversarial import (
        AdversarialTrainer,
        make_adversarial_train_step,
    )
    from medfusion_tpu_torch.train.autoencoder import (
        AutoencoderTrainer,
        make_autoencoder_train_step,
    )
    from medfusion_tpu_torch.utils import checkpoint as C

    p = PRESETS["chest"]
    ds = build_dataset(p, str(root))
    batch = {"source": torch.stack([torch.from_numpy(ds[i]["source"])
                                    for i in range(AE_BATCH)]).cuda()}
    report = {}
    for model, flags in DIFFUSERS_RUNS:
        out, out_b = tmp / model, tmp / f"{model}_resumed"
        common = ["--preset", "chest", "--data-root", str(root), "--model", model,
                  "--device", "cuda", "--ckpt-every", str(AE_CKPT_EVERY), "--sample-every",
                  "0", *flags]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses = train_autoencoder.main([*common, "--out", str(out), "--max-steps",
                                                str(AE_STEPS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_counts(f"{model} train CLI", ops.launch_counts(), {})
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"{model}: losses {losses}")
        (out_b / "checkpoints").mkdir(parents=True)
        for name in (f"step_{AE_CKPT_EVERY}.pt", C.CONFIG_FILE):
            shutil.copy(out / "checkpoints" / name, out_b / "checkpoints" / name)
        _, losses_b = train_autoencoder.main([*common, "--out", str(out_b), "--max-steps",
                                              str(AE_STEPS), "--resume"])
        log(f"  {' '.join([model, *flags])} train CLI: {AE_STEPS} steps at B={AE_BATCH} (f32) in "
            f"{seconds:.1f} s with loading; losses {losses}; resume at step {AE_CKPT_EVERY}: "
            f"step-{AE_STEPS} loss {losses_b[0]!r} vs {losses[-1]!r}")
        if len(losses_b) != 1 or abs(losses_b[0] - losses[-1]) > (
                AE_RESUME_LOSS_RTOL * abs(losses[-1])):
            raise RuntimeError(f"{model}: resumed losses {losses_b} against {losses[-1]}")
        gan = bool(flags)
        ae = state.gen.model if gan else state.model
        quantized = model.endswith("vq")
        trainer = AutoencoderTrainer(ae, flavor="vqvae" if quantized else "vae",
                                     pixel_loss="l2", embedding_loss_weight=1.0,
                                     use_ssim=False)
        if gan:
            step = make_adversarial_train_step(AdversarialTrainer(
                trainer, state.disc.model, start_gan_train_step=2, start_disc_train_step=1))
        else:
            step = make_autoencoder_train_step(trainer)
        noise = None if quantized else torch.randn((AE_BATCH, *p.latent_shape), device="cuda")
        ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, noise, 3)
        n_params = sum(q.numel() for q in ae.parameters())
        log(f"  {model} step ({n_params / 1e6:.1f} M parameters{', GAN on' if gan else ''}, "
            f"B={AE_BATCH}, f32, 256^2): {ms:.1f} ms/step, peak memory {peak:.2f} GiB; "
            f"profiled step wall {wall:.1f} ms, {fmt_kinds(kinds)}")
        report[model] = {"ms": ms, "peak": peak}
        del state, ae, trainer, step
        torch.cuda.empty_cache()
        shutil.rmtree(out)
        shutil.rmtree(out_b)
    return report


# Phase 16: serving and the 3-D models. The served chest pipeline (bf16;
# /one at SERVE_STEPS DDIM steps, eta 0, CFG 4, in batches of SERVE_BATCH;
# /sample pages DDIM eta 1, CFG PAGE_GUIDANCE) from a reference Lightning
# checkpoint of seeded, perturbed chest weights. Every UNet forward launches
# the UNet's GroupNorms (a CFG step is one batched forward), every decode
# the VAE's; with spatial attention each forward adds what EXPECTED
# counts a step.
SERVE_BATCH, SERVE_BURST, SERVE_STEPS = 8, 32, 50
PAGE_N, PAGE_STEPS, PAGE_GUIDANCE = 4, 50, 8.0
SERVE_ALONE = (3, 17)  # served again alone, against their burst rows
# The 3-D volume path: the chest VAE's widths on B=2 volumes of one channel,
# 64 x 128 x 128 (latent 8 x 16 x 16 x 8, strides 1, 2, 2, 2), f32 training
# steps; GroupNorm at its four levels (C, downsampling), 8 groups: the first
# a group of 8 x 1,048,576 elements, which no block of clusters holds.
VOL3D, VOL3D_BATCH = (64, 128, 128), 2
GN3D_SHAPES = ((64, 1), (128, 2), (256, 4), (512, 8))
VOL3D_STEPS, VOL3D_GUIDANCE = 50, 4.0


def spatial_launches(forwards=0, decodes=0):
    """The chest spatial-attention UNet's launches a forward (EXPECTED's
    per step) and the VAE's a decode."""
    per = {k: v // STEPS for k, v in EXPECTED["spatial"].items() if k != "group_norm_silu"}
    out = {k: v * forwards for k, v in per.items()}
    out["group_norm_silu"] = ((UNET_GN_PER_FORWARD + 2 * TRANSFORMERS) * forwards
                              + VAE_GN_PER_DECODE * decodes)
    return out


def times(counts, n):
    return {k: v * n for k, v in counts.items()}


def conv_row_spread():
    """The cause of a served image's dependence on its row in the batch:
    cuDNN's bf16 3x3 convs at the UNet's two lowest levels, 16 identical
    rows (a CFG batch of 8), each row's largest difference from row 0, with
    ``cudnn.deterministic`` off and on."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for c, side in ((512, 16), (1024, 8)):
        w = (torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        x = torch.randn((1, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        x = x.expand(2 * SERVE_BATCH, -1, -1, -1).contiguous()
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            y = F.conv2d(x, w, padding=1).float()
            out[(c, side, det)] = [(y[k] - y[0]).abs().max().item() for k in range(y.shape[0])]
        torch.backends.cudnn.deterministic = False
    log("  cuDNN bf16 3x3 conv, 16 identical rows, each row's max|d| from row 0: " + "; ".join(
        f"{c}x{side}^2 deterministic={det}: {v}" for (c, side, det), v in out.items()))
    return out


def write_reference_ckpt(path, unet, vae):
    """A Lightning-format checkpoint of the reference's DiffusionPipeline:
    one ``state_dict`` with both prefixes, plain ``hyper_parameters``."""
    import torch

    sd = {f"noise_estimator.{k}": v.detach().cpu() for k, v in unet.state_dict().items()}
    sd.update({f"latent_embedder.{k}": v.detach().cpu() for k, v in vae.state_dict().items()})
    torch.save({"state_dict": sd, "hyper_parameters": {"num_classes": 2, "timesteps": 1000},
                "pytorch-lightning_version": "1.9.0", "epoch": 0, "global_step": 0}, path)
    return path


def perturbed_reference_ckpt(preset, path, device):
    """The preset's seeded UNet and VAE built on ``device`` and perturbed
    from seed 18 (a seeded VAE decodes every latent to 0), as a reference
    Lightning file that the CLIs' ``--ckpt`` reads."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline

    pipe = build_pipeline(PRESETS[preset], device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(18)
    perturb_(pipe.noise_estimator, gen)
    perturb_(pipe.latent_embedder, gen)
    return write_reference_ckpt(path, pipe.noise_estimator, pipe.latent_embedder)


def serve_in_thread(server, argv):
    """``demo.server`` on 127.0.0.1:0 in this process: (http server, state,
    thread, base url); built and warmed before it serves."""
    import threading

    httpd, state = server.make_server(server.parse_args([*argv, "--port", "0"]))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, state, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_server(httpd, state, thread):
    httpd.shutdown()
    httpd.server_close()
    state.close()
    thread.join(timeout=30)


def http_get(url):
    """(body, seconds) of one GET."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=600) as r:
        body = r.read()
    return body, time.perf_counter() - t0


def concurrent_gets(urls):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(urls)) as ex:
        return list(ex.map(http_get, urls))


def phase_reference_ckpt(ops, tmp):
    """16a: seeded chest weights, perturbed, as a reference ``.ckpt``;
    ``cli.sample --ckpt`` bit-equal to a direct call on the same weights
    (condition 1), launches counted. Returns (checkpoint, direct images)."""
    import numpy as np
    import torch

    from medfusion_tpu_torch.cli import sample
    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
    from medfusion_tpu_torch.utils import torch_compat

    p = PRESETS["chest"]
    f32 = build_pipeline(p, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(16)
    perturb_(f32.noise_estimator, gen)
    perturb_(f32.latent_embedder, gen)
    ckpt = write_reference_ckpt(tmp / "chest.ckpt", f32.noise_estimator, f32.latent_embedder)
    del f32
    log(f"  wrote a Lightning-format chest checkpoint ({ckpt.stat().st_size / 2**20:.1f} MiB)")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    images = sample.main(["--preset", "chest", "--ckpt", str(ckpt), "--n", str(PAGE_N),
                          "--steps", str(PAGE_STEPS), "--guidance", str(PAGE_GUIDANCE),
                          "--seed", "0", "--out", str(tmp / "ckpt_samples"),
                          "--device", "cuda"])
    torch.cuda.synchronize()
    log(f"  cli.sample --ckpt x.ckpt: {PAGE_N} images x 3 conditions, DDIM {PAGE_STEPS}, "
        f"in {time.perf_counter() - t0:.3f} s")
    check_counts("cli.sample --ckpt x.ckpt", ops.launch_counts(),
                 unet_launches(forwards=3 * PAGE_STEPS, decodes=3))
    unet_state, vae_state = torch_compat.pipeline_states(ckpt)
    if vae_state is None:
        raise RuntimeError("the checkpoint's latent_embedder part is missing")
    direct = build_pipeline(p, device="cuda", compute_dtype=torch.bfloat16, seed=1,
                            unet_state=unet_state, vae_ckpt=str(ckpt))
    g = torch.Generator(device="cuda").manual_seed(0)
    cond = torch.full((PAGE_N,), 1, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        want = direct.sample(PAGE_N, p.latent_shape, condition=cond, generator=g,
                             steps=min(PAGE_STEPS, p.timesteps), use_ddim=True,
                             guidance_scale=PAGE_GUIDANCE,
                             eta=1.0).float().cpu().numpy()
    del direct
    torch.cuda.empty_cache()
    if want.shape != (PAGE_N, 256, 256, 3) or not np.isfinite(want).all():
        raise RuntimeError(f"direct chest samples {want.shape} or non-finite")
    if not np.array_equal(images[1], want):
        raise RuntimeError(f"cli.sample --ckpt departs from the direct call by "
                           f"{np.abs(images[1] - want).max()}")
    log(f"  cli.sample --ckpt x.ckpt condition 1 bit-equal to the direct call (range "
        f"[{want.min():.3f}, {want.max():.3f}])")
    return ckpt, want


def phase_serving(ops, tmp):
    """16b: ``demo.server`` with the chest checkpoint: a /sample page and
    its /img fetches deduplicated onto one run (and equal to phase 16a's
    direct call), a burst of concurrent /one requests (PNGs, batches,
    latencies, launches), two seeds served alone against their burst rows
    (bit-equal, or else equal to their row of a batch of copies of them:
    the row position, measured on cuDNN's convs by :func:`conv_row_spread`);
    then a spatial-attention server's /one batch (kernels 1, 2, 5, 6
    counted), the card's refusal of --no-flash, and the smoke /one batch
    function card against CPU."""
    import numpy as np
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
    from medfusion_tpu_torch.data.png import decode_png
    from medfusion_tpu_torch.demo import server
    from medfusion_tpu_torch.demo.serving import make_sample_batch_fn

    ckpt, want = phase_reference_ckpt(ops, tmp)
    report = {}
    t0 = time.perf_counter()
    httpd, state, thread, url = serve_in_thread(server, [
        "--preset", "chest", "--ckpt", str(ckpt), "--serve-batch", str(SERVE_BATCH),
        "--device", "cuda"])
    report["start_s"] = time.perf_counter() - t0
    log(f"  demo.server --ckpt x.ckpt: built, warmed and serving at {url} in "
        f"{report['start_s']:.2f} s")
    try:
        q = f"preset=chest&n={PAGE_N}&steps={PAGE_STEPS}&guidance={PAGE_GUIDANCE}&cond=1&seed=0"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = concurrent_gets([f"{url}/sample?{q}"]
                              + [f"{url}/img?{q}&i={i}" for i in range(PAGE_N)])
        check_counts(f"a /sample page and its {PAGE_N} /img fetches, at once",
                     ops.launch_counts(), unet_launches(forwards=PAGE_STEPS, decodes=1))
        served = np.stack([decode_png(body) for body, _ in res[1:]])
        if not np.array_equal(served, server.to_uint8(want)):
            raise RuntimeError("the server's page departs from the direct call on the "
                               "checkpoint's weights")
        log(f"  the page's {PAGE_N} PNGs equal the direct call's images as uint8")

        batcher = state.batcher("chest")
        before = batcher.batches_run
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = concurrent_gets([f"{url}/one?preset=chest&seed={s}&cond={s % 2}"
                               for s in range(SERVE_BURST)])
        wall = time.perf_counter() - t0
        batches = batcher.batches_run - before
        imgs = [decode_png(body) for body, _ in res]
        if any(im.shape != (256, 256, 3) for im in imgs):
            raise RuntimeError(f"/one PNG shapes {sorted({im.shape for im in imgs})}")
        if batches > SERVE_BURST // SERVE_BATCH + 1:
            raise RuntimeError(f"{SERVE_BURST} requests ran {batches} batches")
        check_counts(f"/one burst of {SERVE_BURST} ({batches} batches)", ops.launch_counts(),
                     times(unet_launches(forwards=SERVE_STEPS, decodes=1), batches))
        lat = np.asarray([dt for _, dt in res])
        seeds = torch.arange(SERVE_BATCH)
        batcher.batch_fn(seeds, seeds % 2)  # warm, then one batch timed alone
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batcher.batch_fn(seeds, seeds % 2)
        torch.cuda.synchronize()
        report.update(batches=batches, p50_s=float(np.percentile(lat, 50)),
                      p95_s=float(np.percentile(lat, 95)), images_per_s=SERVE_BURST / wall,
                      burst_s=wall, batch_s=time.perf_counter() - t1)
        log(f"  /one burst: {SERVE_BURST} concurrent requests in {wall:.3f} s = "
            f"{report['images_per_s']:.3f} images/s, {batches} batches of {SERVE_BATCH}, "
            f"latency p50 {report['p50_s']:.3f} s, p95 {report['p95_s']:.3f} s, max "
            f"{lat.max():.3f} s; one batch alone {report['batch_s']:.3f} s (DDIM "
            f"{SERVE_STEPS}, eta 0, CFG {server.ONE_GUIDANCE}, bf16)")
        report["alone_max_d"] = {}
        for s in SERVE_ALONE:
            again = decode_png(http_get(f"{url}/one?preset=chest&seed={s}&cond={s % 2}")[0])
            d = int(np.abs(again.astype(np.int16) - imgs[s].astype(np.int16)).max())
            report["alone_max_d"][s] = d
            log(f"  seed {s} served alone (a padded batch, its row 0): max|d| {d} against "
                f"its burst row")
            if d:  # the cause must be the row position: a batch of copies of it
                copies = server.to_uint8(batcher.batch_fn(
                    torch.full((SERVE_BATCH,), s), torch.full((SERVE_BATCH,), s % 2)).cpu().numpy())
                rows = [j for j in range(SERVE_BATCH) if np.array_equal(copies[j], imgs[s])]
                log(f"    its burst image equals rows {rows} of a batch of {SERVE_BATCH} copies "
                    f"of it, whose rows differ from row 0 by "
                    f"{[int(np.abs(copies[j].astype(np.int16) - copies[0]).max()) for j in range(SERVE_BATCH)]}")
                if not rows:
                    raise RuntimeError(f"seed {s}: the image depends on its batch beyond its "
                                       f"row position (max|d| {d})")
        report["conv_row_spread"] = conv_row_spread()
    finally:
        stop_server(httpd, state, thread)
    torch.cuda.empty_cache()

    httpd, state, thread, url = serve_in_thread(server, [
        "--preset", "chest", "--attention", "spatial", "--serve-batch", str(SERVE_BATCH),
        "--device", "cuda"])
    try:
        batcher = state.batcher("chest")
        before = batcher.batches_run
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = concurrent_gets([f"{url}/one?preset=chest&seed={s}&cond={s % 2}"
                               for s in range(SERVE_BATCH)])
        report["spatial_s"] = time.perf_counter() - t0
        batches = batcher.batches_run - before
        check_counts(f"--attention spatial: {SERVE_BATCH} /one requests ({batches} batches)",
                     ops.launch_counts(),
                     times(spatial_launches(forwards=SERVE_STEPS, decodes=1), batches))
        if batches < 1 or any(decode_png(b).shape != (256, 256, 3) for b, _ in res):
            raise RuntimeError("the spatial-attention /one batch failed")
        log(f"  --attention spatial /one: {SERVE_BATCH} requests in {report['spatial_s']:.3f} s")
    finally:
        stop_server(httpd, state, thread)
    torch.cuda.empty_cache()

    try:
        server.main(["--preset", "chest", "--attention", "spatial", "--no-flash"])
        code = 0
    except SystemExit as e:
        code = e.code
    log(f"  demo.server --attention spatial --no-flash on the card: exit {code}")
    if code != 2:
        raise RuntimeError(f"--no-flash on the card exited {code}, expected 2")

    p = PRESETS["smoke"]
    cpu = build_pipeline(p, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(16)
    perturb_(cpu.noise_estimator, gen)
    perturb_(cpu.latent_embedder, gen)
    card = build_pipeline(p, device="cuda", seed=0)
    card.noise_estimator.load_state_dict(cpu.noise_estimator.state_dict())
    card.latent_embedder.load_state_dict(cpu.latent_embedder.state_dict())
    seeds, conds = torch.tensor([0, 1, 2, 3]), torch.tensor([0, 1, 1, 0])
    noise = {int(s): torch.randn(p.latent_shape, generator=gen) for s in seeds}

    def init(slots):
        return torch.stack([noise[s] for s in slots])

    outs = [make_sample_batch_fn(pipe, p.latent_shape, steps=min(SERVE_STEPS, p.timesteps),
                                 guidance_scale=server.ONE_GUIDANCE, init_noise=init)(seeds, conds)
            for pipe in (cpu, card)]
    close_scaled("smoke /one batch function card vs cpu (f32, the same initial noise)",
                 outs[1], outs[0])
    return report


def volume_vae(kind="vae"):
    """The chest VAE's (or VQVAE's) widths on one-channel volumes."""
    from medfusion_tpu_torch.models import latent_embedders as le

    kw = dict(in_channels=1, out_channels=1, spatial_dims=3, emb_channels=8,
              hid_chs=(64, 128, 256, 512), kernel_sizes=(3,) * 4, strides=(1, 2, 2, 2),
              deep_supervision=1, norm_name=("GROUP", {"num_groups": 8, "affine": True}))
    return le.VQVAE(num_embeddings=8192, **kw) if kind == "vqvae" else le.VAE(**kw)


def phase_3d_group_norm(G, worst):
    """16c: kernel 1 against its plain version at the 3-D VAE's GroupNorm
    shapes ([2, C, D, H, W], 8 groups), f32 and bf16, SiLU on, bit for bit
    across two launches, each with its plan; then its time at the largest
    f32 shape beside F.group_norm + F.silu and the bytes bound."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    partly = False
    for c, f in GN3D_SHAPES:
        dims = tuple(v // f for v in VOL3D)
        s = math.prod(dims)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = (torch.randn((VOL3D_BATCH, c, *dims), generator=gen, device="cuda") * 2 + 1
                 ).to(dtype)
            scale = (1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)
            bias = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)
            out = G.group_norm_silu_cuda(x, scale, bias, 8)
            again = G.group_norm_silu_cuda(x, scale, bias, 8)
            ref = G.group_norm_silu_reference(x, scale, bias, 8)
            err = close(f"gn 3-D C={c} {dims} {name}", out, ref, TOL[name], TOL[name])
            keep(worst, "group_norm_silu", name, err)
            if not torch.equal(out, again):
                raise RuntimeError(f"gn 3-D C={c} {name}: two launches differ")
            plan = G._plan_for(VOL3D_BATCH, c, s, 8, dtype, True)
            partly = partly or (plan["route"] == "cluster" and plan["resident"] < plan["slice"])
            log(f"  gn 3-D B={VOL3D_BATCH} C={c} {dims} G=8 {name}: a group of "
                f"{plan['n']:,} ({gn_route(G, VOL3D_BATCH, c, s, 8, dtype, plan)}), "
                f"resident share {plan['resident'] / plan['slice'] if plan['route'] == 'cluster' else 1:.3f}; "
                f"max|d| {err:.3e} (atol=rtol={TOL[name]}), bitwise equal across two launches")
            del x, out, again, ref
    if not partly:
        raise RuntimeError("no 3-D shape took the partly resident cluster route")
    c, f = GN3D_SHAPES[0]
    x = torch.randn((VOL3D_BATCH, c, *VOL3D), generator=gen, device="cuda")
    scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    k = cuda_ms(lambda: G.group_norm_silu_cuda(x, scale, bias, 8), 5)
    lib = cuda_ms(lambda: F.silu(F.group_norm(x, 8, scale, bias, 1e-5)), 5)
    plain = cuda_ms(lambda: G.group_norm_silu_reference(x, scale, bias, 8), 5)
    bound = bounds(0, 2 * x.numel() * x.element_size() + 2 * c * 4)["bound_ms"]
    log(f"  gn 3-D time at B={VOL3D_BATCH} C={c} {VOL3D} f32: kernel {k:.4f} ms, "
        f"F.group_norm+F.silu {lib:.4f} ms, plain {plain:.4f} ms, bytes bound {bound:.4f} ms "
        f"({bound / k:.1%} of bound)")
    return {"ms": k, "library_ms": lib, "plain_ms": plain, "bound_ms": bound}


def phase_3d_training(ops):
    """16d: one f32 train step of the chest-width VAE and of the VQVAE on
    B=2 64x128x128 volumes (L2 + SSIM + KL or codebook loss, Adam): the
    second step's ms and the peak memory, GroupNorm launches a step held
    to the encoder's and decoder's."""
    import torch

    from medfusion_tpu_torch.train import TrainState
    from medfusion_tpu_torch.train.autoencoder import (
        AutoencoderTrainer,
        make_autoencoder_train_step,
    )

    report = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand((VOL3D_BATCH, *VOL3D, 1), generator=gen, device="cuda") * 2 - 1
    latent = tuple(v // 8 for v in VOL3D)
    for kind in ("vae", "vqvae"):
        torch.manual_seed(0)
        with torch.device("cuda"):
            model = volume_vae(kind)
        perturb_(model, gen)
        state = TrainState(model, lr=1e-4, weight_decay=0.0)
        step = make_autoencoder_train_step(AutoencoderTrainer(
            model, flavor=kind, pixel_loss="l2", embedding_loss_weight=1e-6))
        noise = (torch.randn((VOL3D_BATCH, *latent, 8), generator=gen, device="cuda")
                 if kind == "vae" else None)
        step(state, {"source": x}, noise)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(state, {"source": x}, noise)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_counts(f"3-D {kind} train step", ops.launch_counts(),
                     {"group_norm_silu": AE_GN_PER_STEP})
        if not math.isfinite(loss):
            raise RuntimeError(f"3-D {kind} step loss {loss}")
        log(f"  3-D {kind} f32 train step B={VOL3D_BATCH} {VOL3D}: {ms:.1f} ms, peak "
            f"{peak:.2f} GiB, loss {loss:.5f}")
        report[kind] = {"ms": ms, "peak": peak}
        del model, state, step
        torch.cuda.empty_cache()
    return report


def phase_3d_sampling(ops):
    """16e: the chest-width 3-D UNet (widths 256-1024, 32 groups) on the
    [8, 16, 16] x 8 latent, DDIM 50 with CFG 4 at B=2, then the 3-D VAE's
    decode to 64x128x128, bf16: seconds and launches."""
    import torch

    from medfusion_tpu_torch.cli.presets import build_scheduler, PRESETS
    from medfusion_tpu_torch.models.unet import UNet
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline

    torch.manual_seed(0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.device("cuda"):
        unet = UNet(in_ch=8, out_ch=8, spatial_dims=3, hid_chs=(256, 256, 512, 1024),
                    kernel_sizes=(3,) * 4, strides=(1, 2, 2, 2), time_emb_dim=1024,
                    cond_emb_num_classes=2, deep_supervision=0, use_res_block=True,
                    norm_name=("GROUP", {"num_groups": 32, "affine": True}))
        vae = volume_vae()
    perturb_(unet, gen)
    perturb_(vae, gen)
    pipe = DiffusionPipeline(scheduler=build_scheduler(PRESETS["chest"], "cuda"),
                             noise_estimator=unet.to(torch.bfloat16).eval(),
                             latent_embedder=vae.to(torch.bfloat16).eval(), clip_x0=False,
                             do_input_centering=False, compute_dtype=torch.bfloat16)
    latent = (*(v // 8 for v in VOL3D), 8)
    cond = torch.tensor([0, 1], device="cuda")
    sgen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        vols = pipe.sample(VOL3D_BATCH, latent, condition=cond, generator=sgen,
                           steps=VOL3D_STEPS, use_ddim=True, guidance_scale=VOL3D_GUIDANCE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts("3-D sampling", ops.launch_counts(),
                 unet_launches(forwards=VOL3D_STEPS, decodes=1))
    if tuple(vols.shape) != (VOL3D_BATCH, *VOL3D, 1) or not torch.isfinite(vols).all():
        raise RuntimeError(f"3-D samples {tuple(vols.shape)} or non-finite")
    log(f"  3-D sampling: DDIM {VOL3D_STEPS}, CFG {VOL3D_GUIDANCE}, B={VOL3D_BATCH}, latent "
        f"{latent}, decoded {tuple(vols.shape)} in {seconds:.3f} s")
    return seconds


def phase_3d_vs_cpu(tmp):
    """16f: tests/test_3d.py's sizes (8^3 volumes, widths 4-8; the UNet 16-32
    with spatial attention, since the GEGLU kernel takes widths that are
    multiples of 16) card against CPU, f32: the VAE, VQVAE, both
    discriminators and the UNet forward, each
    autoencoder's train loss and gradients (the phase-15 tolerances); and a
    .nii.gz volume written here read through SimpleDataset3D."""
    import numpy as np
    import torch

    from medfusion_tpu_torch.data import nifti
    from medfusion_tpu_torch.data.datasets_3d import SimpleDataset3D
    from medfusion_tpu_torch.models import latent_embedders as le
    from medfusion_tpu_torch.models.unet import UNet
    from medfusion_tpu_torch.train.autoencoder import AutoencoderTrainer

    gn2 = ("GROUP", {"num_groups": 2, "affine": True})
    ae = dict(in_channels=1, out_channels=1, spatial_dims=3, emb_channels=2, hid_chs=(4, 8),
              strides=(1, 2), kernel_sizes=(3, 3), norm_name=gn2)
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((2, 1, 8, 8, 8), generator=gen) * 2 - 1
    noise = torch.randn((2, 2, 4, 4, 4), generator=gen)
    models = {
        "vae": lambda: le.VAE(deep_supervision=1, **ae),
        "vqvae": lambda: le.VQVAE(num_embeddings=32, **ae),
        "disc": lambda: le.Discriminator(in_channels=1, spatial_dims=3, hid_chs=(4, 8),
                                         kernel_sizes=(3, 3), strides=(1, 2), norm_name=gn2),
        "patch": lambda: le.NLayerDiscriminator(in_channels=1, spatial_dims=3,
                                                hid_chs=(4, 8, 8), kernel_sizes=(4, 4, 4),
                                                strides=(2, 2, 1)),
        "unet": lambda: UNet(in_ch=2, out_ch=2, spatial_dims=3, hid_chs=(16, 32),
                             kernel_sizes=(3, 3), strides=(1, 2), time_emb_dim=16,
                             cond_emb_num_classes=2, use_attention="spatial", norm_name=gn2),
    }
    report = {}
    for name, make in models.items():
        torch.manual_seed(0)
        cpu = make()
        perturb_(cpu, gen)
        card = make().cuda()
        card.load_state_dict(cpu.state_dict())
        out = {}
        for dev, m in (("cpu", cpu), ("cuda", card)):
            m.train()
            if name == "unet":
                z = noise.to(dev)
                t, c = torch.tensor([3, 17], device=dev), torch.tensor([0, 1], device=dev)
                y, _ = m(z, t, c)
                loss = (y ** 2).mean()
            elif name in ("vae", "vqvae"):
                args = (x.to(dev), noise.to(dev)) if name == "vae" else (x.to(dev),)
                y = m(*args)[0]
                loss, _ = AutoencoderTrainer(m, flavor=name, pixel_loss="l2",
                                             embedding_loss_weight=1e-2).loss(*args)
            else:
                y = m(x.to(dev))
                loss = (y ** 2).mean()
            loss.backward()
            out[dev] = (y.detach(), loss.detach(), {k: q.grad.detach().cpu()
                                                    for k, q in m.named_parameters()
                                                    if q.grad is not None})
        (y0, l0, g0), (y1, l1, g1) = out["cpu"], out["cuda"]
        close_scaled(f"3-D {name} forward card vs cpu", y1, y0)
        torch.testing.assert_close(l1.cpu(), l0, rtol=SMOKE_TOL, atol=0)
        gap = grad_gap(g1, g0)
        log(f"  3-D {name}: loss {l1.item():.6f} vs {l0.item():.6f}; gradients ({len(g0)} "
            f"tensors) max|d| {gap:.3e} of max|g| (limit {CLF_GRAD_TOL})")
        if set(g1) != set(g0) or not gap <= CLF_GRAD_TOL:
            raise RuntimeError(f"3-D {name}: card gradients depart by {gap}")
        report[name] = gap
    vol = np.random.default_rng(6).standard_normal((20, 24, 16)).astype(np.float32) * 50 + 10
    (tmp / "vol3d").mkdir(exist_ok=True)
    nifti.write_nifti(tmp / "vol3d" / "a.nii.gz", vol, scl_slope=2.0, scl_inter=1.0)
    item = SimpleDataset3D(tmp / "vol3d", crawler_ext="nii.gz", image_resize=(16, 16, 16),
                           image_crop=(12, None, 20))[0]
    src = item["source"]
    if src.shape != (12, 16, 20, 1) or not abs(float(src.mean())) < 1e-4:
        raise RuntimeError(f"SimpleDataset3D item {src.shape}, mean {src.mean()}")
    log(f"  SimpleDataset3D read a .nii.gz volume {vol.shape} -> {src.shape} "
        f"(z-normalised: mean {src.mean():.2e}, std {src.std():.4f})")
    return report


# ---- phase 17: the grain order, the prefetch and the profiling layer, the
# diffusers blocks with FIR resampling and the conditional diffusers UNet ----

GRAIN_STEPS, GRAIN_RESUME_AT, GRAIN_SEED = 3, 2, 3
PREFETCH_STEPS, PREFETCH_SIZE = 5, 2
PREFETCH_REGION = "prefetch_steps"
# 17c: the small diffusers UNet whose bf16 training step is held to its f32
# step, on the worst tensor's |d|_2 / |g32|_2. bf16 keeps 8 significant
# bits and the backward rounds at every layer; the attention is plain, as
# in the JAX package (its softmax in bf16, over 1,024 tokens at the first
# level), and the LayerNorms' and projections' gradients are sums over the
# tokens that cancel, as the OpenAI UNet's scale-shift ones do (phase 15c):
# its limit. A CPU rehearsal at the smoke latent (B=4, CPU bf16) read 0.17
# on a transformer's norm1.bias. The cross-attentions' q and k projections
# are left out: with one context token (a 1-D label) the softmax is 1
# whatever q.k, so their gradient is zero but for rounding in both dtypes.
DIFFUSERS_SMALL = dict(block_out_channels=(64, 128), layers_per_block=1, norm_num_groups=32,
                       cross_attention_dim=64, attention_head_dim=8,
                       down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                       up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
DIFFUSERS_GRAD_REL_LIMIT = OPENAI_GRAD_REL_LIMIT
# 17d: the conditional diffusers UNet at its default widths on the chest
# latent (8 channels in and out, 2 classes); its parameters, counted by the
# JAX package's eval_shape and the port alike
DIFFUSERS_PARAMS = 859_545_544
DIFFUSERS_STEP_REPS = 3
DIFFUSERS_SAMPLE_N, DIFFUSERS_DDIM, DIFFUSERS_CFG = 8, 50, 4.0
# AdamW's two moments, the master weights, their gradients, the EMA copy and
# the step's bf16 copy: 4 + 4 + 4 + 4 + 4 + 2 bytes a parameter
STATE_BYTES_PER_PARAM = 22


def tree_gap(a, b, path=""):
    """max |a - b| over the tensors of two nested checkpoints (dicts, lists,
    tensors, numbers), and the paths whose values are not bit-equal."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return math.inf, [path]
        if torch.equal(a, b):
            return 0.0, []
        d = (a.double() - b.double()).abs().max().item() if a.is_floating_point() else math.inf
        return d, [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return math.inf, [path]
        parts = [tree_gap(a[k], b[k], f"{path}/{k}") for k in a]
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return math.inf, [path]
        parts = [tree_gap(x, y, f"{path}/{i}") for i, (x, y) in enumerate(zip(a, b))]
    else:
        return (0.0, []) if a == b else (math.inf, [path])
    return max([0.0] + [d for d, _ in parts]), [p for _, ps in parts for p in ps]


@contextlib.contextmanager
def recorded_grain_batches():
    """Within the block, the index lists of every epoch that
    ``GrainDataModule`` loads, as (epoch, first batch, [indices a batch])."""
    from medfusion_tpu_torch.data import grain_loader

    real, seen = grain_loader._Batches, []

    class Recording(real):
        def __init__(self, ds, batches, seed, epoch, first):
            super().__init__(ds, batches, seed, epoch, first)
            seen.append((epoch, first, [[int(i) for i in b] for b in batches]))

    grain_loader._Batches = Recording
    try:
        yield seen
    finally:
        grain_loader._Batches = real


def phase_grain_training(ops, tmp, root):
    """17a: cli.train_diffusion --grain --no-donate, chest preset on the
    CheXpert_2 tree ``root`` (B=32, bf16, EMA, GRAIN_STEPS steps, seed
    GRAIN_SEED): kernel 1's launches counted from zero and held to the
    diffusion CLI's count (phase 9); each step's batch indices held to
    ``grain_order`` of seed + epoch; a run stopped at GRAIN_RESUME_AT and
    resumed bit-equal to the unbroken one (cuDNN's deterministic algorithms
    on in both). Returns the unbroken run's (state, pipeline) and a report."""
    import shutil

    import torch

    from medfusion_tpu_torch.cli import train_diffusion
    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset
    from medfusion_tpu_torch.data.grain_loader import grain_order
    from medfusion_tpu_torch.utils import checkpoint as C

    p = PRESETS["chest"]
    n = len(build_dataset(p, str(root)))
    per_epoch = n // TRAIN_BATCH
    want = []
    for step in range(GRAIN_STEPS):
        epoch, b = divmod(step, per_epoch)
        want.append(grain_order(n, GRAIN_SEED + epoch)[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH]
                    .tolist())
    argv = ["--preset", "chest", "--data-root", str(root), "--device", "cuda", "--bf16",
            "--use-ema", "--grain", "--no-donate", "--seed", str(GRAIN_SEED),
            "--batch-size", str(TRAIN_BATCH), "--ckpt-every", str(GRAIN_RESUME_AT)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with recorded_grain_batches() as seen:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, losses, pipe = train_diffusion.main(
                [*argv, "--out", str(tmp / "grain"), "--max-steps", str(GRAIN_STEPS)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ops.launch_counts()
            check_counts("--grain train CLI", launches, {
                "group_norm_silu": (UNET_GN_PER_FORWARD + VAE_GN_PER_ENCODE) * GRAIN_STEPS})
            got = [b for _, _, batches in seen for b in batches][:GRAIN_STEPS]
            if got != want:
                raise RuntimeError(f"--grain batches {[g[:4] for g in got]}... differ from "
                                   f"grain's order {[w[:4] for w in want]}...")
            if not all(math.isfinite(v) for v in losses) or state.step != GRAIN_STEPS:
                raise RuntimeError(f"--grain run: step {state.step}, losses {losses}")
            log(f"  --grain --no-donate train CLI: {GRAIN_STEPS} steps at B={TRAIN_BATCH} "
                f"(bf16, EMA) on {n} images ({per_epoch} batch(es) an epoch) in "
                f"{seconds:.1f} s with loading; losses {losses}; each step's indices equal "
                f"grain's order of seed {GRAIN_SEED} + epoch (first batch {got[0][:6]}...)")
            seen.clear()
            train_diffusion.main([*argv, "--out", str(tmp / "grain_b"), "--max-steps",
                                  str(GRAIN_RESUME_AT)])
            _, rest, _ = train_diffusion.main([*argv, "--out", str(tmp / "grain_b"),
                                               "--max-steps", str(GRAIN_STEPS), "--resume"])
            resumed = [b for _, first, batches in seen for b in batches]
            if resumed[GRAIN_RESUME_AT] != want[GRAIN_RESUME_AT]:
                raise RuntimeError("the resumed --grain run read another batch")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gap, paths = tree_gap(C.load_payload(tmp / "grain_b" / "checkpoints", GRAIN_STEPS)["state"],
                          C.load_payload(tmp / "grain" / "checkpoints", GRAIN_STEPS)["state"])
    for run in ("grain", "grain_b"):
        shutil.rmtree(tmp / run)
    log(f"  resumed at step {GRAIN_RESUME_AT}: step-{GRAIN_STEPS} loss {rest!r} vs "
        f"{losses[GRAIN_RESUME_AT:]!r}; the saved state (weights, EMA, AdamW moments) "
        f"max|d| {gap!r} over {len(paths)} differing tensors")
    if rest != losses[GRAIN_RESUME_AT:] or paths:
        raise RuntimeError(f"the resumed --grain run departs: losses {rest} vs "
                           f"{losses[GRAIN_RESUME_AT:]}, {paths[:5]}")
    return state, pipe, {"launches": launches["group_norm_silu"], "seconds": seconds}


def read_trace_region(log_dir, region):
    """The trace file ``utils.profiling.trace`` wrote into ``log_dir``: the
    host span of the ``annotate`` region ``region`` and the CUDA kernels that
    ran inside it (its device span where the trace has one, else its host
    span, which ends after a synchronize), as (span ms, [kernel names])."""
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise RuntimeError(f"trace: {len(files)} trace files in {log_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e.get("cat"): e for e in events if e.get("name") == region and "dur" in e}
    if "user_annotation" not in spans:
        raise RuntimeError(f"trace: no region {region!r} in {files[0].name}")
    span = spans.get("gpu_user_annotation", spans["user_annotation"])
    start, end = span["ts"], span["ts"] + span["dur"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and start <= e.get("ts", -1) <= end]
    return spans["user_annotation"]["dur"] / 1e3, kernels, sorted(spans)


def phase_prefetch_and_trace(ops, tmp, root, state, pipe):
    """17b: the --grain loader's B=32 batches through ``prefetch_to_device``
    (size PREFETCH_SIZE) on the card against the same batches copied
    without it: bit-equal, in order. Over a loop of PREFETCH_STEPS chest
    training steps (bf16), the ms a step and the ms spent waiting for a
    batch, with and without the prefetch (for the record); ``StepTimer``'s
    stats of the prefetched loop; then that loop again inside
    ``utils.profiling.trace`` and an ``annotate`` region, whose trace file
    must hold the region with CUDA kernels (kernel 1's among them) in it."""
    import itertools

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_dataset
    from medfusion_tpu_torch.data import GrainDataModule, prefetch_to_device
    from medfusion_tpu_torch.train import make_diffusion_train_step
    from medfusion_tpu_torch.train.loop import batch_stream
    from medfusion_tpu_torch.utils import profiling

    p = PRESETS["chest"]
    dm = GrainDataModule(build_dataset(p, str(root), seed=GRAIN_SEED),
                         batch_size=TRAIN_BATCH, seed=GRAIN_SEED)
    step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(17))

    def to_card(batch):
        return {k: torch.from_numpy(batch[k]).cuda() for k in ("source", "target")}

    def loop(prefetch, timer=None):
        stream = batch_stream(dm, 0)
        batches = itertools.islice(stream, PREFETCH_STEPS)
        source = (prefetch_to_device(batches, size=PREFETCH_SIZE) if prefetch
                  else map(to_card, batches))
        seen, wait = [], 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            batch = next(source, None)
            wait += time.perf_counter() - t1
            if batch is None:
                break
            step(state, batch, draws)
            seen.append((batch["source"], batch["target"]))
            if timer is not None:
                timer.tick()
        torch.cuda.synchronize()
        stream.close()
        return (time.perf_counter() - t0) / PREFETCH_STEPS * 1e3, wait / PREFETCH_STEPS * 1e3, seen

    loop(True)  # warm-up: the step, the pinned pool, the side stream
    timer = profiling.StepTimer()
    # in turns (without, with, with, without), on one card
    runs = [loop(False), loop(True, timer), loop(True), loop(False)]
    plain, pre = runs[0][2], runs[1][2]
    if not len(plain) == len(pre) == PREFETCH_STEPS:
        raise RuntimeError(f"prefetch gave {len(pre)} batches, the loader {len(plain)}")
    for i, ((s0, t0), (s1, t1)) in enumerate(zip(plain, pre)):
        if not (s1.is_cuda and torch.equal(s0, s1) and torch.equal(t0, t1)):
            raise RuntimeError(f"prefetched batch {i} differs from the loader's")
    ms_plain, wait_plain = ((runs[0][k] + runs[3][k]) / 2 for k in (0, 1))
    ms_pre, wait_pre = ((runs[1][k] + runs[2][k]) / 2 for k in (0, 1))
    log(f"  prefetch_to_device (size {PREFETCH_SIZE}): {PREFETCH_STEPS} B={TRAIN_BATCH} batches "
        f"bit-equal to the loader's, in order; loops of {PREFETCH_STEPS} bf16 steps in "
        f"turns (without, with, with, without): ms a step " + ", ".join(
            f"{r[0]:.1f}" for r in runs) + "; ms a batch waiting for the loader and the "
        "copy " + ", ".join(f"{r[1]:.1f}" for r in runs) + f"; means without {ms_plain:.1f} "
        f"/ {wait_plain:.1f}, with {ms_pre:.1f} / {wait_pre:.1f}; StepTimer {timer.stats()}")
    log_dir = tmp / "trace"
    with profiling.trace(log_dir):
        with profiling.annotate(PREFETCH_REGION):
            loop(True)
    span_ms, kernels, cats = read_trace_region(log_dir, PREFETCH_REGION)
    kinds = sorted({kind_of(k) for k in kernels})
    log(f"  trace: {next(Path(log_dir).glob('*.pt.trace.json')).name}, region "
        f"{PREFETCH_REGION!r} ({', '.join(cats)}) {span_ms:.1f} ms on the host, "
        f"{len(kernels)} CUDA kernels inside it, of kinds {kinds}")
    if not kernels or "group_norm_silu" not in kinds:
        raise RuntimeError(f"the trace's region holds {len(kernels)} kernels, kinds {kinds}")
    return {"ms_plain": ms_plain, "ms_prefetch": ms_pre, "wait_plain": wait_plain,
            "wait_prefetch": wait_pre, "trace_kernels": len(kernels),
            "timer": timer.stats()}


def diffusers_block_cases():
    """(type, factory arguments, the block's inputs as a function of a
    generator and a device): each of the 14 types at a small width."""
    import torch

    temb, ctx = 16, 16

    def down(c_in, *extra):
        def make(gen, dev):
            x = torch.randn((2, c_in, 16, 16), generator=gen).to(dev)
            t = torch.randn((2, temb), generator=gen).to(dev)
            args = {"x": (x,), "temb": (x, t), "ctx": (x, t, torch.randn(
                (2, 3, ctx), generator=gen).to(dev)), "skip": (x, t, torch.randn(
                    (2, 3, 16, 16), generator=gen).to(dev))}
            return args[extra[0] if extra else "temb"]
        return make

    def up(prev, c_in, c_out, kind):
        def make(gen, dev):
            x = torch.randn((2, prev, 8, 8), generator=gen).to(dev)
            t = torch.randn((2, temb), generator=gen).to(dev)
            states = [torch.randn((2, c_in if i == 0 else c_out, 8, 8), generator=gen).to(dev)
                      for i in range(2)]
            return {"x": (x,), "temb": (x, states, t),
                    "ctx": (x, states, t, torch.randn((2, 3, ctx), generator=gen).to(dev)),
                    "skip": (x, states, t, torch.randn((2, 3, 4, 4), generator=gen).to(dev))
                    }[kind]
        return make

    common = dict(num_layers=2, temb_channels=temb)
    return (
        ("DownBlock2D", dict(common, in_channels=32, out_channels=64, add_downsample=True,
                             resnet_groups=8), down(32)),
        ("CrossAttnDownBlock2D", dict(common, in_channels=32, out_channels=64,
                                      add_downsample=True, resnet_groups=8,
                                      attn_num_head_channels=8, cross_attention_dim=ctx),
         down(32, "ctx")),
        ("AttnDownBlock2D", dict(common, in_channels=32, out_channels=64, add_downsample=True,
                                 resnet_groups=8, attn_num_head_channels=16), down(32)),
        ("SkipDownBlock2D", dict(common, in_channels=64, out_channels=64,
                                 add_downsample=True), down(64, "skip")),
        ("AttnSkipDownBlock2D", dict(common, in_channels=64, out_channels=64,
                                     add_downsample=True, attn_num_head_channels=32),
         down(64, "skip")),
        ("DownEncoderBlock2D", dict(common, in_channels=32, out_channels=64,
                                    add_downsample=True, resnet_groups=8), down(32, "x")),
        ("AttnDownEncoderBlock2D", dict(common, in_channels=32, out_channels=64,
                                        add_downsample=True, resnet_groups=8,
                                        attn_num_head_channels=16), down(32, "x")),
        ("UpBlock2D", dict(common, in_channels=32, prev_output_channel=64, out_channels=64,
                           add_upsample=True, resnet_groups=8), up(64, 32, 64, "temb")),
        ("CrossAttnUpBlock2D", dict(common, in_channels=32, prev_output_channel=64,
                                    out_channels=64, add_upsample=True, resnet_groups=8,
                                    attn_num_head_channels=4, cross_attention_dim=ctx),
         up(64, 32, 64, "ctx")),
        ("AttnUpBlock2D", dict(common, in_channels=32, prev_output_channel=64,
                               out_channels=64, add_upsample=True, resnet_groups=8,
                               attn_num_head_channels=16), up(64, 32, 64, "temb")),
        ("SkipUpBlock2D", dict(common, in_channels=64, prev_output_channel=64,
                               out_channels=64, add_upsample=True), up(64, 64, 64, "skip")),
        ("AttnSkipUpBlock2D", dict(common, in_channels=64, prev_output_channel=64,
                                   out_channels=64, add_upsample=True,
                                   attn_num_head_channels=32), up(64, 64, 64, "skip")),
        ("UpDecoderBlock2D", dict(common, in_channels=32, prev_output_channel=32,
                                  out_channels=64, add_upsample=True, resnet_groups=8),
         up(32, 32, 64, "x")),
        ("AttnUpDecoderBlock2D", dict(common, in_channels=32, prev_output_channel=32,
                                      out_channels=64, add_upsample=True, resnet_groups=8,
                                      attn_num_head_channels=16), up(32, 32, 64, "x")),
    )


def flat_outputs(out):
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return []


def phase_diffusers_vs_cpu():
    """17c: f32 with TF32 off, card against CPU from the same weights and
    inputs at phase 15's tolerances: ``upfirdn2d`` at four (up, down, pad)
    cases, both FIR resamplers with and without their conv, ``DResnetBlock``
    with ``up_fir`` and ``down_fir``, each of the factories' 14 block types
    at a small width (forward), and a small ``UNet2DConditionDiffusers``
    (forward with labels and a CFG mask, one ``train_loss`` and its
    gradients); then that UNet's bf16 training step's gradients against its
    f32 step's, the worst tensor held to DIFFUSERS_GRAD_REL_LIMIT."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline
    from medfusion_tpu_torch.models import diffusers_blocks as db
    from medfusion_tpu_torch.models.latent_embedders_diffusers import DResnetBlock
    from medfusion_tpu_torch.models.unet_diffusers import UNet2DConditionDiffusers

    gen = torch.Generator().manual_seed(17)
    x = torch.randn((2, 16, 24, 20), generator=gen)
    kernel = torch.outer(torch.tensor([1.0, 3, 3, 1]), torch.tensor([1.0, 2, 3, 4]))
    kernel = kernel / kernel.sum()
    for up, down, pad in ((1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (3, 2))):
        close_scaled(f"upfirdn2d up {up} down {down} pad {pad}",
                     db.upfirdn2d(x.cuda(), kernel.cuda(), up, down, pad),
                     db.upfirdn2d(x, kernel, up, down, pad))
    modules = [(f"{cls.__name__} conv={use_conv}", lambda c=cls, u=use_conv: c(16, 32, u),
                (x,)) for cls in (db.FirUpsample, db.FirDownsample) for use_conv in (False, True)]
    temb = torch.randn((2, 8), generator=gen)
    modules += [(f"DResnetBlock {mode}", lambda m=mode: DResnetBlock(
        16, 32, 8, 8, groups_out=16, output_scale_factor=2.0, updown=m), (x, temb))
        for mode in ("up_fir", "down_fir")]
    modules += [(name, lambda n=name, k=kw: (db.get_down_block if "Down" in n
                                             else db.get_up_block)(n, **k), make(gen, "cpu"))
                for name, kw, make in diffusers_block_cases()]
    for name, make, args in modules:
        torch.manual_seed(0)
        cpu = make()
        perturb_(cpu, gen)
        perturb_gn_(cpu, gen)
        card = make().cuda()
        card.load_state_dict(cpu.state_dict())

        def to(a, dev):
            return [to(v, dev) for v in a] if isinstance(a, list) else a.to(dev)

        with torch.no_grad():
            ref = flat_outputs(cpu(*args))
            out = flat_outputs(card(*[to(a, "cuda") for a in args]))
        if len(ref) != len(out) or not ref:
            raise RuntimeError(f"{name}: {len(out)} outputs on the card, {len(ref)} on the CPU")
        for i, (o, r) in enumerate(zip(out, ref)):
            close_scaled(f"{name} output {i} {tuple(r.shape)}", o, r)

    p = PRESETS["smoke"]
    b = 4
    pipes = {}
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        unet = UNet2DConditionDiffusers(in_channels=p.emb_channels, out_channels=p.emb_channels,
                                        num_classes=2, **dict(DIFFUSERS_SMALL,
                                                              block_out_channels=(32, 64),
                                                              cross_attention_dim=32))
        pipe = build_train_pipeline(p, device=dev, seed=0)
        pipes[dev] = dataclasses.replace(pipe, noise_estimator=unet.to(dev), latent_embedder=None)
    perturb_(pipes["cpu"].noise_estimator, gen)
    perturb_gn_(pipes["cpu"].noise_estimator, gen)
    pipes["cuda"].noise_estimator.load_state_dict(pipes["cpu"].noise_estimator.state_dict())
    z = torch.randn((b, *p.latent_shape), generator=gen)
    t = torch.randint(0, p.timesteps, (b,), generator=gen)
    cond, mask = torch.arange(b) % 2, torch.tensor([1.0, 0.0] * (b // 2))
    batch = {"source": z, "target": cond}
    draws = dict(pipes["cpu"].train_draws(b, p.latent_shape, generator=gen),
                 drop=torch.tensor(False))
    out = {}
    for dev, pipe in pipes.items():
        est = pipe.noise_estimator
        with torch.no_grad():
            y, _ = est(z.movedim(-1, 1).to(dev), t.to(dev), cond.to(dev), mask.to(dev))
        loss, _ = pipe.train_loss({k: v.to(dev) for k, v in batch.items()},
                                  {k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        out[dev] = (y, loss.detach(), {k: q.grad.detach().cpu()
                                       for k, q in est.named_parameters() if q.grad is not None})
    (y0, l0, g0), (y1, l1, g1) = out["cpu"], out["cuda"]
    close_scaled("small UNet2DConditionDiffusers forward", y1, y0)
    torch.testing.assert_close(l1.cpu(), l0, rtol=SMOKE_TOL, atol=0)
    gap = grad_gap(g1, g0)
    log(f"  small UNet2DConditionDiffusers train step: loss {l1.item():.6f} vs "
        f"{l0.item():.6f}; gradients ({len(g0)} tensors) max|d| {gap:.3e} of max|g| (limit "
        f"{CLF_GRAD_TOL})")
    if set(g1) != set(g0) or not gap <= CLF_GRAD_TOL:
        raise RuntimeError(f"small diffusers UNet: card gradients depart by {gap}")
    del pipes, out

    # bf16 against f32 on the chest latent, B=32
    c = PRESETS["chest"]
    with torch.device("cuda"):
        torch.manual_seed(0)
        unet = UNet2DConditionDiffusers(in_channels=c.emb_channels, out_channels=c.emb_channels,
                                        num_classes=c.num_classes, **DIFFUSERS_SMALL)
    pipe = dataclasses.replace(build_train_pipeline(c, device="cuda", seed=0),
                               noise_estimator=unet, latent_embedder=None)
    cgen = torch.Generator(device="cuda").manual_seed(18)
    perturb_(unet, cgen)
    perturb_gn_(unet, cgen)
    latents = {"source": torch.randn((TRAIN_BATCH, *c.latent_shape), generator=cgen,
                                     device="cuda"),
               "target": torch.arange(TRAIN_BATCH, device="cuda") % 2}
    cdraws = dict(pipe.train_draws(TRAIN_BATCH, c.latent_shape, generator=cgen),
                  drop=torch.tensor(False, device="cuda"))
    l32, g32 = grads_of(pipe, latents, cdraws, None)
    l16, g16 = grads_of(pipe, latents, cdraws, torch.bfloat16)
    single_token = (".attn2.to_q.", ".attn2.to_k.")
    keep = [k for k in g32 if not any(s in k for s in single_token)]
    worst, glob = grad_departure({k: g16[k] for k in keep}, {k: g32[k] for k in keep})
    n_params = sum(q.numel() for q in unet.parameters())
    log(f"  small UNet2DConditionDiffusers ({n_params / 1e6:.1f} M, widths "
        f"{DIFFUSERS_SMALL['block_out_channels']}) bf16 vs f32 step at B={TRAIN_BATCH}: loss "
        f"{l16.item():.5f} vs {l32.item():.5f}; gradients ({len(keep)} of {len(g32)} tensors) "
        f"worst |d|_2/|g32|_2 = {fmt_worst(worst)} (limit {DIFFUSERS_GRAD_REL_LIMIT}); "
        f"max|d|/max|g32| {glob:.3e}")
    if not (torch.isfinite(l16) and abs(l16.item() - l32.item()) <= 5e-2 * abs(l32.item())):
        raise RuntimeError(f"bf16 loss {l16.item()} departs from f32 {l32.item()}")
    if not worst[0][0] < DIFFUSERS_GRAD_REL_LIMIT:
        raise RuntimeError(f"diffusers UNet bf16 gradients depart: {fmt_worst(worst)}")
    return {"grad_gap": gap, "bf16_worst": worst[0][0]}


def phase_diffusers_full_width(ops, root):
    """17d: ``UNet2DConditionDiffusers`` at its default widths (320 / 640 /
    1,280 / 1,280, 2 layers a block, 32 groups, cross-attention 768, 8
    heads) on the chest latent (8 channels, 32x32, 2 classes) with the chest
    schedule and VAE, seeded weights: one bf16 training step on f32 masters
    with AdamW + EMA at B=32 on phase 9's images (the VAE's encode the only
    kernel launches: VAE_GN_PER_ENCODE a step), ms a step (host clock around
    DIFFUSERS_STEP_REPS synchronised steps) and peak memory, a profiled
    step's device time by kind; then DDIM DIFFUSERS_DDIM (eta 0, CFG
    DIFFUSERS_CFG) at B=DIFFUSERS_SAMPLE_N in bf16 with the decode: seconds
    and launches (the decode's only)."""
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline, seeded
    from medfusion_tpu_torch.models.unet_diffusers import UNet2DConditionDiffusers
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    pipe = build_train_pipeline(p, device="cuda", seed=0)
    with seeded(torch.device("cuda"), 0):
        unet = UNet2DConditionDiffusers(in_channels=p.emb_channels, out_channels=p.emb_channels,
                                        num_classes=p.num_classes)
    n_params = sum(q.numel() for q in unet.parameters())
    if n_params != DIFFUSERS_PARAMS:
        raise RuntimeError(f"the default diffusers UNet has {n_params} parameters, the JAX "
                           f"package's {DIFFUSERS_PARAMS}")
    pipe = dataclasses.replace(pipe, noise_estimator=unet)
    # the seeded VAE's zero-initialised out conv would decode every latent to 0
    perturb_(pipe.latent_embedder, torch.Generator(device="cuda").manual_seed(21))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState(unet, lr=p.diffusion_lr, weight_decay=1e-2, use_ema=True)
    step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
    batch = family_batch(p, root)
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(19))
    ops.reset_launch_counts()
    metrics = step(state, batch, draws)
    torch.cuda.synchronize()
    check_counts("full-width diffusers UNet train step", ops.launch_counts(),
                 {"group_norm_silu": VAE_GN_PER_ENCODE})
    loss0 = float(metrics["loss"])
    ms, peak, wall, kinds = step_ms_and_breakdown(step, state, batch, draws,
                                                  DIFFUSERS_STEP_REPS)
    loss = float(step(state, batch, draws)["loss"])
    state_gib = n_params * STATE_BYTES_PER_PARAM / 2**30
    log(f"  UNet2DConditionDiffusers ({n_params:,} parameters) train step at B={TRAIN_BATCH} "
        f"(bf16 on f32 masters, AdamW + EMA): {ms:.1f} ms/step, peak memory {peak:.2f} GiB "
        f"(the state alone {state_gib:.2f} GiB at {STATE_BYTES_PER_PARAM} bytes a "
        f"parameter); profiled step wall {wall:.1f} ms, {fmt_kinds(kinds)}; losses "
        f"{loss0:.5f} -> {loss:.5f}")
    if not (math.isfinite(loss0) and math.isfinite(loss)):
        raise RuntimeError(f"full-width diffusers UNet losses {loss0}, {loss}")
    report = {"params": n_params, "ms": ms, "peak": peak, "wall": wall, "kinds": kinds}
    del state, step, batch, draws, metrics
    torch.cuda.empty_cache()

    sampler = dataclasses.replace(pipe, noise_estimator=unet.to(torch.bfloat16).eval(),
                                  latent_embedder=pipe.latent_embedder.to(torch.bfloat16),
                                  compute_dtype=torch.bfloat16)
    cond = torch.arange(DIFFUSERS_SAMPLE_N, device="cuda") % 2
    kw = dict(condition=cond, steps=DIFFUSERS_DDIM, guidance_scale=DIFFUSERS_CFG, eta=0.0,
              decode=False)
    with torch.no_grad():
        sampler.sample(2, p.latent_shape, condition=cond[:2], steps=2,
                       guidance_scale=DIFFUSERS_CFG, eta=0.0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        z = sampler.sample(DIFFUSERS_SAMPLE_N, p.latent_shape,
                           generator=torch.Generator(device="cuda").manual_seed(20), **kw)
        images = sampler.decode_latent(z.movedim(-1, 1)).movedim(1, -1)  # as decode=True
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sample_peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts(f"diffusers UNet DDIM {DIFFUSERS_DDIM}", ops.launch_counts(),
                 {"group_norm_silu": VAE_GN_PER_DECODE})
    side = p.image_size
    finite = bool(torch.isfinite(z).all() and torch.isfinite(images).all())
    if images.shape != (DIFFUSERS_SAMPLE_N, side, side, 3) or not finite:
        raise RuntimeError(f"diffusers UNet samples {tuple(images.shape)}, finite {finite}")
    log(f"  UNet2DConditionDiffusers DDIM {DIFFUSERS_DDIM} (eta 0, CFG {DIFFUSERS_CFG}: "
        f"{2 * DIFFUSERS_SAMPLE_N} rows a forward) at B={DIFFUSERS_SAMPLE_N} with the decode, "
        f"bf16: {seconds:.3f} s, peak {sample_peak:.2f} GiB; latents {tuple(z.shape)} std "
        f"{z.float().std().item():.3f}, max|z| {z.float().abs().max().item():.3f}; images "
        f"{tuple(images.shape)} in [{images.min().item():.3f}, {images.max().item():.3f}]")
    report.update(sample_s=seconds, sample_peak=sample_peak)
    del sampler, pipe, unet, images, z
    torch.cuda.empty_cache()
    return report


# ---- phase 18: parallelism at world 1 over NCCL ------------------------------
# The card run is one process: NCCL refuses two ranks on one card and gloo
# has no CUDA all-to-all or point-to-point, so every sharded path runs at
# world 1 and is held bit for bit to its unsharded counterpart. The sharded
# sampler and the CLI at the chest preset's full width (B=32, bf16, DDIM 50,
# eta 1; the sampler with CFG and un_cond = 1 - label); two chest-UNet
# train steps at B=32 for each placement; ring attention at the 32^2 level
# of chest-spatial (8 heads of 32, 1,024 tokens) at the sampling batch's 16
# rows; the chest DiT-MoE (DIT_MOE) forward and step; a one-stage pipeline
# of residual MLP blocks on the DiT's tokens.
PAR_N, PAR_STEPS, PAR_TRAIN_STEPS = 32, 50, 2
RING_SPLITS = (2, 4)
# the ring's backward at the training batch; its f32 case at the classifier's
# (256 tokens, 4 heads x 32) attention, B=8, held to the plain version at 1e-5
RING_BWD_BATCH = TRAIN_BATCH
RING_F32, RING_F32_TOL = (8, 4, 256, 32), 1e-5
PIPE_TOKENS, PIPE_WIDTH = 256, 384


def fully_shard_takes_placement_fn():
    import inspect

    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:
        from torch.distributed._composable.fsdp import fully_shard
    return "shard_placement_fn" in inspect.signature(fully_shard).parameters


def same(name, out, ref):
    """Raise unless ``out`` and ``ref`` are equal bit for bit."""
    import torch

    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.equal(out, ref):
        diff = ((out.float() - ref.float()).abs().max().item()
                if out.shape == ref.shape else None)
        raise RuntimeError(f"{name}: not bit-equal to the unsharded path (max|d| {diff}, "
                           f"{tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype})")


def same_params(name, a, b):
    for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        same(f"{name} {k}", x, y)


def phase_parallel_init():
    """18a: versions, the NCCL group at world 1, the mesh."""
    import torch
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel import make_mesh
    from medfusion_tpu_torch.parallel.multihost import initialize_multihost

    log(f"  torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}, fully_shard takes "
        f"shard_placement_fn: {fully_shard_takes_placement_fn()}")
    t0 = time.perf_counter()
    info = initialize_multihost(device="cuda")
    mesh = make_mesh(n_model=1, device="cuda")
    log(f"  initialize_multihost(device='cuda'): {info}, backend {dist.get_backend()}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} in {time.perf_counter() - t0:.2f} s")
    if info["process_count"] != 1 or dist.get_backend() != "nccl":
        raise RuntimeError(f"expected NCCL at world 1, got {info}, {dist.get_backend()}")
    return mesh


def phase_sharded_sampler(ops, mesh):
    """18b: ``make_sharded_sampler`` against ``pipe.denoise`` with the same
    generator, chest, B=PAR_N, bf16, DDIM PAR_STEPS at eta 1, CFG GUIDANCE
    with un_cond = 1 - label, decode: bit-equal, kernel 1's launches held."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline
    from medfusion_tpu_torch.parallel import make_sharded_sampler

    p = PRESETS["chest"]
    pipe = build_pipeline(p, device="cuda", compute_dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(18)
    perturb_(pipe.noise_estimator, gen)
    perturb_(pipe.latent_embedder, gen)  # a seeded VAE decodes every latent to 0
    cond = torch.arange(PAR_N, device="cuda") % 2
    kw = dict(steps=PAR_STEPS, guidance_scale=GUIDANCE, eta=1.0)
    expected = unet_launches(forwards=PAR_STEPS, decodes=1)
    out = {}
    for name in ("unsharded", "sharded", "unsharded ", "sharded "):
        g = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if name.strip() == "sharded":
            sampler = make_sharded_sampler(pipe, mesh, p.latent_shape, **kw)
            imgs = sampler(g, PAR_N, cond, 1 - cond)
        else:
            x_T = torch.randn((PAR_N, *p.latent_shape), generator=g, device="cuda")
            imgs = pipe.denoise(x_T, condition=cond, un_cond=1 - cond, generator=g, **kw)
        torch.cuda.synchronize()
        out.setdefault(name.strip(), []).append(time.perf_counter() - t0)
        check_counts(f"{name.strip()} sampler", ops.launch_counts(), expected)
        out[name.strip() + " images"] = imgs
    same("sharded sampler", out["sharded images"], out["unsharded images"])
    if not torch.isfinite(out["sharded images"]).all():
        raise RuntimeError("non-finite images")
    if out["sharded images"].float().std().item() == 0:
        raise RuntimeError("the sharded sampler's images are constant")
    s = {k: min(v) for k, v in out.items() if not k.endswith("images")}
    log(f"  sharded sampler (chest, B={PAR_N}, bf16, DDIM {PAR_STEPS}, CFG {GUIDANCE}, "
        f"decode): bit-equal to pipe.denoise; {s['sharded']:.3f} s, unsharded "
        f"{s['unsharded']:.3f} s")
    return {"sharded_s": s["sharded"], "unsharded_s": s["unsharded"],
            "launches": expected["group_norm_silu"]}


def phase_sample_dataset_torchrun(tmp):
    """18c: ``cli.sample_dataset`` (chest, chunk PAR_N, PAR_N samples a
    label, DDIM PAR_STEPS) under ``torch.distributed.run`` at one process
    and run alone, on seeded and perturbed weights given as a reference
    ``--ckpt`` (a seeded VAE decodes every latent to 0): the PNGs byte for
    byte, and not all alike."""
    from medfusion_tpu_torch.data.png import read_png

    ckpt = perturbed_reference_ckpt("chest", tmp / "weights.ckpt", "cuda")
    argv = ["-m", "medfusion_tpu_torch.cli.sample_dataset", "--preset", "chest",
            "--ckpt", str(ckpt), "--chunk", str(PAR_N), "--n-samples", str(PAR_N),
            "--steps-list", str(PAR_STEPS)]
    runs = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", "1"] + argv,
            "alone": [sys.executable] + argv}
    seconds = {}
    for name, cmd in runs.items():
        out = tmp / name
        t0 = time.perf_counter()
        res = subprocess.run(cmd + ["--out", str(out)], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        seconds[name] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"cli.sample_dataset ({name}) exited {res.returncode}:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
        for line in res.stdout.splitlines():
            if "samples ->" in line:
                log(f"    {name}: {line.strip()}")
    files = sorted(q.relative_to(tmp / "alone") for q in (tmp / "alone").rglob("*.png"))
    other = sorted(q.relative_to(tmp / "torchrun") for q in (tmp / "torchrun").rglob("*.png"))
    if files != other or len(files) != 2 * PAR_N:
        raise RuntimeError(f"torchrun wrote {len(other)} PNGs, alone {len(files)}")
    for f in files:
        if (tmp / "alone" / f).read_bytes() != (tmp / "torchrun" / f).read_bytes():
            raise RuntimeError(f"{f} differs between torchrun and a plain run")
    if read_png(tmp / "alone" / files[0]).std() == 0:
        raise RuntimeError(f"{files[0]} is one grey level: the weights decode to a constant")
    log(f"  cli.sample_dataset under torchrun (1 process, NCCL): {len(files)} PNGs "
        f"byte-equal to the plain run; wall {seconds['torchrun']:.1f} s, alone "
        f"{seconds['alone']:.1f} s (each with its start-up)")
    return seconds


def phase_parallel_train(ops, mesh):
    """18d: two chest-UNet steps at B=32, bf16 on f32 masters, AdamW + EMA,
    through ``shard_params``/``shard_batch`` (dp, FSDP, TP with
    min_shard_dim 256), each bit-equal to the plain steps (cuDNN's
    deterministic algorithms on) with kernel 1's launches held."""
    import copy
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline
    from medfusion_tpu_torch.parallel import shard_batch, shard_params
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    pipe = build_train_pipeline(p, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(18)
    perturb_(pipe.noise_estimator, gen)
    batches = train_batches(p, PAR_TRAIN_STEPS, seed=18)
    draws = [pipe.train_draws(TRAIN_BATCH, p.latent_shape, generator=gen) for _ in batches]
    base = copy.deepcopy(pipe.noise_estimator)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    expected = {"group_norm_silu": PAR_TRAIN_STEPS * (UNET_GN_PER_FORWARD + VAE_GN_PER_ENCODE)}
    runs = {}
    try:
        for name, placement in (("plain", None), ("dp", {}), ("fsdp", {"fsdp": True}),
                                ("tp", {"tensor_parallel": True, "min_shard_dim": 256}),
                                ("plain again", None)):
            unet = copy.deepcopy(base)
            if placement is not None:
                shard_params(unet, mesh, **placement)
            state = TrainState(unet, lr=p.diffusion_lr, weight_decay=1e-2, use_ema=True)
            step = make_diffusion_train_step(
                dataclasses.replace(pipe, noise_estimator=unet), compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            losses = []
            for b, d in zip(batches, draws):  # the last step timed: the first warms up
                t0 = time.perf_counter()
                if placement is not None:
                    b, d = shard_batch(b, mesh), shard_batch(d, mesh)
                losses.append(step(state, b, d)["loss"])
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check_counts(f"{name} train steps", ops.launch_counts(), expected)
            runs[name] = (state, torch.stack(losses), ms)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref = runs["plain"][0]
    same_params("plain step again", runs["plain again"][0].model, ref.model)
    for name in ("dp", "fsdp", "tp"):
        state, losses, _ = runs[name]
        same(f"{name} losses", losses, runs["plain"][1])
        same_params(f"{name} params", state.model, ref.model)
        same_params(f"{name} EMA", state.ema, ref.ema)
    ms = {k: v[2] for k, v in runs.items()}
    log(f"  chest train steps (B={TRAIN_BATCH}, bf16, {PAR_TRAIN_STEPS} steps) through "
        f"shard_params: dp, FSDP, TP bit-equal to the plain steps; ms of the last step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return ms


def phase_ring_attention(ops, FA, mesh):
    """18e: ring attention at world 1 bit-equal to kernel 2 alone, its launch
    counted; the lse merge of kernel 2 over K/V split into RING_SPLITS
    blocks against the same merge of the plain version's blocks (bf16, two
    ulps of the blocks' largest |o|) and against kernel 2 on the whole.
    Then its gradient (:func:`ring_backward_checks`)."""
    import torch

    from medfusion_tpu_torch.parallel import ring_attention
    from medfusion_tpu_torch.parallel.ring_attention import merge_attention_blocks

    gen = torch.Generator(device="cuda").manual_seed(18)
    b, h, n, d = 2 * N_SAMPLES, 8, 1024, 32
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    scale = d ** -0.25
    with torch.no_grad():
        ops.reset_launch_counts()
        out = ring_attention(q, k, v, mesh, scale=scale, axis="data")
        check_counts("ring attention (world 1)", ops.launch_counts(), {"flash_attention": 1})
        whole, _ = FA.flash_attention(q, k, v, scale)
        same("ring attention", out, whole)
        ring_ms = cuda_ms(lambda: ring_attention(q, k, v, mesh, scale=scale, axis="data"), 20)
        kernel_ms = cuda_ms(lambda: FA.flash_attention(q, k, v, scale), 20)
        errs = {}
        for parts in RING_SPLITS:
            blocks = list(zip(k.chunk(parts, dim=2), v.chunk(parts, dim=2)))
            ops.reset_launch_counts()
            kern = [FA.flash_attention(q, kb, vb, scale) for kb, vb in blocks]
            check_counts(f"merge over {parts} blocks", ops.launch_counts(),
                         {"flash_attention": parts})
            plain = [FA.naive_attention_reference(q, kb, vb, scale) for kb, vb in blocks]
            got, _ = merge_attention_blocks(*zip(*kern))
            want, _ = merge_attention_blocks(*zip(*plain))
            atol, _ = attn_o_tol(torch.stack([o for o, _ in plain]))
            errs[parts] = close(f"merge of {parts} blocks", got, want, atol, 0.0)
            errs[f"{parts} vs whole"] = (got.float() - whole.float()).abs().max().item()
            merge_ms = cuda_ms(lambda: merge_attention_blocks(
                *zip(*[FA.flash_attention(q, kb, vb, scale) for kb, vb in blocks])), 20)
            errs[f"{parts} ms"] = merge_ms
    log(f"  ring attention (B={b}, 8 heads x 32, {n} tokens, bf16): bit-equal to kernel 2, "
        f"{ring_ms:.4f} ms (kernel alone {kernel_ms:.4f}); lse merge vs the plain merge "
        f"max|d| " + ", ".join(f"{p} blocks {errs[p]:.3e} ({errs[f'{p} ms']:.4f} ms; vs the "
                                f"whole {errs[f'{p} vs whole']:.3e})" for p in RING_SPLITS))
    return {"ring_ms": ring_ms, "kernel_ms": kernel_ms, "errs": errs,
            "backward": ring_backward_checks(ops, FA, mesh)}


def check_blocks_backward(ops, FA, q, k, v, do, scale, parts, f32_tol=None):
    """``attention_blocks_backward`` over ``parts`` K/V blocks with the merged
    kernel-2 o and lse: both kernels launched once a block, against the same
    sums of the plain backward's pairs. bf16: each block's dK/dV within
    ``attn_bwd_tol`` of its plain pair, dQ (an f32 sum of ``parts`` bf16
    partials) within the sum of its partials' tolerances; f32: ``f32_tol``.
    Returns (max errors, (dq, dk, dv) in the input dtype, the merged (o, lse),
    the blocks)."""
    import torch

    from medfusion_tpu_torch.parallel.ring_attention import (
        attention_blocks_backward,
        merge_attention_blocks,
    )

    blocks = list(zip(k.chunk(parts, dim=2), v.chunk(parts, dim=2)))
    o, lse = merge_attention_blocks(*zip(*[FA.flash_attention(q, kb, vb, scale)
                                           for kb, vb in blocks]))
    ops.reset_launch_counts()
    dq, dkv = attention_blocks_backward(q, blocks, o, lse, do, scale)
    check_counts(f"block-pair backward over {parts} blocks", ops.launch_counts(),
                 {"flash_attention_bwd_dq": parts, "flash_attention_bwd_dkv": parts})
    plain = [FA.flash_attention_backward_reference(q, kb, vb, o, lse, do, scale)
             for kb, vb in blocks]
    tag = f"blocks backward x{parts} {str(q.dtype).split('.')[-1]}"

    def tol(ref):  # (atol, rtol)
        return (attn_bwd_tol(ref)[0], 0.0) if f32_tol is None else (f32_tol, f32_tol)

    dq_tol = tol(plain[0][0])
    if f32_tol is None:  # an f32 sum of bf16 partials: their tolerances add
        dq_tol = (sum(tol(g[0])[0] for g in plain), 0.0)
    errs = {"dq": close(f"{tag} dq", dq, sum(g[0].float() for g in plain), *dq_tol)}
    for i, ((dk, dv), (_, rk, rv)) in enumerate(zip(dkv, plain)):
        for what, got, ref in (("dk", dk, rk), ("dv", dv, rv)):
            errs[what] = max(errs.get(what, 0.0),
                             close(f"{tag} block {i} {what}", got, ref, *tol(ref)))
    grads = (dq.to(q.dtype), torch.cat([g for g, _ in dkv], dim=2),
             torch.cat([g for _, g in dkv], dim=2))
    return errs, grads, (o, lse), blocks


def ring_backward_checks(ops, FA, mesh):
    """18e, the gradient, at the 32^2 level of chest-spatial (B=RING_BWD_BATCH,
    8 heads x 32, 1,024 tokens, bf16): the ring's backward at world 1
    bit-equal to kernels 3 and 4 on the whole, each launched once;
    ``attention_blocks_backward`` over RING_SPLITS blocks against the plain
    backward's pairs (``check_blocks_backward``), with its max|d| against the
    whole-sequence pair; one f32 case at the classifier's (256, 4 x 32)
    shape (RING_F32) over 2 blocks within RING_F32_TOL. Times (eager and
    graph-replayed) against the pair on the whole sequence;
    ``tools/ring_backward_times.py`` splits them by kernel."""
    import torch

    from medfusion_tpu_torch.parallel import ring_attention
    from medfusion_tpu_torch.parallel.ring_attention import attention_blocks_backward

    gen = torch.Generator(device="cuda").manual_seed(20)
    b, h, n, d = RING_BWD_BATCH, 8, 1024, 32
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    scale = d ** -0.25
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launch_counts()
    o = ring_attention(*leaves, mesh, scale=scale, axis="data")
    grads = torch.autograd.grad(o, leaves, do, retain_graph=True)
    check_counts("ring attention forward + backward (world 1)", ops.launch_counts(),
                 {"flash_attention": 1, "flash_attention_bwd_dq": 1,
                  "flash_attention_bwd_dkv": 1})
    with torch.no_grad():
        whole_o, whole_lse = FA.flash_attention(q, k, v, scale)
    whole = FA.flash_attention_backward_cuda(q, k, v, whole_o, whole_lse, do, scale)
    for what, got, want in zip(("dq", "dk", "dv"), grads, whole):
        same(f"ring backward {what}", got, want)

    def pair():
        return FA.flash_attention_backward_cuda(q, k, v, whole_o, whole_lse, do, scale)

    out = {"ring_ms": cuda_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                              20),
           "pair_ms": cuda_ms(pair, 20), "pair_graph_ms": graph_ms(pair, 20),
           "whole_max": {w: g.float().abs().max().item()
                         for w, g in zip(("dq", "dk", "dv"), whole)}}
    for parts in RING_SPLITS:
        errs, got, (bo, blse), blocks = check_blocks_backward(ops, FA, q, k, v, do, scale,
                                                              parts)
        run = functools.partial(attention_blocks_backward, q, blocks, bo, blse, do, scale)
        out[parts] = {
            "errs": errs,
            "vs_whole": {w: (g.float() - r.float()).abs().max().item()
                         for w, g, r in zip(("dq", "dk", "dv"), got, whole)},
            "ms": cuda_ms(run, 20), "graph_ms": graph_ms(run, 20)}
    gen32 = torch.Generator(device="cuda").manual_seed(21)
    f32 = [torch.randn(RING_F32, generator=gen32, device="cuda") for _ in range(4)]
    out["f32"], _, _, _ = check_blocks_backward(ops, FA, *f32, RING_F32[3] ** -0.25, 2,
                                               f32_tol=RING_F32_TOL)
    log(f"  ring backward (B={b}, 8 heads x 32, {n} tokens, bf16; {card_line()}): world 1 "
        f"bit-equal to kernels 3 + 4 on the whole, {out['ring_ms']:.4f} ms (the pair alone "
        f"{out['pair_ms']:.4f}, graph-replayed {out['pair_graph_ms']:.4f}); block-pair "
        f"backward " + "; ".join(
            f"over {p} blocks {out[p]['ms']:.4f} ms (graph-replayed {out[p]['graph_ms']:.4f}), "
            f"vs the plain pairs max|d| "
            + ", ".join(f"{w} {e:.3e}" for w, e in out[p]["errs"].items())
            + " (vs the whole pair " + ", ".join(
                f"{w} {e:.3e} of max|g| {out['whole_max'][w]:.3e}"
                for w, e in out[p]["vs_whole"].items()) + ")"
            for p in RING_SPLITS)
        + f"; f32 B={RING_F32[0]} ({RING_F32[2]}, {RING_F32[1]} x {RING_F32[3]}) over 2 "
        f"blocks max|d| " + ", ".join(f"{w} {e:.3e}" for w, e in out["f32"].items())
        + f" (tol {RING_F32_TOL})")
    return out


def phase_expert_parallel(ops, mesh):
    """18f: the chest DiT-MoE (DIT_MOE) with ``moe_expert_axis`` against the
    one without on the same weights: a bf16 forward bit for bit, then
    PAR_TRAIN_STEPS bf16 train steps on one batch (loss, params, EMA bit
    for bit), kernels 3-5 counted."""
    import copy
    import dataclasses

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS, build_train_pipeline, build_unet, seeded
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    pipe = build_train_pipeline(p, device="cuda", estimator="dit", seed=0)
    with seeded(torch.device("cuda"), 18):
        dense = build_unet(p, "dit", **DIT_MOE)
        ep = build_unet(p, "dit", **DIT_MOE, moe_expert_axis=mesh["data"])
    ep.load_state_dict(dense.state_dict(), strict=True)
    batch = train_batches(p, 1, seed=18)[0]
    draws = pipe.train_draws(TRAIN_BATCH, p.latent_shape,
                             generator=torch.Generator(device="cuda").manual_seed(18))
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn((TRAIN_BATCH, *p.latent_shape[2:], *p.latent_shape[:2]),
                    generator=gen, device="cuda").bfloat16()
    t = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    c = torch.arange(TRAIN_BATCH, device="cuda") % 2
    with torch.no_grad():
        fwd = [copy.deepcopy(m).bfloat16()(x, t, c, with_aux=True) for m in (dense, ep)]
    same("DiT-MoE forward", fwd[1][0], fwd[0][0])
    same("DiT-MoE aux", fwd[1][2], fwd[0][2])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, model in (("dense", dense), ("expert-parallel", ep)):
            state = TrainState(model, lr=p.diffusion_lr, weight_decay=1e-2, use_ema=True)
            step = make_diffusion_train_step(dataclasses.replace(pipe, noise_estimator=model),
                                             compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            for _ in range(PAR_TRAIN_STEPS):  # the last step timed: the first warms up
                t0 = time.perf_counter()
                metrics = step(state, batch, draws)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check_counts(f"DiT-MoE {name} train steps", ops.launch_counts(),
                         dit_launches(PAR_TRAIN_STEPS, PAR_TRAIN_STEPS,
                                      encodes=PAR_TRAIN_STEPS))
            runs[name] = (state, metrics, ms)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (sd, md, ms_d), (se, me, ms_e) = runs["dense"], runs["expert-parallel"]
    same("DiT-MoE loss", me["loss"], md["loss"])
    same("DiT-MoE moe_aux", me["moe_aux"], md["moe_aux"])
    same_params("DiT-MoE params", se.model, sd.model)
    same_params("DiT-MoE EMA", se.ema, sd.ema)
    log(f"  DiT-MoE with moe_expert_axis (world 1): bf16 forward and {PAR_TRAIN_STEPS} train "
        f"steps (B={TRAIN_BATCH}) bit-equal to the dense layout; the last step {ms_e:.1f} ms "
        f"(dense {ms_d:.1f})")
    return {"ep_ms": ms_e, "dense_ms": ms_d}


def phase_pipeline_world1(mesh):
    """18g: ``pipeline_apply`` at world 1 (one stage: a residual MLP block
    on [B, PIPE_TOKENS, PIPE_WIDTH] tokens, f32) against the stage applied
    directly: output and parameter gradients bit for bit."""
    import torch
    import torch.nn.functional as F

    from medfusion_tpu_torch.parallel import pipeline_apply, stack_stage_params

    gen = torch.Generator(device="cuda").manual_seed(18)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    def stage(prm, x):
        h = F.layer_norm(x, x.shape[-1:])
        return x + F.gelu(h @ prm["w1"] + prm["b1"]) @ prm["w2"]

    c = PIPE_WIDTH
    params = {"w1": rnd(c, 4 * c, std=c ** -0.5), "b1": rnd(4 * c, std=0.1),
              "w2": rnd(4 * c, c, std=(4 * c) ** -0.5)}
    x = rnd(TRAIN_BATCH, PIPE_TOKENS, c)
    stacked = {k: v.requires_grad_(True) for k, v in stack_stage_params([params]).items()}
    y = pipeline_apply(stage, stacked, x, mesh=mesh, axis="model")
    g = torch.autograd.grad((y ** 2).mean(), list(stacked.values()))
    flat = {k: v[0].detach().requires_grad_(True) for k, v in stacked.items()}
    y_ref = stage(flat, x)
    g_ref = torch.autograd.grad((y_ref ** 2).mean(), list(flat.values()))
    same("pipeline output", y, y_ref)
    for k, a, b in zip(flat, g, g_ref):
        same(f"pipeline grad {k}", a[0], b)
    with torch.no_grad():
        pipe_ms = cuda_ms(lambda: pipeline_apply(stage, stacked, x, mesh=mesh), 20)
        plain_ms = cuda_ms(lambda: stage(flat, x), 20)
    log(f"  pipeline_apply at world 1 (one stage, x {tuple(x.shape)}): output and gradients "
        f"bit-equal to the stage; forward {pipe_ms:.4f} ms (stage alone {plain_ms:.4f})")
    return {"pipe_ms": pipe_ms, "plain_ms": plain_ms}


# ---- phase 19: the constructor options no CLI reaches ------------------------------
# 19a: the chest UNet and VAE with learnable_interpolation=False, bf16, DDIM
# SURFACE_STEPS with CFG at B=8 and the decode; 19b: one bf16 step at B=32 of that
# UNet and of the legacy UNet whose decoders concatenate their skips
# (LEGACY_CONCAT_ATTENTION: spatial attention at level 1, so kernel 1 normalises
# the 256 + 512 channels of decoder 1's concatenation and the attention runs at
# 256 tokens, 8 heads of 96 and of 32, and kernel 6 at widths 768 and 256 on
# B x 256 rows), each held to an f32 step; 19c: the 3-D
# classifier on phase 16's latent [B, 8, 8, 16, 16], f32; 19d: small widths of
# the three on the card against the CPU.
SURFACE_STEPS = 25
LEGACY_CONCAT_ATTENTION = ("none", "spatial", "none", "none")
SMOKE_CONCAT_ATTENTION = ("spatial", "none")  # 19d: decoder 0's 32 + 16 channels
# tokens, width, heads of 19b's spatial transformers: attention and GEGLU
LEGACY_ATTN_SHAPES = ((256, 768, 8), (256, 256, 8))
CLF3D_KW = dict(image_size=16, in_channels=8, model_channels=CLF_CHANNELS, out_channels=2,
                num_res_blocks=2, attention_resolutions=(2,), channel_mult=(1, 2),
                spatial_dims=3, num_head_channels=32, pool="adaptive")
CLF3D_INPUT = (2, 8, 8, 16, 16)
# 8 x 8 x 8 tokens after the (1, 2, 2) downsample, 4 heads of 32
CLF3D_TOKENS, CLF3D_WIDTH, CLF3D_HEADS = 512, 2 * CLF_CHANNELS, 4


@contextlib.contextmanager
def gn_shapes_of(*modules):
    """The set of (shape, groups, eps, SiLU fused, dtype) of every GROUP
    norm that ``modules`` run inside the block."""
    from medfusion_tpu_torch.nn.blocks import Norm

    seen = set()

    def hook(m, args):
        seen.add((tuple(args[0].shape), m.num_groups, m.eps, m.fuse_silu, args[0].dtype))

    handles = [m.register_forward_pre_hook(hook) for mod in modules for m in mod.modules()
               if isinstance(m, Norm) and m.kind == "group"]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def check_gn_shapes(G, worst, shapes, label):
    """Kernel 1 against its plain version at each recorded GroupNorm shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(19)
    top = {}
    for shape, g, eps, silu, dtype in sorted(shapes, key=str):
        name = str(dtype).split(".")[-1]
        c = shape[1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 1.0).to(dtype)
        scale = (1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)
        bias = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)
        out = G.group_norm_silu_cuda(x, scale, bias, g, eps, apply_silu=silu)
        ref = G.group_norm_silu_reference(x, scale, bias, g, eps, apply_silu=silu)
        err = close(f"gn {label} {shape} G={g} {name}", out, ref, TOL[name], TOL[name])
        keep(worst, "group_norm_silu", name, err)
        top[name] = max(top.get(name, 0.0), err)
    widths = sorted({(s[0][1], s[1]) for s in shapes})
    log(f"  kernel 1 at the {len(shapes)} GroupNorm shapes of {label} (C, G: {widths}): "
        f"max|d| " + ", ".join(f"{k} {v:.3e}" for k, v in top.items())
        + f" (atol=rtol {TOL})")


def surface_models(p, dev, legacy_attention=None):
    """(UNet, VAE) at preset ``p``'s widths, seeded, both with
    ``learnable_interpolation=False``; with ``legacy_attention`` (one type a
    level) the legacy UNet in place of the UNet."""
    import torch

    from medfusion_tpu_torch.cli.presets import build_unet, build_vae, seeded

    options = {"learnable_interpolation": False}
    if legacy_attention is not None:
        options["use_attention"] = list(legacy_attention)
    with seeded(torch.device(dev), 0):
        return (build_unet(p, "unet" if legacy_attention is None else "unet_legacy",
                           **options),
                build_vae(p, learnable_interpolation=False))


def surface_pipeline(p, unet, vae, dev, compute_dtype=None, train=False):
    """The pipeline as ``build_pipeline`` (sampling) or ``build_train_pipeline``
    (``train``: CFG dropout, L1, a frozen VAE) make it, on these modules."""
    from medfusion_tpu_torch.cli.presets import build_scheduler
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline

    if train:
        return DiffusionPipeline(
            scheduler=build_scheduler(p, dev), noise_estimator=unet,
            latent_embedder=vae.eval().requires_grad_(False), estimator_objective="x_T",
            classifier_free_guidance_dropout=p.cfg_dropout, do_input_centering=False,
            clip_x0=False, loss="l1")
    return DiffusionPipeline(scheduler=build_scheduler(p, dev), noise_estimator=unet.eval(),
                             latent_embedder=vae.eval(), estimator_objective="x_T",
                             clip_x0=False, compute_dtype=compute_dtype)


def group_norms(*modules):
    from medfusion_tpu_torch.nn.blocks import Norm

    return sum(isinstance(m, Norm) and m.kind == "group" for mod in modules
               for m in mod.modules())


def learned_resamplers(*modules):
    """The BasicDown/BasicUp of ``modules`` that hold a conv (none, without
    learnable interpolation)."""
    from medfusion_tpu_torch.nn.blocks import BasicDown, BasicUp

    return [m for mod in modules for m in mod.modules()
            if isinstance(m, (BasicDown, BasicUp)) and any(True for _ in m.parameters())]


def phase_surface_sampling(ops, G, worst):
    """19a: the chest UNet and VAE without learnable interpolation: a bf16
    forward against f32 at the sampling batch's 16 rows, then DDIM
    SURFACE_STEPS with CFG 8 at B=8 and the decode, bf16, its launches held
    to the structure's (34 GroupNorms a UNet forward, 8 a decode); kernel 1
    at every GroupNorm shape the sampling ran."""
    import copy

    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS

    p = PRESETS["chest"]
    unet32, vae32 = surface_models(p, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    perturb_(unet32, gen)
    perturb_(vae32, gen)
    dec_norms = group_norms(vae32.inc_dec, vae32.decoders, vae32.outc)
    if (group_norms(unet32), dec_norms) != (UNET_GN_PER_FORWARD, VAE_GN_PER_DECODE):
        raise RuntimeError(f"{group_norms(unet32)} UNet and {dec_norms} decoder GroupNorms, "
                           f"the counts assume {UNET_GN_PER_FORWARD} and {VAE_GN_PER_DECODE}")
    if learned_resamplers(unet32, vae32):
        raise RuntimeError("a down or up block holds a conv without learnable interpolation")
    unet16 = copy.deepcopy(unet32).to(torch.bfloat16)
    vae16 = copy.deepcopy(vae32).to(torch.bfloat16)
    rows = 2 * N_SAMPLES
    x = torch.randn((rows, p.emb_channels, *p.latent_shape[:2]), generator=gen, device="cuda")
    t = torch.linspace(999, 0, rows, device="cuda").long()
    c = torch.arange(rows, device="cuda") % 2
    with torch.no_grad():
        y32, _ = unet32.eval()(x, t, c)
        y16, _ = unet16.eval()(x.bfloat16(), t, c)
    rel = ((y16.float() - y32).abs().max() / y32.abs().max()).item()
    log(f"  19a chest UNet without learnable interpolation, forward bf16 vs f32: "
        f"max|d|/max|ref| = {rel:.3e} (limit 5e-2)")
    if not rel < 5e-2:
        raise RuntimeError(f"bf16 UNet departs from f32 by {rel:.3e}")
    del unet32, vae32, y32, y16
    torch.cuda.empty_cache()

    pipe = surface_pipeline(p, unet16, vae16, "cuda", torch.bfloat16)
    cond = torch.arange(N_SAMPLES, device="cuda") % 2
    sgen = torch.Generator(device="cuda").manual_seed(0)
    with gn_shapes_of(unet16, vae16) as shapes:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = pipe.sample(N_SAMPLES, p.latent_shape, condition=cond, generator=sgen,
                           steps=SURFACE_STEPS, guidance_scale=GUIDANCE, eta=1.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    check_counts(f"19a sampling (DDIM {SURFACE_STEPS}, CFG {GUIDANCE}, B={N_SAMPLES}, decode)",
                 launches, unet_launches(forwards=SURFACE_STEPS, decodes=1))
    side = p.image_size
    if tuple(imgs.shape) != (N_SAMPLES, side, side, 3) or not torch.isfinite(imgs).all():
        raise RuntimeError(f"19a images {tuple(imgs.shape)} or non-finite")
    amax = imgs.abs().max().item()
    if not 0 < amax < 1e4:
        raise RuntimeError(f"19a image magnitude {amax} out of range")
    log(f"  19a sample: {tuple(imgs.shape)} in {seconds:.3f} s, image range "
        f"[{imgs.min().item():.3f}, {imgs.max().item():.3f}]")
    check_gn_shapes(G, worst, shapes, "19a's sampling")
    return {"seconds": seconds, "launches": launches["group_norm_silu"]}


def phase_surface_training(ops, FA, G, GL, worst):
    """19b: one bf16 step (AdamW + EMA, B=32, after a warm-up step) of 19a's
    UNet and of the legacy UNet with concatenated skips, each with phase 8's
    bf16-against-f32 gradient check first; the step's launches held to the
    structure's; kernel 1 at every GroupNorm shape the steps and checks ran,
    and the attention kernels and kernel 6 (B x tokens rows) at the legacy
    UNet's two transformer shapes, f32 and bf16 as the check and the step
    ran them."""
    import torch

    from medfusion_tpu_torch.cli.presets import PRESETS
    from medfusion_tpu_torch.nn.attention import SpatialTransformer
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p = PRESETS["chest"]
    batches = train_batches(p, 2, seed=19)
    report = {}
    for label, legacy in (("unet", False), ("unet_legacy", True)):
        unet, vae = surface_models(p, "cuda", LEGACY_CONCAT_ATTENTION if legacy else None)
        gen = torch.Generator(device="cuda").manual_seed(19)
        perturb_(unet, gen)
        perturb_(vae, gen)
        n_st = sum(isinstance(m, SpatialTransformer) for m in unet.modules())
        if n_st != (2 if legacy else 0):
            raise RuntimeError(f"19b {label}: {n_st} spatial transformers")
        per_forward = (LEGACY_GN_PER_FORWARD + 2 * n_st) if legacy else UNET_GN_PER_FORWARD
        if group_norms(unet) - n_st != per_forward:  # a transformer's cross-attention
            raise RuntimeError(f"19b {label}: {group_norms(unet)} GroupNorms")  # skips one
        expected = {"group_norm_silu": per_forward + VAE_GN_PER_ENCODE}
        if n_st:
            expected.update(flash_attention_tokens=n_st, flash_attention_bwd_dq=n_st,
                            flash_attention_bwd_dkv=n_st, geglu_mlp=n_st)
        pipe = surface_pipeline(p, unet, vae, "cuda", train=True)
        draws = [pipe.train_draws(TRAIN_BATCH, p.latent_shape, generator=gen) for _ in batches]
        with gn_shapes_of(unet, vae) as shapes:
            log(f"  19b {label} without learnable interpolation"
                + (f" (decoder skips concatenated, attention {LEGACY_CONCAT_ATTENTION})"
                   if legacy else "") + ":")
            check_train_grads(FA, pipe, batches[0], draws[0], faults=())
            state = TrainState(unet, lr=p.diffusion_lr, weight_decay=1e-2, use_ema=True)
            step = make_diffusion_train_step(pipe, compute_dtype=torch.bfloat16)
            step(state, batches[0], draws[0])  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            loss = float(step(state, batches[1], draws[1])["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = ops.launch_counts()
        check_counts(f"19b {label} step (B={TRAIN_BATCH}, bf16)", launches, expected)
        if not math.isfinite(loss):
            raise RuntimeError(f"19b {label}: loss {loss}")
        log(f"  19b {label} step: loss {loss:.5f}, {ms:.1f} ms (one step after a warm-up)")
        check_gn_shapes(G, worst, shapes, f"19b's {label} steps")
        report[label] = ms
        del unet, vae, pipe, state, step
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(191)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, c, heads in LEGACY_ATTN_SHAPES:
            for kernel, err in check_attention(FA, n, n, c, heads, dtype, gen).items():
                keep(worst, kernel, name, err)
            for kernel, err in check_attention_backward(FA, n, n, c, heads, dtype,
                                                        gen).items():
                keep(worst, kernel, name, err)
            keep(worst, "geglu_mlp", name, check_geglu(GL, TRAIN_BATCH * n, c, dtype, gen))
    return report


def phase_surface_classifier_3d(ops, FA, worst):
    """19c: ``EncoderUNetOpenAI(spatial_dims=3)`` (attention at the 8 x 8 x 8
    level, adaptive pool; its GroupNorm32s plain, as in JAX) on phase 16's
    latent, f32: a forward and the backward of a cross-entropy, the
    attention's launches held (kernel 5 forward, kernels 3 and 4 backward,
    one each a block) and each block's token count; then kernels 5, 3 and 4
    at that shape against their plain versions."""
    import torch
    import torch.nn.functional as F

    from medfusion_tpu_torch.models.unet_openai import EncoderUNetOpenAI, SDAttentionBlock

    gen = torch.Generator(device="cuda").manual_seed(193)
    with torch.device("cuda"):
        clf = EncoderUNetOpenAI(**CLF3D_KW)
    perturb_(clf, gen)
    perturb_gn_(clf, gen)
    blocks = [m for m in clf.modules() if isinstance(m, SDAttentionBlock)]
    tokens = []
    handles = [b.register_forward_pre_hook(lambda m, a: tokens.append(a[0][0, 0].numel()))
               for b in blocks]
    x = torch.randn(CLF3D_INPUT, generator=gen, device="cuda").requires_grad_()
    t = torch.tensor([10, 500], device="cuda")
    label = torch.tensor([0, 1], device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = clf(x, t)
    F.cross_entropy(logits, label).backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    for h in handles:
        h.remove()
    n = len(blocks)
    check_counts(f"19c 3-D classifier forward + backward ({n} attention blocks)", launches,
                 {"flash_attention_tokens": n, "flash_attention_bwd_dq": n,
                  "flash_attention_bwd_dkv": n})
    if tokens != [CLF3D_TOKENS] * n:
        raise RuntimeError(f"19c attention token counts {tokens}")
    grads = [q.grad for q in clf.parameters()] + [x.grad]
    if (tuple(logits.shape) != (CLF3D_INPUT[0], 2) or not torch.isfinite(logits).all()
            or any(g is None or not torch.isfinite(g).all() for g in grads)
            or not x.grad.abs().max() > 0):
        raise RuntimeError("19c logits or gradients missing or non-finite")
    log(f"  19c 3-D classifier on {CLF3D_INPUT}: logits {tuple(logits.shape)}, forward + "
        f"backward {ms:.1f} ms (f32, the first call), max|dx| {x.grad.abs().max().item():.3e}")
    slice_attention_checks(FA, worst, "3-D classifier", CLF3D_TOKENS, CLF3D_WIDTH,
                           CLF3D_HEADS, new_order=False)
    return {"ms": ms}


def phase_surface_vs_cpu():
    """19d: small widths on the card against the CPU, f32, from the same
    perturbed weights and draws: the smoke preset's UNet and VAE without
    learnable interpolation (DDIM 10, CFG 3, decode; SMOKE_TOL), the smoke
    legacy UNet with concatenated skips (a train step's loss and gradients,
    CLF_GRAD_TOL x max|g|), and a narrow 3-D classifier (logits, and the
    input gradient within CLF_GRAD_TOL x its max)."""
    import torch
    import torch.nn.functional as F

    from medfusion_tpu_torch.cli.presets import PRESETS
    from medfusion_tpu_torch.models.unet_openai import EncoderUNetOpenAI

    p = PRESETS["smoke"]
    gen = torch.Generator().manual_seed(194)
    report = {}
    weights = None
    pipes = {}
    for dev in ("cpu", "cuda"):
        unet, vae = surface_models(p, dev)
        if weights is None:
            perturb_(unet, gen)
            perturb_(vae, gen)
            weights = (unet.state_dict(), vae.state_dict())
        else:
            unet.load_state_dict(weights[0])
            vae.load_state_dict(weights[1])
        pipes[dev] = surface_pipeline(p, unet, vae, dev)
    b, steps = 4, 10
    x_T = torch.randn((b, *p.latent_shape), generator=gen)
    noise = torch.randn((steps, 2, b, *p.latent_shape), generator=gen)
    cond = torch.tensor([0, 1, 0, 1])
    kw = dict(steps=steps, guidance_scale=3.0, eta=1.0)
    ref = pipes["cpu"].denoise(x_T, condition=cond, noise=noise, **kw)
    out = pipes["cuda"].denoise(x_T.cuda(), condition=cond.cuda(), noise=noise.cuda(), **kw)
    report["sampling"] = close_scaled("19d smoke UNet and VAE without learnable "
                                      "interpolation, card vs cpu, images", out, ref)

    batch = {"source": torch.rand((b, p.image_size, p.image_size, 3), generator=gen) * 2 - 1,
             "target": torch.arange(b) % 2}
    out, draws = {}, None
    for dev in ("cpu", "cuda"):
        unet, vae = surface_models(p, dev, SMOKE_CONCAT_ATTENTION)
        if draws is None:
            perturb_(unet, gen)
            perturb_(vae, gen)
            weights = (unet.state_dict(), vae.state_dict())
        else:
            unet.load_state_dict(weights[0])
            vae.load_state_dict(weights[1])
        pipe = surface_pipeline(p, unet, vae, dev, train=True)
        if draws is None:
            draws = dict(pipe.train_draws(b, p.latent_shape, generator=gen),
                         drop=torch.tensor(False))
        loss, _ = pipe.train_loss({k: v.to(dev) for k, v in batch.items()},
                                  {k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        out[dev] = (loss.detach().cpu(), {k: q.grad.detach().cpu()
                                          for k, q in unet.named_parameters()
                                          if q.grad is not None})
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    torch.testing.assert_close(l1, l0, rtol=SMOKE_TOL, atol=0)
    gap = grad_gap(g1, g0)
    log(f"  19d smoke legacy UNet with concatenated skips, train step card vs cpu: loss "
        f"{l1.item():.6f} vs {l0.item():.6f}; gradients ({len(g0)} tensors) max|d| "
        f"{gap:.3e} of max|g| (limit {CLF_GRAD_TOL})")
    if set(g1) != set(g0) or not gap <= CLF_GRAD_TOL:
        raise RuntimeError(f"19d legacy: card gradients depart by {gap}")
    report["legacy_grads"] = gap

    kw = dict(CLF3D_KW, image_size=8, in_channels=2, model_channels=16, num_head_channels=8,
              norm_groups=8)
    x = torch.randn((2, 2, 4, 8, 8), generator=gen)
    t, label = torch.tensor([10, 500]), torch.tensor([0, 1])
    out = {}
    for dev in ("cpu", "cuda"):
        with torch.device(dev):
            clf = EncoderUNetOpenAI(**kw)
        if dev == "cpu":
            perturb_(clf, gen)
            perturb_gn_(clf, gen)
            clf_weights = clf.state_dict()
        else:
            clf.load_state_dict(clf_weights)
        xd = x.detach().to(dev).requires_grad_()
        logits = clf(xd, t.to(dev))
        F.cross_entropy(logits, label.to(dev)).backward()
        out[dev] = (logits.detach(), xd.grad.detach())
    report["classifier_3d"] = close_scaled("19d narrow 3-D classifier, card vs cpu, logits",
                                           out["cuda"][0], out["cpu"][0])
    gap = grad_gap(out["cuda"][1], out["cpu"][1])
    log(f"  19d narrow 3-D classifier input gradient card vs cpu: max|d| {gap:.3e} of max|g| "
        f"(limit {CLF_GRAD_TOL})")
    if not gap <= CLF_GRAD_TOL:
        raise RuntimeError(f"19d 3-D classifier: card input gradient departs by {gap}")
    report["classifier_3d_grad"] = gap
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


PHASE_CLOCK = {"name": None, "t0": 0.0}
PHASE_SECONDS = {}


def end_phase():
    """Close the running phase: its seconds on a line of their own."""
    name = PHASE_CLOCK["name"]
    if name is not None:
        seconds = time.perf_counter() - PHASE_CLOCK["t0"]
        PHASE_SECONDS[name] = seconds
        log(f"  phase {name}: {seconds:.1f} s")
        PHASE_CLOCK["name"] = None


def begin_phase(name, msg=None):
    """Close the running phase and start ``name``, logging ``msg`` as its
    header."""
    end_phase()
    if msg is not None:
        log(f"[{name}] {msg}")
    PHASE_CLOCK.update(name=name, t0=time.perf_counter())


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
    # the CLIs' process groups (NCCL at world 1) on a machine with no network:
    # loopback only, for this process and the ones it starts
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    begin_phase("1", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                     f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    begin_phase("2")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s; each library "
        f"done after (s): " + ", ".join(f"{k} {v:.1f}" for k, v in build.BUILD_SECONDS.items()))
    for stem, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {stem}: {line.strip()}")

    begin_phase("3", "kernels against their plain versions (B=2)")
    worst = phase_kernel_checks(G, FA, GL)

    begin_phase("4", "kernel times (bf16; CUDA events around a replayed CUDA graph of the "
                     "launches, and around the same launches made eagerly)")
    rows = phase_kernel_times(G)
    attn_rows, geglu_rows, geglu_b8 = phase_attention_geglu_times(FA, GL, worst)
    bwd_rows = phase_attention_backward_times(FA, worst)
    wide_rows = phase_wide_attention_times(FA, worst)

    begin_phase("5", "smoke preset: card against CPU (float32)")
    for attention in ("none", "spatial"):
        phase_smoke_vs_cpu(attention)
    phase_smoke_train_vs_cpu()

    begin_phase("6", "sampling paths: chest, bf16")
    launches_none, _, pipe = phase_main_path(ops, "none")
    del pipe
    torch.cuda.empty_cache()
    launches, seconds, pipe = phase_main_path(ops, "spatial")

    begin_phase("7", "where a chest-spatial sampling step's device time goes")
    phase_breakdown(pipe)
    del pipe
    torch.cuda.empty_cache()
    begin_phase("6b", f"sampling path: chest-spatial at {WIDE_SAMPLE_HEADS} heads, bf16")
    launches_wide, _, pipe = phase_main_path(ops, "spatial", WIDE_SAMPLE_HEADS)
    del pipe
    torch.cuda.empty_cache()

    begin_phase("8", f"training path: chest-spatial, bf16 compute, f32 masters, B={TRAIN_BATCH}, "
                     "AdamW + EMA")
    train_launches, train_ms, train = phase_train_main_path(ops, FA)
    phase_train_breakdown(train, train_ms)
    del train
    torch.cuda.empty_cache()

    with contextlib.ExitStack() as stack:  # phase 9's tree and runs serve phase 13
        tmp = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="two_stage_")))
        root = tmp / "chexpert"
        begin_phase("9")
        t0 = time.perf_counter()
        write_chexpert_tree(root, TWO_STAGE_IMAGES, TWO_STAGE_SIDE, seed=0)
        log("[9] two-stage program: chest, PNG files, autoencoder -> diffusion -> samples; "
            f"wrote {TWO_STAGE_IMAGES} grey PNGs of {TWO_STAGE_SIDE[0]}x{TWO_STAGE_SIDE[1]} "
            f"(row filters 0-4) in {time.perf_counter() - t0:.1f} s")
        two_stage = phase_two_stage(ops, G, worst, tmp, root)
        begin_phase("10", "adversarial autoencoder and the VQVAE family: chest, PNG files, B=8, "
                          "f32")
        adversarial = phase_adversarial(ops, G, worst, tmp, root)

        with tempfile.TemporaryDirectory(prefix="options_") as otmp:
            begin_phase("11", "the diffusion family's options: samplers, editing, "
                              "zero-terminal-SNR, self-conditioning, learned variance, deep "
                              "supervision, Min-SNR")
            phase_smoke_options_vs_cpu()
            option_report = phase_option_samplers(ops, Path(otmp))
            option_train_ms = phase_option_training(ops)

        with tempfile.TemporaryDirectory(prefix="evaluation_") as etmp:
            etmp = Path(etmp)
            begin_phase("12", "evaluation: InceptionV3 FID and precision/recall, LPIPS and "
                              "MS-SSIM, the weight ingest and --lpips training, the helper CLIs "
                              "(f32)")
            phase_eval_vs_cpu()
            real, eval_report = phase_evaluate_images(ops, etmp)
            pr_report = phase_pr_scale()
            lpips_report = phase_ingest_and_lpips(ops, etmp, real)

        begin_phase("13", "the flow family and classifier guidance: card against CPU (f32), the "
                          "classifier gradient's planted fault, the flow and classifier programs "
                          "on phase 9's tree")
        phase_smoke_flow_vs_cpu()
        clf_report = phase_classifier_vs_cpu(FA, worst)
        clf_attn_rows = clf_attention_times(FA, worst)
        flow_report = phase_flow_program(ops, tmp, root)
        guided_report = phase_classifier_program(ops, tmp, root)

        begin_phase("14", "the DiT estimator, its mixture-of-experts blocks and distillation: "
                          "card against CPU (f32), the kernels at the DiT's shape, the DiT "
                          "programs and cli.distill on phase 9's tree")
        phase_dit_vs_cpu()
        dit_attention_checks(FA, worst)
        dit_rows = dit_attention_times(FA, worst)
        dit_train = phase_dit_train(ops, FA, tmp, root)
        dit_sample = phase_dit_sample_and_flow(ops, tmp, root)
        moe_report = phase_dit_moe(ops)
        distill_report = phase_distill(ops, tmp, root)

        begin_phase("15", "the other estimator families (legacy, OpenAI, lucidrains UNets), "
                          "--remat, and the diffusers autoencoders: card against CPU (f32), the "
                          "kernels at the OpenAI middle block's shape, the programs on phase 9's "
                          "tree")
        family_smoke = phase_families_vs_cpu()
        openai_rows = openai_attention_checks_and_times(FA, worst)
        ftmp = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="families_",
                                                                    dir=ram_dir())))
        (ftmp / "ae").symlink_to(tmp / "ae")  # phase 9's autoencoder
        log(f"  phase 15's runs write under {ftmp}")
        family_train = phase_family_train(ops, FA, ftmp, root)
        family_sample = phase_family_sample(ops, ftmp)
        diffusers_report = phase_diffusers_autoencoders(ops, ftmp, root)

        begin_phase("16", "serving (a reference Lightning checkpoint, demo.server's pages and "
                          "micro-batched /one) and the 3-D models and data")
        stmp = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="serving_",
                                                                    dir=ram_dir(8))))
        serve_report = phase_serving(ops, stmp)
        gn3d = phase_3d_group_norm(G, worst)
        train3d = phase_3d_training(ops)
        sample3d_s = phase_3d_sampling(ops)
        smoke3d = phase_3d_vs_cpu(stmp)

        begin_phase("17", "the grain order (cli.train_diffusion --grain --no-donate), the "
                          "prefetch to the card and the profiling layer on phase 9's tree; the "
                          "diffusers blocks with FIR resampling and the conditional diffusers "
                          "UNet: card against CPU (f32), bf16 against f32, and at full width")
        gtmp = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="grain_",
                                                                    dir=ram_dir(32))))
        gstate, gpipe, grain_report = phase_grain_training(ops, gtmp, root)
        prefetch_report = phase_prefetch_and_trace(ops, gtmp, root, gstate, gpipe)
        del gstate, gpipe
        torch.cuda.empty_cache()
        diffusers_small = phase_diffusers_vs_cpu()
        diffusers_full = phase_diffusers_full_width(ops, root)
        torch.cuda.empty_cache()

        begin_phase("18", "parallelism at world 1 over NCCL: the sharded sampler, "
                          "cli.sample_dataset under torchrun, dp / FSDP / TP train steps, ring "
                          "attention, expert-parallel DiT-MoE and the pipeline, each bit-equal "
                          "to its unsharded path")
        t18 = time.perf_counter()
        mesh = phase_parallel_init()
        par_sampler = phase_sharded_sampler(ops, mesh)
        torch.cuda.empty_cache()
        ptmp = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="parallel_",
                                                                    dir=ram_dir(4))))
        par_cli = phase_sample_dataset_torchrun(ptmp)
        par_train = phase_parallel_train(ops, mesh)
        torch.cuda.empty_cache()
        par_ring = phase_ring_attention(ops, FA, mesh)
        par_moe = phase_expert_parallel(ops, mesh)
        torch.cuda.empty_cache()
        par_pipe = phase_pipeline_world1(mesh)
        par_seconds = time.perf_counter() - t18
        torch.distributed.destroy_process_group()

    begin_phase("19", "the constructor options no CLI reaches: the chest UNet and VAE "
                      "without learnable interpolation (sampling, training), the legacy "
                      "UNet with concatenated skips, the 3-D classifier; small widths card "
                      "against CPU")
    w19 = {}
    surface_sample = phase_surface_sampling(ops, G, w19)
    surface_steps = phase_surface_training(ops, FA, G, GL, w19)
    clf3d = phase_surface_classifier_3d(ops, FA, w19)
    surface_smoke = phase_surface_vs_cpu()
    log(f"  phase 19 worst errors by kernel and dtype: {w19}")
    for kernel, by_dtype in w19.items():
        for name, err in by_dtype.items():
            keep(worst, kernel, name, err)
    end_phase()

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
    log(f"  slice 12 on the card: flow train step {flow_report['train_ms']:.1f} ms (B="
        f"{TRAIN_BATCH}, bf16, {flow_report['train_peak']:.2f} GiB), flow sample Heun "
        f"{FLOW_STEPS} {flow_report['sample_s']:.3f} s; classifier gradient card vs cpu "
        f"{clf_report['adaptive']:.3e} / {clf_report['attention']:.3e} (adaptive / attention "
        f"pool), planted dq fault {clf_report['fault']:.3e}, planted lse fault "
        f"{clf_report['lse_fault']:.3e}; guided sampling " + "; ".join(
            f"{k} {s:.3f} s {peak:.3f} GiB" for k, (s, peak) in guided_report.items())
        + "; f32 attention at the classifier's shapes (B=8, ms kernel / plain / sdpa): "
        + "; ".join(f"N={r['N']} H={r['H']} " + ", ".join(
            f"{w} {r[w]['ms']:.4f}/{r[w]['plain_ms']:.4f}/{r[w]['library_ms']:.4f}"
            for w in ("forward", "dQ", "dK/dV")) for r in clf_attn_rows))
    log(f"  slice 13 on the card: DiT train step {dit_train['train_ms']:.1f} ms (B="
        f"{TRAIN_BATCH}, bf16, {dit_train['train_peak']:.2f} GiB); DiT sample DDIM "
        f"{DIT_SAMPLE_STEPS} "
        f"{dit_sample['sample_s']:.3f} s ({dit_sample['sample_peak']:.3f} GiB), flow Heun "
        f"{FLOW_STEPS} {dit_sample['flow_sample_s']:.3f} s; DiT-MoE step {moe_report['ms']:.1f} "
        f"ms ({moe_report['peak']:.2f} GiB), moe_aux {moe_report['aux']:.6f}, dropped "
        f"{moe_report['dropped']}; distill ms an iteration: " + ", ".join(
            f"{k} {v[0]:.1f}" for k, v in distill_report.items() if v[0] is not None)
        + "; kernels at the DiT's shape (ms kernel / plain / sdpa / bound): " + "; ".join(
            f"{k} B={r['B']} {r['ms']:.4f}/{r['plain_ms']:.4f}/{r['library_ms']:.4f}/"
            f"{r['bound_ms']:.4f}" for k, r in dit_rows.items() if isinstance(r, dict)))
    log("  slice 14 on the card: train steps (B=32, bf16) " + ", ".join(
        f"{k} {v['ms']:.1f} ms ({v['peak']:.2f} GiB)" for k, v in family_train.items()
        if "ms" in v) + "; remat forward + backward " + ", ".join(
        f"{k} {v['remat_ms']:.1f} ms, {v['peak']:.2f} GiB above the weights (plain "
        f"{v['plain_ms']:.1f} ms, {v['plain_peak']:.2f} GiB)"
        for k, v in family_train.items() if "plain_peak" in v)
        + f"; sample DDIM {FAMILY_SAMPLE_STEPS} " + ", ".join(
            f"{k} {s:.3f} s ({peak:.3f} GiB)" for k, (s, peak) in family_sample.items())
        + "; diffusers steps (B=8, f32) " + ", ".join(
            f"{k} {v['ms']:.1f} ms ({v['peak']:.2f} GiB)" for k, v in diffusers_report.items())
        + "; smoke gradients card vs cpu (of max|g|) " + ", ".join(
            f"{k.split(' ')[0]} {v:.2e}" for k, v in family_smoke.items())
        + "; kernels at the OpenAI middle block (ms kernel / plain / sdpa / bound): " + "; ".join(
            f"{label} {k} B={r['B']} {r['ms']:.4f}/{r['plain_ms']:.4f}/{r['library_ms']:.4f}/"
            f"{r['bound_ms']:.4f}" for label, rows in openai_rows.items()
            for k, r in rows.items() if isinstance(r, dict)))
    log(f"  slice 15 on the card: /one burst of {SERVE_BURST} at --serve-batch {SERVE_BATCH}: "
        f"{serve_report['images_per_s']:.3f} images/s, latency p50 {serve_report['p50_s']:.3f} "
        f"s, p95 {serve_report['p95_s']:.3f} s, {serve_report['batches']} batches, one batch "
        f"{serve_report['batch_s']:.3f} s; server start {serve_report['start_s']:.2f} s; seeds "
        f"served alone against their burst rows, max|d| {serve_report['alone_max_d']}; 3-D "
        f"GroupNorm at B={VOL3D_BATCH} C=64 {VOL3D} f32 {gn3d['ms']:.4f} ms (F.group_norm+F.silu "
        f"{gn3d['library_ms']:.4f}, bound {gn3d['bound_ms']:.4f}); 3-D train steps (f32) "
        + ", ".join(f"{k} {v['ms']:.1f} ms ({v['peak']:.2f} GiB)" for k, v in train3d.items())
        + f"; 3-D sampling DDIM {VOL3D_STEPS} + decode {sample3d_s:.3f} s; small 3-D "
        f"gradients card vs cpu " + ", ".join(f"{k} {v:.2e}" for k, v in smoke3d.items()))
    log(f"  slice 16 on the card: --grain train CLI {GRAIN_STEPS} steps "
        f"{grain_report['seconds']:.1f} s, group_norm_silu {grain_report['launches']}; "
        f"prefetch loop {prefetch_report['ms_prefetch']:.1f} ms a step (without "
        f"{prefetch_report['ms_plain']:.1f}), waiting {prefetch_report['wait_prefetch']:.1f} "
        f"ms a batch (without {prefetch_report['wait_plain']:.1f}), {prefetch_report['trace_kernels']} "
        f"kernels in the traced region; small diffusers UNet gradients card vs cpu "
        f"{diffusers_small['grad_gap']:.2e}, bf16 vs f32 worst {diffusers_small['bf16_worst']:.3e}; "
        f"UNet2DConditionDiffusers ({diffusers_full['params']:,}) step B={TRAIN_BATCH} "
        f"{diffusers_full['ms']:.1f} ms, peak {diffusers_full['peak']:.2f} GiB; DDIM "
        f"{DIFFUSERS_DDIM} CFG {DIFFUSERS_CFG} B={DIFFUSERS_SAMPLE_N} "
        f"{diffusers_full['sample_s']:.3f} s")
    log(f"  slice 17 on the card (world 1, NCCL): sharded sampler {par_sampler['sharded_s']:.3f} "
        f"s (pipe.denoise {par_sampler['unsharded_s']:.3f} s), group_norm_silu "
        f"{par_sampler['launches']}; cli.sample_dataset torchrun {par_cli['torchrun']:.1f} s "
        f"(alone {par_cli['alone']:.1f} s); train ms a step " + ", ".join(
            f"{k} {v:.1f}" for k, v in par_train.items())
        + f"; ring attention {par_ring['ring_ms']:.4f} ms (kernel {par_ring['kernel_ms']:.4f}); "
        f"DiT-MoE step expert-parallel {par_moe['ep_ms']:.1f} ms (dense "
        f"{par_moe['dense_ms']:.1f}); "
        f"pipeline {par_pipe['pipe_ms']:.4f} ms (stage {par_pipe['plain_ms']:.4f}); phase 18 "
        f"{par_seconds:.1f} s")
    ring_bwd = par_ring["backward"]
    log(f"  ring attention's gradient on the card (world 1): backward "
        f"{ring_bwd['ring_ms']:.4f} ms (kernels 3 + 4 on the whole {ring_bwd['pair_ms']:.4f}, "
        f"graph-replayed {ring_bwd['pair_graph_ms']:.4f}); block-pair backward " + ", ".join(
            f"over {p} blocks {ring_bwd[p]['ms']:.4f} ms (graph-replayed "
            f"{ring_bwd[p]['graph_ms']:.4f})" for p in RING_SPLITS))
    log(f"  slice 21 on the card: sampling without learnable interpolation (DDIM "
        f"{SURFACE_STEPS}, CFG, B={N_SAMPLES}, decode) {surface_sample['seconds']:.3f} s, "
        f"group_norm_silu {surface_sample['launches']}; bf16 steps (B={TRAIN_BATCH}) "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in surface_steps.items())
        + f"; 3-D classifier forward + backward {clf3d['ms']:.1f} ms; small widths card vs "
        f"cpu " + ", ".join(f"{k} {v:.2e}" for k, v in surface_smoke.items()))
    log("  seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
