#!/usr/bin/env python3
"""Drive the port's parallel layer on the four cards of one host, over NCCL.

Run from the root of a checkout on a host with four CUDA cards:

    python3 multicard_smoke.py                      # every check
    python3 multicard_smoke.py train ring           # the named checks alone
    python3 multicard_smoke.py --device cpu --world 2   # gloo, CPU, the smoke preset

First the kernels are built once, in this process (the ranks then find the
libraries under the build directory's lock), and ``kernels`` runs
``tests/test_torch_kernels_cuda.py -k two_cards``: one process launches
each kernel route on card 0 and then on card 1. Then this script starts
itself as four ranks (``python -m torch.distributed.run --standalone
--nproc_per_node 4``), one card a rank (``LOCAL_RANK``), each calling
``initialize_multihost(device="cuda")``, and runs the rank checks in order:

* ``init``: the world, the backend (NCCL on the cards, gloo on the CPU),
  each rank's card, and the ('data', 'model') meshes (4, 1), (2, 2) and
  (1, 4) built, used and destroyed in turn (the cards' interconnect, from
  ``nvidia-smi``, is printed once before the ranks start);
* ``sampler``: ``make_sharded_sampler`` on (4, 1) at the preset's width
  (chest: B=32, bf16, DDIM 50, eta 1, CFG 8, decode; the VAE perturbed,
  since a seeded one decodes every latent to 0) against a control on one
  card: the same rows in blocks of B/4, as each rank takes them; and its
  difference from the same sampler on one card at B=32;
* ``train``: two AdamW + EMA steps of the preset's UNet (chest: B=32 in
  all, bf16 on f32 masters) placed by ``shard_params`` as dp on (4, 1),
  FSDP on (4, 1), TP (``min_shard_dim`` 256) on (1, 4) and dp x TP with
  FSDP over 'data' on (2, 2), against two plain steps on one card at B=32,
  and a control on one card: four B/4 microbatches accumulated;
* ``checkpoint``: ``save_checkpoint`` of the (2, 2) state, the file read in
  one process against the gathered parameters, ``restore_checkpoint`` on
  every rank;
* ``ring``: ``ring_attention`` over 'data' of (4, 1), forward and gradient,
  bf16 (8 heads of 32, 1,024 tokens: 256 a rank) and f32 (d 64), against
  kernels 2, 3 and 4 on the whole sequence on one card;
* ``moe``: the preset's DiT with 8 experts (2 a rank) expert-parallel over
  the four ranks, a bf16 forward and two train steps, against the dense DiT
  on one card at B=32, with the control of ``train``;
* ``pipeline``: ``pipeline_apply`` of residual MLP stages ([B, 256, 384]
  tokens, f32) at 4 stages on (1, 4), and at 2 stages x dp 2 with the stage
  parameters sliced over 'data' on (2, 2), against the stages applied in
  sequence on the same shapes.

``cli`` then runs ``cli.sample_dataset`` (chest, 32 samples a label in one
chunk, DDIM 50, perturbed weights from a reference ``--ckpt``) under
``torch.distributed.run`` at four processes, and compares its PNGs with the
CLI's own code run as each rank in turn on one card (the control) and with
the command run alone.

What each check holds:

* bit for bit: the sampler's images and the CLI's PNGs against their
  controls on one card (the cards compute the same bits for the same rows
  at the same batch); the replicas of every parameter (and of the EMA)
  across the ranks that hold the same piece, after every step; the model
  ranks of a data rank on a tensor-parallel output; the pipeline's output
  and each stage's gradient against the stages in sequence (f32, the same
  shapes a stage, the gradients summed in the pipeline's order); the
  restored checkpoint's pieces;
* against a control, where four ranks change the batching (cuDNN and
  cuBLAS at B/4 rows, NCCL's order of a sum): the same rows at B/4 on one
  card, the gradients summed in f32. dp and FSDP compute what it computes,
  so their losses and parameter updates are held to it, within twice its
  own spread over the orders in which a ring sums the gradients
  (``CONTROL_TIGHT``); tensor parallelism, (2, 2) and the MoE slice their
  products, so their max |d| from the one card's B=32 losses, updates and
  MoE outputs is held to twice the control's (``CONTROL_FACTOR``); each
  bound is printed beside its number;
* ring attention: o within two bf16 ulps of the K/V blocks' largest |o|
  (f32: 2e-5) of kernel 2 on the whole sequence, the gradients within the
  plain backward's bound of kernels 3 and 4 on the whole sequence
  (``chip_smoke.attn_bwd_tol``);
* launches: each rank counts its kernel launches on each path against the
  counts derived from the architecture; the ``kernels`` line sums them.

A failed check fails the run: the ranks stop, the checks after it run in a
new set of ranks, and the script exits 1 with no result line. The last
lines are the kernels' JSON, each card's name and power limit as
``nvidia-smi`` gives them, and ``{"ok": true, "device": {...}}``. Every
number is printed beside the card line. ``--device cpu`` runs the same rank
checks as gloo processes (the kernels' plain versions; ``kernels`` is
skipped), as ``tests/test_torch_multicard.py`` does at worlds 2 and 4.
``--world 1`` on one card runs every path at world 1 with the chest widths
(a rehearsal before four cards are spent; it exits 3 with no result line).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
RANK_CHECKS = ("init", "sampler", "train", "checkpoint", "ring", "moe", "pipeline")
CHECKS = ("kernels",) + RANK_CHECKS[:2] + ("cli",) + RANK_CHECKS[2:]
GUIDANCE = 8.0


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A run's widths by device: the chest preset at full width on the
    cards, the smoke preset at tiny widths on the CPU."""

    preset: str
    dtype: str  # the sampler's and the train step's compute dtype
    batch: int  # the global batch of the sampler, the train steps and the DiT
    steps: int  # DDIM steps of the sampler and the CLI
    ring: tuple  # (B, heads, tokens, head width), bf16
    ring_f32: tuple
    pipe: tuple  # (B, tokens, width) of the pipeline's stages
    min_shard_dim: int  # tensor parallelism's smallest sharded width
    fsdp_min_size: int


SIZES = {"cuda": Sizes("chest", "bfloat16", 32, 50, (16, 8, 1024, 32), (8, 4, 1024, 64),
                        (32, 256, 384), 256, 2 ** 14),
         "cpu": Sizes("smoke", "float32", 8, 4, (2, 2, 64, 16), (2, 2, 64, 16),
                        (8, 16, 32), 16, 256)}
# (name, csrc file, TPU kernel) of each kernel, for the kernels line
KERNELS = (
    ("group_norm_silu", "group_norm_silu.cu", "medfusion_tpu/ops/group_norm.py:25"),
    ("flash_attention", "flash_attention.cu", "medfusion_tpu/ops/flash_attention.py:73"),
    ("flash_attention_tokens", "flash_attention.cu",
     "medfusion_tpu/ops/flash_attention.py:327"),
    ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
     "medfusion_tpu/ops/flash_attention.py:113"),
    ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
     "medfusion_tpu/ops/flash_attention.py:141"),
    ("geglu_mlp", "geglu_mlp.cu", "medfusion_tpu/ops/geglu.py:96"),
)
# kernels 1-5 run on every rank; kernel 6 (GEGLU) is on none of these paths
PATH_KERNELS = tuple(k[0] for k in KERNELS[:5])
# The bound of a trained path against its control: twice the control's
# departure from the one-card run (the control measures one draw of the
# batching's rounding; world 4 adds the order of NCCL's sums, tensor
# parallelism's sliced products and the expert layout's), plus, for the
# losses, W roundings of the loss in the compute dtype (a mean over W ranks
# of means of outputs rounded to it), and for the updates 1e-4: f32 sums in another
# order move an update by up to a few 1e-5 (rel L2) where Adam normalises a
# near-zero gradient (a gloo rehearsal at the smoke preset read 3.1e-5 for
# tensor parallelism against its control). A fault (a gradient not summed, a
# wrong exchange) moves them by orders of magnitude more.
CONTROL_FACTOR, UPDATE_FLOOR = 2.0, 1e-4
# dp and FSDP compute what the control computes (each rank's rows from its
# own cast of the parameters, the gradients summed in f32 and divided by W),
# the order of the sum aside, so they are held to the control itself: to
# CONTROL_FACTOR x the control's own spread over the other orders in which a
# ring sums the W gradients (0 at W=2, where f32 addition commutes), plus
# this share of the losses' size and this rel L2 of an update (four H100s
# read 1.1e-9 for dp and 2.9e-9 for FSDP against the control). Adam's
# normalisation nearly cancels a gradient scaled by a wrong factor, which
# the bound against one card lets through; this one does not
# (``--fault fsdp-scale``).
CONTROL_TIGHT = 1e-6


def log(msg):
    print(msg, flush=True)


def ulp(x, dtype) -> float:
    """One ulp of max|x| in ``dtype`` (bf16 or f32)."""
    import torch

    top = x.float().abs().max().item()
    bits = 7 if dtype == torch.bfloat16 else 23
    return 2.0 ** (math.floor(math.log2(top)) - bits) if top > 0 else 0.0


def max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---- one rank ---------------------------------------------------------------------------


class RowBlock:
    """A mesh stand-in for one process: rank ``index`` of ``parts`` over
    'data', so that one card computes the rows a rank of a ``parts``-rank
    mesh computes, with no collective."""

    mesh_dim_names = ("data", "model")

    def __init__(self, parts: int, index: int):
        self.parts, self.index = parts, index

    def size(self, dim: int) -> int:
        return (self.parts, 1)[dim]

    def get_local_rank(self, axis: str) -> int:
        return self.index if axis == "data" else 0


class Rank:
    """This rank's device, sizes and meshes."""

    def __init__(self, args):
        import torch
        import torch.distributed as dist

        from medfusion_tpu_torch.cli.presets import PRESETS

        self.device = args.device
        self.dev = (torch.device("cuda", torch.cuda.current_device())
                    if args.device == "cuda" else torch.device("cpu"))
        self.cuda = args.device == "cuda"
        self.sizes = SIZES[args.device]
        self.p = PRESETS[self.sizes.preset]
        self.dtype = getattr(torch, self.sizes.dtype)
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.fault = args.fault
        self.tmp = Path(args.tmp)
        self.meshes, self.cache = {}, {}
        import chip_smoke as cs

        # a UNet train step: its forward and the frozen VAE's encode
        self.per_step = cs.unet_launches(forwards=1, encodes=1)

    def mesh(self, n_data: int, n_model: int):
        from medfusion_tpu_torch.parallel import make_mesh

        key = (n_data, n_model)
        if key not in self.meshes:
            self.meshes[key] = make_mesh(n_data, n_model, device=self.device)
        return self.meshes[key]

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def timed(self, fn):
        """(fn(), seconds) between two barriers, the device drained."""
        import torch.distributed as dist

        self.sync()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        dist.barrier()
        return out, time.perf_counter() - t0

    def gen(self, seed: int):
        import torch

        return torch.Generator(device=self.dev).manual_seed(seed)

    def expect(self, what, launches, expected):
        """On the cards (the chest preset, whose counts ``chip_smoke``
        derives), raise unless ``launches`` are ``expected``."""
        if not self.cuda:
            return
        for kernel, n in launches.items():
            if n != expected.get(kernel, 0):
                raise RuntimeError(f"{what}: {kernel} launched {n} times on rank {self.rank}, "
                                   f"expected {expected.get(kernel, 0)}")


def broadcast_module(module):
    """Rank 0's parameters and buffers on every rank."""
    import torch
    import torch.distributed as dist

    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def gather(x, dim: int = 0):
    """Every rank's ``x`` joined along ``dim`` (the default group)."""
    import torch
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


def replica_mismatches(model, what: str):
    """[names] of the parameters of ``model`` whose copies differ between
    ranks that hold the same piece (bit for bit; a collective)."""
    import torch
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel.mesh import layout

    lay = layout(model)
    names = [n for n, _ in model.named_parameters()]
    keys = [tuple(dist.get_rank(g) for _, g in lay.get(n, [])) for n in names]
    flat = torch.cat([p.detach().reshape(-1).view(torch.uint8)
                      for p in model.parameters()])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    all_keys = [None] * dist.get_world_size()
    dist.all_gather_object(all_keys, keys)
    bad, offset = [], 0
    for i, p in enumerate(model.parameters()):
        n = p.numel() * p.element_size()
        first = {}
        for r, k in enumerate(all_keys):
            piece = every[r][offset:offset + n]
            if k[i] not in first:
                first[k[i]] = piece
            elif not torch.equal(piece, first[k[i]]):
                bad.append(f"{what} {names[i]} (rank {r})")
                break
        offset += n
    return bad


def whole_params(model):
    """name -> the whole parameter (a collective), detached."""
    from medfusion_tpu_torch.parallel.mesh import layout, whole

    lay = layout(model)
    return {k: (whole(lay[k], p.detach()) if k in lay else p.detach()).clone()
            for k, p in model.named_parameters()}


def update_errors(theta0, got, ref):
    """name -> |got - ref|_2 / |ref - theta0|_2: each parameter's update
    after the steps against the reference update."""
    out = {}
    for k, t0 in theta0.items():
        den = (ref[k].float() - t0.float()).norm().item()
        num = (got[k].float() - ref[k].float()).norm().item()
        out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def add_counts(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}


def worst(errs):
    name = max(errs, key=errs.get)
    return name, errs[name]


def rows_of(tree, index: int, parts: int):
    """Block ``index`` of ``parts`` of the rows of every tensor of rank >= 1."""
    import torch

    from medfusion_tpu_torch.data.prefetch import _map
    from medfusion_tpu_torch.parallel.mesh import rows

    return _map(lambda x: rows(x, index, parts)
                if isinstance(x, torch.Tensor) and x.ndim >= 1 else x, tree)


def train_batches(ctx, n_batches: int, seed: int):
    """Synthetic batches of the preset, as the training CLI makes them."""
    import torch

    from medfusion_tpu_torch.data import SimpleDataModule, SyntheticDataset2D

    p, b = ctx.p, ctx.sizes.batch
    ds = SyntheticDataset2D(n=b * n_batches, image_size=p.image_size, channels=p.in_channels,
                            num_classes=p.num_classes, seed=seed)
    dm = SimpleDataModule(ds, batch_size=b, seed=seed)
    return [{"source": torch.from_numpy(x["source"]).to(ctx.dev),
             "target": torch.from_numpy(x["target"]).long().to(ctx.dev)}
            for x in dm.train_dataloader(0)]


def accumulated_step(pipe, state, batch, draws, parts: int, first: int = 0):
    """One step of ``state`` on ``parts`` microbatches of the batch in one
    process (the control of a data-parallel step): each microbatch's
    gradient from its own cast of the parameters, as a rank computes it,
    the gradients summed in f32 from microbatch ``first`` on, cyclically
    (the order in which a ring all-reduce sums one chunk), and divided by
    ``parts``, as the ranks' all-reduce does; then :func:`train_on`'s
    update."""
    import torch

    from medfusion_tpu_torch.train.diffusion import estimator_params

    state.optimizer.zero_grad(set_to_none=True)
    metrics = {}
    for i in ((first + j) % parts for j in range(parts)):
        loss, m = pipe.train_loss(rows_of(batch, i, parts), rows_of(draws, i, parts),
                                  estimator_params=estimator_params(state.model,
                                                                    pipe.compute_dtype))
        loss.backward()
        for k, v in m.items():
            metrics[k] = metrics.get(k, 0.0) + v.detach() / parts
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        p.grad.div_(parts)
    state.apply_gradients()
    return metrics


def one_card_runs(ctx, pipe, base, batches, draws, orders: bool = False):
    """On this rank alone: two plain steps at the whole batch and the
    control (``accumulated_step`` at ``ctx.world`` microbatches), and with
    ``orders`` the control summed from each other microbatch on ("control
    from r"). Returns {name: (whole params after, losses, aux, ms of the
    last step)}."""
    import torch

    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step
    from medfusion_tpu_torch.train.diffusion import with_compute_dtype

    out = {}
    names = ["one card", "control"]
    names += [f"control from {r}" for r in range(1, ctx.world)] if orders else []
    for name in names:
        model = copy.deepcopy(base)
        state = TrainState(model, lr=ctx.p.diffusion_lr, weight_decay=1e-2, use_ema=True)
        placed = dataclasses.replace(pipe, noise_estimator=model)
        step = make_diffusion_train_step(placed, compute_dtype=ctx.dtype)
        mine = with_compute_dtype(placed, ctx.dtype)
        losses, aux = [], []
        for b, d in zip(batches, draws):
            t0 = time.perf_counter()
            m = (step(state, b, d) if name == "one card"
                 else accumulated_step(mine, state, b, d, ctx.world,
                                       int(name.split()[-1]) if " from " in name else 0))
            ctx.sync()
            losses.append(m["loss"].item())
            aux.append(m["moe_aux"].item() if "moe_aux" in m else 0.0)
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = ({k: p.detach().clone() for k, p in model.named_parameters()},
                     losses, aux, ms)
        del state, model
        if ctx.cuda:
            torch.cuda.empty_cache()
    return out


def hold_to_control(ctx, label, theta0, runs, got, losses, aux=None, tight=False):
    """world's losses and parameter updates held to the control: with
    ``tight`` (dp, FSDP, which compute what the control computes) to the
    control itself within ``CONTROL_TIGHT``, else to ``CONTROL_FACTOR`` x
    the control's departure from the one-card run. Returns the report's
    numbers, and its words under "text"."""
    import torch

    ref, ref_losses, ref_aux, _ = runs["one card"]
    ctl, ctl_losses, ctl_aux, _ = runs["control"]
    d_loss = max(abs(a - b) for a, b in zip(losses, ref_losses))
    c_loss = max(abs(a - b) for a, b in zip(ctl_losses, ref_losses))
    w_name, w_err = worst(update_errors(theta0, got, ref))
    c_name, c_err = worst(update_errors(theta0, ctl, ref))
    v_name, vs_ctl = worst(update_errors(theta0, got, ctl))
    l_ctl = max(abs(a - b) for a, b in zip(losses, ctl_losses))
    out = {"max_loss_diff": d_loss, "control_loss_diff": c_loss,
           "worst_update_rel_l2": w_err, "worst_param": w_name,
           "control_update_rel_l2": c_err, "control_worst_param": c_name,
           "update_rel_l2_vs_control": vs_ctl, "worst_param_vs_control": v_name,
           "loss_diff_vs_control": l_ctl}
    if aux is not None:
        out["max_moe_aux_diff"] = max(abs(a - b) for a, b in zip(aux, ref_aux))
    one_card = (f"from one card: losses max|d| {d_loss:.4e}, worst update rel L2 {w_err:.4e} "
                f"({w_name}); the control's {c_loss:.4e} and {c_err:.4e} ({c_name})")
    if tight:
        others = [runs[k] for k in runs if k.startswith("control from")]
        o_loss = max([max(abs(a - b) for a, b in zip(o[1], ctl_losses)) for o in others],
                     default=0.0)
        o_upd = max([worst(update_errors(theta0, o[0], ctl))[1] for o in others], default=0.0)
        loss_bound = CONTROL_FACTOR * o_loss + CONTROL_TIGHT * max(map(abs, ctl_losses))
        upd_bound = CONTROL_FACTOR * o_upd + CONTROL_TIGHT
        out.update(loss_bound=loss_bound, update_bound=upd_bound, order_loss_diff=o_loss,
                   order_update_rel_l2=o_upd)
        out["text"] = (f"against the control: losses max|d| {l_ctl:.4e} (bound "
                       f"{loss_bound:.4e}), worst update rel L2 {vs_ctl:.4e} ({v_name}; bound "
                       f"{upd_bound:.4e}; the control summed in the other orders of a ring "
                       f"{o_loss:.4e} and {o_upd:.4e}); {one_card}")
        if not l_ctl <= loss_bound:
            raise RuntimeError(f"{label}: losses {losses} depart from the control's "
                               f"{ctl_losses} by {l_ctl:.3e} > {loss_bound:.3e}")
        if not vs_ctl <= upd_bound:
            raise RuntimeError(f"{label}: {v_name}'s update departs from the control's by "
                               f"{vs_ctl:.3e} (rel L2) > {upd_bound:.3e}")
        return out
    loss_bound = CONTROL_FACTOR * c_loss + ctx.world * ulp(torch.tensor(ref_losses), ctx.dtype)
    upd_bound = CONTROL_FACTOR * c_err + UPDATE_FLOOR
    out.update(loss_bound=loss_bound, update_bound=upd_bound)
    out["text"] = (f"{one_card}; bounds {loss_bound:.4e} and {upd_bound:.4e}; against the "
                   f"control: losses {l_ctl:.4e}, update {vs_ctl:.4e}")
    if not d_loss <= loss_bound:
        raise RuntimeError(f"{label}: losses {losses} depart from the one card's {ref_losses} "
                           f"by {d_loss:.3e} > {loss_bound:.3e} (control {c_loss:.3e})")
    if not w_err <= upd_bound:
        raise RuntimeError(f"{label}: {w_name}'s update departs from the one card's by "
                           f"{w_err:.3e} (rel L2) > {upd_bound:.3e} (control {c_err:.3e}, "
                           f"{c_name})")
    return out


def check_init(ctx):
    """The world, the backend, this rank's card, and each mesh built, used
    and destroyed in turn."""
    import torch
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel.mesh import MESH_DIMS, axis_group, axis_size
    from medfusion_tpu_torch.parallel.multihost import BACKENDS

    backend = dist.get_backend()
    out = {"world": ctx.world, "backend": backend, "rank": ctx.rank}
    if ctx.world != ctx.expected_world:
        raise RuntimeError(f"world {ctx.world}, expected {ctx.expected_world}")
    if backend != BACKENDS[ctx.device]:
        raise RuntimeError(f"backend {backend} on {ctx.device}, expected "
                           f"{BACKENDS[ctx.device]}")
    if ctx.cuda:
        local = int(os.environ["LOCAL_RANK"])
        out.update(local_rank=local, card=torch.cuda.current_device(),
                   name=torch.cuda.get_device_name())
        if torch.cuda.current_device() != local:
            raise RuntimeError(f"rank {ctx.rank} is on card {torch.cuda.current_device()}, "
                               f"LOCAL_RANK {local}")
    from medfusion_tpu_torch.parallel import make_mesh

    shapes = []
    for shape in ((ctx.world, 1), mixed(ctx.world), (1, ctx.world)):
        if shape is None or shape in shapes:
            continue
        mesh = make_mesh(*shape, device=ctx.device)
        for axis in MESH_DIMS:
            group = axis_group(mesh, axis)
            one = torch.ones((), device=ctx.dev)
            dist.all_reduce(one, group=group)
            if one.item() != axis_size(mesh, axis):
                raise RuntimeError(f"mesh {shape}: the {axis} group sums {one.item()}")
        for axis in MESH_DIMS:  # the default group, where a dim spans it, stays
            group = axis_group(mesh, axis)
            if group is not dist.group.WORLD:
                dist.destroy_process_group(group)
        shapes.append(shape)
    out["meshes"] = shapes
    lines = [f"init: world {ctx.world}, backend {backend}, meshes {shapes} built, summed over "
             f"and destroyed"]
    if ctx.cuda:
        cards = [None] * ctx.world
        dist.all_gather_object(cards, (ctx.rank, out["local_rank"], out["card"], out["name"]))
        lines.append("ranks (rank, LOCAL_RANK, card, name): " + "; ".join(map(str, cards)))
    out["lines"] = lines
    return out


def check_sampler(ctx):
    """``make_sharded_sampler`` on (W, 1) against one card at the whole
    batch, held to the control (the same rows in blocks of B/W, one card)."""
    import torch

    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.cli.presets import build_pipeline
    from medfusion_tpu_torch.cli.sample_dataset import to_uint8
    from medfusion_tpu_torch.parallel import make_sharded_sampler

    import chip_smoke as cs

    p, s = ctx.p, ctx.sizes
    pipe = build_pipeline(p, device=ctx.dev, compute_dtype=ctx.dtype, seed=0)
    gen = ctx.gen(18)
    for module in (pipe.noise_estimator, pipe.latent_embedder):  # seeded decoders give 0
        cs.perturb_(module, gen)
    broadcast_module(pipe.noise_estimator)
    broadcast_module(pipe.latent_embedder)
    cond = torch.arange(s.batch, device=ctx.dev) % 2
    kw = dict(steps=s.steps, guidance_scale=GUIDANCE, eta=1.0)

    def sample(mesh):
        sampler = make_sharded_sampler(pipe, mesh, p.latent_shape, **kw)
        return sampler(ctx.gen(7), s.batch, cond, 1 - cond)

    mesh = ctx.mesh(ctx.world, 1)
    sample(mesh)  # the first call's set-up stays out of the time
    ops.reset_launch_counts()
    mine, seconds = ctx.timed(lambda: sample(mesh))
    launches = ops.launch_counts()
    ctx.expect("sampler", launches, cs.unet_launches(forwards=s.steps, decodes=1))
    imgs = gather(mine)
    out = {"launches": launches, "world_s": seconds}
    if ctx.rank == 0:
        t0 = time.perf_counter()
        ref = sample(RowBlock(1, 0))
        ctx.sync()
        out["one_card_s"] = time.perf_counter() - t0
        control = torch.cat([sample(RowBlock(ctx.world, r)) for r in range(ctx.world)])
        if imgs.shape != ref.shape or not torch.isfinite(imgs).all():
            raise RuntimeError(f"sampler: {tuple(imgs.shape)} images, finite "
                               f"{bool(torch.isfinite(imgs).all())}; expected {tuple(ref.shape)}")
        if ref.float().std().item() == 0:
            raise RuntimeError("sampler: the one-card images are constant")
        d, c = max_diff(imgs, ref), max_diff(control, ref)
        levels = int(abs(to_uint8(imgs.float().cpu().numpy()).astype(int)
                         - to_uint8(ref.float().cpu().numpy()).astype(int)).max())
        out.update(max_diff=d, control_diff=c, levels=levels, max_abs=ref.abs().max().item())
        if not torch.equal(imgs, control):
            raise RuntimeError(f"sampler: world {ctx.world}'s images are not bit-equal to the "
                               f"same rows at B={s.batch // ctx.world} on one card (max|d| "
                               f"{max_diff(imgs, control):.3e})")
        out["lines"] = [
            f"sampler ({s.preset}, B={s.batch}, {s.dtype}, DDIM {s.steps}, eta 1, CFG "
            f"{GUIDANCE}, decode) on ({ctx.world}, 1): bit-equal to the control (the same rows "
            f"at B={s.batch // ctx.world} on one card); max|d| from one card's B={s.batch} "
            f"{d:.4e} ({levels} levels; the control's {c:.4e}; max|img| "
            f"{out['max_abs']:.3f}); world {seconds:.3f} s, one card B={s.batch} "
            f"{out['one_card_s']:.3f} s"]
    return out


FAULTS = {"skip-sync": "dp", "fsdp-scale": "fsdp"}  # planted fault -> its placement


def _plant_fault(ctx, label):
    """The planted fault of ``label``'s placement, on rank 1: ``skip-sync``
    takes part in ``sync_gradients``' collectives on copies and keeps its
    own gradients; ``fsdp-scale`` leaves its FSDP slices' gradients summed,
    not divided by W. Returns the real ``sync_gradients``."""
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel import mesh as parallel_mesh

    real = parallel_mesh.sync_gradients

    def skipped(model, group):
        own = [(p, p.grad.clone()) for p in model.parameters() if p.grad is not None]
        real(model, group)
        for p, g in own:
            p.grad.copy_(g)

    def scaled(model, group):
        real(model, group)
        plan = model.parallel_plan
        for name, p in model.named_parameters():
            if p.grad is not None and plan.fsdp_dim(name) is not None:
                p.grad.mul_(dist.get_world_size(group))

    if ctx.fault and FAULTS[ctx.fault] == label and ctx.rank == 1:
        parallel_mesh.sync_gradients = {"skip-sync": skipped, "fsdp-scale": scaled}[ctx.fault]
    return real


def mixed(world: int):
    """The (2, W/2) mesh of the JAX dryrun's compositions; None at world 1."""
    return (2, world // 2) if world % 2 == 0 else None


def placements(ctx):
    w, s = ctx.world, ctx.sizes
    tp = {"tensor_parallel": True, "min_shard_dim": s.min_shard_dim}
    fsdp = {"fsdp": True, "fsdp_min_size": s.fsdp_min_size}
    out = (("dp", (w, 1), {}), ("fsdp", (w, 1), fsdp), ("tp", (1, w), tp))
    if mixed(w):
        out += (("dp x tp + fsdp", mixed(w), {**tp, **fsdp}),)
    return out


def train_setup(ctx):
    """The preset's train pipeline, its perturbed UNet (rank 0's on every
    rank), two batches and their draws."""
    import chip_smoke as cs
    from medfusion_tpu_torch.cli.presets import build_train_pipeline

    pipe = build_train_pipeline(ctx.p, device=ctx.dev, seed=0)
    gen = ctx.gen(18)
    for module in (pipe.noise_estimator, pipe.latent_embedder):
        cs.perturb_(module, gen)
    broadcast_module(pipe.noise_estimator)
    broadcast_module(pipe.latent_embedder)
    batches = train_batches(ctx, 2, seed=18)
    draws = [pipe.train_draws(ctx.sizes.batch, ctx.p.latent_shape, generator=gen)
             for _ in batches]
    return pipe, copy.deepcopy(pipe.noise_estimator), batches, draws


def tp_mismatch(ctx, model, mesh):
    """Whether the model ranks of a data rank disagree on the model's output
    for that data rank's rows (a collective; FSDP pieces gathered as the
    train step gathers them)."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    from medfusion_tpu_torch.parallel.mesh import axis_rank
    from medfusion_tpu_torch.train.diffusion import estimator_params

    h, w, c = ctx.p.latent_shape
    d = axis_rank(mesh, "data")
    g = torch.Generator().manual_seed(100 + d)
    b = ctx.sizes.batch // ctx.world
    x = torch.randn((b, c, h, w), generator=g).to(ctx.dev)
    t = torch.randint(0, 1000, (b,), generator=g).to(ctx.dev)
    y = torch.arange(b, device=ctx.dev) % 2
    with torch.no_grad():
        out = functional_call(model, estimator_params(model), (x, t, y))[0]
    every = [torch.empty_like(out) for _ in range(ctx.world)]
    dist.all_gather(every, out)
    coords = [None] * ctx.world
    dist.all_gather_object(coords, d)
    first = {}
    for r, k in enumerate(coords):
        if k not in first:
            first[k] = every[r]
        elif not torch.equal(every[r], first[k]):
            return True
    return False


def train_placed(ctx, pipe, base, batches, draws, shape, placement, label):
    """Two steps of ``base`` placed on a mesh of ``shape``; the replicas
    checked after every step. Returns (state, losses, ms of the last step,
    the steps' launches, replica mismatches, tensor-parallel mismatch)."""
    import torch

    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.parallel import mesh as parallel_mesh
    from medfusion_tpu_torch.parallel import shard_batch, shard_params
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    mesh = ctx.mesh(*shape)
    unet = copy.deepcopy(base)
    shard_params(unet, mesh, **placement)
    state = TrainState(unet, lr=ctx.p.diffusion_lr, weight_decay=1e-2, use_ema=True)
    step = make_diffusion_train_step(dataclasses.replace(pipe, noise_estimator=unet),
                                     compute_dtype=ctx.dtype)
    real = _plant_fault(ctx, label)
    losses, bad, launches = [], [], {}
    try:
        for i, (b, d) in enumerate(zip(batches, draws)):
            ctx.sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            m = step(state, shard_batch(b, mesh), shard_batch(d, mesh))
            ctx.sync()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            ctx.expect(f"train {label} step {i + 1}", counts, ctx.per_step)
            launches = add_counts(launches, counts)
            losses.append(m["loss"].item())
            bad += replica_mismatches(unet, f"{label} step {i + 1}")
    finally:
        parallel_mesh.sync_gradients = real
    bad += replica_mismatches(state.ema, f"{label} EMA")
    tp_bad = (tp_mismatch(ctx, unet, mesh) if placement.get("tensor_parallel")
              else False)
    if ctx.cuda:
        torch.cuda.empty_cache()
    return state, losses, ms, launches, bad, tp_bad


def check_train(ctx):
    """Two UNet steps on each placement against two plain steps on one card,
    held to the control; replicas bit for bit after every step."""
    import torch

    pipe, base, batches, draws = train_setup(ctx)
    ctx.cache["base"] = base
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, lines, total = {}, [], {}
    try:
        theta0 = {k: p.detach().clone() for k, p in base.named_parameters()}
        runs = (one_card_runs(ctx, pipe, base, batches, draws, orders=True)
                if ctx.rank == 0 else None)
        for label, shape, placement in placements(ctx):
            state, losses, ms, launches, bad, tp_bad = train_placed(
                ctx, pipe, base, batches, draws, shape, placement, label)
            total = add_counts(total, launches)
            got = whole_params(state.model)
            if label == placements(ctx)[-1][0]:  # the checkpoint's state
                ctx.cache["placed"] = (state, shape, placement)
            if ctx.rank != 0:
                continue
            if bad:
                raise RuntimeError(f"train {label}: replicas differ: {bad[:5]}")
            if tp_bad:
                raise RuntimeError(f"train {label}: the model ranks of a data rank differ on "
                                   f"the tensor-parallel output")
            res = hold_to_control(ctx, f"train {label}", theta0, runs, got, losses,
                                  tight=label in ("dp", "fsdp"))
            res.update(ms=ms, one_card_ms=runs["one card"][3], mesh=shape)
            out[label] = res
            lines.append(
                f"train {label} on {shape}: replicas bit-equal after each step"
                + (", model ranks bit-equal on the TP output" if placement.get(
                    "tensor_parallel") else "")
                + f"; {res.pop('text')}; last step {ms:.1f} ms, one card "
                f"{runs['one card'][3]:.1f} ms")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["launches"] = total
    if ctx.rank == 0:
        head = (f"train ({ctx.sizes.preset} UNet, B={ctx.sizes.batch} in all, "
                f"{ctx.sizes.dtype} on f32 masters, AdamW + EMA, 2 steps; control: "
                f"{ctx.world} microbatches of B={ctx.sizes.batch // ctx.world} accumulated on "
                f"one card; dp and FSDP held to the control within {CONTROL_FACTOR} x its "
                f"spread over a ring's orders of the sum + {CONTROL_TIGHT:.0e} (the losses "
                f"relative), the others to {CONTROL_FACTOR} x its departure "
                f"from one card + {ctx.world} {ctx.sizes.dtype} ulps of the loss / "
                f"{UPDATE_FLOOR})")
        out["lines"] = [head] + lines
    return out


def check_checkpoint(ctx):
    """``save_checkpoint`` of the (2, W/2) dp x TP + FSDP state (at world 1,
    the TP state), the file against the gathered parameters,
    ``restore_checkpoint`` on every rank."""
    import torch
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel import shard_params
    from medfusion_tpu_torch.train import TrainState
    from medfusion_tpu_torch.utils import checkpoint as C

    if "placed" not in ctx.cache:  # run alone: place and train the state first
        pipe, base, batches, draws = train_setup(ctx)
        ctx.cache["base"] = base
        label, shape, placement = placements(ctx)[-1]
        state = train_placed(ctx, pipe, base, batches, draws, shape, placement, label)[0]
        ctx.cache["placed"] = (state, shape, placement)
    state, shape, placement = ctx.cache["placed"]
    ckpt = ctx.tmp / "checkpoint"
    _, save_s = ctx.timed(lambda: C.save_checkpoint(ckpt, state, step=state.step))
    got = whole_params(state.model)
    ema = whole_params(state.ema)
    file_equal = None
    if ctx.rank == 0:
        saved = C.load_payload(ckpt)["state"]
        file_equal = (all(torch.equal(saved["model"][k], v.cpu()) for k, v in got.items())
                      and all(torch.equal(saved["ema"][k], v.cpu()) for k, v in ema.items()))
    model2 = copy.deepcopy(ctx.cache["base"])
    shard_params(model2, ctx.mesh(*shape), **placement)
    with torch.no_grad():
        for p in model2.parameters():
            p.zero_()
    state2 = TrainState(model2, lr=ctx.p.diffusion_lr, weight_decay=1e-2, use_ema=True)
    _, restore_s = ctx.timed(lambda: C.restore_checkpoint(ckpt, state2))
    pieces = all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                   model2.parameters()))
    pieces &= all(torch.equal(a, b) for a, b in zip(state.ema.parameters(),
                                                    state2.ema.parameters()))
    moments = all(torch.equal(a[k], b[k]) for a, b in zip(state.optimizer.state.values(),
                                                         state2.optimizer.state.values())
                  for k in ("exp_avg", "exp_avg_sq"))
    ok = torch.tensor([int(pieces and moments and state2.step == state.step)], device=ctx.dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    out = {"save_s": save_s, "restore_s": restore_s, "restored_pieces": bool(ok.item())}
    if ctx.rank == 0:
        size = C.step_file(ckpt, state.step).stat().st_size
        shutil.rmtree(ckpt)
        out.update(file_equal=file_equal, bytes=size)
        if not file_equal:
            raise RuntimeError("checkpoint: the file differs from the gathered parameters")
        if not ok.item():
            raise RuntimeError("checkpoint: a rank's restored pieces differ from its own")
        out["lines"] = [f"checkpoint of the {shape} {placements(ctx)[-1][0]} state (step "
                        f"{state.step}, "
                        f"{size / 2**30:.2f} GiB): the file equals the gathered parameters "
                        f"and EMA; every rank's restored pieces (model, EMA, moments, step) "
                        f"bit-equal; save {save_s:.2f} s, restore {restore_s:.2f} s"]
    dist.barrier()
    return out


def check_ring(ctx):
    """``ring_attention`` over 'data' of (W, 1), forward and gradient, against
    the kernels on the whole sequence on one card."""
    import torch

    import chip_smoke as cs
    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.ops import flash_attention as FA
    from medfusion_tpu_torch.parallel import ring_attention
    from medfusion_tpu_torch.parallel.ring_attention import shard_tokens

    mesh = ctx.mesh(ctx.world, 1)
    out, lines = {}, []
    for label, dtype, shape in (("bf16", torch.bfloat16, ctx.sizes.ring),
                                ("f32", torch.float32, ctx.sizes.ring_f32)):
        b, h, n, d = shape
        scale = d ** -0.25
        gen = ctx.gen(22)
        q, k, v, do = (torch.randn(shape, generator=gen, device=ctx.dev).to(dtype)
                       for _ in range(4))
        leaves = [shard_tokens(t, mesh).contiguous().requires_grad_() for t in (q, k, v)]
        my_do = shard_tokens(do, mesh).contiguous()

        def ring():
            o = ring_attention(*leaves, mesh, scale=scale, axis="data")
            return (o, *torch.autograd.grad(o, leaves, my_do))

        ring()  # warm
        ops.reset_launch_counts()
        got, seconds = ctx.timed(ring)
        launches = ops.launch_counts()
        w = ctx.world
        ctx.expect(f"ring {label}", launches, {"flash_attention": w,
                                               "flash_attention_bwd_dq": w,
                                               "flash_attention_bwd_dkv": w})
        got = [gather(t.detach(), dim=2) for t in got]
        res = {"launches": launches, "world_s": seconds}
        if ctx.rank == 0:
            whole = [t.clone().requires_grad_() for t in (q, k, v)]

            def one_card():
                o, _ = FA.flash_attention(*whole, scale)
                return (o.detach(), *torch.autograd.grad(o, whole, do))

            one_card()  # warm
            ctx.sync()
            t0 = time.perf_counter()
            ref = one_card()
            ctx.sync()
            res["one_card_s"] = time.perf_counter() - t0
            with torch.no_grad():
                blocks = [FA.flash_attention(q, kb, vb, scale)[0]
                          for kb, vb in zip(k.chunk(w, dim=2), v.chunk(w, dim=2))]
            tols = [cs.attn_o_tol(torch.stack(blocks))] + [cs.attn_bwd_tol(r) for r in ref[1:]]
            for what, g, r, (atol, rtol) in zip(("o", "dq", "dk", "dv"), got, ref, tols):
                res[what] = max_diff(g, r)
                res[f"{what}_atol"] = atol
                torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol,
                                           msg=lambda m, x=what: f"ring {label} {x}: {m}")
            lines.append(f"ring attention {label} (B={b}, {h} heads x {d}, {n} tokens, "
                         f"{n // w} a rank) on ({w}, 1) against kernels 2, 3, 4 on the whole "
                         f"sequence: " + ", ".join(f"{x} max|d| {res[x]:.3e} (atol "
                                                   f"{res[x + '_atol']:.3e})"
                                                   for x in ("o", "dq", "dk", "dv"))
                         + f"; forward + backward {seconds * 1e3:.2f} ms (world), "
                         f"{res['one_card_s'] * 1e3:.2f} ms (one card)")
        out[label] = res
        out["launches"] = add_counts(out.get("launches", {}), launches)
    if ctx.rank == 0:
        out["lines"] = lines
    return out


def check_moe(ctx):
    """The DiT with 8 experts expert-parallel over the W ranks: a forward
    and two train steps in the compute dtype against the dense DiT on one
    card at the whole batch, held to the control."""
    import torch

    import chip_smoke as cs
    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.cli.presets import build_train_pipeline, build_unet, seeded
    from medfusion_tpu_torch.parallel import shard_batch
    from medfusion_tpu_torch.parallel.mesh import layout, local_piece
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    p, s, w = ctx.p, ctx.sizes, ctx.world
    pipe = build_train_pipeline(p, device=ctx.dev, estimator="dit", seed=0)
    cs.perturb_(pipe.latent_embedder, ctx.gen(17))
    broadcast_module(pipe.latent_embedder)
    mesh = ctx.mesh(w, 1)
    with seeded(ctx.dev, 18):
        dense = build_unet(p, "dit", **cs.DIT_MOE)
    cs.perturb_(dense, ctx.gen(18))  # the DiT's zero-initialised output and modulations
    broadcast_module(dense)
    with seeded(ctx.dev, 18):
        ep = build_unet(p, "dit", **cs.DIT_MOE, moe_expert_axis=mesh["data"])
    lay = layout(ep)
    ep.load_state_dict({k: local_piece(lay[k], v).clone() if k in lay else v
                        for k, v in dense.state_dict().items()}, strict=True)
    gen = torch.Generator().manual_seed(19)
    h, wd, c = p.latent_shape
    x = torch.randn((s.batch, c, h, wd), generator=gen).to(ctx.dev, ctx.dtype)
    t = torch.randint(0, 1000, (s.batch,), generator=gen).to(ctx.dev)
    y = torch.arange(s.batch, device=ctx.dev) % 2
    mine = [rows_of(v, ctx.rank, w) for v in (x, t, y)]
    ep_cast = copy.deepcopy(ep).to(ctx.dtype)
    with torch.no_grad():
        ep_cast(*mine, with_aux=True)  # warm
    ops.reset_launch_counts()
    with torch.no_grad():
        (fy, _, faux), fwd_s = ctx.timed(lambda: ep_cast(*mine, with_aux=True))
    launches = ops.launch_counts()
    ctx.expect("moe forward", launches, cs.dit_launches(forwards=1))
    del ep_cast
    fy = gather(fy)
    aux = gather(faux.reshape(1).float()).mean().item()
    out = {}
    if ctx.rank == 0:
        d_cast = copy.deepcopy(dense).to(ctx.dtype)
        with torch.no_grad():
            ry, _, raux = d_cast(x, t, y, with_aux=True)
            cy = torch.cat([d_cast(*[rows_of(v, r, w) for v in (x, t, y)], with_aux=True)[0]
                            for r in range(w)])
        del d_cast
        dy, cd = max_diff(fy, ry), max_diff(cy, ry)
        bound = cd + ulp(ry, ctx.dtype)
        aux_bound = 4 * ulp(raux, ctx.dtype)
        out.update(forward_diff=dy, forward_control=cd, forward_bound=bound,
                   aux_diff=abs(aux - raux.item()), aux_bound=aux_bound)
        if not dy <= bound:
            raise RuntimeError(f"moe forward: {dy:.3e} from the dense one-card forward > "
                               f"{bound:.3e} (control {cd:.3e})")
        if not abs(aux - raux.item()) <= aux_bound:
            raise RuntimeError(f"moe forward: aux {aux} against {raux.item()}")
    batches = train_batches(ctx, 2, seed=18)
    draws = [pipe.train_draws(s.batch, p.latent_shape, generator=ctx.gen(18 + i))
             for i in range(2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        theta0 = {k: v.detach().clone() for k, v in dense.named_parameters()}
        runs = one_card_runs(ctx, pipe, dense, batches, draws) if ctx.rank == 0 else None
        state = TrainState(ep, lr=p.diffusion_lr, weight_decay=1e-2, use_ema=True)
        step = make_diffusion_train_step(dataclasses.replace(pipe, noise_estimator=ep),
                                         compute_dtype=ctx.dtype)
        ops.reset_launch_counts()
        losses, auxes = [], []
        for b, d in zip(batches, draws):
            ctx.sync()
            t0 = time.perf_counter()
            m = step(state, shard_batch(b, mesh), shard_batch(d, mesh))
            ctx.sync()
            ms = (time.perf_counter() - t0) * 1e3
            losses.append(m["loss"].item())
            auxes.append(m["moe_aux"].item())
        counts = ops.launch_counts()
        ctx.expect("moe train (2 steps)", counts,
                   cs.dit_launches(forwards=2, backwards=2, encodes=2))
        launches = add_counts(launches, counts)
        bad = replica_mismatches(ep, "moe")
        got = whole_params(ep)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["launches"] = launches
    if ctx.rank == 0:
        if bad:
            raise RuntimeError(f"moe: replicas differ: {bad[:5]}")
        res = hold_to_control(ctx, "moe", theta0, runs, got, losses, auxes)
        out.update(train=res, ms=ms, one_card_ms=runs["one card"][3])
        out["lines"] = [
            f"moe ({s.preset} DiT, {cs.DIT_MOE['moe_experts']} experts, "
            f"{cs.DIT_MOE['moe_experts'] // w} a rank, all-to-all over ({w}, 1)): {s.dtype} forward "
            f"max|d| {out['forward_diff']:.4e} from the dense one-card B={s.batch} (control "
            f"{out['forward_control']:.4e}, bound {out['forward_bound']:.4e}), aux |d| "
            f"{out['aux_diff']:.3e} (bound {out['aux_bound']:.3e}); 2 {s.dtype} steps: replicas "
            f"bit-equal, moe_aux max|d| {res['max_moe_aux_diff']:.3e}, {res.pop('text')}; "
            f"last step "
            f"{ms:.1f} ms (forward {fwd_s * 1e3:.1f} ms), dense one card "
            f"{runs['one card'][3]:.1f} ms"]
    return out


def _stage(prm, x):
    import torch.nn.functional as F

    h = F.layer_norm(x, x.shape[-1:])
    return x + F.gelu(h @ prm["w1"] + prm["b1"]) @ prm["w2"]


def pipeline_reference(stacked, x, n_stages, n_micro, n_data):
    """The stages in sequence on each (microbatch, data block), the shapes
    of the pipeline's ranks, and the gradient of mean(y^2): returns (y, one
    [S, ...] gradient tree a data block), each block's stage parameters a
    leaf of its own, so that a stage's gradient sums its microbatches in
    the pipeline's order (the last first)."""
    import torch

    xs = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    leaves = [{k: v.detach().clone().requires_grad_() for k, v in stacked.items()}
              for _ in range(n_data)]
    per_stage = [[{k: v[s] for k, v in lv.items()} for s in range(n_stages)] for lv in leaves]
    outs = []
    for i in range(n_micro):
        parts = []
        for d, block in enumerate(xs[i].chunk(n_data, dim=0)):
            a = block
            for s in range(n_stages):
                a = _stage(per_stage[d][s], a)
            parts.append(a)
        outs.append(torch.cat(parts))
    y = torch.stack(outs).reshape(x.shape)
    grads = torch.autograd.grad((y ** 2).mean(), [v for lv in leaves for v in lv.values()])
    keys = list(stacked)
    return y.detach(), [dict(zip(keys, grads[j * len(keys):(j + 1) * len(keys)]))
                        for j in range(n_data)]


def check_pipeline(ctx):
    """``pipeline_apply`` at W stages on (1, W) and at W/2 stages x dp 2 with
    the stage parameters sliced over 'data' on (2, W/2), against the stages
    in sequence: output and this rank's gradient bit for bit."""
    import torch

    from medfusion_tpu_torch.parallel import (
        pipeline_apply,
        shard_stage_params,
        stack_stage_params,
    )
    from medfusion_tpu_torch.parallel.mesh import axis_rank, axis_size

    b, tokens, c = ctx.sizes.pipe
    out, lines = {}, []
    runs = [("stages", (1, ctx.world), {})]
    if mixed(ctx.world):
        runs.append(("stages x dp 2, zero over data", mixed(ctx.world),
                     {"data_axis": "data", "zero_axis": "data"}))
    for label, shape, kw in runs:
        mesh = ctx.mesh(*shape)
        n_stages, n_data = axis_size(mesh, "model"), (2 if kw else 1)
        s, dr = axis_rank(mesh, "model"), axis_rank(mesh, "data")
        gen = torch.Generator().manual_seed(18)

        def rnd(*size, std=1.0):
            return (torch.randn(size, generator=gen) * std).to(ctx.dev)

        stacked = stack_stage_params([{"w1": rnd(c, 4 * c, std=c ** -0.5),
                                       "b1": rnd(4 * c, std=0.1),
                                       "w2": rnd(4 * c, c, std=(4 * c) ** -0.5)}
                                      for _ in range(n_stages)])
        x = rnd(b, tokens, c)
        if kw:
            mine = {k: v.requires_grad_() for k, v in shard_stage_params(
                stacked, mesh, axis="model", zero_axis="data").items()}
        else:
            mine = {k: v.clone().requires_grad_() for k, v in stacked.items()}

        def run():
            y = pipeline_apply(_stage, mine, x, mesh=mesh, axis="model", **kw)
            return y, torch.autograd.grad((y ** 2).mean(), list(mine.values()))

        run()  # warm
        (y, grads), seconds = ctx.timed(run)
        ctx.sync()
        t0 = time.perf_counter()
        ref_y, ref_grads = pipeline_reference(stacked, x, n_stages, n_stages, n_data)
        ctx.sync()
        ref_s = time.perf_counter() - t0
        total = ref_grads[0] if n_data == 1 else {
            k: ref_grads[0][k] + ref_grads[1][k] for k in ref_grads[0]}
        diffs = {"y": max_diff(y, ref_y)}
        same = torch.equal(y, ref_y)
        for (k, g) in zip(mine, grads):
            want = total[k]
            if kw:  # this rank's stage, its slice over 'data' of the first post-stage dim
                want = want[s:s + 1]
                if want.ndim >= 2:
                    want = want.chunk(n_data, dim=1)[dr]
            elif g.shape[0] == n_stages:  # the stacked leaf: only this stage's row is ours
                g, want = g[s], want[s]
            diffs[k] = max_diff(g, want)
            same &= torch.equal(g, want)
        if not same:
            raise RuntimeError(f"pipeline {label} on {shape}: not bit-equal to the stages in "
                               f"sequence on rank {ctx.rank}: max|d| {diffs}")
        out[label] = {"world_s": seconds, "sequence_s": ref_s, "mesh": shape}
        lines.append(f"pipeline {n_stages} {label} on {shape} (x {tuple(x.shape)}, f32): output "
                     f"and each rank's stage gradients bit-equal to the stages in sequence; "
                     f"forward + backward {seconds * 1e3:.2f} ms (world), {ref_s * 1e3:.2f} ms "
                     f"(the sequence on one card)")
    if ctx.rank == 0:
        out["lines"] = lines
    return out


RANK_FNS = {"init": check_init, "sampler": check_sampler, "train": check_train,
            "checkpoint": check_checkpoint, "ring": check_ring, "moe": check_moe,
            "pipeline": check_pipeline}


def rank_main(args):
    """One rank under ``torch.distributed.run``: the group, then each check;
    a check that raises ends this rank with exit code 1."""
    import torch
    import torch.distributed as dist

    from medfusion_tpu_torch import ops
    from medfusion_tpu_torch.ops import build
    from medfusion_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device == "cpu":
        torch.set_num_threads(1)
    # a rank left waiting in a collective (a peer failed or hangs) raises
    # after this, not after the library's 300 s; the longest wait on a
    # sound run is rank 0's one-card runs and the checkpoint's write
    multihost.TIMEOUT = COLLECTIVE_TIMEOUT
    multihost.initialize_multihost(device=args.device)
    ctx = Rank(args)
    ctx.expected_world = args.world
    out = Path(args.out)
    for name in args.checks:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = RANK_FNS[name](ctx)
        except Exception:  # noqa: BLE001 - reported, then this rank ends
            err = traceback.format_exc()
            print(f"rank {ctx.rank}: check {name} failed:\n{err}", flush=True)
            (out / f"{name}.{ctx.rank}.json").write_text(json.dumps({"error": err}))
            sys.stdout.flush()
            os._exit(1)
        res["seconds"] = time.perf_counter() - t0
        res["compiled"] = sorted(build.BUILD_SECONDS)  # sources this rank compiled itself
        (out / f"{name}.{ctx.rank}.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ---- the launcher --------------------------------------------------------------------------


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [x.strip() for x in out.strip().splitlines()]


def interconnect() -> str:
    """``nvidia-smi topo -m``, or where it fails, each card's NVLinks and
    their speeds from ``nvidia-smi nvlink --status``."""
    def query(*args):
        res = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        return (res.stdout + res.stderr).strip()

    topo = query("topo", "-m")
    if "GPU0" in topo:
        return "nvidia-smi topo -m:\n" + topo
    links = {}
    for line in query("nvlink", "--status").splitlines():
        if line.startswith("GPU "):
            card = line.split(" (UUID")[0]
            links[card] = []
        elif line.strip().startswith("Link") and links:
            links[card].append(line.split(":", 1)[1].strip())
    return (f"nvidia-smi topo -m: {topo.splitlines()[0] if topo else 'no output'}; "
            f"nvidia-smi nvlink --status: " + "; ".join(
                f"{c}: {len(v)} links at {', '.join(sorted(set(v)))}" for c, v in links.items()))


def run_kernels_check():
    """The one-process, two-card kernel test; returns (ok, its output)."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
           "-s", "tests/test_torch_kernels_cuda.py", "-k", "two_cards"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    text = res.stdout + res.stderr
    passed = res.returncode == 0 and " passed" in text and "skipped" not in text
    return passed, text


def read_results(out: Path, check: str, world: int):
    """Every rank's result of ``check`` (None where a rank wrote none)."""
    res = []
    for r in range(world):
        f = out / f"{check}.{r}.json"
        res.append(json.loads(f.read_text()) if f.exists() else None)
    return res


def run_ranks(args, checks, out: Path, tmp: Path):
    """The rank checks in sets of ranks, restarting after a failed check with
    the checks after it. Returns {check: every rank's result, or an error}."""
    results = {}
    remaining = list(checks)
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    while remaining:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(args.world), str(ROOT / "multicard_smoke.py"),
               "--as-rank", "--device", args.device,
               "--world", str(args.world), "--out", str(out), "--tmp", str(tmp)]
        if args.fault:
            cmd += ["--fault", args.fault]
        log(f"[ranks] {' '.join(remaining)}: {args.world} ranks ({args.device})")
        proc = subprocess.Popen(cmd + remaining, cwd=ROOT, env=env, start_new_session=True)
        try:
            rc = proc.wait(timeout=args.rank_timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        failed = None
        for name in remaining:
            res = read_results(out, name, args.world)
            if all(r is not None and "error" not in r for r in res):
                results[name] = res
                continue
            errors = [r["error"] for r in res if r is not None and "error" in r]
            results[name] = {"error": errors[0] if errors else
                             f"no result from every rank (ranks exited {rc})"}
            failed = name
            break
        if failed is None:
            if rc != 0:
                results["ranks"] = {"error": f"the ranks exited {rc} after every check"}
            break
        remaining = remaining[remaining.index(failed) + 1:]
    return results


def cli_control(cli_argv, out: Path, world: int):
    """The CLI's own code as each of ``world`` ranks in turn, in this
    process on one card, through a stand-in mesh (:class:`RowBlock`): each
    rank's rows at B/W, with no group."""
    from medfusion_tpu_torch.cli import sample_dataset as cli

    real = cli.make_mesh
    try:
        for r in range(world):
            cli.make_mesh = lambda *a, r=r, **k: RowBlock(world, r)
            cli.main(cli_argv + ["--out", str(out)])
    finally:
        cli.make_mesh = real


def run_cli_check(args, tmp: Path):
    """``cli.sample_dataset`` under ``torch.distributed.run`` at W processes:
    its PNGs byte for byte against the CLI's own code run as each rank in
    turn on one card (the control), and against the command run alone
    (B=32 on one card), the difference in 0-255 levels."""
    import numpy as np

    from medfusion_tpu_torch.data.png import read_png

    import chip_smoke as cs

    s = SIZES[args.device]
    tmp.mkdir(parents=True, exist_ok=True)
    ckpt = cs.perturbed_reference_ckpt(s.preset, tmp / "weights.ckpt", "cpu")
    cli_argv = ["--preset", s.preset, "--ckpt", str(ckpt), "--chunk", str(s.batch),
                "--n-samples", str(s.batch), "--steps-list", str(s.steps)]
    if args.device == "cpu":
        cli_argv += ["--device", "cpu", "--dtype", "f32"]
    argv = ["-m", "medfusion_tpu_torch.cli.sample_dataset"] + cli_argv
    runs = {"world": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                      "--nproc_per_node", str(args.world)] + argv,
            "alone": [sys.executable] + argv}
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    seconds = {}
    for name, cmd in runs.items():
        t0 = time.perf_counter()
        res = subprocess.run(cmd + ["--out", str(tmp / name)], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=900)
        seconds[name] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"cli.sample_dataset ({name}) exited {res.returncode}:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    t0 = time.perf_counter()
    if args.device == "cpu":  # as the ranks run (OMP_NUM_THREADS=1): one thread's sums
        import torch

        torch.set_num_threads(1)
    cli_control(cli_argv, tmp / "control", args.world)
    seconds["control"] = time.perf_counter() - t0
    trees = {k: sorted(q.relative_to(tmp / k) for q in (tmp / k).rglob("*.png"))
             for k in ("world", "control", "alone")}
    files = trees["world"]
    if any(t != files for t in trees.values()) or len(files) != 2 * s.batch:
        raise RuntimeError(f"PNGs written: {({k: len(v) for k, v in trees.items()})}, "
                           f"expected {2 * s.batch} each")
    if read_png(tmp / "alone" / files[0]).std() == 0:
        raise RuntimeError(f"{files[0]} is one grey level: the weights decode to a constant")
    unequal = [f for f in files
               if (tmp / "world" / f).read_bytes() != (tmp / "control" / f).read_bytes()]
    equal, levels, differing, pixels = 0, 0, 0, 0
    for f in files:
        equal += (tmp / "alone" / f).read_bytes() == (tmp / "world" / f).read_bytes()
        ia, ib = (read_png(tmp / k / f).astype(np.int16) for k in ("alone", "world"))
        levels = max(levels, int(np.abs(ia - ib).max()))
        differing += int((ia != ib).sum())
        pixels += ia.size
    out = {"pngs": len(files), "unequal_to_control": len(unequal), "byte_equal_alone": equal,
           "max_levels": levels, "differing_share": differing / pixels,
           "world_s": seconds["world"], "alone_s": seconds["alone"],
           "control_s": seconds["control"]}
    if unequal:
        raise RuntimeError(f"cli: {len(unequal)} PNGs of the {args.world}-process run differ "
                           f"from the control, e.g. {unequal[:3]}")
    out["lines"] = [
        f"cli.sample_dataset ({s.preset}, {s.batch} a label in one chunk, DDIM {s.steps}, "
        f"perturbed weights from a reference --ckpt) under torch.distributed.run at "
        f"{args.world} processes: {len(files)} PNGs byte-equal to the control (the CLI's "
        f"code as each rank in turn, B={s.batch // args.world}, one card); against the "
        f"command alone (B={s.batch}): {equal} byte-equal, largest difference {levels} "
        f"levels in 0-255, {differing / pixels:.4%} of the pixel values differ; wall "
        f"{seconds['world']:.1f} s, alone {seconds['alone']:.1f} s (each with its start-up)"]
    return out


def kernels_line(results, world):
    """Launches summed over the ranks and checks, by kernel."""
    by_rank = {name: [0] * world for name, _, _ in KERNELS}
    for res in results.values():
        if not isinstance(res, list):
            continue
        for r, one in enumerate(res):
            for name, n in (one.get("launches") or {}).items():
                by_rank[name][r] += n
    return {"kernels": [{"name": name, "route": "cuda",
                         "source": f"medfusion_tpu_torch/csrc/{src}", "replaces": replaces,
                         "launches": sum(by_rank[name]), "launches_by_rank": by_rank[name]}
                        for name, src, replaces in KERNELS]}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checks", nargs="*", help=f"checks to run (default: all of {CHECKS})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="keep the per-rank JSON results here (default: a temporary "
                    "directory, removed at the end)")
    ap.add_argument("--tmp", default=None, help="working directory (checkpoints, PNG "
                    "trees; default: a temporary one in /dev/shm, removed at the end)")
    ap.add_argument("--rank-timeout", type=float, default=1200.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant a fault the train check must flag on rank 1: skip-sync "
                    "keeps its own gradients (dp), fsdp-scale leaves its FSDP slices' "
                    "gradients undivided by the world")
    ap.add_argument("--as-rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    unknown = [c for c in args.checks if c not in CHECKS]
    if unknown:
        ap.error(f"unknown checks {unknown}; choose from {CHECKS}")
    if args.as_rank:
        args.checks = [c for c in RANK_CHECKS if c in args.checks]
    else:
        args.checks = [c for c in CHECKS if c in (args.checks or CHECKS)
                       and not (c == "kernels" and args.device == "cpu")]  # cards only
    return args


def launch(args):
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("multicard_smoke: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() != args.world:
            print(f"multicard_smoke: {torch.cuda.device_count()} CUDA devices, the run "
                  f"needs {args.world}", file=sys.stderr)
            return 2
    if args.world < 1 or (args.world > 1 and args.world % 2):
        print(f"multicard_smoke: world {args.world}: 1 or an even world", file=sys.stderr)
        return 2
    if args.world < 2:  # the two-card kernel check needs two cards
        args.checks = [c for c in args.checks if c != "kernels"]
    if not (ROOT / "medfusion_tpu_torch" / "csrc").is_dir():
        print("multicard_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from medfusion_tpu_torch.ops import build

    t_all = time.perf_counter()
    cards = card_lines() if args.device == "cuda" else ["cpu"]
    card = cards[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; cards: {cards}")
    if args.device == "cuda":
        peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(args.world)]
                 for i in range(args.world)]
        log(f"NCCL {torch.cuda.nccl.version()}; peer access between the cards: {peers}")
    tmp = Path(args.tmp) if args.tmp else Path(tempfile.mkdtemp(
        prefix="multicard-", dir="/dev/shm" if os.path.isdir("/dev/shm") else None))
    out = Path(args.out) if args.out else tmp / "results"
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*.json"):
        old.unlink()
    results, lines = {}, []
    try:
        if args.device == "cuda":
            log(f"interconnect: {interconnect()} ({card})")
            t0 = time.perf_counter()
            libs = build.build_all()
            log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s ({card})")
            if "kernels" in args.checks:
                ok, text = run_kernels_check()
                log(text.rstrip())
                results["kernels"] = ([{"lines": [
                    "kernels on two cards in one process "
                    "(tests/test_torch_kernels_cuda.py -k two_cards): passed"]}] if ok
                                      else {"error": text[-4000:]})
        rank_checks = [c for c in args.checks if c in RANK_CHECKS]
        if rank_checks:
            results.update(run_ranks(args, rank_checks, out, tmp))
        if "cli" in args.checks:
            try:
                results["cli"] = [run_cli_check(args, tmp / "cli")]
            except Exception:  # noqa: BLE001 - reported below; the run fails
                results["cli"] = {"error": traceback.format_exc()}
    finally:
        if not args.tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    failed = [name for name in [*args.checks, "ranks"] if isinstance(results.get(name), dict)]
    log(f"---- summary ({card}) ----")
    for name in args.checks:
        res = results.get(name)
        if isinstance(res, dict):
            log(f"[{name}] FAILED ({card}):\n{res['error'].rstrip()}")
            continue
        for line in (res[0].get("lines") or []):
            log(f"[{name}] {line} ({card})")
        launches = [r.get("launches") for r in res if isinstance(r.get("launches"), dict)]
        if launches and any(any(v for v in x.values()) for x in launches):
            log(f"[{name}] launches by rank: {launches}")
        if name in RANK_CHECKS:
            log(f"[{name}] seconds by rank: {[round(r.get('seconds', 0), 1) for r in res]}")
    if "ranks" in results:
        log(f"[ranks] FAILED: {results['ranks']['error']}")
    last = [results[c] for c in args.checks if c in RANK_CHECKS and isinstance(results[c], list)]
    if last:
        log(f"sources each rank compiled itself: {[r['compiled'] for r in last[-1]]} (the "
            f"launcher built them first)")
    kernels = kernels_line(results, args.world)
    if args.device == "cuda" and not failed and set(RANK_CHECKS) <= set(args.checks):
        for k in kernels["kernels"]:
            if k["name"] in PATH_KERNELS and 0 in k["launches_by_rank"]:
                failed.append(f"kernel {k['name']} not launched on every rank")
    log(f"seconds: {time.perf_counter() - t_all:.1f} ({card})")
    if failed:
        log(f"multicard_smoke: FAILED: {failed}")
        return 1
    if args.device == "cuda" and args.world != 4:
        log(f"multicard_smoke: every check passed at world {args.world}, a rehearsal on "
            f"fewer cards; the run is world 4")
        return 3
    print(json.dumps(kernels), flush=True)
    print("\n".join(cards), flush=True)
    device = ({"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": torch.cuda.device_count()} if args.device == "cuda"
              else {"platform": "cpu", "kind": "cpu", "count": args.world})
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.as_rank:
        return rank_main(args)
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
