"""Distill a trained diffusion or flow model with the PyTorch port.

The counterpart of ``medfusion_tpu/cli/distill.py``, four methods:

* ``--method pd``: progressive distillation (arXiv:2202.00512). The
  teacher is a port ``cli.train_diffusion`` run (``--teacher-ckpt``; a
  seeded random estimator without it); each stage's student starts from
  its teacher, trains ``--iters-per-stage`` iterations to sample in N
  steps, and becomes the next teacher, N halving from ``--start-steps``
  down to 1 (or for ``--stages`` stages). Sample a stage with
  ``cli.sample --ckpt <out>/stage_<N>steps --steps N --timestep-spacing
  trailing --objective <the objective>``.
* ``--method cd``: consistency distillation (arXiv:2303.01469) into a
  one- to few-step generator, the teacher's step Euler or Heun
  (``--cd-solver``), the target the student (or its EMA, ``--cd-ema``),
  squared L2 or pseudo-Huber (``--cd-huber``); sample with ``cli.sample
  --sampler consistency --ckpt <out>/consistency``.
* ``--method ct``: consistency training from data alone (arXiv:2310.14189;
  no teacher, ``--teacher-ckpt`` refused), pseudo-Huber at c = 0.00054
  sqrt(D) by default, the discretization doubling from ``--ct-s0`` + 1
  toward ``--ct-s1`` + 1 over equal shares of the iterations.
* ``--method reflow``: rectified-flow straightening (arXiv:2209.03003) of a
  ``cli.train_diffusion --family flow`` run: a pool of ``--pair-batches``
  coupled-pair batches from the teacher's ODE (``--reflow-teacher-steps``
  Heun steps), reflow on the straight paths (``--regen-every`` regenerates
  the pool from the student), then optionally ``--reflow-distill-iters``
  iterations at t = 1 (the one-Euler-step generator); sample with
  ``cli.sample --family flow --ckpt <out>/reflow[_1step]``.

``--teacher-guidance`` distils the CFG-combined teacher at a fixed weight
(arXiv:2210.03142; pd's first stage only, reflow's first pool only), the
negative label 1 - label for a two-class preset. The frozen VAE
(``--vae-ckpt``) encodes each batch in float32 outside the step;
``--bf16`` runs the teacher's and the student's forwards and the backward
in bf16 on float32 masters. Each stage writes checkpoints every
``--ckpt-every`` iterations and at its end (``utils/checkpoint.py``, the
latest 2) with the run's config, and ``--resume`` restores each stage's
latest checkpoint and continues it (finished stages fast-forward; the
data stream restarts, as in the JAX CLI). Iteration i of a stage draws
from a generator seeded by (``--seed``, the stage, i), the JAX CLI's
``fold_in`` keys made a seed sequence.

``--estimator`` distils any family of ``cli.train_diffusion`` (the DiT,
the legacy, OpenAI or lucidrains UNet); ``--attention`` and
``--attention-heads`` must be the teacher's. The teacher's run config is
checked against ``--estimator``, ``--attention``, ``--attention-heads``,
``--objective`` (not for reflow) and the family. The kernel switches follow
the JAX CLI's rules (``cli/kernels.py``; ``--no-flash`` and
``--no-fused-geglu`` are refused on the card); ``--vae-ckpt`` also takes a
reference Lightning ``.ckpt``.

Usage:
  python -m medfusion_tpu_torch.cli.distill --preset chest --method pd \\
      --teacher-ckpt runs/diffusion --vae-ckpt runs/ae --objective v \\
      --start-steps 16 --iters-per-stage 10000 --bf16 --out runs/distill
  python -m medfusion_tpu_torch.cli.distill --preset smoke --device cpu \\
      --start-steps 4 --stages 1 --iters-per-stage 4 --out /tmp/pd
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.kernels import add_kernel_args, resolve_kernel_flags
from medfusion_tpu_torch.cli.presets import (
    ESTIMATORS,
    PRESETS,
    build_dataset,
    build_scheduler,
    build_unet,
    estimator_refusal,
    load_vae,
    seeded,
)
from medfusion_tpu_torch.cli.sample import load_unet_state
from medfusion_tpu_torch.data import SimpleDataModule
from medfusion_tpu_torch.nn.attention import ATTENTION_TYPES
from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc
from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline
from medfusion_tpu_torch.train import TrainState
from medfusion_tpu_torch.train import consistency as CM
from medfusion_tpu_torch.train import reflow as RF
from medfusion_tpu_torch.train.distillation import (
    distillation_draws,
    make_distillation_train_step,
    next_stage_steps,
)
from medfusion_tpu_torch.train.loop import check_labels, step_generator
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils.logging import MetricsWriter

METHODS = ("pd", "cd", "ct", "reflow")
# the generator keys of the reflow pools and iterations (the JAX CLI's fold_in keys)
POOL_KEY, REFLOW_ITER_KEY = 500_000, 7_000_000


def _run_stage(state, stage_step, iters, stage_dir, tag, ckpt_every, config, resume=False):
    """One stage of any method: ``stage_step(state, it0) -> metrics``, the
    metrics logged at iteration 1 and every 50, a checkpoint every
    ``ckpt_every`` and at the end. ``resume`` restores the stage's latest
    checkpoint and continues from its iteration (a finished stage returns
    at once). Returns a record: the stage's tag, its losses and the seconds
    of its iterations (after the last loss is read)."""
    ckpt_dir = stage_dir / "checkpoints"
    start = 0
    if resume and C.latest_step(ckpt_dir):
        C.restore_checkpoint(ckpt_dir, state)
        start = min(C.latest_step(ckpt_dir), iters)
        print(f"{tag}: resumed from it {start}/{iters}")
    record = {"tag": tag, "losses": [], "seconds": 0.0}
    if start >= iters:
        return record
    writer = MetricsWriter(stage_dir / "logs")
    losses, t0 = [], time.perf_counter()
    try:
        for it in range(start + 1, iters + 1):
            metrics = stage_step(state, it - 1)
            losses.append(metrics["loss"])
            if it % 50 == 0 or it == 1:
                writer.log_scalars(it, metrics)
                print(f"{tag} it {it} loss {float(metrics['loss']):.5f} "
                      f"({time.perf_counter() - t0:.1f}s)")
            if it % ckpt_every == 0 or it >= iters:
                C.save_checkpoint(ckpt_dir, state, it, config=config, keep_top_k=2)
    finally:
        writer.close()
    record["losses"] = [float(v) for v in losses]
    record["seconds"] = time.perf_counter() - t0
    return record


def _latent_batches(dm, pipe, p, dev, seed, key, want_uncond):
    """Endless ``(batch, generator)`` pairs: each batch encoded by the frozen
    VAE in float32 (outside the step) into a channels-last latent
    ``source``, with its labels and, for a guided teacher of a two-class
    preset, the negative labels ``un_cond`` = 1 - label; the generator,
    seeded by (seed, key, iteration), has drawn the encoder's noise and
    draws the step's."""
    it, epoch = 0, 0
    while True:
        for batch in dm.train_dataloader(epoch=epoch):
            gen = step_generator(dev, seed, key, it)
            x = _to_nchw(torch.from_numpy(batch["source"]).to(dev))
            b = x.shape[0]
            enc_noise = torch.randn((b, *p.latent_shape), generator=gen, device=dev)
            with torch.no_grad():
                dev_batch = {"source": _to_nhwc(pipe.encode_latent(x, _to_nchw(enc_noise)))}
            if "target" in batch and p.num_classes:
                check_labels(batch["target"], p.num_classes)
                tgt = torch.from_numpy(batch["target"]).long().to(dev)
                dev_batch["target"] = tgt
                if want_uncond and p.num_classes == 2:
                    dev_batch["un_cond"] = 1 - tgt
            yield dev_batch, gen
            it += 1
        epoch += 1


def _frozen_copy(module, dtype):
    """A frozen copy of ``module`` (cast to ``dtype`` once: the steps' cast
    of its parameters is then a no-op)."""
    teacher = copy.deepcopy(module).requires_grad_(False).eval()
    return teacher if dtype is None else teacher.to(dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="chest")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--teacher-ckpt", default=None,
                    help="a port cli.train_diffusion run (its --family flow run for "
                         "reflow); a seeded random estimator when omitted (smoke/testing)")
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run, an .npz of the JAX VAE's params, or a "
                         "reference Lightning .ckpt")
    ap.add_argument("--out", default="runs/distill")
    ap.add_argument("--objective", choices=("x_T", "x_0", "v"), default="v",
                    help="the teacher's parameterization; the paper recommends v "
                         "(eps degenerates at few steps, arXiv:2202.00512 §4)")
    ap.add_argument("--start-steps", type=int, default=16,
                    help="the first student's sampling step count N")
    ap.add_argument("--stages", type=int, default=0,
                    help="number of halvings (0 = keep halving down to 1 step)")
    ap.add_argument("--iters-per-stage", type=int, default=10000)
    ap.add_argument("--method", choices=METHODS, default="pd",
                    help="pd = progressive distillation (arXiv:2202.00512); cd = "
                         "consistency distillation (arXiv:2303.01469); ct = teacher-free "
                         "consistency training (arXiv:2310.14189); reflow = rectified-"
                         "flow straightening of a --family flow run (arXiv:2209.03003)")
    ap.add_argument("--ct-s0", type=int, default=10,
                    help="ct: the curriculum's first discretization N(0) - 1")
    ap.add_argument("--ct-s1", type=int, default=1280,
                    help="ct: the curriculum's last discretization (doubles toward)")
    ap.add_argument("--ct-doublings", type=int, default=None,
                    help="ct: cap the curriculum's stages (smoke/testing)")
    ap.add_argument("--flow-shift", type=float, default=1.0,
                    help="reflow: the SD3 shift the flow teacher was trained with")
    ap.add_argument("--reflow-teacher-steps", type=int, default=32,
                    help="reflow: the teacher's ODE steps per generated pair")
    ap.add_argument("--pair-batches", type=int, default=8,
                    help="reflow: the coupled-pair pool in batches, generated up front "
                         "and cycled")
    ap.add_argument("--regen-every", type=int, default=0,
                    help="reflow: regenerate the pool from the current student every N "
                         "iterations (0 = never)")
    ap.add_argument("--reflow-distill-iters", type=int, default=0,
                    help="reflow: iterations of fixed-t=1 distillation after "
                         "straightening (sample with --family flow --steps 1)")
    ap.add_argument("--cd-grid", type=int, default=18,
                    help="cd: the sigma grid's discretization N (paper Alg. 2)")
    ap.add_argument("--cd-sigma-data", type=float, default=0.5)
    ap.add_argument("--cd-huber", type=float, default=None,
                    help="pseudo-Huber c (arXiv:2310.14189; none = squared L2)")
    ap.add_argument("--cd-ema", action="store_true",
                    help="an EMA target network (paper Alg. 2; default: the student "
                         "without gradient, arXiv:2310.14189)")
    ap.add_argument("--cd-solver", choices=CM.SOLVERS, default="heun",
                    help="cd: the teacher's ODE step (heun, the CM paper's default, "
                         "costs one more teacher forward)")
    ap.add_argument("--teacher-guidance", type=float, default=1.0,
                    help="fixed-weight guided distillation (arXiv:2210.03142): the "
                         "teacher's CFG-combined prediction at this scale; sample the "
                         "student with guidance 1")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: the preset's diffusion learning rate")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--latent-scale", type=float, default=1.0)
    ap.add_argument("--latent-shift", type=float, default=0.0)
    ap.add_argument("--estimator", choices=ESTIMATORS, default="unet")
    ap.add_argument("--attention", choices=ATTENTION_TYPES, default="none")
    ap.add_argument("--attention-heads", type=int, default=8)
    add_kernel_args(ap, attention=False)
    ap.add_argument("--resume", action="store_true",
                    help="restore each stage's latest checkpoint and continue "
                         "(finished stages fast-forward)")
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    why = estimator_refusal(args.estimator, args.attention, args.attention_heads)
    if why is not None:
        ap.error(why)
    resolve_kernel_flags(args, ap)
    if args.method == "ct" and args.teacher_ckpt:
        ap.error("--method ct is teacher-free (consistency TRAINING); drop "
                 "--teacher-ckpt (use cd to distill a diffusion teacher)")
    p = PRESETS[args.preset]
    if args.method == "reflow" and args.teacher_guidance != 1.0 and p.num_classes != 2:
        ap.error("--teacher-guidance negative labels need a 2-class preset")
    return _distill(args, p)


def _distill(args, p):
    """Returns the stages' records (:func:`_run_stage`)."""
    dev = resolve_device(args.device)
    batch_size = args.batch_size or p.diffusion_batch_size
    out = Path(args.out)
    dtype = torch.bfloat16 if args.bf16 else None
    family = "flow" if args.method == "reflow" else "diffusion"
    config = {**dataclasses.asdict(p), "method": args.method, "estimator": args.estimator,
              "attention": args.attention, "attention_heads": args.attention_heads,
              "objective": "x_T" if family == "flow" else args.objective,
              "latent_scale": args.latent_scale, "latent_shift": args.latent_shift,
              "zero_terminal_snr": False, "family": family, "flow_shift": args.flow_shift,
              "use_ema": args.cd_ema}

    with seeded(dev, args.seed):
        student = build_unet(p, args.estimator, attention=args.attention,
                             attn_heads=args.attention_heads)
    if args.teacher_ckpt:
        flags = {k: config[k] for k in ("estimator", "attention", "attention_heads",
                                        "family")}
        if family == "diffusion":
            flags["objective"] = args.objective
        student.load_state_dict(load_unet_state(args.teacher_ckpt, False, flags), strict=True)
        print(f"teacher restored from {args.teacher_ckpt}")
    vae = load_vae(p, dev, args.seed, args.vae_ckpt).requires_grad_(False)
    common = dict(noise_estimator=student, latent_embedder=vae,
                  classifier_free_guidance_dropout=0.0, do_input_centering=False,
                  latent_scale=args.latent_scale, latent_shift=args.latent_shift)
    ds = build_dataset(p, args.data_root, n_synthetic=max(batch_size * 4, 16), seed=args.seed)
    dm = SimpleDataModule(ds, batch_size=batch_size, seed=args.seed, weights=ds.get_weights())
    lr = args.lr or p.diffusion_lr
    if args.method == "reflow":
        pipe = FlowMatchingPipeline(shift=args.flow_shift, **common)
        return _reflow(args, p, pipe, dev, out, batch_size, lr, dtype, config)
    pipe = DiffusionPipeline(scheduler=build_scheduler(p, dev), estimator_objective=args.objective,
                             clip_x0=False, **common)
    latent = p.latent_shape

    def batches(key, want_uncond=False):
        return _latent_batches(dm, pipe, p, dev, args.seed, key, want_uncond)

    if args.method == "ct":
        huber = (args.cd_huber if args.cd_huber is not None
                 else 0.00054 * float(np.sqrt(np.prod(latent))))
        stages = CM.ct_curriculum_grid(args.iters_per_stage, args.ct_s0, args.ct_s1,
                                       args.ct_doublings)
        state = TrainState(student, lr=lr, weight_decay=1e-2, use_ema=args.cd_ema)
        stream = batches(0)
        cur = {"n": None}

        def ct_step(state, it0):
            # the discretization N(k) is fixed per step function: rebuilt at each
            # curriculum doubling
            n_grid = max(n for s, n in stages if s <= it0)
            if n_grid != cur["n"]:
                print(f"ct curriculum: N={n_grid} from it {it0}")
                cur.update(n=n_grid, logits=CM.ct_grid_logits(pipe.scheduler, n_grid),
                           fn=CM.make_consistency_training_step(
                               pipe, n_grid=n_grid, sigma_data=args.cd_sigma_data,
                               huber_c=huber, compute_dtype=dtype))
            batch, gen = next(stream)
            draws = CM.ct_draws(cur["logits"], batch_size, latent, generator=gen, device=dev)
            return cur["fn"](state, batch, draws)

        stage_dir = out / "consistency_training"
        rec = _run_stage(state, ct_step, args.iters_per_stage, stage_dir, "ct",
                         args.ckpt_every, config, resume=args.resume)
        print(f"consistency training done -> {stage_dir}/checkpoints (sample: cli.sample "
              f"--sampler consistency --objective {args.objective}, 1-4 steps)")
        return [rec]

    teacher = _frozen_copy(student, dtype)
    if args.method == "cd":
        step_fn = CM.make_consistency_train_step(
            pipe, n_grid=args.cd_grid, sigma_data=args.cd_sigma_data, huber_c=args.cd_huber,
            teacher_guidance_scale=args.teacher_guidance, solver=args.cd_solver,
            compute_dtype=dtype)
        state = TrainState(student, lr=lr, weight_decay=1e-2, use_ema=args.cd_ema)
        stream = batches(0, want_uncond=args.teacher_guidance != 1.0)

        def cd_step(state, it0):
            batch, gen = next(stream)
            draws = CM.consistency_draws(batch_size, latent, args.cd_grid, generator=gen,
                                         device=dev)
            return step_fn(state, teacher, batch, draws)

        stage_dir = out / "consistency"
        rec = _run_stage(state, cd_step, args.iters_per_stage, stage_dir, "cd",
                         args.ckpt_every, config, resume=args.resume)
        print(f"consistency distillation done -> {stage_dir}/checkpoints (sample: "
              f"cli.sample --sampler consistency --objective {args.objective}, 1-4 steps)")
        return [rec]

    records, n, stage_idx = [], args.start_steps, 0
    while n is not None:
        # guided distillation applies to the first stage only: later teachers
        # already absorbed the guidance (arXiv:2210.03142)
        tg = args.teacher_guidance if stage_idx == 0 else 1.0
        step_fn = make_distillation_train_step(pipe, student_steps=n, compute_dtype=dtype,
                                               teacher_guidance_scale=tg)
        state = TrainState(student, lr=lr, weight_decay=1e-2)
        print(f"--- stage {stage_idx}: distilling to a {n}-step student ---")
        stream = batches(stage_idx, want_uncond=tg != 1.0)

        def pd_step(state, it0, _f=step_fn, _t=teacher, _s=stream, _n=n):
            batch, gen = next(_s)
            draws = distillation_draws(batch_size, latent, _n, generator=gen, device=dev)
            return _f(state, _t, batch, draws)

        stage_dir = out / f"stage_{n}steps"
        records.append(_run_stage(state, pd_step, args.iters_per_stage, stage_dir,
                                  f"stage {n}-step", args.ckpt_every, config,
                                  resume=args.resume))
        teacher = _frozen_copy(student, dtype)  # the student becomes the next teacher
        print(f"stage done -> {stage_dir}/checkpoints (sample: --steps {n} "
              f"--timestep-spacing trailing --objective {args.objective})")
        stage_idx += 1
        if args.stages and stage_idx >= args.stages:
            break
        n = next_stage_steps(n)
    print(f"distillation complete: {stage_idx} stage(s) -> {out}")
    return records


def _reflow(args, p, pipe, dev, out, batch_size, lr, dtype, config):
    """Rectified-flow straightening of a flow teacher: a pool of coupled
    pairs from the teacher's ODE, reflow on the straight paths, then the
    optional fixed-t=1 phase; each phase a stage."""
    student = pipe.noise_estimator
    teacher = _frozen_copy(student, None)  # pairs are generated in float32

    def make_pool(module, pool_key, guided):
        """``--pair-batches`` coupled-pair batches from ``module``'s ODE; the
        guidance applies only to the original teacher's pool (a trained
        student has absorbed it)."""
        g = args.teacher_guidance if guided else 1.0
        gen_pipe = dataclasses.replace(pipe, noise_estimator=module, compute_dtype=None)
        pool = []
        for j in range(args.pair_batches):
            gen = step_generator(dev, args.seed, pool_key, j)
            cond = un_cond = None
            if p.num_classes:
                cond = torch.randint(0, p.num_classes, (batch_size,), generator=gen,
                                     device=dev)
                if g != 1.0:
                    un_cond = 1 - cond  # the two-class convention
            z1 = torch.randn((batch_size, *p.latent_shape), generator=gen, device=dev)
            z1, z0 = RF.generate_reflow_pairs(gen_pipe, z1, condition=cond,
                                              steps=args.reflow_teacher_steps,
                                              guidance_scale=g, un_cond=un_cond)
            pool.append({"z0": z0, "z1": z1} if cond is None
                        else {"z0": z0, "z1": z1, "target": cond})
        return pool

    phases = [("reflow", None, args.iters_per_stage)]
    if args.reflow_distill_iters:
        phases.append(("reflow_1step", 1.0, args.reflow_distill_iters))
    records = []
    for phase_idx, (phase, distill_t, iters) in enumerate(phases):
        step_fn = RF.make_reflow_train_step(pipe, distill_t=distill_t, compute_dtype=dtype)
        state = TrainState(student, lr=lr, weight_decay=1e-2)
        first = phase == "reflow"
        holder = {"pool": make_pool(teacher if first else student, POOL_KEY + phase_idx,
                                    guided=first)}
        print(f"--- {phase}: {len(holder['pool'])} pair batches x {batch_size}, "
              f"{iters} iters ---")

        def reflow_step(state, it0, _phase=phase, _idx=phase_idx, _step=step_fn, _h=holder):
            it = it0 + 1
            if args.regen_every and _phase == "reflow" and it % args.regen_every == 0:
                _h["pool"] = make_pool(state.model, it, guided=False)
            gen = step_generator(dev, args.seed, REFLOW_ITER_KEY + it, _idx)
            draws = RF.reflow_draws(pipe, batch_size, generator=gen, device=dev)
            return _step(state, _h["pool"][it0 % len(_h["pool"])], draws)

        records.append(_run_stage(state, reflow_step, iters, out / phase, phase,
                                  args.ckpt_every, config, resume=args.resume))
        print(f"{phase} done -> {out / phase}/checkpoints")
    steps = "1 (Euler)" if args.reflow_distill_iters else "1-4"
    print(f"reflow complete -> {out} (sample: cli.sample --family flow --steps {steps})")
    return records


if __name__ == "__main__":
    main()
