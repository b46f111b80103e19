"""Training as ``cli/train_diffusion.py`` runs it with ``--bf16 --use-ema``:
``train/diffusion.py::make_diffusion_train_step`` on the ``TrainState``
(AdamW, EMA), float32 masters and bf16 compute, over a cycled pool of
batches and draws made on the card from the seed before the window. On a
world of several ranks (one process and one card a rank, NCCL) the model is
placed by ``parallel/mesh.py::shard_params`` on a ('data',) mesh and each
rank trains on its own block of rows of every global batch.

Set-up drives the state through its first ``checked_steps`` steps with the
window's own call and feed, on batches whose rows all differ, and keeps
what the check compares: each step's loss, the first gradient (from
AdamW's first moment after one step: its leaf norms, and on rank 0 the
whole of it, on the host) and, after the last checked step, the leaf norms
of the parameters' and the EMA's change. The same state then runs the
window."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from port_bench.harness import check, program, seeded, trace
from port_bench.reference import diffusion as RD
from port_bench.reference import model as R
from port_bench.reference.precision import F32, no_tf32


AGREE_EVERY = 16


class Training:
    """The driver of a 'train' traffic mix: a round is a step."""

    def __init__(self, cell, seed: int, device, rank: int = 0, world: int = 1,
                 host_group=None):
        from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

        self.cfg, self.tr, self.seed, self.device = cell.config, cell.traffic, seed, device
        self.rank, self.world, self.host_group = rank, world, host_group
        self.rows = self.tr["rows_per_rank"]
        self.rows_per_round = self.rows * world
        self.sd_unet, sd_vae = program.seeded_weights(self.cfg, seed, device)
        pipe = program.training_pipeline(self.cfg, self.sd_unet, sd_vae, device)
        del sd_vae
        unet = pipe.noise_estimator
        if world > 1:
            from medfusion_tpu_torch.parallel import make_mesh, shard_params

            shard_params(unet, make_mesh(n_model=1, device=device.type))
        opt = self.cfg["optimizer"]
        self.state = TrainState(unet, lr=opt["lr"], weight_decay=opt["weight_decay"],
                                use_ema=True)
        self.step_fn = make_diffusion_train_step(pipe, compute_dtype=program.DTYPES[
            self.cfg["compute_dtype"]])
        self.pool = [seeded.batch(self.cfg, seed, i, rank, self.rows, device)
                     for i in range(self.tr["pool_batches"])]
        self.steps = 0
        self.losses: List[torch.Tensor] = []
        self.ends: List[torch.cuda.Event] = []
        self.readings: Dict = {}

    def step(self):
        batch, draws = self.pool[self.steps % len(self.pool)]
        metrics = self.step_fn(self.state, batch, draws)
        self.losses.append(metrics["loss"])
        self.steps += 1
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ends.append(ev)

    def prepare(self):
        """The first steps, and what the check compares from them."""
        params = dict(self.state.model.named_parameters())
        names = sorted(params)
        b1 = self.cfg["optimizer"]["betas"][0]
        for _ in range(self.tr["checked_steps"]):
            self.step()
            if self.steps == 1:
                moments = self.state.optimizer.state
                grad = [moments[params[n]]["exp_avg"] / (1 - b1) if params[n] in moments
                        else torch.zeros_like(params[n]) for n in names]
                self.readings["grad"] = check.leaf_norms(grad)
                if self.rank == 0:
                    self.readings["grad_full"] = [g.cpu() for g in grad]
                del grad
        p0 = [self.sd_unet[n] for n in names]
        with torch.no_grad():
            self.readings["change"] = check.leaf_norms(
                torch._foreach_sub([params[n].detach() for n in names], p0))
            ema = dict(self.state.ema.named_parameters())
            self.readings["ema"] = check.leaf_norms(
                torch._foreach_sub([ema[n].detach() for n in names], p0))
        self.readings["losses"] = [float(v) for v in self.losses]
        del self.sd_unet, p0

    def _stop(self, t0: float, seconds: float) -> bool:
        done = time.perf_counter() - t0 >= seconds
        if self.host_group is None:
            return done
        flag = torch.tensor([1.0 if done else 0.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(flag.item())

    def window(self, seconds: float, sync):
        """Steps until ``seconds`` have passed; returns the seconds. On a
        world of several ranks the ranks agree on the host, over gloo, that
        some rank's clock says so, every ``AGREE_EVERY`` steps, so that all
        run the same steps without holding every host to the slowest one's
        every step."""
        first = self.steps
        every = 1 if self.host_group is None else AGREE_EVERY
        t0 = time.perf_counter()
        while (self.steps - first) % every or not self._stop(t0, seconds):
            self.step()
        sync()
        seconds = time.perf_counter() - t0
        self.window_rounds = self.steps - first
        # each step's duration: the gap between the CUDA events at the ends
        # of consecutive steps (the first from the last set-up step's)
        ends = self.ends[-(self.window_rounds + 1):]
        self.round_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return seconds

    def traced(self, sync):
        """``trace_rounds`` steps profiled on the device, then one step
        profiled on the host too. Returns (device profile, its seconds, no
        hooks, host profile)."""
        def rounds(n):
            for _ in range(n):
                self.step()

        prof, seconds = trace.profiled(lambda: rounds(self.tr["trace_rounds"]), sync, host=False)
        host, _ = trace.profiled(lambda: rounds(1), sync, host=True)
        return prof, seconds, {}, host

    def counts(self):
        """(steps attempted, steps whose loss is not finite), this rank's."""
        losses = torch.stack(self.losses).float().cpu()
        return len(losses), int((~torch.isfinite(losses)).sum())

    def release(self):
        readings = self.readings
        del self.state, self.step_fn, self.pool, self.losses
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return readings


def numbers(cell, seed: int, out, device, world: int = 1) -> Dict[str, float]:
    """The numbers compared: the checked steps' readings against the
    reference's."""
    return check.train_numbers(out, reference_readings(cell.config, cell.traffic, seed,
                                                       device, world,
                                                       judged=out.get("grad_full")))


def reference_readings(cfg, tr, seed, device, world: int = 1, prec=F32,
                       rows_per_rank: Optional[int] = None, judged=None,
                       keep_grad: bool = False) -> Dict:
    """The plain reference's readings of the checked steps on the global
    batches (every rank's block), from the same seed, in blocks of rows:
    float32 with TF32 off (or ``prec``). ``judged``: the other side's whole
    first gradient (host leaves in sorted order), whose leaf norms of the
    difference from the reference's are read as 'grad_diff'; ``keep_grad``
    keeps this side's whole first gradient on the host as 'grad_full'."""
    rows = rows_per_rank or tr["rows_per_rank"]
    sd_unet, sd_vae = program.seeded_weights(cfg, seed, device)
    unet, vae = program.reference_models(cfg, sd_unet, sd_vae, device)
    R.set_precision(unet, prec)
    R.set_precision(vae, prec)
    sched = RD.Schedule(cfg, device)
    params = {n: p for n, p in sorted(unet.named_parameters())}
    p0 = [sd_unet[n] for n in params]
    ema = [p.detach().clone() for p in params.values()]
    opt = RD.AdamW(params.values(), cfg)
    block, total = tr["check_block_rows"], rows * world
    losses, out = [], {}
    with no_tf32():
        for step in range(tr["checked_steps"]):
            unet.zero_grad(set_to_none=True)
            loss = 0.0
            for rank in range(world):
                batch, draws = seeded.batch(cfg, seed, step, rank, rows, device)
                for start in range(0, rows, block):
                    part = slice(start, start + block)
                    b = {k: v[part] for k, v in batch.items()}
                    d = {k: (v[part] if v.ndim else v) for k, v in draws.items()}
                    n = b["source"].shape[0]
                    l_ = RD.loss(unet, vae, sched, b, d) * (n / total)
                    l_.backward()
                    loss += float(l_.detach())
            losses.append(loss)
            if step == 0:
                grad = [torch.zeros_like(p) if p.grad is None else p.grad
                        for p in params.values()]
                out["grad"] = check.leaf_norms(grad)
                if judged is not None:
                    out["grad_diff"] = check.leaf_norms(
                        [g - j.to(device) for g, j in zip(grad, judged)])
                if keep_grad:
                    out["grad_full"] = [g.cpu() for g in grad]
                del grad
            opt.step()
            decay = RD.ema_decay(step, cfg)
            with torch.no_grad():
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, [p.detach() for p in params.values()],
                                    alpha=1 - decay)
    with torch.no_grad():
        out["change"] = check.leaf_norms(torch._foreach_sub(
            [p.detach() for p in params.values()], p0))
        out["ema"] = check.leaf_norms(torch._foreach_sub(ema, p0))
    out["losses"] = losses
    return out
