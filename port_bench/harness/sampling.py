"""Bulk sampling as ``cli/sample_dataset.py`` runs it: chunks of ``rows``
images, one label a chunk in turn, DDIM at eta 1 with guidance 1 and the
decode, through ``parallel/sampling.py::make_sharded_sampler`` at world 1.
Closed loop: the next chunk is sent when the host has sent the last. The
images stay on the card. Each chunk's draws come from the seed and the
chunk's index; after the window a sample of the finished images, drawn
from the seed, is held to the plain reference."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from port_bench.harness import check, program, seeded, trace
from port_bench.reference import diffusion as RD
from port_bench.reference import model as R
from port_bench.reference.precision import F32, no_tf32


class Sampling:
    """The driver of a 'sample' traffic mix: a round is a chunk."""

    def __init__(self, cell, seed: int, device, rank: int = 0, world: int = 1,
                 host_group=None):
        from medfusion_tpu_torch.parallel import make_mesh, make_sharded_sampler

        if world != 1:
            raise ValueError("the sampling traffic runs on one card")
        self.cfg, self.tr, self.seed, self.device = cell.config, cell.traffic, seed, device
        self.rows, self.steps = self.tr["rows"], self.tr["steps"]
        self.rows_per_round = self.rows
        sd_unet, sd_vae = program.seeded_weights(self.cfg, seed, device)
        self.pipe = program.sampling_pipeline(self.cfg, sd_unet, sd_vae, device)
        del sd_unet, sd_vae
        self.mesh = make_mesh(n_model=1, device=device.type)
        lat = self.cfg["latent_size"], self.cfg["latent_size"], self.cfg["latent_channels"]
        common = dict(guidance_scale=self.tr["guidance"], eta=self.tr["eta"], decode=True)
        self.sampler = make_sharded_sampler(self.pipe, self.mesh, lat, steps=self.steps,
                                            **common)
        self.warm = make_sharded_sampler(self.pipe, self.mesh, lat,
                                         steps=self.tr["warmup_steps"], **common)
        self.images = []

    def _chunk(self, index: int, sampler, steps: int):
        x_T, noise = seeded.chunk(self.cfg, self.seed, index, self.rows, steps, self.device)
        label = seeded.chunk_label(index, self.cfg["num_classes"])
        cond = torch.full((self.rows,), label, dtype=torch.long, device=self.device)
        return sampler(None, self.rows, cond, 1 - cond, x_T=x_T, noise=noise)

    def prepare(self):
        """Every shape of the window: one chunk of ``warmup_steps`` steps."""
        self._chunk(0, self.warm, self.tr["warmup_steps"])

    def window(self, seconds: float, sync):
        """Chunks until ``seconds`` have passed; returns the seconds."""
        t0 = time.perf_counter()
        ends = []
        while time.perf_counter() - t0 < seconds:
            self.images.append(self._chunk(len(self.images), self.sampler, self.steps))
            if self.device.type == "cuda":
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
        sync()
        seconds = time.perf_counter() - t0
        self.window_rounds = len(self.images)
        self.round_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return seconds

    def traced(self, sync):
        """``trace_rounds`` whole chunks profiled on the device, with the
        UNet's and the decode's calls timed by CUDA events in forward hooks;
        then one chunk profiled on the host too. Returns (device profile,
        its seconds, hook ms, host profile)."""
        hooks = trace.Hooks()
        vae = self.pipe.latent_embedder
        hooks.add("unet", self.pipe.noise_estimator)
        hooks.add("decode", vae.inc_dec, vae.outc)

        def rounds(n):
            for _ in range(n):
                self.images.append(self._chunk(len(self.images), self.sampler, self.steps))

        try:
            prof, seconds = trace.profiled(lambda: rounds(self.tr["trace_rounds"]), sync,
                                           host=False)
        finally:
            hooks.remove()
        host, _ = trace.profiled(lambda: rounds(1), sync, host=True)
        return prof, seconds, hooks.ms(), host

    def counts(self):
        """(images attempted, images with a value that is not finite)."""
        bad = sum(int((~torch.isfinite(c.flatten(1)).all(dim=1)).sum()) for c in self.images)
        return len(self.images) * self.rows, bad

    def draw_sample(self):
        """(chunk, row) pairs of the finished images to check, from the seed."""
        n = len(self.images) * self.rows
        k = min(self.tr["check_rows"], n)
        pick = seeded.rng(self.seed, "sample").choice(n, size=k, replace=False)
        return sorted((int(i) // self.rows, int(i) % self.rows) for i in pick)

    def release(self):
        """Keep the sampled images; free the program."""
        sample = self.draw_sample()
        kept = torch.stack([self.images[c][r] for c, r in sample]).clone()
        del self.images, self.sampler, self.warm, self.pipe
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return sample, kept


def reference_images(cfg, tr, seed, sample, device, prec=F32):
    """The reference's images at the sampled (chunk, row) pairs, from the
    same seed: weights rounded to the compute dtype (as served), float32
    arithmetic with TF32 off (or ``prec``), in blocks of ``check_block_rows``."""
    sd_unet, sd_vae = program.seeded_weights(cfg, seed, device)
    unet, vae = program.reference_models(cfg, sd_unet, sd_vae, device,
                                         served=program.DTYPES[cfg["compute_dtype"]])
    del sd_unet, sd_vae
    R.set_precision(unet, prec)
    R.set_precision(vae, prec)
    sched = RD.Schedule(cfg, device)
    rows, steps = tr["rows"], tr["steps"]
    out = []
    block = tr["check_block_rows"]
    with no_tf32():
        for start in range(0, len(sample), block):
            part = sample[start:start + block]
            xs, ns, labels = [], [], []
            for c, r in part:
                x_T, noise = seeded.chunk(cfg, seed, c, rows, steps, device)
                xs.append(x_T[r])
                ns.append(noise[:, :, r])
                labels.append(seeded.chunk_label(c, cfg["num_classes"]))
            out.append(RD.sample(unet, vae, sched, torch.stack(xs), torch.stack(ns, dim=2),
                                 torch.tensor(labels, device=device), steps, tr["eta"]))
    return torch.cat(out)


def numbers(cell, seed: int, out, device, world: int = 1):
    """The numbers compared: the sampled images' worst gap to the
    reference's."""
    sample, kept = out
    ref = reference_images(cell.config, cell.traffic, seed, sample, device)
    return {"image": check.image_gap(kept, ref)}
