"""DDIM / ancestral reverse loop with inpainting and the RePaint walk
(port of ``medfusion_tpu/pipelines/diffusion/ddim.py``).

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
of eager steps. Randomness is explicit: ``noise`` holds every draw the loop
makes, or a ``torch.Generator`` draws them as the loop goes. Its layout
follows the JAX package's keys (``keys = split(rng, n)``, one key a step,
split again within the step):

* ``[n, 2, *x_t.shape]``: ``noise[i, 0]`` the ancestral draw and
  ``noise[i, 1]`` the DDIM draw of grid step ``i`` (``split(keys[i])``);
* ``[n, 3, *x_t.shape]`` with ``known``: (ancestral, DDIM, known), from
  ``split(keys[i], 3)``; the third re-noises ``known`` to the new level;
* ``[len(ops), 3, *x_t.shape]`` under RePaint (``resample_steps > 1``), one
  row an op of :func:`repaint_op_schedule` (keys ``split(rng, len(ops))``):
  a forward re-noise op reads row 0, the ancestral draw, as the JAX package
  does.

With ``start_idx`` the loop starts at grid step ``start_idx`` and reads the
rows from there, as the JAX package slices its keys.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from medfusion_tpu_torch.core.draws import normal
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.utils.profiling import annotate


def _to_nchw(x):
    return x.movedim(-1, 1).contiguous()


def _to_nhwc(x):
    return x.movedim(1, -1).contiguous()


def repaint_op_schedule(n: int, jump_length: int, resample_steps: int):
    """The RePaint walk (arXiv:2201.09865 §4.2, Alg. 2) over a descending
    ``n``-step grid: ``(from_pos, to_pos)`` pairs, where position ``p < n``
    is grid level ``p`` and ``n`` the clean state; ``to = from + 1`` is a
    reverse transition, ``to = from - 1`` a forward re-noise. After every
    ``jump_length`` reverse transitions the walk climbs ``jump_length``
    levels and descends again, ``resample_steps - 1`` extra times."""
    if jump_length < 1 or resample_steps < 1:
        raise ValueError("jump_length and resample_steps must be >= 1")
    if resample_steps > 1 and jump_length >= n:
        raise ValueError(
            f"jump_length={jump_length} >= grid length {n}: no jump point "
            f"exists, so the requested resampling would silently not happen "
            f"— use jump_length < steps (paper default 10 needs steps > 10)")
    ops = []
    jumps = {p: resample_steps - 1 for p in range(jump_length, n, jump_length)}
    pos = 0
    while pos < n:
        ops.append((pos, pos + 1))
        pos += 1
        if jumps.get(pos, 0) > 0:
            jumps[pos] -= 1
            for _ in range(jump_length):
                ops.append((pos, pos - 1))
                pos -= 1
    return ops


class DDIMSamplerMixin:
    def _grid(self, steps: Optional[int], use_ddim: bool, spacing: str) -> np.ndarray:
        """The ascending timestep grid of ``denoise``."""
        sched = self.scheduler
        if use_ddim:
            n = sched.timesteps if steps is None else steps
            return sched.ddim_timesteps_host(n, spacing=spacing).astype(np.int64)
        return sched.timesteps_host()[: (steps or sched.timesteps)]

    @torch.no_grad()
    def denoise(self, x_t, condition=None, steps: Optional[int] = None,
                use_ddim: bool = True, guidance_scale: float = 1.0,
                eta: float = 1.0, decode: bool = True,
                guidance_rescale: float = 0.0,
                timestep_spacing: str = "linspace", start_idx: int = 0,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                known=None, mask=None, resample_steps: int = 1,
                jump_length: int = 1, un_cond=None, cold_diffusion: bool = False,
                classifier_grad=None, classifier_scale: float = 0.0):
        """Full reverse process from the channels-last latent ``x_t``
        [B, *spatial, C]. Returns channels-last images (``decode``) or the
        final latent.

        ``known``/``mask`` (channels-last, ``mask`` of ``known``'s rank and
        broadcasting against it, 1 = keep) inpaint: after every reverse
        transition the kept region is replaced by ``known`` forward-diffused
        to the new level (exactly ``known`` on the clean state).
        ``resample_steps``/``jump_length`` run the RePaint walk
        (:func:`repaint_op_schedule`) and need ``known``. With
        ``use_self_conditioning`` the x_0 (or eps) estimate of each step is
        carried into the next, zeros at the first. ``classifier_grad`` and
        ``classifier_scale``: classifier guidance (:meth:`estimate`)."""
        if (known is None) != (mask is None):
            raise ValueError("inpainting needs BOTH known and mask (or neither)")
        repaint = resample_steps > 1 or jump_length > 1
        if repaint and known is None:
            raise ValueError("RePaint resampling (resample_steps/jump_length > 1) "
                             "requires known + mask")
        sched = self.scheduler
        ts = self._grid(steps, use_ddim, timestep_spacing)
        n = len(ts)
        if not 0 <= start_idx < n:
            raise ValueError(f"start_idx must be in [0, {n}); got {start_idx}")
        if start_idx and repaint:
            raise ValueError("start_idx (img2img) does not compose with the "
                             "RePaint resampling op walk")
        ts_rev = [int(v) for v in ts[::-1]]
        ops = None
        if repaint:
            ops = repaint_op_schedule(n, jump_length, resample_steps)
        rows = len(ops) if ops is not None else n
        width = 2 if known is None else 3
        if noise is not None and tuple(noise.shape) != (rows, width, *x_t.shape):
            raise ValueError(f"noise must have shape {(rows, width, *x_t.shape)}, "
                             f"got {tuple(noise.shape)}")

        x = _to_nchw(x_t)
        b = x.shape[0]
        if noise is not None:
            noise = noise.to(x.device).movedim(-1, 3)
        if known is not None:
            known = _to_nchw(known.to(x.device))
            mask = _to_nchw(mask.to(x.device)).to(x.dtype)
        self_cond = torch.zeros_like(x)

        def draw(i, j):
            if noise is not None:
                return noise[i, j].contiguous()
            return normal(x.shape, generator, x.device, x.dtype)

        def full(t):
            return torch.full((b,), t, dtype=torch.long, device=x.device)

        def reverse(x, self_cond, t, t_next, more, row):
            x_prior, x_0, x_T, new_sc = self.estimate(
                x, full(t), draw(row, 0), condition, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, un_cond=un_cond,
                self_cond=self_cond if self.use_self_conditioning else None,
                cold_diffusion=cold_diffusion, classifier_grad=classifier_grad,
                classifier_scale=classifier_scale)
            if not use_ddim:
                return x_prior, new_sc
            if more:
                return S.ddim_step(sched, x_0, x_T, t, t_next, draw(row, 1), eta), new_sc
            # trailing grids end above t=0: return the x_0 prediction;
            # linspace ends at t=0, where the ancestral step is x_0
            return (x_0 if timestep_spacing == "trailing" else x_prior), new_sc

        def project(x_new, t_next, more, row):
            # the kept region at the new state's level; clean on the last
            if more:
                known_t = S.q_sample(sched, known, full(t_next), draw(row, 2))
            else:
                known_t = known
            return mask * known_t + (1.0 - mask) * x_new

        if ops is None:
            for i in range(start_idx, n):
                more = i < n - 1
                t_next = ts_rev[i + 1] if more else 0
                with annotate("sample.step"):
                    x, self_cond = reverse(x, self_cond, ts_rev[i], t_next, more, i)
                if known is not None:
                    x = project(x, t_next, more, i)
        else:
            ab = sched.alphas_cumprod
            for row, (frm, to) in enumerate(ops):
                t_cur = ts_rev[frm]
                t_to = ts_rev[to] if to < n else 0
                if to < frm:
                    # one grid level up: x' = sqrt(r) x + sqrt(1 - r) z,
                    # r = abar_to / abar_cur
                    r = (S.extract(ab, full(t_to), x.ndim)
                         / S.extract(ab, full(t_cur), x.ndim))
                    x = torch.sqrt(r) * x + torch.sqrt(1.0 - r) * draw(row, 0)
                    more = True
                else:
                    more = to < n
                    with annotate("sample.step"):
                        x, self_cond = reverse(x, self_cond, t_cur, t_to, more, row)
                x = project(x, t_to, more, row)
        if decode:
            x = self.decode_latent(x)
        return _to_nhwc(x)
