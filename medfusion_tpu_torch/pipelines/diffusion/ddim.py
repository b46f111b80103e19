"""DDIM / ancestral reverse loop
(port of ``medfusion_tpu/pipelines/diffusion/ddim.py::denoise``).

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
of eager steps. Randomness is explicit: ``noise`` holds every draw the loop
makes, ``[n, 2, *x_t.shape]`` with ``noise[i, 0]`` the ancestral draw and
``noise[i, 1]`` the DDIM draw of grid step ``i`` (the JAX package draws them
from ``split(split(rng, n)[i])``), or a ``torch.Generator`` draws them as the
loop goes. Inpainting and RePaint resampling are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from medfusion_tpu_torch.core import schedules as S


def _to_nchw(x):
    return x.movedim(-1, 1).contiguous()


def _to_nhwc(x):
    return x.movedim(1, -1).contiguous()


class DDIMSamplerMixin:
    @torch.no_grad()
    def denoise(self, x_t, condition=None, steps: Optional[int] = None,
                use_ddim: bool = True, guidance_scale: float = 1.0,
                eta: float = 1.0, decode: bool = True,
                guidance_rescale: float = 0.0,
                timestep_spacing: str = "linspace", start_idx: int = 0,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                known=None, mask=None, resample_steps: int = 1):
        """Full reverse process from the channels-last latent ``x_t``
        [B, *spatial, C]. Returns channels-last images (``decode``) or the
        final latent."""
        if known is not None or mask is not None or resample_steps != 1:
            raise NotImplementedError(
                "inpainting / RePaint resampling are not ported yet")
        sched = self.scheduler
        if use_ddim:
            n = sched.timesteps if steps is None else steps
            ts = sched.ddim_timesteps_host(n, spacing=timestep_spacing)
        else:
            ts = np.linspace(0, sched.T - 1, sched.timesteps).astype(np.int64)
            ts = ts[: (steps or sched.timesteps)]
            n = len(ts)
        if not 0 <= start_idx < n:
            raise ValueError(f"start_idx must be in [0, {n}); got {start_idx}")
        if noise is not None and tuple(noise.shape) != (n, 2, *x_t.shape):
            raise ValueError(f"noise must have shape {(n, 2, *x_t.shape)}, "
                             f"got {tuple(noise.shape)}")
        ts_rev = [int(v) for v in ts[::-1]]
        ts_next = ts_rev[1:] + [0]

        x = _to_nchw(x_t)
        b = x.shape[0]
        if noise is not None:
            noise = noise.to(x.device).movedim(-1, 3)

        def draw(i, j):
            if noise is not None:
                return noise[i, j].contiguous()
            return torch.randn(x.shape, generator=generator, device=x.device,
                               dtype=x.dtype)

        for i in range(start_idx, n):
            t, t_next, more = ts_rev[i], ts_next[i], i < n - 1
            t_b = torch.full((b,), t, dtype=torch.long, device=x.device)
            x_prior, x_0, x_T = self.estimate(
                x, t_b, draw(i, 0), condition, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale)
            if not use_ddim:
                x = x_prior
            elif more:
                x = S.ddim_step(sched, x_0, x_T, t, t_next, draw(i, 1), eta)
            else:
                # trailing grids end above t=0: return the x_0 prediction;
                # linspace ends at t=0, where the ancestral step is x_0
                x = x_0 if timestep_spacing == "trailing" else x_prior
        if decode:
            x = self.decode_latent(x)
        return _to_nhwc(x)
