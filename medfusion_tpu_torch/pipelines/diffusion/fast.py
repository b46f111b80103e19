"""Encoder-propagation DDIM sampler (Faster Diffusion, arXiv:2312.09608)
(port of ``medfusion_tpu/pipelines/diffusion/fast.py``).

On key steps (every ``encoder_key_every``-th, from the first) the UNet's
encoder runs and its skip stack is cached; on the others only
``decode_features`` runs, on the cached skips. The time embedding is cast
to the compute dtype as ``UNet.forward`` casts it (the JAX fast path leaves
it float32 and so promotes its bf16 activations; ROADMAP Queue 3). One draw
a step, ``noise`` [n, *x_t.shape] or a ``torch.Generator``, serves as the
ancestral noise and, when eta != 0, as the DDIM noise, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

from medfusion_tpu_torch.core.draws import normal
from medfusion_tpu_torch.core import schedules as S
from medfusion_tpu_torch.pipelines.diffusion.ddim import _to_nchw, _to_nhwc


class FastSamplerMixin:
    @torch.no_grad()
    def denoise_fast(self, x_t, condition=None, steps: Optional[int] = None,
                     guidance_scale: float = 1.0, un_cond=None, eta: float = 0.0,
                     decode: bool = True, encoder_key_every: int = 3,
                     timestep_spacing: str = "linspace",
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Approximate DDIM from the channels-last latent ``x_t``;
        ``encoder_key_every=1`` is :meth:`denoise` with the same draw in
        both of its noise slots. Needs an estimator with ``embed``,
        ``encode_features`` and ``decode_features`` (the UNet);
        self-conditioning is refused."""
        if self.use_self_conditioning:
            raise ValueError("fast sampler: self-cond unsupported")
        if encoder_key_every < 1:
            raise ValueError("encoder_key_every must be >= 1")
        sched = self.scheduler
        unet = self.noise_estimator
        n = sched.timesteps if steps is None else steps
        ts_rev = [int(v) for v in sched.ddim_timesteps_host(n, spacing=timestep_spacing)[::-1]]
        if noise is not None and tuple(noise.shape) != (n, *x_t.shape):
            raise ValueError(f"noise must have shape {(n, *x_t.shape)}, "
                             f"got {tuple(noise.shape)}")
        x = _to_nchw(x_t)
        b = x.shape[0]
        if noise is not None:
            noise = noise.to(x.device).movedim(-1, 2)

        cache, refresh = None, True

        def propagate(x_in, t_in, cond, mask, self_cond=None):
            """The UNet on the cached encoder features, refreshed on key
            steps; called as ``_apply_estimator``."""
            nonlocal cache
            if self.compute_dtype is not None:
                x_in = x_in.to(self.compute_dtype)
            emb = unet.embed(t_in, cond, mask)
            if emb is not None:
                emb = emb.to(x_in.dtype)
            if refresh:
                cache = unet.encode_features(x_in, emb)
            y, y_ver = unet.decode_features(cache, emb)
            return y.float(), y_ver

        for i, t in enumerate(ts_rev):
            more = i < n - 1
            t_next = ts_rev[i + 1] if more else 0
            refresh = i % encoder_key_every == 0
            t_b = torch.full((b,), t, dtype=torch.long, device=x.device)
            pred = self._guided_pred(x, t_b, condition, guidance_scale, un_cond=un_cond,
                                     estimator=propagate)
            pred, _ = self._split_variance(pred)
            z = (noise[i].contiguous() if noise is not None else
                 normal(x.shape, generator, x.device))
            x_prior, x_0, x_T, _ = self._pred_to_states(x, t_b, pred, z)
            if more:
                x = S.ddim_step(sched, x_0, x_T, t, t_next,
                                torch.zeros_like(x) if eta == 0.0 else z, eta)
            else:
                x = x_0 if timestep_spacing == "trailing" else x_prior
        if decode:
            x = self.decode_latent(x)
        return _to_nhwc(x)
