"""Batch-sharded bulk sampling (port of
``medfusion_tpu/parallel/sampling.py``): each rank of the mesh's 'data' dim
samples its rows of every global chunk.

The JAX package compiles one program over the chunk and shards it; here each
rank runs the pipeline's sampler on its rows, with the weights replicated.
Its noise is the whole chunk's: every rank draws the chunk's x_T and every
loop draw at the whole chunk from the same generator, in the same order, and
keeps its rows (``core/draws.py``), so world N's rows are world 1's.
"""

from __future__ import annotations

from typing import Tuple

from medfusion_tpu_torch.core.draws import RowDraws, normal
from medfusion_tpu_torch.parallel.mesh import axis_rank, axis_size
from medfusion_tpu_torch.utils.profiling import annotate


def make_sharded_sampler(
    pipeline,
    mesh,
    img_size: Tuple[int, ...],
    steps: int = 150,
    use_ddim: bool = True,
    guidance_scale: float = 1.0,
    eta: float = 1.0,
    decode: bool = True,
    encoder_key_every: int = 1,
    sampler: str = "ddim",  # 'ddim' | 'dpmpp' | 'edm' (Karras Heun) | 'flow'
    classifier_apply=None,
    classifier_scale: float = 0.0,
    guidance_rescale: float = 0.0,
    timestep_spacing: str = "linspace",
    edm_churn: float = 0.0,
    edm_rho: float = 7.0,
    flow_shift: float = 1.0,
    flow_heun: bool = True,
):
    """Returns ``sample_fn(generator, num_samples, condition=None,
    un_cond=None, x_T=None, noise=None)``: this rank's rows of
    ``num_samples`` (divisible by the 'data' size) channels-last samples.

    ``condition`` and ``un_cond`` are integer labels of the whole chunk
    [num_samples]; each rank takes its rows, and ``un_cond`` None stays None
    (the null embedding, not a label 0). The draws come from ``generator``
    (x_T first, then the sampler's), or are given at the whole chunk:
    ``x_T`` [num_samples, *img_size] and ``noise`` in the sampler's layout
    (DDIM's [n, 2, num_samples, ...], EDM's churn and the fast sampler's
    [n, num_samples, ...]).

    ``classifier_apply(x_t, t) -> [N, K]`` guides DDIM and DPM-Solver++
    toward each row's ``condition`` (arXiv:2105.05233)."""
    if classifier_apply is not None and encoder_key_every > 1:
        raise ValueError("classifier guidance is not wired into the "
                         "encoder-propagation fast sampler")
    if guidance_rescale > 0 and encoder_key_every > 1:
        raise ValueError("guidance_rescale is not wired into the "
                         "encoder-propagation fast sampler")
    if sampler == "flow" and (classifier_apply is not None
                              or encoder_key_every > 1 or guidance_rescale > 0):
        raise ValueError("the flow-family ODE sampler supports CFG only "
                         "(no classifier guidance / encoder-propagation / "
                         "CFG rescale)")
    n_data, rank = axis_size(mesh, "data"), axis_rank(mesh, "data")

    def sample_fn(generator, num_samples: int, condition=None, un_cond=None, x_T=None,
                  noise=None):
        if num_samples % n_data:
            raise ValueError(f"num_samples={num_samples} must divide by the data axis "
                             f"size {n_data}")
        local = num_samples // n_data
        with annotate("sample.chunk", rows=local):
            return chunk(generator, local, condition, un_cond, x_T, noise)

    def chunk(generator, local, condition, un_cond, x_T, noise):
        def mine(t, dim=0):
            return None if t is None else t.narrow(dim, rank * local, local)

        gen = None if generator is None else RowDraws(generator, rank, n_data)
        if x_T is None:
            x_T = normal((local, *img_size), gen, pipeline.device)
        else:
            x_T = mine(x_T).to(pipeline.device)
        cond, unc = mine(condition), mine(un_cond)
        classifier_grad = None
        if classifier_apply is not None:
            from medfusion_tpu_torch.pipelines.diffusion import make_classifier_grad

            if cond is None:
                # silently guiding everything toward class 0 would bias the
                # generated distribution undetectably
                raise ValueError("classifier guidance needs `condition` (the "
                                 "per-sample guidance labels)")
            classifier_grad = make_classifier_grad(classifier_apply, cond)
        common = dict(condition=cond, steps=steps, guidance_scale=guidance_scale,
                      un_cond=unc, decode=decode)
        if sampler == "flow":
            return pipeline.denoise(x_T, heun=flow_heun, shift=flow_shift, **common)
        if sampler == "edm":
            if classifier_apply is not None:
                raise ValueError("classifier guidance is not wired into the "
                                 "EDM sampler (fractional-t queries)")
            return pipeline.denoise_edm(x_T, s_churn=edm_churn, rho=edm_rho,
                                        guidance_rescale=guidance_rescale,
                                        churn_noise=mine(noise, 1),
                                        generator=gen if edm_churn > 0 else None, **common)
        if sampler == "dpmpp":
            return pipeline.denoise_dpmpp(x_T, classifier_grad=classifier_grad,
                                          classifier_scale=classifier_scale,
                                          guidance_rescale=guidance_rescale,
                                          timestep_spacing=timestep_spacing, **common)
        if encoder_key_every > 1:
            return pipeline.denoise_fast(x_T, eta=eta, encoder_key_every=encoder_key_every,
                                         timestep_spacing=timestep_spacing,
                                         noise=mine(noise, 1), generator=gen, **common)
        return pipeline.denoise(x_T, use_ddim=use_ddim, eta=eta,
                                classifier_grad=classifier_grad,
                                classifier_scale=classifier_scale,
                                guidance_rescale=guidance_rescale,
                                timestep_spacing=timestep_spacing, noise=mine(noise, 2),
                                generator=gen, **common)

    return sample_fn
