"""Classifier guidance (Dhariwal & Nichol, arXiv:2105.05233 Alg. 2) (port of
``medfusion_tpu/pipelines/diffusion/guidance.py``)."""

from __future__ import annotations

import torch


def make_classifier_grad(classifier_apply, label):
    """The ``classifier_grad(x_t, t)`` callback of the guided samplers:
    d/dx_t sum_b log softmax(logits)[b, label_b], the per-sample score of
    p(y | x_t), where ``classifier_apply(x_t, t)`` gives the logits [B, K]
    (e.g. ``models/unet_openai.py::EncoderUNetOpenAI``) and ``label`` [B]
    holds the integer targets. The samplers run under ``torch.no_grad()``:
    the gradient is taken with grad enabled on a detached leaf copy of
    ``x_t``, and ``torch.autograd.grad`` frees the classifier's graph before
    it returns, so no graph outlives the call."""
    label = torch.as_tensor(label).long()

    def grad_fn(x_t, t):
        with torch.enable_grad():
            x = x_t.detach().requires_grad_(True)
            lp = torch.log_softmax(classifier_apply(x, t).float(), dim=-1)
            logp = lp.gather(-1, label.to(lp.device)[:, None]).sum()
            (grad,) = torch.autograd.grad(logp, x)
        return grad

    return grad_fn
