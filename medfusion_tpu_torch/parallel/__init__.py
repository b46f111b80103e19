"""Parallelism (port of ``medfusion_tpu/parallel``): the mixture-of-experts
MLP, run with its experts local to one card. The mesh, sharding, pipeline
and ring-attention modules are ROADMAP Queue 1 item 9."""

from medfusion_tpu_torch.parallel.moe import MoEMLP, moe_capacity

__all__ = ["MoEMLP", "moe_capacity"]
