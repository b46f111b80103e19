"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit) and the least time a piece of work can take on it.

``bound_s`` is ``chip_smoke.py::bounds`` as a yardstick: the larger of the
time to do the FLOPs at the bf16 tensor peak, to compute the exponentials
at the SFU's rate, and to move the bytes at the HBM rate."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        # 16 exponentials a clock on each of 132 SMs at the 1,980 MHz maximum
        "exp_per_s": 16 * 132 * 1.980e9,
    },
}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def bound_s(flops: float = 0.0, nbytes: float = 0.0, exps: float = 0.0,
            peaks: dict = H100) -> float:
    """The card's least seconds for the work."""
    return max(flops / peaks["bf16_flops_per_s"], exps / peaks["exp_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
