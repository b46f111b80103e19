"""What each hand-written kernel's call asks of the card, from the shapes
that the plain reference's calls present (``reference/model.py::Probe``):
FLOPs, exponentials and bytes at the kernel's boundary, each input read
once and each output written once, in the compute dtype's bytes.

* GroupNorm (+SiLU): x and the affine read, y written; no FLOPs bound it.
* Attention forward: 4 N M d FLOPs a head (q k^T and p v), N M
  exponentials a head, q, k, v read and o written.
* Attention backward: 8 N M d FLOPs a head (dp, ds, dq, dk, dv: four
  products of the same size as the forward's two), q, k, v, o and do read,
  dq, dk and dv written; no exponential is asked for (p is the forward's).
* GEGLU MLP: 6 M C F FLOPs (x W1 [C, 2F] and g W2 [F, C]), x, the
  LayerNorm affine, W1, b1, W2, b2 read and the output written.

``kind_of`` names a device kernel's kind, copied from
``chip_smoke.py::kind_of``, with NCCL's kernels apart."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from port_bench.count.peaks import bound_s


def work(kind: str, shape: dict, elt: int) -> Dict[str, float]:
    """{'flops', 'exps', 'bytes'} of one call of ``kind`` at ``shape``."""
    if kind == "group_norm":
        return {"flops": 0.0, "exps": 0.0,
                "bytes": (2 * shape["numel"] + 2 * shape["channels"]) * elt}
    if kind in ("attention", "attention_bwd"):
        b, h, n, m, d = (shape[k] for k in ("b", "heads", "n", "m", "d"))
        tokens = b * h * d
        if kind == "attention":
            return {"flops": 4.0 * b * h * n * m * d, "exps": float(b * h * n * m),
                    "bytes": (2 * n * tokens + 2 * m * tokens) * elt}
        return {"flops": 8.0 * b * h * n * m * d, "exps": 0.0,
                "bytes": (4 * n * tokens + 4 * m * tokens) * elt}
    if kind == "geglu":
        rows, c, f = shape["rows"], shape["c"], shape["f"]
        return {"flops": 6.0 * rows * c * f, "exps": 0.0,
                "bytes": (2 * rows * c + 3 * c * f + 2 * f + 3 * c) * elt}
    raise ValueError(f"no work count for kernel kind {kind!r}")


def bound_seconds(calls: Iterable[Tuple[str, dict]], elt: int, kinds=None) -> Dict[str, float]:
    """Kind -> the summed bound of ``calls`` [(kind, shape)] of the kinds in
    ``kinds`` (every kind where None); each call bounded on its own."""
    out: Dict[str, float] = {}
    for kind, shape in calls:
        if kinds is not None and kind not in kinds:
            continue
        w = work(kind, shape, elt)
        out[kind] = out.get(kind, 0.0) + bound_s(w["flops"], w["bytes"], w["exps"])
    return out


def kind_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "nccl" in name:
        return "nccl"
    if "gn_block_kernel" in name or "gn_cluster_kernel" in name:
        return "group_norm"
    if "flash_fwd" in name:
        return "attention"
    if "flash_bwd" in name:
        return "attention_bwd"
    if "adam" in name or "multi_tensor_apply" in name or "foreach" in name:
        return "optimizer"
    if "geglu_" in name:
        return "geglu"
    if any(k in name for k in ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                               "fprop", "nchwtonhwc", "nhwctonchw", "fft", "complex",
                               "cf32")):
        return "conv"
    if any(k in name for k in ("gemm", "xmma", "cutlass", "gemv", "sm90_", "nvjet")):
        return "matmul"
    return "other"
