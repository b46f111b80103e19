"""The arithmetic of the plain reference: every product (conv, linear,
matmul) in float32 with TF32 off, or, for the control, with its operands
rounded to float8 e4m3 under a per-tensor scale first.

``Precision`` is the object the reference's modules hold; ``F32`` is the
reference proper, ``FP8`` the control (the step below the bf16 that the
configurations state)."""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN, restored
    on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under the scale that maps its largest
    magnitude to e4m3's largest, and back to x's dtype."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()  # the rounded value, the gradient passed straight


@dataclasses.dataclass(frozen=True)
class Precision:
    fp8: bool = False

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.fp8 else x

    def conv(self, x, w, b, stride, padding):
        return F.conv2d(self.operand(x), self.operand(w), b, stride, padding)

    def linear(self, x, w, b):
        return F.linear(self.operand(x), self.operand(w), b)

    def matmul(self, a, b):
        return self.operand(a) @ self.operand(b)


F32 = Precision(fp8=False)
FP8 = Precision(fp8=True)
