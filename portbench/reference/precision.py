"""The arithmetic the plain reference computes in: exact fp32, or the fp8 control.

Every matrix product of the reference (linear layers, convolutions,
attention's two products) goes through a :class:`Precision`. ``fp32``
multiplies float32 operands with TF32 off (:func:`exact_fp32`); ``fp8``
rounds both operands to float8 e4m3 with one scale per tensor (its largest
magnitude to 448, the format's largest finite value) and multiplies the
rounded values in float32. Sums, norms, softmax, the schedule and the loss
stay float32 in both. ``fp8`` is the control: the nearest precision below
the bf16 that both configurations state. Under autograd the rounding is
passed straight through, so the control's gradients follow its forward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["Precision", "exact_fp32"]

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block, restored after it."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Precision:
    """Operand rounding for the reference's products: ``"fp32"`` (none) or ``"fp8"`` (e4m3, per tensor)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach() if x.requires_grad else q

    def linear(self, x, w, b=None):
        return F.linear(self.round(x), self.round(w), b)

    def conv(self, x, w, b=None, *, stride: int = 1, padding: int = 0):
        """Convolution of an NHWC tensor with an OIHW weight; NHWC out."""
        y = F.conv2d(self.round(x).permute(0, 3, 1, 2), self.round(w), b, stride, padding)
        return y.permute(0, 2, 3, 1)

    def matmul(self, a, b):
        return torch.matmul(self.round(a), self.round(b))
