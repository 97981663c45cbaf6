"""Fused LayerNorm: the hand-written CUDA kernel for forwards that record no graph, and its plain version.

No TPU kernel stands behind it: the JAX package leaves flax's
``LayerNorm(dtype=float32)``, the cast back to the compute dtype and the
DiT's AdaLN modulation to XLA, which fuses them. Run eagerly, that chain is
about 15 launches a norm; ``csrc/layer_norm.cu`` does it in one pass that
reads the input once and writes the output once, in the compute dtype.

Arithmetic (flax's, as the port computed it before the kernel): fp32
``mean`` and ``E[x²]``, ``var = max(E[x²] − mean², 0)``,
``y = (x − mean)·rsqrt(var + eps)``; then one epilogue:

- none — ``y`` in ``dtype``;
- affine (``weight``, ``bias``: fp32 ``[D]``; the :class:`LayerNorm`
  module) — ``(y·w + b)`` in fp32, then in ``dtype``;
- AdaLN (``shift``, ``scale``: ``[B, D]`` in ``dtype``, one row a sample of
  ``x [B, S, D]``; the DiT) — ``r = y`` in ``dtype``, then
  ``r·(1 + scale) + shift``, each step rounded to ``dtype``.

- :func:`layer_norm` — every LayerNorm of the port (the ``LayerNorm``
  module's affine, the DiT's AdaLN modulation): the span ``norm.layer``,
  then the kernel where ``kernel.takes_kernel`` (a CUDA tensor in a
  forward that records no autograd graph; the kernel has no backward), the
  plain chain for every other call, so training keeps its arithmetic,
  gradients and launches. Each call adds 1 to ``norm.layer.kernel`` or
  ``norm.layer.plain``.
- :func:`layer_norm_reference` — the plain PyTorch chain, op for op. The
  kernel is held to it on the card.
- ``LAYER_NORM`` — the kernel object (``kernel.CudaKernel``; ``copies``
  counts inputs it had to copy: an ``x`` not contiguous in its last
  dimension, or not viewable as rows, and scale and shift rows of
  different strides).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import kernel
from .kernel import DTYPE_CODES, CudaKernel, aligned16, check_vectors

__all__ = ["LAYER_NORM", "LayerNormKernel", "check_epilogue", "layer_norm", "layer_norm_reference"]

_NONE, _AFFINE, _ADALN = 0, 1, 2


def layer_norm_reference(
    x: torch.Tensor, eps: float, *, weight=None, bias=None, shift=None, scale=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, then the affine or AdaLN epilogue, out in ``dtype``."""
    check_epilogue(weight, bias, shift, scale)
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    y = y.to(dtype)
    if scale is not None:
        y = y * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return y


def check_epilogue(weight, bias, shift, scale) -> int:
    """The epilogue the operands name (0 none, 1 affine, 2 AdaLN); raises on an unpaired or mixed set."""
    if (weight is None) != (bias is None) or (shift is None) != (scale is None):
        raise ValueError("weight and bias, and shift and scale, come in pairs")
    if weight is not None and scale is not None:
        raise ValueError("one epilogue: an affine (weight, bias) or an AdaLN (shift, scale)")
    return _AFFINE if weight is not None else _ADALN if scale is not None else _NONE


class LayerNormKernel(CudaKernel):
    """The kernel: ``x`` fp32 or bf16 ``[..., D]`` → ``dtype`` (fp32 or bf16), contiguous, ``x``'s shape."""

    def __init__(self):
        super().__init__(
            "layer_norm",
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p],
        )

    def __call__(
        self, x: torch.Tensor, eps: float, *, weight=None, bias=None, shift=None, scale=None,
        dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Launch on a CUDA ``x``; raises on anything the kernel does not take."""
        epilogue = check_epilogue(weight, bias, shift, scale)
        device = x.device
        if device.type != "cuda":
            raise ValueError(f"x must be a CUDA tensor, got {device}")
        if x.dtype not in DTYPE_CODES or dtype not in DTYPE_CODES:
            raise ValueError(f"x {x.dtype} → {dtype}: the kernel takes float32 or bfloat16 to either")
        if x.ndim == 0:
            raise ValueError("x needs a last dimension to normalise")
        shape, d = x.shape, x.shape[-1]
        if x.stride(-1) != 1 and d > 1:
            x = self.copy(x)
        operands, p_sb = (None, None), 0
        if epilogue == _AFFINE:
            check_vectors(device, d, weight=weight, bias=bias)
            operands = (weight, bias)
        elif epilogue == _ADALN:
            if x.ndim != 3:
                raise ValueError(f"the AdaLN epilogue takes x [B, S, D], got {tuple(x.shape)}")
            for name, t in (("shift", shift), ("scale", scale)):
                if t.device != device or t.dtype != dtype or t.shape != (x.shape[0], d):
                    raise ValueError(
                        f"{name} must be {dtype} [{x.shape[0]}, {d}] on {device}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}"
                    )
            if scale.stride() != shift.stride() or scale.stride(-1) != 1:
                shift, scale = (t if t.is_contiguous() else self.copy(t) for t in (shift, scale))
            operands, p_sb = (scale, shift), scale.stride(0) if scale.shape[0] > 1 else 0
        if x.ndim != 3:  # rows [1, N, D]: a view where the leading dims merge
            try:
                x = x.view(1, -1, d)
            except RuntimeError:
                x = self.copy(x).view(1, -1, d)
        b, s, _ = x.shape
        out = torch.empty(shape, dtype=dtype, device=device)
        if out.numel() == 0:
            return out
        ptrs = [t.data_ptr() if t is not None else None for t in (x, out, *operands)]
        # 16-byte chunks: the width, x's strides and every base aligned to them
        vec = 16 // x.element_size()
        vectorized = (
            d % vec == 0 and aligned16(x, 2) and p_sb % vec == 0
            and all(ptr % 16 == 0 for ptr in ptrs if ptr is not None)
        )
        self.launch(device, *ptrs, b * s, s, d, *x.stride()[:2], p_sb,
                    DTYPE_CODES[x.dtype], DTYPE_CODES[dtype], epilogue, int(vectorized), eps)
        return out


LAYER_NORM = LayerNormKernel()


def layer_norm(
    x: torch.Tensor, eps: float, *, weight=None, bias=None, shift=None, scale=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)`` over the last dim, then an epilogue; ``dtype`` out; the span ``norm.layer``.

    ``weight``/``bias`` (fp32 ``[D]``): ``y·w + b`` in float32, then cast.
    ``shift``/``scale`` (``[B, D]`` in ``dtype``, for ``x [B, S, D]``): the
    DiT's AdaLN modulation ``y·(1 + scale) + shift`` after the cast, in
    ``dtype``. Neither: ``y`` cast. ``LAYER_NORM`` where
    ``kernel.takes_kernel``, :func:`layer_norm_reference` otherwise.
    """
    kw = dict(weight=weight, bias=bias, shift=shift, scale=scale, dtype=dtype)
    with profiling.span("norm.layer"):
        if kernel.takes_kernel(x, weight, bias, shift, scale):
            profiling.count("norm.layer.kernel")
            return LAYER_NORM(x, eps, **kw)
        profiling.count("norm.layer.plain")
        return layer_norm_reference(x, eps, **kw)
