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

- :func:`layer_norm_reference` — the plain PyTorch chain, op for op. CPU
  tensors and forwards that record a graph take it; the kernel is held to
  it on the card.
- ``LAYER_NORM`` — the kernel object (``flash_attention.CudaKernel``: built
  at first use with ``nvcc`` into ``build/torch_kernels/<source hash>/``,
  ``launches`` counted; ``copies`` counts inputs it had to copy: an ``x``
  not contiguous in its last dimension, or not viewable as rows, and scale
  and shift rows of different strides).

``models/layers.py::layer_norm`` chooses between them: the kernel, which
has no backward, for a CUDA tensor in a forward that records no autograd
graph; the plain chain for every other call, so training keeps its
arithmetic, gradients and launches.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_attention import CudaKernel, _DTYPE_CODES

__all__ = ["LAYER_NORM", "LayerNormKernel", "check_epilogue", "layer_norm_reference"]

_NONE, _AFFINE, _ADALN = 0, 1, 2


def layer_norm_reference(
    x: torch.Tensor, eps: float, *, weight=None, bias=None, shift=None, scale=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, then the affine or AdaLN epilogue, out in ``dtype``."""
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


def _multiple(t: torch.Tensor, dims: int, n: int) -> bool:
    """True if the strides of ``t``'s first ``dims`` dimensions are multiples of ``n`` (size-1 dims aside)."""
    return all(size == 1 or stride % n == 0 for size, stride in zip(t.shape[:dims], t.stride()[:dims]))


class LayerNormKernel(CudaKernel):
    """The kernel: ``x`` fp32 or bf16 ``[..., D]`` → ``dtype`` (fp32 or bf16), contiguous, ``x``'s shape."""

    def __init__(self):
        super().__init__(
            "layer_norm",
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p],
        )

    def _copy(self, x: torch.Tensor) -> torch.Tensor:
        self.copies += 1
        return x.contiguous()

    def __call__(
        self, x: torch.Tensor, eps: float, *, weight=None, bias=None, shift=None, scale=None,
        dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Launch on a CUDA ``x``; raises on anything the kernel does not take."""
        epilogue = check_epilogue(weight, bias, shift, scale)
        device = x.device
        if device.type != "cuda":
            raise ValueError(f"x must be a CUDA tensor, got {device}")
        if x.dtype not in _DTYPE_CODES or dtype not in _DTYPE_CODES:
            raise ValueError(f"x {x.dtype} → {dtype}: the kernel takes float32 or bfloat16 to either")
        if x.ndim == 0:
            raise ValueError("x needs a last dimension to normalise")
        shape, d = x.shape, x.shape[-1]
        if x.stride(-1) != 1 and d > 1:
            x = self._copy(x)
        operands, p_sb = (None, None), 0
        if epilogue == _AFFINE:
            for name, t in (("weight", weight), ("bias", bias)):
                if t.device != device or t.dtype != torch.float32 or t.shape != (d,) or not t.is_contiguous():
                    raise ValueError(
                        f"{name} must be a contiguous float32 [{d}] on {device}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}"
                    )
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
                shift, scale = self._copy(shift), self._copy(scale)
            operands, p_sb = (scale, shift), scale.stride(0) if scale.shape[0] > 1 else 0
        if x.ndim != 3:  # rows [1, N, D]: a view where the leading dims merge
            try:
                x = x.view(1, -1, d)
            except RuntimeError:
                x = self._copy(x).view(1, -1, d)
        b, s, _ = x.shape
        out = torch.empty(shape, dtype=dtype, device=device)
        if out.numel() == 0:
            return out
        ptrs = [t.data_ptr() if t is not None else None for t in (x, out, *operands)]
        # 16-byte chunks: the width, x's strides and every base aligned to them
        vec = 16 // x.element_size()
        vectorized = (
            d % vec == 0 and _multiple(x, 2, vec) and p_sb % vec == 0
            and all(ptr % 16 == 0 for ptr in ptrs if ptr is not None)
        )
        self.build()
        args = (*ptrs, b * s, s, d, *x.stride()[:2], p_sb,
                _DTYPE_CODES[x.dtype], _DTYPE_CODES[dtype], epilogue, int(vectorized), eps)
        if device.index == torch.cuda.current_device():  # the usual case: no device switch
            self._launch(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                self._launch(*args, torch.cuda.current_stream().cuda_stream)
        return out


LAYER_NORM = LayerNormKernel()
