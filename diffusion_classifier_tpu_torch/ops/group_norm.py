"""Fused GroupNorm: the hand-written CUDA kernel for forwards that record no graph, and its plain version.

No TPU kernel stands behind it: the JAX package's ``group_norm_mxu`` is
plain jnp that XLA fuses with the SiLU after it. Run eagerly, that chain is
about 20 launches a norm and a separate SiLU pass; ``csrc/group_norm.cu``
does it in one pass that reads the input once and writes the output once,
in the input's dtype.

Arithmetic (``group_norm_mxu``'s, as the port computed it before the
kernel), over the channels of ``x [N, ..., C]`` in ``G`` groups of
``cg = C / G``: fp32 sums of ``x`` and of its squares, the squares formed
in ``x.dtype`` (bf16 rounds them); ``var = max(E[x²] − mean², 0)``,
``inv = rsqrt(var + eps)``; per channel ``w = inv·scale`` and
``b = bias − mean·inv·scale`` in fp32, cast to ``x.dtype``; ``y = x·w + b``
in ``x.dtype``; then, with ``silu``, ``F.silu(y)`` (the kernel's quotient
to 2 fp32 ulps, ATen's exact).

- :func:`group_norm` — every GroupNorm of the port (the resnet blocks' norms
  and the UNet's last pass ``silu=True``): the span ``norm.group``, then
  the kernel where ``kernel.takes_kernel`` (a CUDA tensor in a forward that
  records no autograd graph; the kernel has no backward and raises on what
  it cannot take: fp16, or rows that are no whole 16-byte chunks), the
  plain chain and ``F.silu`` for every other call, so training keeps its
  arithmetic, gradients and launches. Each call adds 1 to
  ``norm.group.kernel`` or ``norm.group.plain``.
- :func:`group_norm_reference` — the plain PyTorch chain, op for op. The
  kernel is held to it on the card.
- ``GROUP_NORM`` — the kernel object (``kernel.CudaKernel``; ``copies``
  counts inputs it had to copy: an ``x`` that cannot be viewed as
  ``[N, HW, C]`` rows of contiguous channels at 16-byte aligned strides).
- :func:`tiling` — the kernel's tile for a shape: the channels a block takes
  and the chunks a thread holds.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import kernel
from .kernel import DTYPE_CODES, CudaKernel, aligned16, check_vectors

__all__ = ["GROUP_NORM", "GroupNormKernel", "group_norm", "group_norm_reference", "tiling"]

_THREADS = 256  # a block's threads (kThreads in csrc/group_norm.cu)
_CHUNKS = (2, 4, 8, 16)  # chunks a thread can hold (the kernel's instantiations)
_ROW_BYTES = 32  # the narrowest tile row: one 32-byte sector of device memory
_FILL = 4  # chunks a thread below which a tile widens


def group_norm_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, num_groups: int, eps: float,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm over the channels of ``[N, ..., C]`` in ``group_norm_mxu``'s arithmetic, then ``F.silu`` if ``silu``."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"groups {num_groups} must divide channels {c}")
    cg = c // num_groups
    xg = x.reshape(n, -1, num_groups, cg)
    count = xg.shape[1] * cg
    # squares in x.dtype (bf16 rounds them), sums in float32
    s_g = xg.sum(dim=(1, 3), dtype=torch.float32)
    ss_g = (xg * xg).sum(dim=(1, 3), dtype=torch.float32)
    mean = s_g / count
    var = torch.clamp(ss_g / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)  # [n, c]
    inv_c = inv.repeat_interleave(cg, dim=1)
    w = (inv_c * scale[None, :]).to(x.dtype)
    b = (bias[None, :] - mean_c * inv_c * scale[None, :]).to(x.dtype)
    y = (x.reshape(n, -1, c) * w[:, None, :] + b[:, None, :]).reshape(x.shape)
    return F.silu(y) if silu else y


@functools.lru_cache(maxsize=None)
def tiling(hw: int, channels: int, group_size: int, element_size: int) -> Optional[tuple[int, int]]:
    """``(width, chunks)`` for a sample of ``hw`` rows × ``channels``: a block's tile and a thread's chunks.

    A block takes ``width`` channels of one sample, every row: a multiple
    of ``group_size`` and of the 16-byte chunk that divides ``channels``,
    whose row has ``_ROW_BYTES`` or more where ``channels`` allows. Of
    those, the narrowest whose tile a thread holds in at most 16 chunks,
    widened while a thread would hold fewer than ``_FILL``. ``chunks`` is
    the fewest held chunks a thread (2, 4, 8 or 16) that cover the rows, or
    0 where no tile can be held: the two-pass kernel at the narrowest
    width, which reads the tile twice. None where no width fits a block
    (more than 256 chunks or 256 groups a row).
    """
    vec = 16 // element_size
    unit = math.lcm(group_size, vec)
    widths = [
        w for w in range(unit, channels + 1, unit)
        if channels % w == 0 and w // vec <= _THREADS and w // group_size <= _THREADS
    ]
    widths = [w for w in widths if w * element_size >= _ROW_BYTES] or widths[-1:]
    if not widths:
        return None

    def passes(w: int) -> int:  # rows a thread holds
        return -(-hw // (_THREADS // (w // vec)))

    held = [w for w in widths if passes(w) <= _CHUNKS[-1]]
    if not held:
        return widths[0], 0
    width = held[0]
    for w in held[1:]:
        if hw * (width // vec) >= _FILL * _THREADS:
            break
        width = w
    return width, next(k for k in _CHUNKS if k >= passes(width))


class GroupNormKernel(CudaKernel):
    """The kernel: ``x`` fp32 or bf16 ``[N, ..., C]`` → the same dtype and shape, contiguous."""

    def __init__(self):
        super().__init__(
            "group_norm",
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 + [ctypes.c_int] * 2
            + [ctypes.c_float, ctypes.c_void_p],
        )

    def __call__(
        self, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, num_groups: int, eps: float,
        silu: bool = False,
    ) -> torch.Tensor:
        """Launch on a CUDA ``x``; raises on anything the kernel does not take."""
        if x.ndim < 2:
            raise ValueError(f"x needs a sample and a channel dimension, got {tuple(x.shape)}")
        n, c = x.shape[0], x.shape[-1]
        if c % num_groups:
            raise ValueError(f"groups {num_groups} must divide channels {c}")
        if x.dtype not in DTYPE_CODES:
            raise ValueError(f"x {x.dtype}: the kernel takes float32 or bfloat16")
        vec = 16 // x.element_size()
        if c % vec:
            raise ValueError(f"channels {c}: the kernel takes rows of 16-byte chunks ({vec} {x.dtype})")
        device = x.device
        check_vectors(device, c, scale=scale, bias=bias)
        if device.type != "cuda":
            raise ValueError(f"x must be a CUDA tensor, got {device}")
        out = torch.empty(x.shape, dtype=x.dtype, device=device)
        if out.numel() == 0:
            return out
        try:
            rows = x.view(n, -1, c)
        except RuntimeError:
            rows = None
        if rows is None or (c > 1 and rows.stride(-1) != 1) or not aligned16(rows, 2):
            rows = self.copy(x).view(n, -1, c)
        hw = rows.shape[1]
        tile = tiling(hw, c, c // num_groups, x.element_size())
        if tile is None:
            raise ValueError(f"no tile of [{hw}, {c}] in {num_groups} groups fits a block")
        strides = [0 if size == 1 else stride for size, stride in zip(rows.shape[:2], rows.stride()[:2])]
        self.launch(device, rows.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(), n, hw, c,
                    *strides, c // num_groups, *tile, DTYPE_CODES[x.dtype], int(silu), eps)
        return out


GROUP_NORM = GroupNormKernel()


def group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, num_groups: int, eps: float,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm over the channels of a ``[N, ..., C]`` tensor in ``group_norm_mxu``'s arithmetic, then SiLU if ``silu``.

    The span ``norm.group``, the SiLU inside it: ``GROUP_NORM`` where
    ``kernel.takes_kernel``, :func:`group_norm_reference` otherwise.
    """
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    with profiling.span("norm.group"):
        if kernel.takes_kernel(x, scale, bias):
            profiling.count("norm.group.kernel")
            return GROUP_NORM(x, scale, bias, **kw)
        profiling.count("norm.group.plain")
        return group_norm_reference(x, scale, bias, **kw)
