"""The port's hand-written CUDA kernels: one object per ``csrc/<name>.cu`` entry point, and the rule for when a call takes one.

- :class:`CudaKernel` — a C entry point of ``csrc/<name>.cu``, built with
  ``nvcc`` at its first launch (``utils/native.py``: into
  ``build/torch_kernels/<hash>/``) and bound with ``ctypes``.
  :meth:`~CudaKernel.launch` runs it on the current stream; ``launches``
  counts its launches and ``copies`` the inputs its wrapper had to copy
  (:meth:`~CudaKernel.copy`).
- :data:`DTYPE_CODES` — the dtype code every entry point takes.
- :func:`aligned16` — the 16-byte base and stride test of the vectorised
  and TMA loads; :func:`check_vectors` — the fp32 ``[C]`` parameter check.
- :func:`takes_kernel` — the one rule: a CUDA tensor in a forward that
  records no autograd graph takes the kernel (they have no backward but
  attention's), every other call the plain version. ``ops/layer_norm.py``
  and ``ops/group_norm.py`` route on it; attention's D = 72 gate
  (``flash_attention.supports``) on :func:`records_graph`.

Each op module keeps what is its own: the plain version, the marshalling of
its arguments into its entry point's, and its kernel object.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..utils import native

__all__ = [
    "CudaKernel", "DTYPE_CODES", "ENCODE_ERROR", "aligned16", "check_vectors", "launch_error",
    "records_graph", "takes_kernel",
]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: a C entry point's return at or above this is a tensor-map encode that
#: failed: this plus its CUresult (``kEncodeError`` in csrc/flash_sm90.cuh)
ENCODE_ERROR = 100000


def records_graph(*tensors: "torch.Tensor | None") -> bool:
    """True if autograd records a graph through any of ``tensors`` (None entries aside)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes_kernel(x: torch.Tensor, *params: "torch.Tensor | None") -> bool:
    """True where an op launches its kernel: a CUDA ``x`` in a forward that records no graph through ``x`` or ``params``."""
    return x.is_cuda and not records_graph(x, *params)


def aligned16(x: torch.Tensor, dims: int) -> bool:
    """True if ``x``'s base and the byte strides of its first ``dims`` dimensions are multiples of 16.

    The stride of a dimension of size 1 is never used, so it is not tested.
    """
    if x.data_ptr() % 16:
        return False
    n = x.element_size()
    for size, stride in zip(x.shape[:dims], x.stride()[:dims]):  # a loop: the wrappers' host time
        if size != 1 and stride * n % 16:
            return False
    return True


def check_vectors(device: torch.device, channels: int, **params: torch.Tensor) -> None:
    """Raise unless each of ``params`` is a contiguous float32 ``[channels]`` on ``device``."""
    for name, t in params.items():
        if t.device != device or t.dtype != torch.float32 or t.shape != (channels,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 [{channels}] on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def launch_error(name: str, code: int) -> str:
    """The message for a C entry point's nonzero return: a launch's ``cudaError_t`` or an encode's ``CUresult``."""
    if code >= ENCODE_ERROR:
        return f"{name}: cuTensorMapEncodeTiled failed with CUresult {code - ENCODE_ERROR}"
    return f"{name} launch failed: cudaError {code}"


class CudaKernel(native.Library):
    """The C entry point ``name`` of ``csrc/<name>.cu``: ``argtypes`` end with the stream, which :meth:`launch` appends."""

    def __init__(self, name: str, argtypes: list):
        super().__init__(os.path.join(_CSRC, f"{name}.cu"), name)
        self.launches = 0
        self.copies = 0
        self._argtypes = argtypes
        self._fn = None

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` copied into a new contiguous tensor (16-byte aligned: the allocator's), counted in ``copies``."""
        self.copies += 1
        return torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)

    def launch(self, device: torch.device, *args) -> None:
        """Run the entry point on ``device``'s current stream, built and bound at the first launch; raises on a nonzero return."""
        fn = self._fn
        if fn is None:
            fn = getattr(self.load(), self.name)
            fn.argtypes, fn.restype = self._argtypes, ctypes.c_int
            self._fn = fn
        if device.index == torch.cuda.current_device():  # the usual case: no device switch
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(launch_error(self.name, err))
        self.launches += 1
