"""Zstandard decompression through the port's own decoder (``csrc/zstd_dec.cpp``).

The JAX package's Orbax checkpoints store their OCDBT nodes and zarr chunks
as zstd frames, and the machines the port runs on need no zstd package: the
RFC 8878 decoder in ``csrc/zstd_dec.cpp`` is compiled at first use with
``g++ -O3 -fPIC -std=c++17 -shared`` into
``build/torch_native/<hash of source and flags>/libzstddec.so`` and loaded
with ``ctypes`` (``utils/native.py``), as ``utils/lz4io.py`` builds its
decoder. A failed build raises; there is no decoder in Python to fall back
to.

- :func:`decompress` returns the content of every frame in ``data`` as bytes;
- :func:`decompress_into` writes it into a preallocated numpy array or CPU
  torch tensor and returns the number of bytes written, so a checkpoint leaf
  is decoded into its final buffer with no copy through Python bytes;
- :func:`crc32c` is the CRC-32C (Castagnoli) that closes every OCDBT file.

A malformed or truncated frame, a dictionary, a skippable frame or a content
checksum that does not match raises ``ValueError`` with the decoder's reason.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from . import native

__all__ = ["crc32c", "decompress", "decompress_into", "library_path"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "diffusion_classifier_tpu_torch", "csrc", "zstd_dec.cpp")
_LIBRARY = native.Library(SOURCE, "zstddec")
_DST_TOO_SMALL = -2
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    """Where this source, built with these flags, lives: a new source or flag builds anew."""
    return _LIBRARY.path()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _LIBRARY.load()
        lib.zstd_decompress.restype = ctypes.c_int
        lib.zstd_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.zstd_frame_sizes.restype = ctypes.c_int
        lib.zstd_frame_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_ulonglong),
        ]
        lib.zstd_last_error.restype = ctypes.c_char_p
        lib.zstd_last_error.argtypes = []
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
        return lib


def _source(data) -> np.ndarray:
    """``data`` (bytes, bytearray, memoryview, numpy) as a 1-D uint8 array over the same memory."""
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if arr.dtype != np.uint8 or arr.ndim != 1 or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return arr


def _error(lib, code: int) -> ValueError:
    return ValueError(f"zstd decode failed (code {code}): {lib.zstd_last_error().decode()}")


def _decode(lib, src: np.ndarray, address: int, capacity: int) -> int:
    written = ctypes.c_size_t(0)
    rc = lib.zstd_decompress(src.ctypes.data, src.size, address, capacity, ctypes.byref(written))
    if rc == _DST_TOO_SMALL:
        raise ValueError(f"zstd content does not fit the {capacity}-byte output")
    if rc != 0:
        raise _error(lib, rc)
    return written.value


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data``, back to back."""
    lib = _load()
    src = _source(data)
    size, bound = ctypes.c_longlong(0), ctypes.c_ulonglong(0)
    rc = lib.zstd_frame_sizes(src.ctypes.data, src.size, ctypes.byref(size), ctypes.byref(bound))
    if rc != 0:
        raise _error(lib, rc)
    capacity = size.value if size.value >= 0 else bound.value  # the bound needs no retry
    out = np.empty(capacity, np.uint8)
    n = _decode(lib, src, out.ctypes.data, capacity)
    return out[:n].tobytes()


def decompress_into(data, out) -> int:
    """Decode ``data`` into ``out`` (a C-contiguous numpy array or CPU torch tensor); returns bytes written.

    Raises ``ValueError`` when the content is larger than ``out``.
    """
    lib = _load()
    src = _source(data)
    if isinstance(out, np.ndarray):
        if not out.flags.c_contiguous or not out.flags.writeable:
            raise ValueError("decompress_into needs a writeable C-contiguous array")
        address, capacity = out.ctypes.data, out.nbytes
    else:  # a torch tensor
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("decompress_into needs a contiguous CPU tensor")
        address, capacity = out.data_ptr(), out.numel() * out.element_size()
    return _decode(lib, src, address, capacity)


def crc32c(data) -> int:
    """CRC-32C of ``data``."""
    src = _source(data)
    return int(_load().crc32c(src.ctypes.data, src.size))
