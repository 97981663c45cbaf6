"""LZ4-frame decompression through the repository's native decoder — port of ``utils/lz4io.py``.

The `.npy.lz4` MRI volumes of the IPMSA data are LZ4 frames. There is no
``lz4`` wheel to lean on: ``native/lz4dec.cpp`` (the JAX package's
decoder, read here as a source, never edited) is compiled at first use with
``g++ -O3 -fPIC -std=c++17 -shared`` into
``build/torch_native/<hash of source and flags>/liblz4dec.so`` and loaded
with ``ctypes`` (``utils/native.py``). The committed ``native/liblz4dec.so``
and ``make -C native`` are not used: the port builds its own copy where the
build tree lives. A failed build raises; there is no decoder in Python to
fall back to.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from . import native

__all__ = ["decompress", "library_path", "load_npy_lz4", "native_available", "open_npy_lz4"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "lz4dec.cpp")
_LIBRARY = native.Library(SOURCE, "lz4dec")
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
        lib.lz4_frame_decompress.restype = ctypes.c_int
        lib.lz4_frame_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.lz4_frame_content_size.restype = ctypes.c_ulonglong
        lib.lz4_frame_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
        return lib


def native_available() -> bool:
    """True if the decoder builds (or is built) and loads."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False


def decompress(data: bytes) -> bytes:
    """Decompress one LZ4 frame; raises ``ValueError`` on a malformed frame."""
    lib = _load()
    hint = int(lib.lz4_frame_content_size(data, len(data)))
    cap = hint if hint > 0 else max(4 * len(data), 1 << 20)
    while True:
        out = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(0)
        rc = lib.lz4_frame_decompress(data, len(data), out, cap, ctypes.byref(out_len))
        if rc == 0:
            return out.raw[: out_len.value]
        if rc == -2:  # output buffer too small: grow
            cap *= 2
            continue
        raise ValueError(f"lz4 frame decode failed (code {rc})")


def open_npy_lz4(path: str) -> io.BytesIO:
    with open(path, "rb") as f:
        return io.BytesIO(decompress(f.read()))


def load_npy_lz4(path: str) -> np.ndarray:
    """Load a `.npy.lz4` volume."""
    return np.load(open_npy_lz4(path))
