"""Decoded-image disk cache for the JPEG pipelines — the port's copy of ``data/decode_cache.py``.

The first epoch pays the decode (optionally the reduced-scale
``fast_decode``) and writes the resized uint8 RGB array to a cache
directory; later epochs read ~0.2 MB an image (256 px) from disk instead of
running libjpeg again. CheXpert's sources are ~2,000-2,800 px, so the
decode, not the device, can hold a train step.

The key hashes the source's absolute path with its stat (mtime_ns, size),
the target size and the fast flag, as the JAX module's does, so both
packages find each other's entries. A touched or replaced source misses and
is decoded again; stale entries are never served. Writes are atomic (a
temporary file, then ``os.replace``), so threads and processes sharing the
directory race benignly.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

__all__ = ["DecodeCache"]


class DecodeCache:
    """``get_or_decode(path) -> uint8 [size, size, 3]`` with a disk cache."""

    def __init__(self, cache_dir: str, size: int, *, fast: bool = False):
        self.cache_dir = cache_dir
        self.size = int(size)
        self.fast = bool(fast)
        os.makedirs(cache_dir, exist_ok=True)

    def _entry_path(self, path: str) -> str:
        """The cache file for the source ``path`` as it is now on disk."""
        st = os.stat(path)
        key = hashlib.sha1(
            f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|"
            f"{self.size}|{int(self.fast)}".encode()
        ).hexdigest()
        return os.path.join(self.cache_dir, key + ".npy")

    def get_or_decode(self, path: str) -> np.ndarray:
        entry = self._entry_path(path)
        try:
            arr = np.load(entry)
            if arr.shape == (self.size, self.size, 3):
                return arr
        except (FileNotFoundError, ValueError, EOFError, OSError):
            pass  # a miss or a truncated entry: decode
        from .loader import decode_image

        arr = np.asarray(decode_image(path, self.size, fast=self.fast), np.uint8)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, entry)  # readers never see a partial file
        except OSError:
            # a failed cache write (disk full, permissions) must not fail the epoch
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return arr
