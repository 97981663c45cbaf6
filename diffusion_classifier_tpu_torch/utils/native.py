"""Native libraries built from the repository's sources at first use: the port's one compile-and-cache path.

A :class:`Library` is one source and the ``ctypes`` library built from it:

- C++ (``.cpp``) with ``g++ -O3 -fPIC -std=c++17 -shared`` into
  ``build/torch_native/`` — the host decoders of ``utils/lz4io.py`` and
  ``utils/zstd.py``;
- CUDA (``.cu``) with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
  ``build/torch_kernels/`` — the kernels of ``ops/`` (``ops/kernel.py``).

Each lands in ``<root>/<hash of flags, source and the headers beside
it>/lib<name>.so``: an edited source, header or flag builds anew, and a
concurrent build wins or loses whole (compiled to a temporary file, then
``os.replace``). :func:`build_all` runs one compiler per source, all started
together. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ["Library", "build_all", "find"]

_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build")
# by source suffix: the compiler, its build root, its flags, and the suffix of the headers it hashes
_TOOLCHAINS = {
    ".cpp": ("g++", "torch_native", ("-O3", "-fPIC", "-std=c++17", "-shared"), ".h"),
    ".cu": ("nvcc", "torch_kernels", (
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    ), ".cuh"),
}


def find(tool: str) -> str:
    """``tool``'s path: ``g++`` on ``$PATH``; a CUDA tool (``nvcc``, ``cuobjdump``) in ``$CUDA_HOME/bin`` (or ``$CUDA_PATH/bin``), on ``$PATH``, or in ``/usr/local/cuda/bin``."""
    if tool == "g++":
        places, hint = (shutil.which(tool),), f"put {tool} on PATH"
    else:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
        places = (
            os.path.join(home, "bin", tool) if home else None,
            shutil.which(tool),
            os.path.join("/usr/local/cuda/bin", tool),
        )
        hint = f"set CUDA_HOME or put {tool} on PATH"
    for cand in places:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{tool} not found ({hint}): the port builds its native libraries from source at first use")


class Library:
    """One source: built at first :meth:`load` (or by :func:`build_all`), loaded once with ``ctypes``."""

    def __init__(self, source: str, name: str):
        self.source = source
        self.name = name
        self.build_log = ""  # the compiler's output, where this process built the library
        self._lib = None

    def path(self) -> str:
        """``<root>/<hash>/lib<name>.so``, hashed over the flags, the source and the headers in its folder."""
        _, root, flags, header = _TOOLCHAINS[os.path.splitext(self.source)[1]]
        digest = hashlib.sha256(" ".join(flags).encode())
        folder = os.path.dirname(self.source)
        headers = sorted(n for n in os.listdir(folder) if n.endswith(header))
        for path in (self.source, *(os.path.join(folder, n) for n in headers)):
            with open(path, "rb") as f:
                digest.update(f.read())
        return os.path.join(_BUILD, root, digest.hexdigest()[:16], f"lib{self.name}.so")

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first unless this source, its headers and flags have one."""
        if self._lib is None:
            build_all(self)
        return self._lib


def build_all(*libraries: Library) -> float:
    """Build and load ``libraries``, one compiler each, all started together; returns seconds spent."""
    start = time.perf_counter()
    paths = {lib: lib.path() for lib in libraries if lib._lib is None}
    jobs = {}  # library -> (compiler process, temporary file)
    try:
        for lib, path in paths.items():
            if os.path.isfile(path):
                continue
            tool, _, flags, _ = _TOOLCHAINS[os.path.splitext(lib.source)[1]]
            compiler = find(tool)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
            os.close(fd)
            jobs[lib] = subprocess.Popen(
                [compiler, *flags, "-o", tmp, lib.source],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp
        for lib, path in paths.items():
            if lib in jobs:
                proc, tmp = jobs[lib]
                lib.build_log, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{os.path.basename(proc.args[0])} failed on {lib.source} ({proc.returncode}):\n{lib.build_log}"
                    )
                os.replace(tmp, path)  # atomic: a concurrent build wins or loses whole
            lib._lib = ctypes.CDLL(path)
    finally:  # after a failure, stop the other compilers and drop their partial files
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return time.perf_counter() - start
