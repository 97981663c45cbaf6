"""Profiling and timing — port of ``utils/profiling.py``.

- :func:`trace` — a context manager around ``torch.profiler`` with CPU and
  CUDA activities; it writes a Chrome trace
  (``<log_dir>/trace_<pid>_<ns>.pt.trace.json``, with each kernel's device
  time) that Perfetto and PyTorch's TensorBoard profiler plugin load.
- :func:`timed` — runs a function and waits for the device that holds its
  outputs; on a CUDA device the time is read from CUDA events around the
  call, on the CPU from the host clock.
- :class:`StepTimer` — per-step wall times with a mean/p50/p95 summary
  (the same keys as the JAX ``StepTimer``). Where CUDA is in use it waits
  for the card at the start and the end of a step, so a step's time holds
  its device work, not only its launches.
- :func:`span` — a named range at a layer boundary of the program
  (``classify``, ``tournament.group``, ``denoiser.tail``, ``norm.group``,
  ``attention.flash``, ``train.optimizer``, ...). Off by default: it then
  returns one shared no-op context, after one test of a module flag. On,
  inside :func:`trace` or :func:`spans`, it enters
  ``torch.profiler.record_function("dc." + name)``: a ``user_annotation``
  in the Chrome trace, on the profiler's clock, the clock of the device's
  kernels. A call's top span (``classify``, ``train_step``) is named
  ``dc.<name>#<n>``, ``n`` being the call's number in its counter
  (``classify.calls``, ``train.steps``); every span inside its interval
  belongs to that call. Spans are opened on the calling thread only: work
  that autograd launches from its own thread falls, by time, inside the
  span open on the calling thread.
- :func:`count` — always on: adds to a process-wide dict of counters
  (``classify.calls``, ``denoiser.rows.tail``, ``attention.flash``, ...);
  :func:`counters` copies it, :func:`reset_counters` clears it.

The JAX module's ``enable_compilation_cache`` has no counterpart: there is
no XLA program to compile, and the CUDA kernels are built once and cached by
the hash of their sources under ``build/`` (``ops/flash_attention.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.autograd.profiler import record_function
from torch.utils._pytree import tree_leaves

__all__ = ["StepTimer", "count", "counters", "reset_counters", "span", "spans", "timed", "trace"]

SPAN_PREFIX = "dc."

_spans_on = False
_OFF = contextlib.nullcontext()
_counters: dict = {}


def span(name: str, call: int | None = None):
    """``with span("tournament.group"): ...``; ``call`` numbers a call's top span."""
    if not _spans_on:
        return _OFF
    label = SPAN_PREFIX + name if call is None else f"{SPAN_PREFIX}{name}#{call}"
    return record_function(label)


@contextlib.contextmanager
def spans():
    """Spans on for the block (they are off outside it, unless an outer block has them on)."""
    global _spans_on
    before, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = before


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to counter ``name``; returns its new value."""
    value = _counters.get(name, 0) + n
    _counters[name] = value
    return value


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(log_dir) as prof: step(...)``: a Chrome trace of the block in ``log_dir``.

    The program's spans (:func:`span`) are on inside the block. Yields the
    ``torch.profiler.profile`` object (``prof.key_averages()`` for a
    table). The trace's path is ``prof.trace_path`` once the block has
    ended.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    with prof, spans():
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def _on_cuda(result) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(result))


def timed(fn: Callable, *args, **kwargs):
    """Run ``fn`` and wait for its outputs; returns ``(result, seconds)``.

    When an output lies on a CUDA device, the seconds are those of CUDA
    events recorded around the call on the current stream (the host waits
    for the end event); otherwise, the host clock's.
    """
    events = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        events[0].record()
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    if not _on_cuda(result):
        return result, time.perf_counter() - t0
    if events is None:  # the call itself brought CUDA up: no event before it
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0
    events[1].record()
    events[1].synchronize()
    return result, events[0].elapsed_time(events[1]) / 1e3


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates per-step wall times; reports mean/p50/p95 (seconds)."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        _sync()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("start() first")
        _sync()
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }
