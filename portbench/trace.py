"""The traced stretch: ``torch.profiler`` over a few whole calls, read back from its Chrome trace.

The profiler records the device's kernels, copies and memsets and, when
asked, the host's operations, on one clock. :func:`profiled` runs a
stretch of whole calls under it twice, each between two synchronisations:
once tracing the device alone, which gives a :class:`Stretch`'s wall (the
span of its device events), busy time (their union) and kernels by name;
once tracing the host too, inside one ``portbench.stretch`` range, which
gives the device's idle gaps by what the host was doing when each began
(the innermost host operation open at that moment). Each trace goes to a
fixed file in the checkout and is deleted once read.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import warnings
from collections import defaultdict

import torch

__all__ = ["Stretch", "profiled", "read_trace"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
RANGE = "portbench.stretch"
NAME_CHARS = 120


@dataclasses.dataclass
class Stretch:
    wall_s: float
    busy_s: float
    kernels: list  # (name, start_us, dur_us), kernels only
    device_ops: list  # [name, seconds], most time first
    idle_gaps: list  # [host operation, seconds], most time first

    def kernel_seconds(self, words) -> float:
        """Seconds of the kernels whose name holds any of ``words``."""
        return sum(d for n, _, d in self.kernels if any(w in n for w in words)) / 1e6


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def _device(spans, w0=None, w1=None):
    """Device intervals ``(start, end, name, cat)`` clipped to ``[w0, w1]`` (default: their own span)."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["cat"])
           for e in spans if e.get("cat") in DEVICE_CATS]
    if w0 is None:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    clipped = [(max(s, w0), min(t, w1), n, c) for s, t, n, c in dev]
    return [d for d in clipped if d[1] > d[0]], w0, w1


def read_trace(device_path: str, host_path: str) -> Stretch:
    """The stretch from a device-only trace (times, kernels) and a host-and-device one (idle gaps)."""
    spans = _events(device_path)
    device, w0, w1 = _device(spans)
    kernels = [(n, s, t - s) for s, t, n, c in device if c == "kernel"]
    busy_us, _ = _union([(s, t) for s, t, _, _ in device])
    by_name = defaultdict(float)
    for s, t, name, _ in device:
        by_name[name[:NAME_CHARS]] += (t - s) / 1e6
    device_ops = sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:10]
    return Stretch((w1 - w0) / 1e6, busy_us / 1e6, kernels, device_ops, _idle_gaps(_events(host_path)))


def _idle_gaps(spans) -> list:
    """The device's idle time inside the ``portbench.stretch`` range, by the host operation open when each gap began."""
    ranges = [e for e in spans if e.get("name") == RANGE and e.get("cat") == "user_annotation"]
    if not ranges:
        raise RuntimeError(f"the trace has no {RANGE} range")
    r0 = float(ranges[0]["ts"])
    r1 = r0 + float(ranges[0]["dur"])
    device, _, _ = _device(spans, r0, r1)
    _, merged = _union([(s, t) for s, t, _, _ in device])
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in spans if e.get("cat") in HOST_CATS and e.get("name") != RANGE
    )
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [r0] + [x for m in merged for x in m] + [r1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        what = "host: no traced operation"
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= a:
                what = host[j][2][:NAME_CHARS]
                break
        gaps[what] += (b - a) / 1e6
    return sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:10]


def _profile(run, path: str, activities) -> None:
    from torch.profiler import profile, record_function

    torch.cuda.synchronize()
    with warnings.catch_warnings():  # the profiler's note on clearing events at each cycle's end
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=activities) as prof:
            with record_function(RANGE):
                run()
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)


def profiled(run, path: str) -> Stretch:
    """Trace ``run()`` (whole calls) twice: device only, then host and device; the stretch read from both.

    The device-only trace gives the times: the host's operations are not
    recorded there, which would slow a host-bound path several-fold. Its
    wall is the span of its device events, from the first call's upload
    to the last call's results. The second trace attributes the idle gaps.
    """
    from torch.profiler import ProfilerActivity

    os.makedirs(os.path.dirname(path), exist_ok=True)
    host_path = path.replace(".json", ".host.json")
    try:
        _profile(run, path, [ProfilerActivity.CUDA])
        _profile(run, host_path, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        return read_trace(path, host_path)
    finally:
        for p in (path, host_path):
            if os.path.exists(p):
                os.remove(p)
