"""The 95th percentile of every call's time in the window, host clock, predictions on the host (nearest rank)."""

import math

UNIT = "ms"


def read(window) -> float:
    times = sorted((c1 - c0) * 1e3 for c0, c1, _ in window.calls)
    return times[max(0, math.ceil(0.95 * len(times)) - 1)]
