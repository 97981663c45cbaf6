"""The whole classify path's model operations over the window's time, as a share of the H100's bf16 peak.

Operations from the benchmark's counts (the reference's products, counted
on the meta device) for every image of the window; the window's time is
the host's, every call included.
"""

UNIT = "%"
LAYER = "classify call"
MOVES = "classify_images_per_s"

from portbench.peaks import BF16_FLOPS


def read(record):
    images = sum(n for _, _, n in record.window.calls)
    return 100.0 * images * record.work["flops"] / record.window.seconds / BF16_FLOPS
