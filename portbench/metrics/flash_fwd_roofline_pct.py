"""The flash-attention forward kernels' share of their roofline, in the traced calls.

The attention's operations and bytes come from the benchmark's counts
(``4·S²·D·H`` a layer and row; q, k, v, o once in bf16), for every row the
traced calls scored; the time is the device time of the kernels named
below. A trace without them has nothing to read.
"""

UNIT = "%"
LAYER = "attention"
MOVES = "classify_images_per_s"

from portbench.peaks import bound_seconds

KERNELS = ("flash_fwd",)


def read(record):
    if record.stretch is None:
        return None
    seconds = record.stretch.kernel_seconds(KERNELS)
    if seconds <= 0 or not record.work.get("attention_flops"):
        return None
    images = record.cell["trace_calls"] * record.cell["batch"]
    bound = bound_seconds(images * record.work["attention_flops"], images * record.work["attention_bytes"])
    return 100.0 * bound / seconds
