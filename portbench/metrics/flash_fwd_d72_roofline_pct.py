"""The D = 72 flash-attention forward's share of its roofline, in the traced calls.

The operations and bytes are the model's attention at D = 72 from the
benchmark's counts (``4·S²·D·H`` a layer and row, q, k, v, o once in bf16),
for every row the traced calls scored, not the 80 columns the kernel pads
to; the time is the device time of the flash forward kernels, of which only
the D = 72 entry runs in the cells that report this. A program without the
kernel at D = 72 runs none there, and the metric is left out.
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
