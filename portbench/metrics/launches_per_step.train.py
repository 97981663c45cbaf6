"""CUDA kernels launched a train step, counted in the device trace of the traced steps."""

UNIT = "kernels"
LAYER = "train step"
MOVES = "train_images_per_s"


def read(record):
    if record.stretch is None or not record.stretch.kernels:
        return None
    return len(record.stretch.kernels) / record.cell["trace_calls"]
