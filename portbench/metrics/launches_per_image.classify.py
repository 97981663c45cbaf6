"""CUDA kernels launched an image classified, counted in the device trace of the traced calls."""

UNIT = "kernels"
LAYER = "denoiser and backbone"
MOVES = "classify_images_per_s"


def read(record):
    if record.stretch is None or not record.stretch.kernels:
        return None
    return len(record.stretch.kernels) / (record.cell["trace_calls"] * record.cell["batch"])
