"""Process start to the window's start: imports, the CUDA context, weights, kernel builds, warm-up."""

UNIT = "s"


def read(window) -> float:
    return window.setup_s
