"""Rows a denoiser forward of the classify tournament carries (the megabatch), from a forward hook on the EMA denoiser."""

UNIT = "rows"
LAYER = "tournament"
MOVES = "classify_images_per_s"


def read(record):
    forwards = sum(record.forwards.values())
    if not forwards:
        return None
    return sum(rows * n for (_, rows), n in record.forwards.items()) / forwards
