"""The share of the traced classify calls' wall in which no kernel, copy or memset ran on the device."""

UNIT = "%"
LAYER = "device"
MOVES = "classify_images_per_s"


def read(record):
    if record.stretch is None or record.stretch.wall_s <= 0:
        return None
    return 100.0 * (1.0 - record.stretch.busy_s / record.stretch.wall_s)
