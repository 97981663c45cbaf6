"""Images stepped in the window over the window's time, up to the final synchronisation."""

UNIT = "images/s"


def read(window) -> float:
    return sum(images for _, _, images in window.calls) / window.seconds
