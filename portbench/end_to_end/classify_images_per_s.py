"""Images classified in the window over the window's time (every call's images, every second)."""

UNIT = "images/s"


def read(window) -> float:
    return sum(images for _, _, images in window.calls) / window.seconds
