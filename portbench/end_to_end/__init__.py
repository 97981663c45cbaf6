"""End-to-end metrics, one reader a file (``<metric>.py``): ``read(window) -> float``.

``window.calls`` holds ``(start, end, images)`` per call on the host clock,
``window.seconds`` the window's length and ``window.setup_s`` the set-up.
"""
