"""Per-layer metrics, one reader a file (``<metric>.py``, dots and all): ``read(record)``.

``record`` holds the cell and its configuration, the ``window``, the traced
``stretch`` (:class:`portbench.trace.Stretch`, ``trace_calls`` whole calls),
``forwards`` (the denoiser's forwards in the stretch by ``(mode, rows)``)
and ``work`` (the benchmark's operations and bytes an image). A reader that
finds nothing to read returns None, and the metric is left out of the line.
"""
