"""The benchmark's own operation and byte counts, per configuration, from shapes alone.

``counts/<configuration>.py`` gives ``counts(config) -> dict`` of
operations a row (one image under one class at one evaluation) for each
denoiser mode the program runs (``full``, or ``encode`` and ``tail`` where
the prefix is shared), and the attention's operations and bytes a row for
a kernel's roofline. :func:`reference_flops` counts the plain reference's
matrix products with ``FlopCounterMode`` on the ``meta`` device (no memory,
no arithmetic), so the counts say what the work is, whatever computes it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["reference_flops", "meta_params"]


def meta_params(shapes: dict) -> dict:
    return {n: torch.empty(s, device="meta") for n, s in shapes.items()}


def reference_flops(fn, *args) -> int:
    """Floating-point operations (2 a multiply-add) of ``fn(*args)`` on meta tensors."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return int(counter.get_total_flops())
