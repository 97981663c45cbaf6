"""A DiT with a learned Σ (DiT-XL/2's 8 output channels over 4 input channels): the ε half of ``dit``.

The forward is ``dit.forward`` (plain PyTorch, fp32 or the fp8 control),
whose final projection gives ``out_channels`` channels: ε in the first
``in_channels``, the learned Σ after them. The classifier compares the ε
half with the draws' ε, so this returns that half; the parameters are
``dit``'s.
"""

from __future__ import annotations

import torch

from . import dit
from .precision import Precision

__all__ = ["forward", "param_shapes"]

param_shapes = dit.param_shapes


def forward(P: dict, model: dict, z: torch.Tensor, lam: torch.Tensor, labels: torch.Tensor,
            prec: Precision = Precision()) -> torch.Tensor:
    """The ε prediction ``[N, H, W, in_channels]``."""
    return dit.forward(P, model, z, lam, labels, prec)[..., : model["in_channels"]]
