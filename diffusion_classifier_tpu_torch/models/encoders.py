"""Prompt/condition encoders — port of ``models/encoders.py``.

- ``encoder_type='nn'``: :class:`ClassEmbedder`, a learnable
  ``Embed(classes + 1, dim)`` with the null token at ``classes``, giving a
  one-token context ``[B, 1, dim]`` for the UNet's cross-attention.
- ``encoder_type='DiT'`` (or None): integer labels go straight to the
  backbone, which owns its label table (null token = ``classes``).
- ``encoder_type='t5'`` needs a frozen T5 encoder's class table, whose
  weights this repository does not carry: it raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ClassEmbedder", "null_token", "make_encoder"]


def null_token(num_classes: int) -> int:
    """The CFG null-condition token id."""
    return num_classes


class ClassEmbedder(nn.Module):
    """``encoder_type='nn'``: labels → ``[B, 1, dim]`` in ``dtype`` (flax ``nn.Embed(dtype=...)``)."""

    def __init__(self, num_classes: int, embedding_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Embedding(num_classes + 1, embedding_dim)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        table = self.embedding.weight.to(self.dtype)
        return F.embedding(labels.to(torch.long), table)[:, None, :]


def make_encoder(
    encoder_type: Optional[str],
    *,
    num_classes: int,
    embedding_dim: Optional[int] = None,
    dtype=torch.float32,
):
    """``(encoder_module_or_None, null_token_id)`` for ``encoder_type``."""
    if encoder_type == "nn":
        if embedding_dim is None:
            raise ValueError("encoder_type='nn' needs embedding_dim (the backbone's encoder_hid_dim)")
        return ClassEmbedder(num_classes, embedding_dim, dtype), null_token(num_classes)
    if encoder_type in ("DiT", None):
        return None, null_token(num_classes)
    if encoder_type == "t5":
        raise NotImplementedError(
            "encoder_type='t5' needs a frozen T5 encoder's class table, whose weights "
            "this repository does not carry (ROADMAP A3)"
        )
    raise ValueError(f"Unknown encoder_type {encoder_type!r}")
