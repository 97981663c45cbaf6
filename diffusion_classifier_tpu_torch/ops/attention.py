"""Attention dispatcher over ``[B, S, H, D]`` — port of ``ops/attention.py``.

The backend names are the JAX config's:

- ``"pallas"`` and ``"auto"`` — :class:`.flash_attention.FlashAttention`
  whenever its gate holds: the hand-written CUDA kernels, forward and
  backward, for CUDA tensors; their plain versions for CPU tensors;
- ``"xla"`` and shapes outside the gate — the plain PyTorch forward,
  differentiated by autograd.

The TPU's ``auto`` routing (kernel only at ≥ 256 tokens) was measured on a
TPU and is not carried over: ``auto`` takes the kernels until routing is
measured on the H100 (ROADMAP A2).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_reference, supports

__all__ = ["attention"]


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, backend: str = "xla"
) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, S, H, D]``; output dtype matches ``q``."""
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"Unknown attention backend {backend!r}")
    if backend != "xla" and supports(q, k, v):
        return flash_attention(q, k, v)
    return flash_attention_reference(q, k, v)
