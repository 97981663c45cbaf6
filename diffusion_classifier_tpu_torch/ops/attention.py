"""Attention dispatcher over ``[B, S, H, D]`` — port of ``ops/attention.py``.

The backend names are the JAX config's:

- ``"pallas"`` and ``"auto"`` — :class:`.flash_attention.FlashAttention`
  whenever its gate holds: the hand-written CUDA kernels, forward and
  backward, for CUDA tensors; their plain versions for CPU tensors;
- ``"xla"`` and shapes outside the gate — :func:`dot_product_attention`,
  the JAX package's route there (``jax.nn.dot_product_attention``) in the
  same arithmetic, differentiated by autograd.

The TPU's ``auto`` routing (kernel only at ≥ 256 tokens) was measured on a
TPU and is not carried over: ``auto`` takes the kernels until routing is
measured on the H100 (ROADMAP A2).

Each call is a span, ``attention.flash`` or ``attention.plain`` by the route
taken, and adds 1 to the counter of the same name (``utils/profiling.py``);
a flash call also to ``attention.flash.d<D>``, the counter of its head dim.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .flash_attention import flash_attention, supports

__all__ = ["attention", "dot_product_attention"]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over ``[B, S, H, D]``, step for step as XLA's ``jax.nn.dot_product_attention``.

    ``_dot_product_attention_core`` (``jax/_src/nn/functions.py``): logits
    ``q · kᵀ`` in ``promote(dtype, fp32)`` from operands in the input dtype;
    the scale ``1/√D`` applied after the product; softmax in fp32 (fp64
    stays fp64: JAX never runs it, and the parity tests' exact reference
    needs it); the probabilities, normalised, cast to ``v.dtype``; P·V in
    the input dtype. ``flash_attention_reference`` (fp32 products, exp2,
    normalised after P·V) stays the kernels' yardstick.
    """
    b, s, h, d = q.shape
    sk = k.shape[1]
    logits_dtype = torch.promote_types(q.dtype, torch.float32)
    qh = q.transpose(1, 2).reshape(b * h, s, d)
    kh = k.transpose(1, 2).reshape(b * h, sk, d)
    vh = v.transpose(1, 2).reshape(b * h, sk, d)
    # a product of two bf16 values is exact in fp32: the upcast product is
    # XLA's BF16_BF16_F32 dot (bf16 operands, fp32 sums)
    logits = torch.bmm(qh.to(logits_dtype), kh.to(logits_dtype).transpose(1, 2)) * (1.0 / d**0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.bmm(probs, vh)  # [B·H, S, D], in v.dtype
    return out.view(b, h, s, d).transpose(1, 2).to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, backend: str = "xla"
) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, S, H, D]``; output dtype matches ``q``."""
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"Unknown attention backend {backend!r}")
    if backend != "xla" and supports(q, k, v):
        profiling.count("attention.flash")
        profiling.count(f"attention.flash.d{q.shape[-1]}")
        with profiling.span("attention.flash"):
            return flash_attention(q, k, v)
    profiling.count("attention.plain")
    with profiling.span("attention.plain"):
        return dot_product_attention(q, k, v)
