"""Prompt/condition encoders — port of ``models/encoders.py``.

- ``encoder_type='nn'``: :class:`ClassEmbedder`, a learnable
  ``Embed(classes + 1, dim)`` with the null token at ``classes``, giving a
  one-token context ``[B, 1, dim]`` for the UNet's cross-attention.
- ``encoder_type='DiT'`` (or None): integer labels go straight to the
  backbone, which owns its label table (null token = ``classes``).
- ``encoder_type='t5'``: :class:`FrozenTableEncoder` over a ``[C+1, S, D]``
  table of class-name embeddings that a frozen T5 encoder computed once
  (:func:`build_t5_class_table`, or a saved ``.npy``); the last row is the
  null condition. The labels pick rows: a context ``[B, S, D]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ClassEmbedder",
    "FrozenTableEncoder",
    "build_t5_class_table",
    "make_encoder",
    "null_token",
]


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


class FrozenTableEncoder(nn.Module):
    """``encoder_type='t5'``: labels → ``table[labels]`` in ``dtype``, a ``[B, S, D]`` context.

    The table is a non-persistent buffer: it moves with the module but is no
    parameter, so neither the optimizer nor the EMA touches it and no
    checkpoint holds it (the JAX module bakes it into its programs as a
    constant; both rebuild it from the config).
    """

    def __init__(self, table, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer(
            "table", torch.tensor(np.asarray(table, np.float32)), persistent=False
        )

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.table.to(self.dtype)[labels.to(torch.long)]


@torch.no_grad()
def build_t5_class_table(
    class_names,
    *,
    model=None,
    model_path: str = "t5-base",
    max_length: int = 8,
    tokenize_fn=None,
    null_text: str = "",
) -> np.ndarray:
    """The ``[C+1, S, D]`` float32 table of class-name embeddings from a frozen T5 encoder.

    ``model`` is a ready torch ``transformers.T5EncoderModel``; otherwise one
    is loaded from ``model_path`` (a local directory where there is no
    network). ``tokenize_fn(texts, max_length)`` replaces the HF tokenizer;
    it returns int ids or an ``(ids, attention_mask)`` pair (bare ids mask
    ``ids != 0``, T5's pad id). The texts are the class names and then
    ``null_text``, whose row is the null condition. ``transformers`` is
    imported here only: serving from a saved table needs none of it.
    """
    if model is None or tokenize_fn is None:
        import transformers
    if model is None:
        model = transformers.T5EncoderModel.from_pretrained(model_path)
    texts = list(class_names) + [null_text]
    if tokenize_fn is not None:
        out = tokenize_fn(texts, max_length)
    else:
        tokens = transformers.AutoTokenizer.from_pretrained(model_path)(
            texts, return_tensors="np", padding="max_length", truncation=True,
            max_length=max_length,
        )
        out = tokens["input_ids"], tokens["attention_mask"]
    ids, mask = out if isinstance(out, tuple) else (out, np.asarray(out) != 0)
    # a copy: the fix-up below must never write into the caller's mask
    mask = np.array(mask, dtype=np.int64)
    # an all-pad row (an empty null_text under a stub tokenizer) keeps one
    # attended position, as the HF tokenizer's EOS always gives one
    mask[mask.sum(axis=-1) == 0, 0] = 1
    # the mask keeps pad tokens out of every class embedding
    device = next(model.parameters()).device
    hidden = model.eval()(
        input_ids=torch.as_tensor(np.asarray(ids, np.int64), device=device),
        attention_mask=torch.as_tensor(mask, device=device),
    ).last_hidden_state
    return hidden.float().cpu().numpy()


def make_encoder(
    encoder_type: Optional[str],
    *,
    num_classes: int,
    embedding_dim: Optional[int] = None,
    dtype=torch.float32,
    t5_table=None,
):
    """``(encoder_module_or_None, null_token_id)`` for ``encoder_type``.

    ``'t5'`` needs ``t5_table``, a ``[num_classes + 1, S, D]`` array from
    :func:`build_t5_class_table` (or its saved ``.npy``).
    """
    if encoder_type == "nn":
        if embedding_dim is None:
            raise ValueError("encoder_type='nn' needs embedding_dim (the backbone's encoder_hid_dim)")
        return ClassEmbedder(num_classes, embedding_dim, dtype), null_token(num_classes)
    if encoder_type in ("DiT", None):
        return None, null_token(num_classes)
    if encoder_type == "t5":
        if t5_table is None:
            raise ValueError(
                "encoder_type='t5' needs a precomputed class-embedding table "
                "(build_t5_class_table, or config.t5_table_path)"
            )
        shape = tuple(np.shape(t5_table))
        if len(shape) != 3 or shape[0] != num_classes + 1:
            raise ValueError(
                f"the t5 table must be [classes + 1, seq, dim] = [{num_classes + 1}, S, D], got {shape}"
            )
        return FrozenTableEncoder(t5_table, dtype), null_token(num_classes)
    raise ValueError(f"Unknown encoder_type {encoder_type!r}")
