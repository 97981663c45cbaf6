"""Conditional denoiser: backbone + prompt encoder — port of ``engine/denoiser.py``.

The call signature is ``(z_t, logsnr_t, labels)`` with integer labels (null
token = ``num_classes``). With an encoder the labels become the backbone's
context tokens; without one they go to the backbone as they are (the DiT's
own label table).

``mode`` mirrors the UNet's prefix split (:func:`supports_prefix`):

- ``'full'`` — the ordinary forward (every backbone);
- ``'encode'`` — the condition-free prefix; labels are ignored;
- ``'tail'`` — encodes the labels and runs the backbone's conditioned
  remainder from ``prefix_state``.

A backbone with more output channels than input channels (DiT-XL/2's
learned Σ: ε in the first ``in_channels``, Σ after them) hands on the ε
half: every mode that predicts returns the first ``in_channels`` channels
as a view of the backbone's output, no copy, so the classifier, the
sampler and the loss compare it with ε as they compare any prediction.
Training the Σ half (DiT's variational-bound term) is not part of the
port. Where the counts are equal the output is the backbone's own.

``deterministic`` goes to the backbone in every mode (False turns the UNet's
dropout on). It defaults to True, and the loss, the classifier and the
sampler never pass it, as in the JAX engine.

A forward is the span ``denoiser.<mode>`` and adds to the counters
``denoiser.forwards.<mode>`` (1) and ``denoiser.rows.<mode>`` (its rows)
(``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils import profiling

__all__ = ["Denoiser", "supports_prefix"]

# mode -> (span, forwards counter, rows counter)
_NAMES = {
    m: (f"denoiser.{m}", f"denoiser.forwards.{m}", f"denoiser.rows.{m}") for m in ("full", "encode", "tail")
}


class Denoiser(nn.Module):
    def __init__(self, backbone: nn.Module, encoder: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.encoder = encoder  # None → labels pass straight to the backbone
        cfg = getattr(backbone, "config", None)
        cin = getattr(cfg, "in_channels", None)
        cout = getattr(cfg, "out_ch", getattr(cfg, "out_channels", None))
        # the predicted channels where the backbone also predicts others (learned Σ)
        self.pred_channels = cin if cin and cout and cout > cin else None

    def _pred(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.pred_channels is None else out[..., : self.pred_channels]

    def forward(
        self,
        z_t: Optional[torch.Tensor],
        logsnr_t: Optional[torch.Tensor],
        labels: Optional[torch.Tensor],
        *,
        deterministic: bool = True,
        mode: str = "full",
        prefix_state=None,
    ):
        names = _NAMES.get(mode)
        if names is None:
            raise ValueError(f"unknown mode {mode!r}")
        name, forwards, rows = names
        profiling.count(forwards)
        profiling.count(rows, (labels if z_t is None else z_t).shape[0])
        with profiling.span(name):
            if mode == "encode":
                return self.backbone(z_t, logsnr_t, None, deterministic=deterministic, mode="encode")
            cond = self.encoder(labels) if self.encoder is not None else labels
            if mode == "tail":
                return self._pred(self.backbone(
                    None, None, cond, deterministic=deterministic, mode="tail",
                    prefix_state=prefix_state,
                ))
            return self._pred(self.backbone(z_t, logsnr_t, cond, deterministic=deterministic))


def supports_prefix(backbone) -> bool:
    """True if the backbone has the encode/tail split with a nonempty prefix."""
    return getattr(backbone, "prefix_split", 0) > 0
