"""Counts of the CheXpert DiT-b4: one forward row, and its attention.

Attention a row is ``4·S²·D·H`` operations a layer (q·kᵀ and P·V) over
``S = (image/2 / patch)²`` tokens, and it reads q, k, v and writes o once,
``4·S·H·D`` bf16 values a layer: at S = 1024 the operations bound it.
"""

from __future__ import annotations

import torch

from ..reference import dit
from . import meta_params, reference_flops


def counts(config: dict) -> dict:
    m, x = config["model"], config["experiment"]
    side = x["image_size"] // 2 if x.get("wavelet_transform") else x["image_size"]
    c = m["in_channels"]
    P = meta_params(dit.param_shapes(m, x["classes"]))
    z = torch.empty((1, side, side, c), device="meta")
    lam = torch.empty((1,), device="meta")
    labels = torch.zeros((1,), dtype=torch.long, device="meta")
    s = (side // m["patch_size"]) ** 2
    hd = m["num_attention_heads"] * m["attention_head_dim"]
    return {
        "full": reference_flops(dit.forward, P, m, z, lam, labels),
        "attention_flops": 4 * s * s * hd * m["num_layers"],
        "attention_bytes": 4 * s * hd * 2 * m["num_layers"],
    }
