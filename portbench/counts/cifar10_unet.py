"""Counts of the CIFAR-10 flagship UNet: the condition-free encode, the tail, and both together."""

from __future__ import annotations

import torch

from ..reference import unet
from . import meta_params, reference_flops


def counts(config: dict) -> dict:
    m, x = config["model"], config["experiment"]
    P = meta_params(unet.param_shapes(m, x["classes"]))
    z = torch.empty((1, x["image_size"], x["image_size"], m["in_channels"]), device="meta")
    lam = torch.empty((1,), device="meta")
    labels = torch.zeros((1,), dtype=torch.long, device="meta")
    state = unet.prefix(P, m, z, lam)
    return {
        "encode": reference_flops(unet.prefix, P, m, z, lam),
        "tail": reference_flops(lambda: unet.tail(P, m, state, unet.context(P, m, labels))),
        "full": reference_flops(unet.forward, P, m, z, lam, labels),
    }
