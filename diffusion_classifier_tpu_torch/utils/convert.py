"""The weight bridge: a flax variable tree → the port's ``state_dict``.

Input: the JAX package's variables as nested dicts of numpy arrays:
``{"params": {...}}`` or its inside, or ``{"params": {...}, "batch_stats":
{...}}`` for a network with BatchNorm (the ResNet baseline), whose
``mean``/``var`` leaves become the ``running_mean``/``running_var`` buffers.
Leaf rules:

- Dense ``kernel [in, out]`` → ``weight [out, in]``;
- Conv ``kernel [kh, kw, in, out]`` (HWIO) → ``weight [out, in, kh, kw]``
  (OIHW) when the port's parameter is 4-D; otherwise the patch ``Dense``
  weight ``[out, kh·kw·in]``: the port writes the DiT patchify as reshape +
  matmul over ``(kh, kw, in)``;
- ``Embed.embedding`` → ``weight``; norm ``scale`` → ``weight``; ``bias`` →
  ``bias``;
- the resnet blocks' flat names ``<part>_kernel``/``_scale``/``_bias``
  (``norm1_scale``, ``conv1_kernel``, ``shortcut_kernel``,
  ``time_emb_bias``, ...) → ``<part>.weight``/``.bias``;
- flax's ``block_<i>`` names → the port's ``blocks.<i>``.

Every leaf must land on a parameter of the module with the same number of
elements; a missing or extra leaf raises.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["flax_to_state_dict"]

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _torch_name(path: tuple, leaves: dict = _LEAF) -> str:
    *mods, leaf = path
    flat = re.fullmatch(r"(\w+)_(kernel|scale|bias)", leaf)
    if flat:  # a resnet block's flat parameter name
        mods, leaf = mods + [flat.group(1)], flat.group(2)
    if leaf not in leaves:
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    mods = [re.sub(r"^block_(\d+)$", r"blocks.\1", m) for m in mods]
    return ".".join(mods + [leaves[leaf]])


def _convert_leaf(leaf: str, value: np.ndarray, target_ndim: int) -> np.ndarray:
    if not leaf.endswith("kernel"):
        return value
    if value.ndim == 4 and target_ndim == 4:  # conv HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    # Dense [in, out], or a conv HWIO flattened over (h, w, in)
    return value.reshape(-1, value.shape[-1]).T


def flax_to_state_dict(flax_params: Mapping, module: nn.Module) -> dict:
    """Convert ``flax_params`` to ``module``'s state dict; raises on missing/extra leaves."""
    stats = {}
    if set(flax_params) <= {"params", "batch_stats"} and "params" in flax_params:
        stats = flax_params.get("batch_stats", {})
        flax_params = flax_params["params"]
    leaves = [(path, value, _torch_name(path)) for path, value in _flatten(flax_params).items()]
    leaves += [(path, value, _torch_name(path, _STATS)) for path, value in _flatten(stats).items()]
    expected = module.state_dict()
    out, extra = {}, []
    for path, value, name in leaves:
        if name not in expected:
            extra.append("/".join(path))
            continue
        target = expected[name]
        arr = _convert_leaf(path[-1], value, target.ndim)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(
                f"{'/'.join(path)}: converted shape {arr.shape} != {name} "
                f"{tuple(target.shape)}"
            )
        out[name] = torch.tensor(arr, dtype=target.dtype)
    missing = sorted(set(expected) - set(out))
    if missing or extra:
        raise KeyError(
            f"flax tree does not match the module: missing {missing}, extra {sorted(extra)}"
        )
    return out
