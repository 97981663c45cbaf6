"""Checkpoints of the whole train state as torch files — port of ``utils/checkpoint.py``.

Layout of a checkpoint folder (``<experiment_path>/checkpoints/``, and a
full copy in ``best_checkpoint/`` when the tracked metric improved):

- ``ema_params.pt`` — the EMA parameters' state dict: what classify,
  evaluate and inference run on, and all that inference reads;
- ``train_state.pt`` — the training parameters, Adam's state (or None for
  an engine that never built an optimizer), the step and the EMA counter;
- ``experiment_state.json`` — the JAX package's sidecar ``{epoch + 1,
  best_metric, experiment_key}``.

Each file is written under a temporary name and renamed into place, so a
crash leaves the previous file whole; the sidecar goes last. The JAX
package's Orbax checkpoints are not readable yet (ROADMAP A8);
``utils/convert.py`` bridges a flax parameter tree in memory.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_EMA = "ema_params.pt"
_TRAIN = "train_state.pt"
_SIDECAR = "experiment_state.json"


def _cpu(state_dict) -> dict:
    return {k: v.detach().to("cpu") for k, v in state_dict.items()}


def _atomic_write(path: str, write) -> None:
    tmp = path + ".new"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(
    experiment_path: str,
    state,
    *,
    epoch: int,
    best_metric: Optional[float] = None,
    experiment_key: Optional[str] = None,
    best: bool = False,
) -> str:
    """Save ``state`` (an ``engine.state.TrainState``) as the latest, and the best if ``best``.

    Returns the latest checkpoint's folder.
    """
    ema = _cpu(state.ema_model.state_dict())
    opt = state.opt_state.state_dict() if state.opt_state is not None else None
    if opt is not None:
        opt = {**opt, "mu": [t.cpu() for t in opt["mu"]], "nu": [t.cpu() for t in opt["nu"]]}
    train = {
        "params": _cpu(state.model.state_dict()),
        "opt_state": opt,
        "step": state.step,
        "ema_counter": state.ema_counter,
    }
    # the NEXT epoch, as the JAX package stores it
    sidecar = {"epoch": epoch + 1, "best_metric": best_metric, "experiment_key": experiment_key}

    def write_sidecar(p):
        with open(p, "w") as f:
            json.dump(sidecar, f)

    folders = [os.path.join(experiment_path, "checkpoints")]
    if best:
        folders.append(os.path.join(experiment_path, "best_checkpoint"))
    for directory in folders:
        os.makedirs(directory, exist_ok=True)
        _atomic_write(os.path.join(directory, _TRAIN), lambda p: torch.save(train, p))
        _atomic_write(os.path.join(directory, _EMA), lambda p: torch.save(ema, p))
        _atomic_write(os.path.join(directory, _SIDECAR), write_sidecar)
    return folders[0]


def load_checkpoint(checkpoint_path: str, *, train_state: bool = True):
    """``(ema_params, train, epoch, best_metric, experiment_key)`` from a folder.

    ``train`` is the ``train_state.pt`` payload (parameters, optimizer state,
    step, EMA counter), or None when the folder has none or ``train_state``
    is False.
    """
    path = os.path.join(checkpoint_path, _EMA)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no torch checkpoint at {path} (JAX Orbax checkpoints are not "
            f"readable by the port yet)"
        )
    ema_params = torch.load(path, map_location="cpu", weights_only=True)
    train = None
    train_path = os.path.join(checkpoint_path, _TRAIN)
    if train_state and os.path.isfile(train_path):
        train = torch.load(train_path, map_location="cpu", weights_only=True)
    epoch, best_metric, experiment_key = 0, None, None
    sidecar_path = os.path.join(checkpoint_path, _SIDECAR)
    if os.path.exists(sidecar_path):
        with open(sidecar_path) as f:
            sidecar = json.load(f)
        epoch = sidecar.get("epoch", 0)
        best_metric = sidecar.get("best_metric")
        experiment_key = sidecar.get("experiment_key")
    return ema_params, train, epoch, best_metric, experiment_key
