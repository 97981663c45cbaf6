"""Checkpoints of the whole train state as torch files — port of ``utils/checkpoint.py``.

Layout of a checkpoint folder (``<experiment_path>/checkpoints/``, and a
full copy in ``best_checkpoint/`` when the tracked metric improved):

- ``ema_params.pt`` — the EMA parameters' state dict: what classify,
  evaluate and inference run on, and all that inference reads;
- ``train_state.pt`` — the training parameters, Adam's state (or None for
  an engine that never built an optimizer), the step and the EMA counter;
  Adam's moments keep their storage dtype (bf16 under
  ``optimizer_state_dtype='bf16'``), so a resume restores them bit for bit;
- ``experiment_state.json`` — the JAX package's sidecar ``{epoch + 1,
  best_metric, experiment_key}``.

The discriminative classifier (``engine/classifier.py``) has no EMA: its
folder holds ``classifier_state.pt`` (the model's state dict, BatchNorm's
running statistics included, and Adam's state) and the same sidecar
(:func:`save_classifier_checkpoint`, :func:`load_classifier_checkpoint`).

Each file is written under a temporary name and renamed into place, so a
crash leaves the previous file whole; the sidecar goes last.

Under several processes a checkpoint is still whole: every rank takes part
in gathering the parameters, the EMA and Adam's moments from their shards
(``parallel.sharding.Placement.full``), rank 0 alone writes, and the others
wait at a barrier until the files are in place (the JAX package's primary-
only sidecar and barriered save). Every rank reads the whole files and
re-places them (``Placement.load``), so a checkpoint loads under any world
size and ``param_sharding``. The JAX
package's Orbax checkpoints are not readable yet (ROADMAP A8);
``utils/convert.py`` bridges a flax parameter tree in memory.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "load_checkpoint",
    "load_classifier_checkpoint",
    "save_checkpoint",
    "save_classifier_checkpoint",
]

_EMA = "ema_params.pt"
_TRAIN = "train_state.pt"
_SIDECAR = "experiment_state.json"
_CLASSIFIER = "classifier_state.pt"


def _cpu(state_dict) -> dict:
    return {k: v.detach().to("cpu") for k, v in state_dict.items()}


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _whole(placement, module) -> dict:
    """The module's whole state dict on the CPU (every rank gathers; rank 0 keeps it)."""
    if placement is None:
        return _cpu(module.state_dict())
    return _cpu(placement.full_state_dict())


def _opt_whole(opt_state, placement, module) -> Optional[dict]:
    """Adam's state with whole moments, in the parameters' order (a collective under sharding)."""
    if opt_state is None:
        return None
    opt = opt_state.state_dict()
    if placement is not None:
        named = list(module.named_parameters())
        for key in ("mu", "nu"):
            opt[key] = [placement.full(n, m, like=p) for (n, p), m in zip(named, opt[key])]
    return {**opt, "mu": [t.cpu() for t in opt["mu"]], "nu": [t.cpu() for t in opt["nu"]]}


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
    extra: Optional[dict] = None,
) -> str:
    """Save ``state`` (an ``engine.state.TrainState``) as the latest, and the best if ``best``.

    Every rank calls it; rank 0 writes. ``extra`` joins the train-state
    payload (the engine's generator state). Returns the latest checkpoint's
    folder.
    """
    ema = _whole(state.ema_placement, state.ema_model)
    train = {
        "params": _whole(state.placement, state.model),
        "opt_state": _opt_whole(state.opt_state, state.placement, state.model),
        "step": state.step,
        "ema_counter": state.ema_counter,
        **(extra or {}),
    }
    # the NEXT epoch, as the JAX package stores it
    sidecar = {"epoch": epoch + 1, "best_metric": best_metric, "experiment_key": experiment_key}
    folders = [os.path.join(experiment_path, "checkpoints")]
    if best:
        folders.append(os.path.join(experiment_path, "best_checkpoint"))
    if _is_writer():
        for directory in folders:
            os.makedirs(directory, exist_ok=True)
            _atomic_write(os.path.join(directory, _TRAIN), lambda p: torch.save(train, p))
            _atomic_write(os.path.join(directory, _EMA), lambda p: torch.save(ema, p))
            _write_sidecar(directory, sidecar)
    _barrier()
    return folders[0]


def _write_sidecar(directory: str, sidecar: dict) -> None:
    def write(p):
        with open(p, "w") as f:
            json.dump(sidecar, f)

    _atomic_write(os.path.join(directory, _SIDECAR), write)


def _read_sidecar(checkpoint_path: str):
    path = os.path.join(checkpoint_path, _SIDECAR)
    if not os.path.exists(path):
        return 0, None, None
    with open(path) as f:
        sidecar = json.load(f)
    return sidecar.get("epoch", 0), sidecar.get("best_metric"), sidecar.get("experiment_key")


def save_classifier_checkpoint(
    experiment_path: str, model, opt_state, *, epoch: int, experiment_key: Optional[str] = None,
    placement=None,
) -> str:
    """Save the classifier's model (parameters and running statistics) and Adam's state; returns the folder.

    Every rank calls it; rank 0 writes.
    """
    payload = {
        "model": _whole(placement, model),
        "opt_state": _opt_whole(opt_state, placement, model),
    }
    directory = os.path.join(experiment_path, "checkpoints")
    if _is_writer():
        os.makedirs(directory, exist_ok=True)
        _atomic_write(os.path.join(directory, _CLASSIFIER), lambda p: torch.save(payload, p))
        _write_sidecar(
            directory, {"epoch": epoch + 1, "best_metric": None, "experiment_key": experiment_key}
        )
    _barrier()
    return directory


def load_classifier_checkpoint(checkpoint_path: str):
    """``(model_state_dict, opt_state or None, epoch, best_metric, experiment_key)`` from a folder."""
    path = os.path.join(checkpoint_path, _CLASSIFIER)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no classifier checkpoint at {path}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return (payload["model"], payload["opt_state"], *_read_sidecar(checkpoint_path))


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
    return (ema_params, train, *_read_sidecar(checkpoint_path))
