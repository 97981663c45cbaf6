"""Streaming classification metrics — port of ``utils/metrics.py``.

Same surface: ``reset / update((y_pred, batch)) / compute / get_output /
sync_across_processes``, integer counters, Precision/Recall/F1 binary with
class 1 positive. Predictions may be torch tensors (any device) or numpy.

Under several processes each rank counts its own rows, and
``sync_across_processes`` sums the counters over the data group with one
``all_reduce`` of an int64 tensor (the reference's ``accelerator.reduce``,
JAX's allgather-and-sum).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "F1"]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    """Counter-based streaming metric. Subclasses define the counters and the math."""

    counter_names: tuple[str, ...] = ()

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.counters = {k: 0 for k in self.counter_names}
        self._synced = False

    def update(self, output) -> None:
        y_pred, batch = output
        delta = self._delta(_numpy(y_pred), _numpy(batch["prompt"]))
        for k, v in delta.items():
            self.counters[k] += int(v)
        self._synced = False

    def compute(self) -> Mapping[str, float]:
        raise NotImplementedError

    def get_output(self) -> Mapping[str, float]:
        return self.compute()

    def sync_across_processes(self, group=None) -> None:
        """Sum the counters over ``group`` (default: every rank); once per round of updates.

        The reduction runs on the backend's device (NCCL reduces CUDA
        tensors only). One process: nothing happens.
        """
        import torch.distributed as dist

        if self._synced or not dist.is_initialized() or dist.get_world_size(group) == 1:
            return
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        names = self.counter_names
        t = torch.tensor([self.counters[k] for k in names], dtype=torch.int64, device=device)
        dist.all_reduce(t, group=group)
        self.counters = dict(zip(names, (int(v) for v in t.tolist())))
        self._synced = True

    def _delta(self, y_pred: np.ndarray, y_true: np.ndarray) -> Mapping[str, int]:
        raise NotImplementedError


def _ratio(num, denom) -> float:
    return float(num / denom) if denom else 0.0


class Accuracy(Metric):
    counter_names = ("correct", "total")

    def _delta(self, y_pred, y_true):
        return {"correct": (y_pred == y_true).sum(), "total": len(y_true)}

    def compute(self):
        return {self.name: _ratio(self.counters["correct"], self.counters["total"])}


class Precision(Metric):
    counter_names = ("tp", "fp")

    def __init__(self, name: str = "precision"):
        super().__init__(name)

    def _delta(self, y_pred, y_true):
        return {
            "tp": ((y_pred == 1) & (y_true == 1)).sum(),
            "fp": ((y_pred == 1) & (y_true == 0)).sum(),
        }

    def compute(self):
        c = self.counters
        return {self.name: _ratio(c["tp"], c["tp"] + c["fp"])}


class Recall(Metric):
    counter_names = ("tp", "fn")

    def __init__(self, name: str = "recall"):
        super().__init__(name)

    def _delta(self, y_pred, y_true):
        return {
            "tp": ((y_pred == 1) & (y_true == 1)).sum(),
            "fn": ((y_pred == 0) & (y_true == 1)).sum(),
        }

    def compute(self):
        c = self.counters
        return {self.name: _ratio(c["tp"], c["tp"] + c["fn"])}


class F1(Metric):
    counter_names = ("tp", "fp", "fn")

    def __init__(self, name: str = "f1"):
        super().__init__(name)

    def _delta(self, y_pred, y_true):
        return {
            "tp": ((y_pred == 1) & (y_true == 1)).sum(),
            "fp": ((y_pred == 1) & (y_true == 0)).sum(),
            "fn": ((y_pred == 0) & (y_true == 1)).sum(),
        }

    def compute(self):
        c = self.counters
        num = 2.0 * c["tp"]
        return {self.name: _ratio(num, num + c["fp"] + c["fn"])}
