"""Experiment tracking — the port's copy of ``utils/tracking.py``.

Stdlib only, copied so the port imports nothing of the JAX package. A
comet-shaped call surface (``log_metric(s) / log_image / log_asset /
log_other / set_name / get_key``) over three backends:

- :class:`StdoutTracker` — prints scalars; always safe.
- :class:`JsonlTracker` — appends events to ``<experiment_path>/track.jsonl``
  with a persistent run key: resumable offline tracking, no network.
- :class:`CometTracker` — the network backend, import-guarded on
  ``comet_ml`` and selected only when an API key is configured; a resumed
  run re-attaches with the stored experiment key.
"""

from __future__ import annotations

import json
import os
import time
import uuid
import warnings
from typing import Any, Mapping, Optional

__all__ = [
    "Tracker",
    "StdoutTracker",
    "JsonlTracker",
    "CometTracker",
    "make_tracker",
]


class Tracker:
    def set_name(self, name: str) -> None: ...
    def get_key(self) -> Optional[str]:
        return None

    def log_metric(self, name: str, value, *, step=None, epoch=None) -> None: ...
    def log_metrics(self, metrics: Mapping[str, Any], *, step=None) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step=step)

    def log_image(self, name: str, image_data) -> None: ...
    def log_asset(self, path: str, name: str) -> None: ...
    def log_other(self, key: str, value) -> None: ...
    def end(self) -> None: ...


class StdoutTracker(Tracker):
    def __init__(self, name: str = "run"):
        self.name = name

    def set_name(self, name: str) -> None:
        self.name = name

    def log_metric(self, name, value, *, step=None, epoch=None) -> None:
        tag = f" step={step}" if step is not None else ""
        tag += f" epoch={epoch}" if epoch is not None else ""
        print(f"[{self.name}]{tag} {name}={value}")


class JsonlTracker(Tracker):
    """Append-only JSONL event log with a resumable run key."""

    def __init__(self, experiment_path: str, key: Optional[str] = None):
        os.makedirs(experiment_path, exist_ok=True)
        self.path = os.path.join(experiment_path, "track.jsonl")
        self.key = key or uuid.uuid4().hex[:16]
        self.name = self.key
        self._emit({"event": "start", "key": self.key})

    def _emit(self, payload: dict) -> None:
        payload["t"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(payload) + "\n")

    def set_name(self, name: str) -> None:
        self.name = name
        self._emit({"event": "name", "name": name})

    def get_key(self) -> str:
        return self.key

    def log_metric(self, name, value, *, step=None, epoch=None) -> None:
        self._emit(
            {
                "event": "metric",
                "name": name,
                "value": float(value),
                "step": step,
                "epoch": epoch,
            }
        )

    def log_image(self, name, image_data) -> None:
        self._emit({"event": "image", "name": name, "path": str(image_data)})

    def log_asset(self, path, name) -> None:
        self._emit({"event": "asset", "name": name, "path": path})

    def log_other(self, key, value) -> None:
        self._emit({"event": "other", "key": key, "value": str(value)})


class CometTracker(Tracker):
    """Comet ML network backend (reference `:395-416` parity).

    ``comet_module`` is injectable so the backend is testable without the
    (absent, zero-egress) real ``comet_ml`` package.
    """

    def __init__(
        self,
        *,
        api_key: str,
        project_name: Optional[str] = None,
        workspace: Optional[str] = None,
        resume_key: Optional[str] = None,
        comet_module=None,
    ):
        if comet_module is None:  # pragma: no cover - needs comet_ml + egress
            import comet_ml as comet_module
        if resume_key:
            # re-attach to the stored run, the reference's resume path
            self._exp = comet_module.ExistingExperiment(
                previous_experiment=resume_key, api_key=api_key
            )
        else:
            self._exp = comet_module.Experiment(
                api_key=api_key,
                project_name=project_name,
                workspace=workspace,
            )

    def set_name(self, name: str) -> None:
        self._exp.set_name(name)

    def get_key(self) -> Optional[str]:
        return self._exp.get_key()

    def log_metric(self, name, value, *, step=None, epoch=None) -> None:
        self._exp.log_metric(name, value, step=step, epoch=epoch)

    def log_metrics(self, metrics, *, step=None) -> None:
        self._exp.log_metrics(dict(metrics), step=step)

    def log_image(self, name, image_data) -> None:
        self._exp.log_image(image_data, name=name)

    def log_asset(self, path, name) -> None:
        self._exp.log_asset(path, name)

    def log_other(self, key, value) -> None:
        self._exp.log_other(key, value)

    def end(self) -> None:
        self._exp.end()


def make_tracker(
    use_tracking: bool,
    experiment_path: str,
    *,
    is_main_process: bool = True,
    resume_key: Optional[str] = None,
    name: Optional[str] = None,
    comet_api_key: Optional[str] = None,
    comet_project_name: Optional[str] = None,
    comet_workspace: Optional[str] = None,
    comet_module=None,
) -> Optional[Tracker]:
    """Mirror of the reference's tracker setup gating (`:400-416`).

    A configured API key selects the Comet network backend when ``comet_ml``
    is importable; otherwise (and by default in this zero-egress
    environment) events go to the resumable JSONL backend.
    """
    if not use_tracking or not is_main_process:
        return None
    if comet_api_key:
        try:
            tracker = CometTracker(
                api_key=comet_api_key,
                project_name=comet_project_name,
                workspace=comet_workspace,
                resume_key=resume_key,
                comet_module=comet_module,
            )
        except Exception as e:  # comet_ml missing OR failing at runtime
            # (no network, bad resume key, …): training must not abort over
            # telemetry — fall through to the resumable JSONL backend.
            if not isinstance(e, ImportError):
                warnings.warn(f"Comet tracker unavailable ({e!r}); "
                              "falling back to JSONL tracking")
            tracker = None
        if tracker is not None:
            if name and not resume_key:
                tracker.set_name(name)
            return tracker
    tracker = JsonlTracker(experiment_path, key=resume_key)
    if name:
        tracker.set_name(name)
    return tracker
