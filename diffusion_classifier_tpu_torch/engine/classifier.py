"""Discriminative classifier engine (the supervised baseline) — port of ``engine/classifier.py``.

A backbone and a linear head (:class:`BackboneWithHead`) trained with
softmax cross-entropy on integer labels (the batch mean), one process:

- ``init_params`` — seeded init (a CPU generator with ``config.seed``, so
  the weights do not depend on the device), then, with
  ``pretrained_path``, the local torchvision ``.npz`` into the backbone
  (the head stays fresh);
- the train step — forward with ``train=True`` (BatchNorm normalises with
  the batch and moves its running averages), loss, backward, then the
  port's optimizer (``engine/state.py``: clip-by-global-norm 1.0 and Adam
  with the cosine warmup; ``optimizer_state_dtype`` as for the diffusion
  engine);
- ``classify`` — argmax of the logits with ``train=False`` (the first
  index on ties);
- ``train_loop`` — epochs, an eval every ``eval_period`` epochs and at the
  last, a checkpoint at each eval (``utils/checkpoint.py``:
  ``classifier_state.pt`` with the running statistics, and the sidecar),
  resume from ``<experiment>/checkpoints``;
- ``inference`` — loads ``<experiment>/<checkpoint_folder>`` and returns
  the mean cross-entropy and the metrics over the val loader.

The device is explicit (``device=``, default ``"cuda"``).

Several processes: as the diffusion engine, ``mesh`` (by default every rank
on the data axis once a process group is up) and ``param_sharding`` place
the model (DDP or FSDP2; ``parallel.sharding``). BatchNorm normalises with
the global batch's statistics (``models/resnet.py``), so the running
averages stay equal on every rank and equal to one process's; the step
returns the global batch's loss, evaluation sums its loss and the metrics'
counters over the data group, and rank 0 alone prints and writes the
checkpoint, gathered whole.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense, reset_parameters
from ..parallel.mesh import is_main_process, make_mesh
from ..parallel.sharding import Placement, shard_params
from ..utils.checkpoint import load_classifier_checkpoint, save_classifier_checkpoint
from ..utils.tracking import make_tracker
from .diffusion_classifier import _first_batch
from .state import make_optimizer

__all__ = ["BackboneWithHead", "Classifier"]


class BackboneWithHead(nn.Module):
    """Backbone features, then a float32 linear head (flax ``Dense`` named ``head``)."""

    def __init__(self, backbone: nn.Module, num_classes: int):
        super().__init__()
        self.backbone = backbone
        self.head = Dense(backbone.output_dim, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.head(self.backbone(x, train=train))


class Classifier:
    """Supervised classifier engine over ``{"images", "prompt"}`` batches."""

    def __init__(self, backbone: nn.Module, config, *, device="cuda", mesh=None):
        self.config = config.validate()
        self.device = torch.device(device)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(device_type=self.device.type)
        self.mesh = mesh
        self.model = BackboneWithHead(backbone, config.classes)
        self.placement = Placement(self.model)
        self._initialised = False
        self._tx = None
        self._opt_state = None

    @property
    def is_main_process(self) -> bool:
        return is_main_process()

    def _log(self, *args) -> None:
        if self.is_main_process:
            print(*args)

    # ------------------------------------------------------------------ utils
    def _images(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(np.asarray(labels, np.int64), device=self.device)

    def init_params(self, sample_batch=None) -> None:
        """Seeded init once; ``pretrained_path`` loads the backbone from a local torchvision ``.npz``."""
        if self._initialised:
            return
        gen = torch.Generator().manual_seed(self.config.seed)
        self.model.backbone.reset_parameters(gen)
        reset_parameters(self.model.head, gen)
        if self.config.pretrained_path:
            from ..models.resnet import load_pretrained_resnet

            in_channels = (
                int(np.asarray(sample_batch["images"]).shape[-1])
                if sample_batch is not None else self.model.backbone.in_channels
            )
            load_pretrained_resnet(
                self.model.backbone, self.config.pretrained_path, in_channels=in_channels
            )
            self._log(f"Loaded pretrained backbone: {self.config.pretrained_path}")
        self.model.to(self.device)
        self._initialised = True
        self._log(f"Parameter count: {sum(p.numel() for p in self.model.parameters())}")
        self.placement = shard_params(self.model, self.mesh, self.config.param_sharding)

    def _build_train_step(self, total_steps: int) -> None:
        cfg = self.config
        self._tx = make_optimizer(
            cfg.learning_rate, cfg.lr_warmup_steps, total_steps,
            state_dtype=cfg.optimizer_state_dtype,
        )
        self.placement.wrap_for_training()
        self._opt_state = self._tx.init(Placement.local(p) for p in self.model.parameters())

    # ------------------------------------------------------------- public API
    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss as a device scalar (no sync)."""
        if self._tx is None:
            raise RuntimeError("build the train step first (train_loop does)")
        x, labels = self._images(batch["images"]), self._labels(batch["prompt"])
        pl = self.placement
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        loss = F.cross_entropy(pl.forward_module(x, train=True), labels)
        loss.backward()
        local = [pl.local(p) for p in params]
        grads = [
            pl.local(p.grad) if p.grad is not None else torch.zeros_like(q)
            for p, q in zip(params, local)
        ]
        self._tx.update(grads, self._opt_state, local, global_norm=pl.grad_norm)
        for p in params:
            p.grad = None
        return pl.mean_over_data(loss.detach())

    @torch.no_grad()
    def classify(self, x) -> torch.Tensor:
        """Argmax over the logits, with the running statistics."""
        return self.model(self._images(x), train=False).argmax(dim=-1)

    def train_one_epoch(self, train_dataloader) -> float:
        total_loss, total = 0.0, 0
        for batch in train_dataloader:
            loss = self.train_step(batch)
            b = len(batch["prompt"])
            total_loss += float(loss) * b
            total += b
        return total_loss / max(total, 1)

    @torch.no_grad()
    def evaluate(self, val_dataloader, stop_idx: Optional[int] = None, metrics=None):
        """``(mean cross-entropy, metrics)``; ``stop_idx`` runs ``stop_idx + 1`` batches.

        The mean is over the data group's rows; the metrics count this
        rank's rows until they are synced.
        """
        total_loss, total = 0.0, 0
        for idx, batch in enumerate(val_dataloader):
            logits = self.model(self._images(batch["images"]), train=False)
            loss = F.cross_entropy(logits, self._labels(batch["prompt"]))
            preds = logits.argmax(dim=-1).cpu()
            b = len(batch["prompt"])
            total_loss += float(loss) * b
            total += b
            for metric in metrics or ():
                metric.update((preds, batch))
            if stop_idx is not None and idx == stop_idx:
                break
        if self.placement.data_count > 1:
            sums = torch.tensor([total_loss, total], dtype=torch.float64)
            if dist.get_backend(self.placement.data_group) == "nccl":
                sums = sums.to(self.device)
            dist.all_reduce(sums, group=self.placement.data_group)
            total_loss, total = float(sums[0]), int(sums[1])
        return total_loss / max(total, 1), metrics

    def train_loop(self, train_dataloader, val_dataloader, metrics: Optional[Sequence] = None):
        cfg = self.config
        total_steps = len(train_dataloader) * cfg.num_epochs
        self.init_params(_first_batch(train_dataloader, "train"))
        self._build_train_step(total_steps)

        start_epoch, experiment_key = 0, None
        if cfg.resume:
            # resume reads the live 'checkpoints' folder, where saves land
            ckpt = os.path.join(cfg.experiment_path, "checkpoints")
            if os.path.exists(ckpt):
                start_epoch, _, experiment_key = self.load_checkpoint(ckpt)
            else:
                self._log("No checkpoint directory found. Starting from scratch.")

        tracker = make_tracker(
            cfg.use_comet,
            cfg.experiment_path,
            is_main_process=self.is_main_process,
            resume_key=experiment_key,
            name=cfg.comet_experiment_name,
            comet_api_key=cfg.comet_api_key,
            comet_project_name=cfg.comet_project_name,
            comet_workspace=cfg.comet_workspace,
        )
        self._log(f"Config:\n{cfg.to_json()}")

        for epoch in range(start_epoch, cfg.num_epochs):
            epoch_start = time.time()
            avg_train_loss = self.train_one_epoch(train_dataloader)
            self._log(
                f"Epoch {epoch}/{cfg.num_epochs - 1}, Train Loss: {avg_train_loss:.4f}, "
                f"Time: {time.time() - epoch_start:.2f}s"
            )
            if tracker is not None:
                tracker.log_metric("train_loss", avg_train_loss, epoch=epoch)
            if epoch % cfg.eval_period == 0 or epoch == cfg.num_epochs - 1:
                val_loss, val_metrics = self.evaluate(
                    val_dataloader, stop_idx=cfg.evaluation_batches, metrics=metrics
                )
                for metric in val_metrics or ():
                    metric.sync_across_processes(self.placement.data_group)
                    out = metric.get_output()
                    self._log(out)
                    if tracker is not None:
                        tracker.log_metrics({f"val_{k}": v for k, v in out.items()}, step=epoch)
                    metric.reset()
                if tracker is not None:
                    tracker.log_metric("val_loss", val_loss, epoch=epoch)
                self.save_checkpoint(epoch, tracker.get_key() if tracker is not None else None)

    def inference(self, val_dataloader, metrics=None):
        """Load ``<experiment>/<checkpoint_folder>`` and evaluate; returns ``(val_loss, metric outputs)``."""
        cfg = self.config
        self.init_params(_first_batch(val_dataloader, "val"))
        self._build_train_step(total_steps=max(1, len(val_dataloader)))
        self.load_checkpoint(os.path.join(cfg.experiment_path, cfg.checkpoint_folder))
        val_loss, val_metrics = self.evaluate(
            val_dataloader, stop_idx=cfg.evaluation_batches, metrics=metrics
        )
        metric_output = []
        for metric in val_metrics or ():
            metric.sync_across_processes(self.placement.data_group)
            metric_output.append(metric.get_output())
        return val_loss, metric_output

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, epoch: int, experiment_key=None) -> None:
        """Every rank calls it (the shards are gathered); rank 0 writes."""
        path = save_classifier_checkpoint(
            self.config.experiment_path, self.model, self._opt_state,
            epoch=epoch, experiment_key=experiment_key, placement=self.placement,
        )
        self._log(f"Checkpoint saved to {path}")

    def load_checkpoint(self, checkpoint_path: str):
        """Restore the model (running statistics included) and, if built, Adam's state.

        Returns ``(epoch, best_metric, experiment_key)``.
        """
        model, opt, epoch, best, key = load_classifier_checkpoint(checkpoint_path)
        pl = self.placement
        pl.load(model)
        if self._opt_state is not None and opt is not None:
            opt = dict(opt)
            named = list(self.model.named_parameters())
            for k in ("mu", "nu"):
                opt[k] = [pl.piece(n, m, p) for (n, p), m in zip(named, opt[k])]
            self._opt_state.load_state_dict(opt)
        self._log(f"Checkpoint loaded. Resuming from epoch {epoch}.")
        return epoch, best, key
