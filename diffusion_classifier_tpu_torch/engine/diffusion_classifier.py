"""DiffusionClassifier engine — port of ``engine/diffusion_classifier.py``.

Ported: construction (schedule, denoiser, classifier, in-graph Haar DWT),
seeded ``init_params``, the train state (training parameters, an EMA copy,
Adam's state, step and EMA counters), ``train_step``, ``loss``,
``train_loop`` (epochs, log cadence, classification eval every
``save_image_epochs``, best-metric checkpoints, resume, the save on
SIGTERM/SIGINT), ``classify``, ``evaluate(classification=True)``,
``inference`` and whole-state checkpoints. Not yet: sampling (ROADMAP A7),
so ``train_loop`` takes no ``plot_function``; the multi-process paths
(ROADMAP A10).

As in the JAX engine, classify and evaluate run on the EMA parameters
(``state.ema_model``); ``loss`` and the train step on the training
parameters (``denoiser``). With the EMA ramp at its start the EMA is a
straight copy for the first ``ema_warmup`` updates.

The device is explicit (``device=``, default ``"cuda"``): nothing moves to
the CPU because no GPU was found. The classifier's and the train step's
draws come from one ``torch.Generator`` on that device seeded with
``config.seed``; parameter init uses a CPU generator with the same seed, so
the weights do not depend on the device. Weights and draws differ from the
JAX package's for the same seed (different generators); the parity tests
inject both.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..diffusion.classify import TorchDraws, make_classifier
from ..diffusion.schedule import make_schedule_fn
from ..models.encoders import make_encoder
from ..ops.wavelet import haar_dwt2
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.tracking import make_tracker
from .denoiser import Denoiser
from .state import EmaConfig, init_train_state, lr_at, make_optimizer
from .steps import TorchTrainDraws, make_loss_fn, make_train_step

__all__ = ["DiffusionClassifier"]


def _first_batch(dataloader, name: str):
    try:
        return next(iter(dataloader))
    except StopIteration:
        raise ValueError(
            f"The {name} dataloader yielded no batches. With drop_last "
            f"batching this happens when the dataset has fewer rows than "
            f"batch_size — reduce batch_size or provide more data."
        ) from None


class DiffusionClassifier:
    """DDPM trainer and per-class-ELBO classifier over a class-conditional denoiser (PyTorch)."""

    def __init__(self, backbone, config, *, device="cuda"):
        self.config = config.validate()
        self.device = torch.device(device)
        self.schedule_fn = make_schedule_fn(
            config.schedule, config.noise_d, config.image_size
        )
        encoder, self.null_token = make_encoder(config.encoder_type, num_classes=config.classes)
        self.denoiser = Denoiser(backbone, encoder)
        self.ema_cfg = EmaConfig(
            beta=config.ema_beta,
            update_after_step=config.ema_warmup,
            update_every=config.ema_update_freq,
        )
        loss_kw = dict(pred_param=config.pred_param, null_token=self.null_token)
        self._loss_fn = make_loss_fn(self.denoiser, self.schedule_fn, **loss_kw)
        # the public loss(): no CFG dropout, as the reference method
        self._loss_eval = make_loss_fn(
            self.denoiser, self.schedule_fn, cfg_dropout=0.0, **loss_kw
        )
        self._classify_impl = make_classifier(
            lambda z, logsnr, labels: self.state.ema_model(z, logsnr, labels),
            self.schedule_fn,
            pred_param=config.pred_param,
            num_classes=config.classes,
            n_stages=config.n_stages,
            evaluation_per_stage=config.evaluation_per_stage,
            n_keep_per_stage=config.n_keep_per_stage,
            fast=config.fast_classification,
            n_fast_classes=config.n_fast_classes,
            eval_group=config.classify_chunk,
            class_chunk=config.classify_class_chunk,
            scan_unroll=config.classify_scan_unroll,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.state = None
        self._train_step = None

    # ------------------------------------------------------------------ utils
    def _images(self, x) -> torch.Tensor:
        """Host images → float32 device tensor, Haar-decomposed (÷2 into [-1, 1]) if configured."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return haar_dwt2(x) / 2.0 if self.config.wavelet_transform else x

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(np.asarray(labels, np.int64), device=self.device)

    def _require_state(self) -> None:
        if self.state is None:
            raise RuntimeError("initialize/restore parameters first")

    def init_params(self, sample_batch=None) -> None:
        """Seeded parameter init and an EMA copy (once); ``sample_batch`` is accepted for API parity."""
        if self.state is not None:
            return
        gen = torch.Generator().manual_seed(self.config.seed)
        self.denoiser.backbone.reset_parameters(gen)
        self.denoiser.to(self.device)
        print(f"Parameter count: {sum(p.numel() for p in self.denoiser.parameters())}")
        self.state = init_train_state(self.denoiser)

    def _build_train_state(self, total_steps: int) -> None:
        """Optimizer for ``total_steps`` and a fresh state: EMA = parameters, counters 0."""
        cfg = self.config
        tx = make_optimizer(
            cfg.learning_rate, cfg.lr_warmup_steps, total_steps,
            state_dtype=cfg.optimizer_state_dtype,
        )
        self.state = init_train_state(self.denoiser, tx)
        self._train_step = make_train_step(
            self._loss_fn, tx, self.ema_cfg,
            grad_accum_steps=cfg.gradient_accumulation_steps,
        )

    # ------------------------------------------------------------- public API
    def train_step(self, batch, *, draws=None) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss as a device scalar (no sync)."""
        if self._train_step is None:
            raise RuntimeError("build the train state first (train_loop does)")
        x = self._images(batch["images"])
        labels = batch.get("prompt")
        labels = self._labels(
            labels if labels is not None else np.zeros(x.shape[0], np.int64)
        )
        draws = draws if draws is not None else TorchTrainDraws(self.generator)
        return self._train_step(self.state, x, labels, draws)

    def classify(self, x, labels=None, *, draws=None):
        """Staged per-class ELBO tournament on the EMA parameters; ``draws`` overrides the generator."""
        self._require_state()
        x = self._images(x)
        if labels is None:
            if self.config.fast_classification:
                raise ValueError("fast_classification requires true labels in classify()")
            labels = np.zeros((x.shape[0],), np.int64)
        draws = draws if draws is not None else TorchDraws(self.generator)
        return self._classify_impl(x, self._labels(labels), draws)

    @torch.no_grad()
    def loss(self, x, labels=None, *, draws=None) -> torch.Tensor:
        """Diffusion loss of one batch on the training parameters, without CFG dropout.

        ``labels=None`` scores unconditionally (the null token).
        """
        self._require_state()
        x = self._images(x)
        if labels is None:
            labels = np.full((x.shape[0],), self.null_token, np.int64)
        draws = draws if draws is not None else TorchTrainDraws(self.generator)
        u, t, eps = draws.loss(0, 1, x.shape[0], tuple(x.shape))
        return self._loss_eval(x, self._labels(labels), u, t, eps)

    def evaluate(
        self,
        val_loader,
        stop_idx: Optional[int] = None,
        metrics: Optional[Sequence] = None,
        classification: bool = False,
    ):
        """Classify val batches and update metrics; ``stop_idx`` runs ``stop_idx + 1`` batches."""
        if not classification:
            raise NotImplementedError("evaluation by sampling needs the sampler (ROADMAP A7)")
        show = self.config.progress
        if show is None:
            show = sys.stderr.isatty()
        try:
            total = len(val_loader)
            if stop_idx is not None:
                total = min(total, stop_idx + 1)
        except TypeError:
            total = None
        val_samples, batches = [], []
        idx = -1
        for idx, batch in enumerate(val_loader):
            if show:
                print(
                    f"\rclassify batch {idx + 1}/{total if total else '?'}",
                    end="", file=sys.stderr, flush=True,
                )
            self.init_params(batch)
            out = self.classify(batch["images"], batch["prompt"]).cpu()
            if metrics is not None:
                for metric in metrics:
                    metric.update((out, batch))
            val_samples.append(out)
            batches.append(batch)
            if stop_idx is not None and idx == stop_idx:
                break
        if show and idx >= 0:
            print(file=sys.stderr)
        return val_samples, batches, metrics

    def train_loop(
        self,
        train_dataloader,
        val_dataloader,
        metrics: Optional[Sequence] = None,
        checkpoint_metric: Optional[str] = None,
        plot_function: Optional[Callable] = None,
    ):
        """Epoch training loop with eval cadence, best-metric checkpoints, tracking and resume."""
        if plot_function is not None:
            raise NotImplementedError(
                "plot_function needs sampled images: the sampler is not ported yet (ROADMAP A7)"
            )
        cfg = self.config
        steps_per_epoch = len(train_dataloader)
        total_steps = steps_per_epoch * cfg.num_epochs
        self.init_params(_first_batch(train_dataloader, "train"))
        self._build_train_state(total_steps)

        checkpoint_tracker = {"value": 0.0, "save_flag": False}
        start_epoch, experiment_key = 0, None
        if cfg.resume:
            # resume reads the live 'checkpoints' folder, where saves land;
            # cfg.checkpoint_folder selects what inference reads
            ckpt = os.path.join(cfg.experiment_path, "checkpoints")
            start_epoch, best, experiment_key = self.load_checkpoint(ckpt)
            checkpoint_tracker["value"] = best or 0.0

        tracker = make_tracker(
            cfg.use_comet,
            cfg.experiment_path,
            resume_key=experiment_key,
            name=cfg.comet_experiment_name,
            comet_api_key=cfg.comet_api_key,
            comet_project_name=cfg.comet_project_name,
            comet_workspace=cfg.comet_workspace,
        )
        if tracker is not None and not cfg.resume:
            kind = (
                torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else str(self.device)
            )
            tracker.log_other("Device", kind)
            tracker.log_other("Python Version", sys.version)
            entry_script = os.path.abspath(sys.argv[0]) if sys.argv else None
            if entry_script and os.path.isfile(entry_script):
                tracker.log_asset(entry_script, os.path.basename(entry_script))
        print(cfg.to_json())

        # single process: on SIGTERM/SIGINT save the latest state, so
        # `resume` continues cleanly (the multi-process sync waits for ROADMAP A10)
        current_epoch = start_epoch
        prev_handlers = {}
        if cfg.save_on_signal:

            def _save_and_exit(signum, frame):
                print(f"Signal {signum}: saving preemption checkpoint...")
                self.save_checkpoint(
                    current_epoch - 1,
                    tracker.get_key() if tracker is not None else None,
                    checkpoint_tracker if checkpoint_metric else None,
                )
                raise SystemExit(128 + signum)

            prev_handlers = {
                sig: signal.signal(sig, _save_and_exit)
                for sig in (signal.SIGTERM, signal.SIGINT)
            }

        try:
            loss = None
            log_k = cfg.log_every_steps
            global_step = start_epoch * steps_per_epoch
            for epoch in range(start_epoch, cfg.num_epochs):
                current_epoch = epoch
                epoch_start = time.time()
                for batch in train_dataloader:
                    loss = self.train_step(batch)
                    global_step += 1
                    if log_k and global_step % log_k == 0:
                        # the host reads the loss only at this cadence
                        loss_val = float(loss)
                        lr = lr_at(
                            cfg.learning_rate, cfg.lr_warmup_steps, total_steps, global_step
                        )
                        if tracker is not None:
                            tracker.log_metric("loss", loss_val, step=global_step)
                            tracker.log_metric("lr", lr, step=global_step)
                        print(f"step {global_step}/{total_steps}: loss={loss_val:.5f} lr={lr:.3e}")
                loss_val = float(loss)
                print(f"Epoch {epoch}/{cfg.num_epochs}: {time.time() - epoch_start:.2f} s.")
                if tracker is not None:
                    tracker.log_metric("loss", loss_val, epoch=epoch)

                if epoch % cfg.save_image_epochs == 0 or epoch == cfg.num_epochs - 1:
                    eval_start = time.time()
                    # the sampling pass only feeds plot_function, which is None here
                    _, _, metrics = self.evaluate(
                        val_dataloader,
                        stop_idx=cfg.evaluation_batches,
                        metrics=metrics,
                        classification=True,
                    )
                    for metric in metrics or ():
                        metric.sync_across_processes()
                        metric_output = metric.get_output()
                        if (
                            checkpoint_metric is not None
                            and metric.name == checkpoint_metric
                            and metric_output[metric.name] > checkpoint_tracker["value"]
                        ):
                            checkpoint_tracker["value"] = metric_output[metric.name]
                            checkpoint_tracker["save_flag"] = True
                        if tracker is not None:
                            tracker.log_metrics(
                                {f"val_{k}": v for k, v in metric_output.items()}, step=epoch
                            )
                        baseline = (
                            1 / cfg.n_fast_classes if cfg.fast_classification else 1 / cfg.classes
                        )
                        print(f"Baseline Classification Accuracy: {baseline:.2f}")
                        print(metric_output)
                        metric.reset()
                    self.save_checkpoint(
                        epoch,
                        tracker.get_key() if tracker is not None else None,
                        checkpoint_tracker if checkpoint_metric else None,
                    )
                    print(f"Val evaluation time: {time.time() - eval_start:.2f} s.")
                    checkpoint_tracker["save_flag"] = False
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def sample(self, *args, **kwargs):
        raise NotImplementedError("sampling is not ported yet (ROADMAP A7)")

    def inference(
        self,
        val_dataloader,
        metrics: Optional[Sequence] = None,
        classification: bool = False,
        checkpoint_folder: str = "checkpoints",
    ):
        """Load a checkpoint's EMA parameters and evaluate the val loader."""
        if not classification:
            raise NotImplementedError("inference by sampling needs the sampler (ROADMAP A7)")
        cfg = self.config
        self.init_params(_first_batch(val_dataloader, "val"))
        self.load_checkpoint(
            os.path.join(cfg.experiment_path, checkpoint_folder), train_state=False
        )
        val_samples, batches, metrics = self.evaluate(
            val_dataloader,
            metrics=metrics,
            stop_idx=cfg.evaluation_batches,
            classification=True,
        )
        if metrics is None:
            return val_samples, batches
        metric_output = []
        for metric in metrics:
            metric.sync_across_processes()
            metric_output.append(metric.get_output())
        return metric_output, val_samples, batches

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, epoch: int, experiment_key=None, checkpoint_tracker=None):
        self._require_state()
        best = bool(checkpoint_tracker and checkpoint_tracker.get("save_flag"))
        path = save_checkpoint(
            self.config.experiment_path,
            self.state,
            epoch=epoch,
            best_metric=checkpoint_tracker["value"] if checkpoint_tracker else None,
            experiment_key=experiment_key,
            best=best,
        )
        print(f"Checkpoint saved to {path}")

    def load_checkpoint(self, checkpoint_path: str, *, train_state: bool = True):
        """Restore the EMA parameters and, with ``train_state``, the rest of the train state.

        Adam's state is restored only into an engine that built an optimizer.
        Returns ``(epoch, best_metric, experiment_key)``.
        """
        if self.state is None:
            raise RuntimeError("initialize parameters before restoring")
        ema, train, epoch, best_metric, experiment_key = load_checkpoint(
            checkpoint_path, train_state=train_state
        )
        state = self.state
        state.ema_model.load_state_dict(ema)
        if train is not None:
            state.model.load_state_dict(train["params"])
            state.step, state.ema_counter = int(train["step"]), int(train["ema_counter"])
            if state.opt_state is not None and train["opt_state"] is not None:
                state.opt_state.load_state_dict(train["opt_state"])
        print(f"Checkpoint loaded. Resuming from epoch {epoch}. Best metric {best_metric}")
        return epoch, best_metric, experiment_key
