"""DiffusionClassifier engine — port of ``engine/diffusion_classifier.py``.

Ported: construction (schedule, encoder, denoiser, classifier, sampler,
in-graph Haar DWT), seeded ``init_params``, the train state (training
parameters, an EMA copy, Adam's state, step and EMA counters),
``train_step``, ``loss``, ``train_loop`` (epochs, log cadence, eval every
``save_image_epochs`` with the sampled images handed to ``plot_function``,
best-metric checkpoints, resume, the save on SIGTERM/SIGINT), ``classify``,
``sample``, ``evaluate`` and ``inference`` (by classification or by
sampling) and whole-state checkpoints, on one process or several.

Several processes (``torch.distributed``, :mod:`..parallel`): ``mesh`` is a
``('data', 'model')`` ``DeviceMesh`` (by default, once a process group is
up, every rank on the data axis), and ``config.param_sharding`` places the
train state on it (``parallel.sharding.shard_params``: DDP, FSDP2, or
tensor parallel on the model axis). Each rank feeds its rows of the global
batch; the draws are the global batch's (the same seed gives the same
draws at any world size), the train step returns the global batch's loss,
and evaluate and inference sum the metrics' counters over the data group.
Only rank 0 prints, plots and writes files; a checkpoint is gathered whole
and loads under any placement. On SIGTERM/SIGINT the ranks agree on one
step to save at (``parallel.mesh.PreemptionSync``): a rank that saved one
step ahead of its peer would wait forever in the peer's collective. One
process keeps the signal handler that saves at once.

A train-state checkpoint also holds the engine generator's state. A resume
restores it and, when the checkpoint was written inside an epoch (a
preemption save), skips the batches of that epoch the saved state has
already taken, so a resumed run continues with the uninterrupted run's
draws and batches (the JAX engine replays the interrupted epoch). Batches
match only where the loader's order of that epoch is the same after a
restart: in the first epoch, or for an unshuffled loader.

``debug_nans`` (the JAX engine's ``jax_debug_nans``): the train step raises
``FloatingPointError`` on a non-finite loss or gradient, and classify and
sample on a non-finite denoiser output (one host sync a forward). Off, it
costs nothing.

As in the JAX engine, classify, sample and evaluate run on the EMA
parameters (``state.ema_model``); ``loss`` and the train step on the
training parameters (``denoiser``). With the EMA ramp at its start the EMA
is a straight copy for the first ``ema_warmup`` updates. A backbone with a
prefix split (the UNet) shares its condition-free prefix across the
candidate classes in classify and across the CFG pair in sampling.

``encoder_type='t5'``: the labels pick rows of a frozen ``[C+1, S, D]``
table of class-name embeddings (:func:`t5_class_table`: ``np.load`` of
``config.t5_table_path``, else computed once by a T5 encoder from
``t5_path``, ``t5_class_names`` and ``t5_max_length``). The backbone must
be built for that context, ``context_tokens=S`` and ``context_dim=D``
(``experiments/cifar10.py::build_backbone`` reads both from the config);
the engine checks it. :meth:`encode_text_prompt` gives the context of a
batch of labels.

``config.compilation_cache_dir`` is accepted and ignored: there is no XLA
compile to cache, and the CUDA kernels are cached by the hash of their
sources under ``build/`` (``ops/flash_attention.py``).

Spans and counters (``utils/profiling.py``): a classify call is the span
``classify`` (counters ``classify.calls``, ``classify.images``), a train
step ``train_step`` (``train.steps``); both, and sample and loss, hand
their host images to the device in ``upload`` (``upload.bytes``) and
Haar-transform them in ``haar``.

The device is explicit (``device=``, default ``"cuda"``): nothing moves to
the CPU because no GPU was found. The classifier's, the sampler's and the
train step's draws come from one ``torch.Generator`` on that device seeded
with ``config.seed``; parameter init uses a CPU generator with the same
seed, so the weights do not depend on the device. Weights and draws differ from the
JAX package's for the same seed (different generators); the parity tests
inject both.
"""

from __future__ import annotations

import copy
import functools
import itertools
import os
import signal
import sys
import time
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..diffusion.classify import TorchDraws, make_classifier
from ..diffusion.sampler import TorchSampleDraws, make_sampler
from ..diffusion.schedule import make_schedule_fn
from ..models.encoders import build_t5_class_table, make_encoder
from ..models.layers import reset_parameters
from ..ops.wavelet import haar_dwt2
from ..parallel.mesh import PreemptionSync, is_main_process, make_mesh
from ..parallel.sharding import shard_params
from ..utils import profiling
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.tracking import make_tracker
from .denoiser import Denoiser, supports_prefix
from .state import EmaConfig, init_train_state, lr_at, make_optimizer
from .steps import TorchTrainDraws, check_finite, make_loss_fn, make_train_step

__all__ = ["DiffusionClassifier", "t5_class_table"]


def t5_class_table(config) -> np.ndarray:
    """The ``[classes + 1, S, D]`` table of ``encoder_type='t5'`` (last row: the null condition).

    ``np.load(config.t5_table_path)`` when it is set (no ``transformers``
    needed); otherwise the T5 encoder at ``config.t5_path`` embeds
    ``config.t5_class_names`` (default: the class ids as text), once a
    process for the same arguments.
    """
    if config.t5_table_path:
        return np.load(config.t5_table_path)
    names = tuple(config.t5_class_names or [str(i) for i in range(config.classes)])
    return _t5_table_from_model(names, config.t5_path, config.t5_max_length).copy()


@functools.lru_cache(maxsize=2)
def _t5_table_from_model(names: tuple, model_path: str, max_length: int) -> np.ndarray:
    return build_t5_class_table(names, model_path=model_path, max_length=max_length)


def _first_batch(dataloader, name: str):
    try:
        return next(iter(dataloader))
    except StopIteration:
        raise ValueError(
            f"The {name} dataloader yielded no batches. With drop_last "
            f"batching this happens when the dataset has fewer rows than "
            f"batch_size — reduce batch_size or provide more data."
        ) from None


def _checked(forward: Callable) -> Callable:
    """``forward`` that raises ``FloatingPointError`` when its output is not finite (``debug_nans``)."""

    def run(*args, **kwargs):
        out = forward(*args, **kwargs)
        check_finite("the denoiser output", [out])
        return out

    return run


class DiffusionClassifier:
    """DDPM trainer and per-class-ELBO classifier over a class-conditional denoiser (PyTorch)."""

    def __init__(self, backbone, config, *, device="cuda", mesh=None):
        self.config = config.validate()
        self.device = torch.device(device)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(device_type=self.device.type)
        self.mesh = mesh
        data_rows = (0, 1)
        if mesh is not None:
            data_rows = (mesh["data"].get_local_rank(), mesh["data"].size())
        self._data_group = mesh["data"].get_group() if mesh is not None else None
        self.schedule_fn = make_schedule_fn(
            config.schedule, config.noise_d, config.image_size
        )
        t5_table = None
        if config.encoder_type == "t5":
            want = (getattr(backbone, "context_tokens", None), getattr(backbone, "context_dim", None))
            if None in want:
                raise ValueError(
                    "encoder_type='t5' gives a [B, S, D] cross-attention context; "
                    f"{type(backbone).__name__} takes none (use a UNet)"
                )
            t5_table = t5_class_table(config)
            if tuple(t5_table.shape[1:]) != want:
                raise ValueError(
                    f"the t5 table is [S, D] = {list(t5_table.shape[1:])} a class, but the backbone "
                    f"was built for a context of {list(want)}: build it with context_tokens=S "
                    f"and context_dim=D"
                )
        encoder, self.null_token = make_encoder(
            config.encoder_type,
            num_classes=config.classes,
            embedding_dim=getattr(getattr(backbone, "config", None), "encoder_hid_dim", None),
            dtype=torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32,
            t5_table=t5_table,
        )
        self.denoiser = Denoiser(backbone, encoder)
        self.ema_cfg = EmaConfig(
            beta=config.ema_beta,
            update_after_step=config.ema_warmup,
            update_every=config.ema_update_freq,
        )
        loss_kw = dict(pred_param=config.pred_param, null_token=self.null_token)
        # the closures reach the engine through a weak proxy: with ``self``
        # each engine would be a reference cycle, whose parameters on the
        # card only the cyclic collector frees
        me = weakref.proxy(self)
        # training runs through the placement's forward (DDP's wrapper, or
        # the module itself)
        train_fn = lambda z, logsnr, labels: me.state.placement.forward_module(z, logsnr, labels)  # noqa: E731
        self._loss_fn = make_loss_fn(train_fn, self.schedule_fn, **loss_kw)
        # the public loss(): no CFG dropout, as the reference method
        self._loss_eval = make_loss_fn(
            self.denoiser, self.schedule_fn, cfg_dropout=0.0, **loss_kw
        )
        apply_fn = lambda z, logsnr, labels: me.state.ema_model(z, logsnr, labels)  # noqa: E731
        encode_fn = tail_fn = None
        if supports_prefix(backbone):
            encode_fn = lambda z, logsnr: me.state.ema_model(z, logsnr, None, mode="encode")  # noqa: E731
            tail_fn = lambda state, labels: me.state.ema_model(  # noqa: E731
                None, None, labels, mode="tail", prefix_state=state
            )
        if config.debug_nans:
            apply_fn = _checked(apply_fn)
            if tail_fn is not None:
                tail_fn = _checked(tail_fn)
        self._encode, self._tail = encode_fn, tail_fn
        self._sample_impl = make_sampler(
            apply_fn,
            self.schedule_fn,
            pred_param=config.pred_param,
            cfg_w=config.cfg_w,
            null_token=self.null_token,
            sampling_steps=config.sampling_steps,
            encode_fn=encode_fn,
            tail_fn=tail_fn,
            data_rows=data_rows,
        )
        self._classify_impl = make_classifier(
            apply_fn,
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
            encode_fn=encode_fn,
            tail_fn=tail_fn,
            data_rows=data_rows,
            row_bytes=getattr(backbone, "classify_row_bytes", None),
        )
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.state = None
        self._train_step = None

    # ------------------------------------------------------------------ utils
    @property
    def is_main_process(self) -> bool:
        return is_main_process()

    def _log(self, *args, **kwargs) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

    def _images(self, x) -> torch.Tensor:
        """Host images → float32 device tensor, Haar-decomposed (÷2 into [-1, 1]) if configured."""
        with profiling.span("upload"):
            x = np.asarray(x, np.float32)
            profiling.count("upload.bytes", x.nbytes)
            x = torch.as_tensor(x, device=self.device)
        if not self.config.wavelet_transform:
            return x
        with profiling.span("haar"):
            return haar_dwt2(x) / 2.0

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(np.asarray(labels, np.int64), device=self.device)

    def _require_state(self) -> None:
        if self.state is None:
            raise RuntimeError("initialize/restore parameters first")

    def init_params(self, sample_batch=None) -> None:
        """Seeded parameter init and an EMA copy, placed on the mesh (once); ``sample_batch`` is accepted for API parity."""
        if self.state is not None:
            return
        gen = torch.Generator().manual_seed(self.config.seed)
        self.denoiser.backbone.reset_parameters(gen)
        if self.denoiser.encoder is not None:
            reset_parameters(self.denoiser.encoder, gen)
        self.denoiser.to(self.device)
        self._log(f"Parameter count: {sum(p.numel() for p in self.denoiser.parameters())}")
        ema = copy.deepcopy(self.denoiser).requires_grad_(False)
        mode = self.config.param_sharding
        self.state = init_train_state(
            self.denoiser,
            ema_model=ema,
            placement=shard_params(self.denoiser, self.mesh, mode),
            ema_placement=shard_params(ema, self.mesh, mode),
        )

    def _build_train_state(self, total_steps: int) -> None:
        """Optimizer for ``total_steps`` and a fresh state: EMA = parameters, counters 0."""
        cfg = self.config
        tx = make_optimizer(
            cfg.learning_rate, cfg.lr_warmup_steps, total_steps,
            state_dtype=cfg.optimizer_state_dtype,
        )
        st = self.state
        st.placement.wrap_for_training()
        self.state = init_train_state(
            self.denoiser, tx, ema_model=st.ema_model,
            placement=st.placement, ema_placement=st.ema_placement,
        )
        self._train_step = make_train_step(
            self._loss_fn, tx, self.ema_cfg,
            grad_accum_steps=cfg.gradient_accumulation_steps,
            debug_nans=cfg.debug_nans,
        )

    # ------------------------------------------------------------- public API
    def train_step(self, batch, *, draws=None) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss as a device scalar (no sync)."""
        if self._train_step is None:
            raise RuntimeError("build the train state first (train_loop does)")
        with profiling.span("train_step", profiling.count("train.steps")):
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
        with profiling.span("classify", profiling.count("classify.calls")):
            x = self._images(x)
            profiling.count("classify.images", x.shape[0])
            if labels is None:
                if self.config.fast_classification:
                    raise ValueError("fast_classification requires true labels in classify()")
                labels = np.zeros((x.shape[0],), np.int64)
            draws = draws if draws is not None else TorchDraws(self.generator)
            return self._classify_impl(x, self._labels(labels), draws)

    def sample(self, x, labels=None, from_t: float = 1.0, *, draws=None) -> torch.Tensor:
        """CFG ancestral sampling on the EMA parameters; ``from_t < 1`` re-noises ``x`` first.

        Returns a device tensor in ``[-1, 1]``, in the Haar domain when
        ``wavelet_transform`` is set (as the JAX engine's). ``draws``
        overrides the generator.
        """
        self._require_state()
        x = self._images(x)
        if labels is None:
            labels = np.zeros((x.shape[0],), np.int64)
        draws = draws if draws is not None else TorchSampleDraws(self.generator)
        return self._sample_impl(x, self._labels(labels), draws, from_t=float(from_t))

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
        pl, b = self.state.placement, x.shape[0]
        u, t, eps = draws.loss(0, 1, b * pl.data_count, (b * pl.data_count,) + tuple(x.shape[1:]))
        if pl.data_count > 1:
            rows = slice(pl.data_index * b, (pl.data_index + 1) * b)
            u, t, eps = u[rows], t[rows], eps[rows]
        return pl.mean_over_data(self._loss_eval(x, self._labels(labels), u, t, eps))

    @torch.no_grad()
    def encode_text_prompt(self, labels) -> torch.Tensor:
        """The condition of integer labels on the EMA parameters, on the engine's device.

        ``'nn'``/``'t5'``: the context ``[B, 1|S, D]`` in the compute dtype;
        ``'DiT'`` (no encoder): the labels as they are.
        """
        labels = self._labels(labels)
        if self.denoiser.encoder is None:
            return labels
        self._require_state()
        return self.state.ema_model.encoder(labels)

    def evaluate(
        self,
        val_loader,
        stop_idx: Optional[int] = None,
        metrics: Optional[Sequence] = None,
        classification: bool = False,
        from_t: float = 1.0,
    ):
        """Classify, or sample from, val batches and update metrics; ``stop_idx`` runs ``stop_idx + 1`` batches."""
        show = self.config.progress
        if show is None:
            show = sys.stderr.isatty()
        show = show and self.is_main_process
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
                    f"\r{'classify' if classification else 'sample'} batch "
                    f"{idx + 1}/{total if total else '?'}",
                    end="", file=sys.stderr, flush=True,
                )
            self.init_params(batch)
            if classification:
                out = self.classify(batch["images"], batch["prompt"]).cpu()
            else:
                out = self.sample(batch["images"], batch["prompt"], from_t=from_t).cpu()
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
        """Epoch training loop with eval cadence, best-metric checkpoints, tracking and resume.

        At each eval, ``plot_function(output_dir=, batches=, samples=, epoch=,
        process_idx=)`` gets images sampled from the val batches, when given.
        """
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
            is_main_process=self.is_main_process,
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
        self._log(cfg.to_json())

        # on SIGTERM/SIGINT save the latest state, so `resume` continues
        # cleanly: one process saves in the handler; several agree on a step
        current_epoch = start_epoch
        prev_handlers = {}
        preemption = None
        if cfg.save_on_signal and dist.is_initialized() and dist.get_world_size() > 1:
            preemption = PreemptionSync()
        elif cfg.save_on_signal:

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

        # a checkpoint written inside an epoch: skip what its state has taken
        skip = self.state.step - start_epoch * steps_per_epoch
        skip = skip if 0 < skip < steps_per_epoch else 0
        try:
            loss = None
            log_k = cfg.log_every_steps
            global_step = start_epoch * steps_per_epoch + skip
            for epoch in range(start_epoch, cfg.num_epochs):
                current_epoch = epoch
                epoch_start = time.time()
                batches = iter(train_dataloader)
                if skip:
                    batches = itertools.islice(batches, skip, None)
                    skip = 0
                for batch in batches:
                    loss = self.train_step(batch)
                    global_step += 1
                    if preemption is not None and preemption.should_save():
                        self._log(f"Preemption notice: saving checkpoint at synced step {global_step}...")
                        self.save_checkpoint(
                            current_epoch - 1,
                            tracker.get_key() if tracker is not None else None,
                            checkpoint_tracker if checkpoint_metric else None,
                        )
                        raise SystemExit(128 + preemption.signum)
                    if log_k and global_step % log_k == 0:
                        # the host reads the loss only at this cadence
                        loss_val = float(loss)
                        lr = lr_at(
                            cfg.learning_rate, cfg.lr_warmup_steps, total_steps, global_step
                        )
                        if tracker is not None:
                            tracker.log_metric("loss", loss_val, step=global_step)
                            tracker.log_metric("lr", lr, step=global_step)
                        self._log(f"step {global_step}/{total_steps}: loss={loss_val:.5f} lr={lr:.3e}")
                loss_val = float(loss)
                self._log(f"Epoch {epoch}/{cfg.num_epochs}: {time.time() - epoch_start:.2f} s.")
                if tracker is not None:
                    tracker.log_metric("loss", loss_val, epoch=epoch)

                if epoch % cfg.save_image_epochs == 0 or epoch == cfg.num_epochs - 1:
                    eval_start = time.time()
                    # the sampling pass only feeds plot_function: skipped without one
                    image_path = None
                    if plot_function is not None:
                        samples, val_batches, _ = self.evaluate(
                            val_dataloader, stop_idx=cfg.evaluation_batches
                        )
                        if self.is_main_process:
                            images_path = os.path.join(cfg.experiment_path, "training_images")
                            os.makedirs(images_path, exist_ok=True)
                            image_path = plot_function(
                                output_dir=images_path, batches=val_batches, samples=samples,
                                epoch=epoch, process_idx=0,
                            )
                    _, _, metrics = self.evaluate(
                        val_dataloader,
                        stop_idx=cfg.evaluation_batches,
                        metrics=metrics,
                        classification=True,
                    )
                    for metric in metrics or ():
                        metric.sync_across_processes(self._data_group)
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
                            if image_path is not None:
                                tracker.log_image(f"Sample at epoch {epoch}", image_path)
                        baseline = (
                            1 / cfg.n_fast_classes if cfg.fast_classification else 1 / cfg.classes
                        )
                        self._log(f"Baseline Classification Accuracy: {baseline:.2f}")
                        self._log(metric_output)
                        metric.reset()
                    self.save_checkpoint(
                        epoch,
                        tracker.get_key() if tracker is not None else None,
                        checkpoint_tracker if checkpoint_metric else None,
                    )
                    self._log(f"Val evaluation time: {time.time() - eval_start:.2f} s.")
                    checkpoint_tracker["save_flag"] = False
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            if preemption is not None:
                preemption.close()

    def inference(
        self,
        val_dataloader,
        metrics: Optional[Sequence] = None,
        plot_function: Optional[Callable] = None,
        classification: bool = False,
        from_t: float = 1.0,
        checkpoint_folder: str = "checkpoints",
    ):
        """Load a checkpoint's EMA parameters and classify, or sample from, the val loader.

        When sampling, ``plot_function`` gets the samples, written under
        ``<experiment>/inference_images/``.
        """
        cfg = self.config
        self.init_params(_first_batch(val_dataloader, "val"))
        self.load_checkpoint(
            os.path.join(cfg.experiment_path, checkpoint_folder), train_state=False
        )
        val_samples, batches, metrics = self.evaluate(
            val_dataloader,
            metrics=metrics,
            stop_idx=cfg.evaluation_batches,
            classification=classification,
            from_t=from_t,
        )
        if plot_function is not None and not classification and self.is_main_process:
            out_dir = os.path.join(cfg.experiment_path, "inference_images")
            os.makedirs(out_dir, exist_ok=True)
            plot_function(
                output_dir=out_dir, batches=batches, samples=val_samples, epoch=0, process_idx=0
            )
        if metrics is None:
            return val_samples, batches
        metric_output = []
        for metric in metrics:
            metric.sync_across_processes(self._data_group)
            metric_output.append(metric.get_output())
        return metric_output, val_samples, batches

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, epoch: int, experiment_key=None, checkpoint_tracker=None):
        """Save the whole train state and the generator's; every rank calls it, rank 0 writes."""
        self._require_state()
        best = bool(checkpoint_tracker and checkpoint_tracker.get("save_flag"))
        path = save_checkpoint(
            self.config.experiment_path,
            self.state,
            epoch=epoch,
            best_metric=checkpoint_tracker["value"] if checkpoint_tracker else None,
            experiment_key=experiment_key,
            best=best,
            extra={"generator": self.generator.get_state(), "generator_device": self.device.type},
        )
        self._log(f"Checkpoint saved to {path}")

    def load_checkpoint(self, checkpoint_path: str, *, train_state: bool = True):
        """Restore the EMA parameters and, with ``train_state``, the rest of the train state.

        Adam's state is restored only into an engine that built an optimizer,
        and the generator's state only from a checkpoint written on the same
        kind of device. Every rank reads the whole files and keeps its own
        pieces (``Placement.load``). A folder of the JAX package (its Orbax
        ``state``) loads the same way; it holds no generator state, so the
        draws go on from this engine's own seeded generator. Returns
        ``(epoch, best_metric, experiment_key)``.
        """
        if self.state is None:
            raise RuntimeError("initialize parameters before restoring")
        ema, train, epoch, best_metric, experiment_key = load_checkpoint(
            checkpoint_path, train_state=train_state, placement=self.state.placement
        )
        state = self.state
        state.ema_placement.load(ema)
        if train is not None:
            state.placement.load(train["params"])
            state.step, state.ema_counter = int(train["step"]), int(train["ema_counter"])
            if state.opt_state is not None and train["opt_state"] is not None:
                opt = dict(train["opt_state"])
                named = list(state.model.named_parameters())
                for key in ("mu", "nu"):
                    opt[key] = [state.placement.piece(n, m, p) for (n, p), m in zip(named, opt[key])]
                state.opt_state.load_state_dict(opt)
            if train.get("generator_device") == self.device.type:
                self.generator.set_state(train["generator"])
        self._log(f"Checkpoint loaded. Resuming from epoch {epoch}. Best metric {best_metric}")
        return epoch, best_metric, experiment_key
