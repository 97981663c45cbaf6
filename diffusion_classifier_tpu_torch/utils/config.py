"""Typed, validated experiment configuration — the port's copy of ``utils/config.py``.

Copied from the JAX package's module (stdlib only) so the port imports
nothing of that package: the same JSON schema, the same field defaults and
the same validator, so a launcher JSON of the JAX experiments loads here
unchanged. Fields that only the JAX engine reads (mesh sharding, the XLA
compilation cache, NaN debugging) are kept for that reason and ignored by
the port.

The reference parses a JSON blob from the ``TRAINING_CONFIG`` /
``INFERENCE_CONFIG`` env var into an object whose ``__getattr__`` silently
returns ``None`` for missing keys; here the schema is a frozen dataclass that
**rejects unknown keys** and validates cross-field invariants up front.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Sequence

__all__ = ["ExperimentConfig", "load_config"]


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # --- diffusion objective (reference :29-44) ---
    pred_param: str = "v"  # 'v' | 'eps'
    schedule: str = "shifted_cosine"  # 'cosine' | 'shifted_cosine'
    noise_d: int = 64
    image_size: int = 32
    image_channels: int = 3
    cfg_w: float = 0.1
    # --- conditioning ---
    encoder_type: Optional[str] = "nn"  # 'nn' | 'DiT' | 't5' | None
    classes: int = 10
    # t5 text-conditioning (encoder_type='t5'): local model path + the class
    # name strings to embed; defaults to stringified class indices
    t5_path: str = "t5-base"
    t5_class_names: Optional[Sequence[str]] = None
    t5_max_length: int = 8
    # precomputed [C+1, S, D] class-embedding table (.npy) — when set, the
    # engine loads it instead of running the T5 encoder (no transformers /
    # tokenizer files needed at runtime; build once with
    # models.encoders.build_t5_class_table and np.save)
    t5_table_path: Optional[str] = None
    # --- EMA (ema_pytorch semantics, reference :51-56) ---
    ema_beta: float = 0.9999
    ema_warmup: int = 100
    ema_update_freq: int = 10
    # --- precision / accumulation ---
    mixed_precision: str = "bf16"  # 'bf16' | 'no'
    gradient_accumulation_steps: int = 1
    # --- paths / run management ---
    project_root: str = "."
    experiment_dir: str = "runs/default"
    resume: bool = False
    checkpoint_folder: str = "checkpoints"
    # --- tracking (comet-shaped; backend pluggable) ---
    use_comet: bool = False
    comet_api_key: Optional[str] = None
    comet_project_name: Optional[str] = None
    comet_workspace: Optional[str] = None
    comet_experiment_name: Optional[str] = None
    # --- training loop ---
    num_epochs: int = 10
    save_image_epochs: int = 1
    eval_period: int = 1
    evaluation_batches: int = 2
    sampling_steps: int = 128
    seed: int = 0
    # in-epoch observability (reference parity surface: per-step tqdm +
    # Comet logging, `diffusion/diffusion_classifier.py:455-461`):
    # log loss + LR through the tracker every K optimizer steps (0 = off;
    # the host fetches the loss scalar only at this cadence — no per-step
    # device sync)
    log_every_steps: int = 0
    # single-line progress printer for eval/classify loops (reference shows
    # tqdm there, `:554,686`); None = auto (only when stderr is a TTY,
    # tqdm's own default), True/False forces
    progress: Optional[bool] = None
    # --- data ---
    data_path: str = "./data"
    batch_size: int = 64
    num_workers: int = 4
    # reduced-scale JPEG decode (PIL draft): libjpeg decodes at the smallest
    # DCT scale >= image_size before the bilinear resize — 3-8x less host
    # decode work on large sources (CheXpert scans are ~2800px). Off by
    # default: pixel output differs from the full decode at resampling-noise
    # level (data/loader.py::decode_image)
    fast_decode: bool = False
    # decoded-sample disk cache for the JPEG pipelines (the reference's
    # ipmsa.py:174-197 lever): epoch 1 decodes + stores resized uint8
    # tensors under this directory, later epochs stream at disk bandwidth
    # instead of re-paying libjpeg (~0.2 MB per 256x256 image). None = off.
    # Keys include source mtime/size, image_size and fast_decode — a
    # changed source or config re-decodes (data/decode_cache.py)
    decode_cache_dir: Optional[str] = None
    slices: Optional[int] = None
    wavelet_transform: bool = False
    # --- optimizer ---
    learning_rate: float = 1e-4
    lr_warmup_steps: int = 500
    # 'bf16' stores the Adam moments in bfloat16 (update math stays fp32):
    # the train-step rooflines showed ~49% MFU with the bottleneck in the
    # optimizer/EMA epilogue's fp32 parameter-copy streaming — mu/nu are 2
    # of its ~6 copies (engine/state.py::compress_opt_state). TPU-first
    # production option; 'fp32' (default) = reference parity
    optimizer_state_dtype: str = "fp32"
    # --- classification protocol (reference :657-725) ---
    classification: bool = True
    fast_classification: bool = False
    n_fast_classes: int = 2
    n_stages: int = 1
    evaluation_per_stage: Sequence[int] = (16,)  # cumulative
    n_keep_per_stage: Sequence[int] = (1,)
    # how many (class × eval) forwards to fuse into one device megabatch
    classify_chunk: int = 0  # 0 = auto
    # classes scored per scan step inside classify (0 = all at once,
    # -1 = auto: 1 at batch >= 16, megabatch below); identical predictions
    # for any value — execution schedule only
    classify_class_chunk: int = -1
    # unroll factor for classify's on-device eval/class scans (removes
    # while-loop barriers so XLA may overlap iterations); bit-identical
    # predictions for any value — execution schedule only. An
    # [eval_unroll, class_unroll] pair unrolls the two scans independently.
    # Measured: 2 helps 2-class DiT shapes (+7%), every variant hurts the
    # 10-class CIFAR shape (BASELINE.md round 4) — hence default 1.
    classify_scan_unroll: Any = 1
    # --- model extras ---
    patch_size: int = 2  # DiT
    # DiT attention head dim (None = family parity default, 64). The model
    # width is fixed per family, so heads = width // head_dim: head_dim=128
    # halves the heads at identical parameter count. TPU-first performance
    # option — D=64 attention can use at most HALF the MXU (64-deep QK^T
    # contraction, 64 P·V output lanes; BASELINE.md round-4 MFU
    # decomposition), D=128 uses all of it. Non-parity: the reference fixes
    # 6x64 (experiments/chexpert-dit/train.py:118-135)
    attention_head_dim: Optional[int] = None
    variant: str = "resnet18"  # discriminative baseline
    pretrained: bool = False
    # local torchvision-state_dict .npz for the discriminative ResNet — the
    # zero-egress completion of the reference's ImageNet-weights path
    # (`nets/resnet.py:31-47`); see models.resnet.load_pretrained_resnet
    pretrained_path: Optional[str] = None
    # OOD evaluation dataset for the chexpert ood.py CLIs
    # (BASELINE.json multi-dataset sweep; also settable via --dataset)
    ood_dataset: str = "mimic"  # 'mimic' | 'padchest' | 'isic'
    # --- runtime ---
    slurm: bool = False
    # parameter/optimizer-state placement over the mesh: 'tp' shards the big
    # matmul weights over the 'model' axis (no-op on a 1-wide model axis);
    # 'fsdp' additionally shards every large param + its Adam/EMA state over
    # the 'data' axis (ZeRO-3); 'replicated' forces full replication
    param_sharding: str = "tp"  # 'tp' | 'fsdp' | 'replicated'
    attn_backend: str = "auto"  # 'auto' | 'xla' | 'pallas' (auto: measured
    # routing — pallas flash attention for sequences >= 256 tokens)
    # per-block activation rematerialization (jax.checkpoint): backward
    # recomputes block interiors instead of storing them — trades ~one extra
    # forward of FLOPs for peak activation memory (bigger batches / models)
    remat: bool = False
    # debug/observability (SURVEY §5.2: the reference has no sanitizers; JAX
    # purity + these toggles are the TPU-native equivalent)
    debug_nans: bool = False
    # checkpoint on SIGTERM/SIGINT for preemption safety (SURVEY §5.3)
    save_on_signal: bool = True
    # persistent XLA compilation cache directory (None = off). Big-model
    # compiles through the TPU remote compiler run 1-5 min; with a cache
    # dir, a restarted process (resume after preemption, inference after
    # training) reloads compiled executables in milliseconds.
    compilation_cache_dir: Optional[str] = None

    @property
    def experiment_path(self) -> str:
        # Reference joins with f"{project_root}{experiment_dir}"
        # (experiments/cifar10/train.py:35); normalized join here.
        return os.path.join(self.project_root, self.experiment_dir)

    def validate(self) -> "ExperimentConfig":
        assert self.pred_param in ("v", "eps"), (
            "Invalid prediction parameterization. Must be 'v' or 'eps'"
        )
        assert self.schedule in ("cosine", "shifted_cosine"), (
            "Invalid schedule. Must be 'cosine' or 'shifted_cosine'"
        )
        # fp16 is rejected loudly: TPU mixed precision is bf16 (no loss
        # scaling); silently running fp32 under an "fp16" config would
        # violate the reject-unknowns philosophy (VERDICT r1, weak #4).
        assert self.mixed_precision in ("bf16", "no"), (
            f"mixed_precision must be 'bf16' or 'no' (got "
            f"{self.mixed_precision!r}; fp16 is not supported on TPU — "
            f"use 'bf16')"
        )
        assert self.param_sharding in ("tp", "fsdp", "replicated"), (
            f"param_sharding must be 'tp', 'fsdp' or 'replicated' "
            f"(got {self.param_sharding!r})"
        )
        assert self.optimizer_state_dtype in ("fp32", "bf16"), (
            f"optimizer_state_dtype must be 'fp32' or 'bf16' "
            f"(got {self.optimizer_state_dtype!r})"
        )
        ev = tuple(self.evaluation_per_stage)
        nk = tuple(self.n_keep_per_stage)
        assert len(ev) == self.n_stages, (
            "Number of evaluations per stage must match the number of stages."
        )
        assert len(nk) == self.n_stages, (
            "Number of classes to keep per stage must match the number of stages."
        )
        assert nk[-1] == 1, (
            "Only one class should be selected at the end of the classification process."
        )
        assert all(a < b for a, b in zip(ev, ev[1:])), (
            "evaluation_per_stage is cumulative and must be strictly increasing"
        )
        if self.classify_chunk:
            stage_evals = [b - a for a, b in zip((0,) + ev, ev)]
            bad = [n for n in stage_evals if n % self.classify_chunk != 0]
            assert not bad, (
                f"classify_chunk={self.classify_chunk} must divide every "
                f"stage's evaluation count (stage counts {stage_evals}); "
                f"use 0 for auto grouping"
            )
        if self.fast_classification:
            assert 2 <= self.n_fast_classes <= self.classes, (
                "Number of fast classes must be at least 2 and at most `classes`."
            )
        return self

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"Unknown config keys: {sorted(unknown)}. "
                f"Valid keys: {sorted(names)}"
            )
        for seq_key in ("evaluation_per_stage", "n_keep_per_stage"):
            if seq_key in d and d[seq_key] is not None:
                d = {**d, seq_key: tuple(d[seq_key])}
        return cls(**d).validate()

    @classmethod
    def from_env(cls, var: str = "TRAINING_CONFIG") -> "ExperimentConfig":
        """Ingest the reference's env-var JSON path (`experiments/*/train.py:24-38`)."""
        blob = os.environ.get(var)
        if blob is None:
            raise ValueError(f"{var} environment variable is not set")
        return cls.from_dict(json.loads(blob))

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw).validate()

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["evaluation_per_stage"] = list(d["evaluation_per_stage"])
        d["n_keep_per_stage"] = list(d["n_keep_per_stage"])
        return json.dumps(d, indent=2, sort_keys=True)


def load_config(
    var: str = "TRAINING_CONFIG", **overrides
) -> ExperimentConfig:
    cfg = ExperimentConfig.from_env(var)
    return cfg.replace(**overrides) if overrides else cfg
