"""How a cell drives the program: one module a mode, found by the workload's ``"mode"``.

A mode module has a ``Runner(ctx)`` (a :class:`Runner` here) with
``setup()`` (build, weights, warm-up; nothing of it may compile inside the
window), ``call(i) -> images`` (one whole call of the window), ``needed()``
(the window's calls, in order, that the check reads), ``finish()`` (wait
for the device), ``counting()`` (a context counting the denoiser's
forwards and rows), ``facts`` (printed before the window), ``held_bytes``
(what the checked calls left allocated on the card), ``work()`` (the model
operations an image, from the benchmark's counts), ``release()`` (drop the
program's state) and ``check(control=False) -> {number: value}``.
The helpers here are shared by the modes: the engine built from the
configuration, the weights made from the seed and given to it.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib

import torch

from ..inputs import make_weights

__all__ = ["Runner", "build_engine", "count_forwards", "reference", "rows_of", "weights"]


def reference(config: dict):
    """The configuration's plain reference module (``portbench/reference/<name>.py``)."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def weights(config: dict, seed: int, device) -> dict:
    """The denoiser's parameters for ``seed``, shaped as the reference names them."""
    shapes = reference(config).param_shapes(config["model"], config["experiment"]["classes"])
    return make_weights(shapes, seed, device)


def build_engine(config: dict, seed: int, device, weights_: dict):
    """The port's engine for the configuration, built on ``device`` and holding ``weights_``.

    The engine comes from the experiment's own ``build_engine``; its
    parameters and its EMA copy are the benchmark's tensors (the engine's
    seeded host init is not run), placed as ``init_params`` places them.
    """
    from diffusion_classifier_tpu_torch.engine.state import init_train_state
    from diffusion_classifier_tpu_torch.parallel.sharding import shard_params
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    experiment = importlib.import_module(f"diffusion_classifier_tpu_torch.experiments.{config['builder']}")
    exp = ExperimentConfig.from_dict(dict(config["experiment"], seed=seed % 2**31))
    with torch.device(device):
        engine = experiment.build_engine(exp, device=device)
    denoiser = engine.denoiser.to(device)
    params = dict(denoiser.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(w.shape) for n, w in weights_.items()}
    if shapes != want:
        diff = sorted(set(shapes.items()) ^ set(want.items()))[:8]
        raise RuntimeError(f"the program's parameters are not the reference's: {diff}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights_[name])
    ema = copy.deepcopy(denoiser).requires_grad_(False)
    mode = exp.param_sharding
    engine.state = init_train_state(
        denoiser, ema_model=ema,
        placement=shard_params(denoiser, engine.mesh, mode),
        ema_placement=shard_params(ema, engine.mesh, mode),
    )
    return engine


def rows_of(output) -> int:
    return (output[0] if isinstance(output, tuple) else output).shape[0]


@contextlib.contextmanager
def count_forwards(module, counts: dict):
    """Count ``module``'s forwards into ``counts[(mode, rows)]`` while the block runs."""

    def hook(mod, args, kwargs, output):
        k = (kwargs.get("mode", "full"), rows_of(output))
        counts[k] = counts.get(k, 0) + 1

    handle = module.register_forward_hook(hook, with_kwargs=True)
    try:
        yield counts
    finally:
        handle.remove()


class Runner:
    """What every mode shares: the cell, its configuration, the seed, the device, the engine's lifetime."""

    def __init__(self, ctx):
        self.ctx, self.cell, self.config = ctx, ctx.cell, ctx.config
        self.seed, self.device = ctx.seed, torch.device(ctx.device)
        self.x = self.config["experiment"]
        self.engine = None
        self.held_bytes = 0

    def needed(self) -> list:
        return []

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
